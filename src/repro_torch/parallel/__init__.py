"""Tensor parallelism: the logical-axis rule table (partition.py) and
the collectives the blocks call on local shards (tp.py)."""
