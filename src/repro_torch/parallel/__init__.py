"""Parallelism: the logical-axis rule table (partition.py), the
collectives the blocks call on local shards (tp.py) and the data axis of
sharded training (dp.py)."""
