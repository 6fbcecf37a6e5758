"""Cost and roofline analysis of the port's steps (counterpart of
``repro/analysis``): ``hlo_cost`` counts a step as it runs, ``roofline``
turns the counts into H100 time terms."""
