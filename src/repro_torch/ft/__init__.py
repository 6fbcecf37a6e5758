from .driver import FTConfig, SimulatedPreemption, StepRecord, TrainDriver  # noqa: F401
