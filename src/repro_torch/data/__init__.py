from .pipeline import DataConfig, SyntheticPipeline, eval_batches  # noqa: F401
