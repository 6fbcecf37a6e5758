from .store import CheckpointStore, flatten_tree, unflatten_like  # noqa: F401
