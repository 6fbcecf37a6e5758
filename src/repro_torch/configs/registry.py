"""Architecture registry of the port (counterpart of
``repro/configs/registry.py``).

Each ``repro_torch/configs/<id>.py`` exposes ``full() -> ModelConfig`` and
``smoke() -> ModelConfig``. Only the architectures this port serves are
known; every other id of the reference raises until its family is ported
(ROADMAP.md, Queue A item 9).
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "qwen3_0_6b",
    "paper_tanh",        # the paper's own deployment context (extra)
]

# assignment ids -> module names
ALIASES = {
    "qwen3-0.6b": "qwen3_0_6b",
    "paper-tanh": "paper_tanh",
}


def _module(name: str):
    mod_name = ALIASES.get(name, name)
    if mod_name not in ARCHS:
        raise NotImplementedError(
            f"arch {name!r} is not ported yet (ported: {sorted(ALIASES)}; "
            f"ROADMAP.md, Queue A item 9)")
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get(name: str, smoke: bool = False, **overrides):
    mod = _module(name)
    cfg = mod.smoke() if smoke else mod.full()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg
