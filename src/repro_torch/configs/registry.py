"""Architecture registry of the port (counterpart of
``repro/configs/registry.py``).

Each ``repro_torch/configs/<id>.py`` exposes ``full() -> ModelConfig`` and
``smoke() -> ModelConfig``. The reference's ten assigned ids all
resolve; an unknown id raises, as in the reference.
"""
from __future__ import annotations

import dataclasses
import importlib

ARCHS = [
    "yi_34b",
    "olmo_1b",
    "qwen3_0_6b",
    "qwen2_5_3b",
    "hymba_1_5b",
    "mixtral_8x22b",
    "llama4_scout_17b_a16e",
    "qwen2_vl_2b",
    "falcon_mamba_7b",
    "musicgen_large",
    "paper_tanh",        # the paper's own deployment context (extra)
]

# assignment ids -> module names
ALIASES = {
    "yi-34b": "yi_34b",
    "olmo-1b": "olmo_1b",
    "qwen3-0.6b": "qwen3_0_6b",
    "qwen2.5-3b": "qwen2_5_3b",
    "hymba-1.5b": "hymba_1_5b",
    "mixtral-8x22b": "mixtral_8x22b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "qwen2-vl-2b": "qwen2_vl_2b",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "musicgen-large": "musicgen_large",
}


# dynamically-registered configs (examples / tests): name -> (full, smoke)
_DYNAMIC: dict = {}


def register(name: str, full_cfg, smoke_cfg=None):
    """Register an ad-hoc config under a registry id (examples/tests)."""
    _DYNAMIC[name] = (full_cfg, smoke_cfg if smoke_cfg is not None else full_cfg)


def _module(name: str):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    return importlib.import_module(f"repro_torch.configs.{mod_name}")


def get(name: str, smoke: bool = False, **overrides):
    if name in _DYNAMIC:
        cfg = _DYNAMIC[name][1 if smoke else 0]
    else:
        mod = _module(name)
        cfg = mod.smoke() if smoke else mod.full()
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    return cfg


def assigned_archs():
    """The ten assigned architecture ids (assignment spelling)."""
    return list(ALIASES.keys())
