"""Checkpointing: tree <-> flat npz, atomic, keep-last-k (counterpart of
``repro/checkpoint/store.py``, with the same layout, so either package
restores what the other wrote).

Layout (one directory per step):

    <dir>/step_00000042/
        arrays.npz        # flat {key path -> ndarray}
        meta.json         # step, array count and bytes, extra metadata
        _COMMITTED        # sentinel written LAST (atomic-rename barrier)

  * **Atomicity**: everything is written into `step_X.tmp-<random>` and
    then `os.rename`d; a crash mid-write leaves no half-valid checkpoint,
    and `latest_step` only ever sees directories with the `_COMMITTED`
    file.
  * **Device-agnostic**: arrays are saved from host memory, and `restore`
    places each one on its template leaf's device, in its dtype.
  * **Self-describing**: key paths are dict keys and sequence indices
    joined by "/" (the reference's ``_path_str``), so a checkpoint can be
    read with numpy alone. bf16 leaves are stored as f32 (npz has no
    bf16; the round trip is exact) and cast back on restore.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

_SENTINEL = "_COMMITTED"
_STEP_RE = re.compile(r"^step_(\d{8})$")


# ---------------------------------------------------------------------------
# tree <-> flat dict
# ---------------------------------------------------------------------------

def _items(tree, prefix=()):
    """(path, leaf) pairs of nested dicts / lists / tuples, dict keys in
    sorted order (the order the reference flattens in)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _items(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _items(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach().cpu()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.to(torch.float32)          # exact; restore casts back
        return leaf.numpy()
    return np.asarray(leaf)


def flatten_tree(tree) -> dict[str, np.ndarray]:
    flat = {}
    for key, leaf in _items(tree):
        assert key not in flat, f"duplicate key {key}"
        flat[key] = _to_numpy(leaf)
    return flat


def _rebuild(template, leaf_fn, prefix=()):
    if isinstance(template, dict):
        return {k: _rebuild(v, leaf_fn, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaf_fn, prefix + (str(i),))
                              for i, v in enumerate(template))
    return leaf_fn("/".join(prefix), template)


def unflatten_like(template, flat: dict[str, np.ndarray]):
    """Rebuild a tree shaped like `template` from the flat dict (numpy
    leaves)."""
    def leaf(key, tmpl):
        if key not in flat:
            raise KeyError(f"checkpoint missing array for {key}")
        arr = flat[key]
        want = tuple(getattr(tmpl, "shape", arr.shape))
        if tuple(arr.shape) != want:
            raise ValueError(
                f"checkpoint shape mismatch at {key}: saved {arr.shape}, "
                f"model wants {want}")
        return arr
    return _rebuild(template, leaf)


def _put(arr: np.ndarray, tmpl) -> torch.Tensor:
    """A stored array as a tensor in the template leaf's dtype, on its
    device."""
    t = torch.as_tensor(arr)
    if isinstance(tmpl, torch.Tensor):
        return t.to(device=tmpl.device, dtype=tmpl.dtype)
    return t


# ---------------------------------------------------------------------------
# store
# ---------------------------------------------------------------------------

class CheckpointStore:
    def __init__(self, directory: str | os.PathLike, keep_last: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last

    # -- write ---------------------------------------------------------
    def save(self, step: int, tree, metadata: dict | None = None) -> Path:
        final = self.dir / f"step_{step:08d}"
        tmp = Path(tempfile.mkdtemp(prefix=final.name + ".tmp-",
                                    dir=self.dir))
        try:
            flat = flatten_tree(tree)
            np.savez(tmp / "arrays.npz", **flat)
            meta = {"step": int(step), "time": time.time(),
                    "n_arrays": len(flat),
                    "bytes": int(sum(a.nbytes for a in flat.values()))}
            if metadata:
                meta["extra"] = metadata
            (tmp / "meta.json").write_text(json.dumps(meta, indent=1))
            (tmp / _SENTINEL).write_text("ok")
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        except BaseException:
            shutil.rmtree(tmp, ignore_errors=True)
            raise
        self._gc()
        return final

    # -- read ----------------------------------------------------------
    def steps(self) -> list[int]:
        out = []
        for p in self.dir.iterdir():
            m = _STEP_RE.match(p.name)
            if m and (p / _SENTINEL).exists():
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def load_flat(self, step: int) -> tuple[dict[str, np.ndarray], dict]:
        d = self.dir / f"step_{step:08d}"
        if not (d / _SENTINEL).exists():
            raise FileNotFoundError(f"no committed checkpoint at step {step}")
        with np.load(d / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        meta = json.loads((d / "meta.json").read_text())
        return flat, meta

    def restore(self, step: int, template, cut=None):
        """Rebuild a `template`-shaped tree of tensors, each leaf in its
        template leaf's dtype and on its device (the stored arrays are
        device-agnostic). With ``cut`` the template gives the whole
        shapes (meta tensors will do) and ``cut`` maps the tree of stored
        arrays to the tree to return (a rank's blocks of a sharded
        state: ``launch/steps.py::ShardedState.local``)."""
        flat, meta = self.load_flat(step)
        arrays = dict(_items(unflatten_like(template, flat)))
        if cut is not None:
            return cut(_rebuild(template, lambda key, _: arrays[key])), meta
        return _rebuild(template,
                        lambda key, tmpl: _put(arrays[key], tmpl)), meta

    def restore_latest(self, template, cut=None):
        step = self.latest_step()
        if step is None:
            return None
        tree, meta = self.restore(step, template, cut)
        return step, tree, meta

    # -- gc --------------------------------------------------------------
    def _gc(self):
        steps = self.steps()
        for s in steps[: max(0, len(steps) - self.keep_last)]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)
        # sweep stale tmp dirs from crashed writers
        for p in self.dir.glob("step_*.tmp-*"):
            shutil.rmtree(p, ignore_errors=True)
