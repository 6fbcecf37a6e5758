"""Build and load the hand-written CUDA kernels of ``repro_torch/csrc``.

At first use, ``nvcc`` compiles every ``csrc/*.cu`` source into an object,
one process per unit (``epilogue.cu`` is GLU_PARTS units, one per
epilogue), all started together, and links the objects into
one shared library with a plain C interface, cached under
``build/repro_torch/`` in the repository checkout and keyed by a hash of
the sources (headers included) and flags, so an edited kernel is rebuilt
and an unchanged one is loaded as it is. The
library is loaded with ``ctypes``: every pointer and the stream are
``c_void_p``, every int is ``c_int``, every float ``c_float``, and each
entry point returns ``cudaGetLastError()`` as an int.

Nothing here runs at import time: a CPU-only process never builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
# sm_90a: wgmma exists only for that target. No -lcuda: the one driver
# function the kernels need (cuTensorMapEncodeTiled) comes through the
# runtime's cudaGetDriverEntryPoint.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

# epilogue.cu compiles as one unit per epilogue (-DREPRO_GLU_PART=e: the
# kernels of approximant.cuh's epilogue e; unit 0 also holds the entry
# points): its kernels are instantiated per epilogue, so each unit takes
# about a fifth of the whole file's time. A build with ``extra`` flags (the
# phase stamps, whose buffer is one unit's own) compiles it whole.
GLU_PARTS = 5

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argtypes (see csrc/elementwise.cu, csrc/epilogue.cu)
SIGNATURES = {
    # x, params, y, rows, cols, scheme, p_rows, p_cols, epi, dtype,
    # inv_period, x_max, saturation, blocks, threads, elems_per_thread,
    # stream
    "repro_elementwise_2d": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _F, _F, _F, _I, _I, _I, _P),
    # x, w_gate, w_up, params, out, M, N, K, scheme, p_rows, p_cols, epi,
    # dtype, inv_period, x_max, saturation, variant, split, stream
    "repro_glu_2d": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                     _F, _F, _F, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def units(extra: tuple[str, ...] = ()) -> list[tuple[Path, tuple[str, ...]]]:
    """(source, its own nvcc flags) of every compilation unit."""
    out = []
    for cu in (s for s in sources() if s.suffix == ".cu"):
        if cu.name == "epilogue.cu" and not extra:
            out += [(cu, (f"-DREPRO_GLU_PART={e}",)) for e in range(GLU_PARTS)]
        else:
            out.append((cu, ()))
    return out


def _key(extra: tuple[str, ...]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def build(extra: tuple[str, ...] = ()) -> Path:
    """Compile the sources (with ``extra`` nvcc flags, e.g. a ``-D`` of a
    diagnostic build) if this exact set has no library yet; returns the
    library's path. Each unit (``units``) compiles in its own ``nvcc``
    process, all at once; the link waits for every one of them."""
    out = BUILD_DIR / f"libepilogue_{_key(extra)}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    todo = units(extra)
    objs = [BUILD_DIR / f"{stem}.{cu.stem}.{i}.o"
            for i, (cu, _) in enumerate(todo)]
    procs = [subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, *extra, *own, "-c", "-o", str(obj), str(cu)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for (cu, own), obj in zip(todo, objs)]
    # communicate() waits for its process, so every nvcc has ended below
    logs = [(" ".join((cu.name, *own)), *proc.communicate(), proc.returncode)
            for (cu, own), proc in zip(todo, procs)]
    try:
        failed = [f"{name} ({rc}):\n{so}\n{se}"
                  for name, so, se, rc in logs if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-shared", "-o",
                               str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out


@functools.lru_cache(maxsize=None)
def library(extra: tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded kernel library (built on first call); ``extra`` nvcc
    flags give a separate library."""
    lib = ctypes.CDLL(str(build(extra)))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib
