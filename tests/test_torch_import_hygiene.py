"""The PyTorch port stands alone: it imports neither jax nor anything of
the JAX reference package, and its entry points never fall back to the
CPU when asked for the GPU."""
import ast
import pathlib
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _port_modules():
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT / "src").with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax_and_no_reference():
    mods = list(_port_modules())
    assert len(mods) > 20, mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py"))
                         + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_source_never_imports_jax_or_reference(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, name)
    text = path.read_text()
    assert "import jax" not in text and "from repro." not in text


def test_engine_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.serve import ServeEngine
    cfg = registry.get("qwen3-0.6b", smoke=True)
    params = M.materialize_params(cfg, seed=0, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServeEngine(cfg, params)


def test_materialize_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    with pytest.raises(RuntimeError):
        M.materialize_params(registry.get("qwen3-0.6b", smoke=True))


@pytest.mark.parametrize("entry", ["tanh_error", "table_1_2",
                                   "generic_error"])
def test_error_analysis_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    import numpy as np

    from repro_torch.core import error_analysis as ea
    call = {"tanh_error": lambda: ea.tanh_error("cr", 32, datapath="fixed"),
            "table_1_2": lambda: ea.table_1_2("qout"),
            "generic_error": lambda: ea.generic_error(
                torch.tanh, np.tanh, -1.0, 1.0, n=11)}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# names of the reference's repro.core.__all__ the port does not export
# yet: none (the last, the fixed-point datapaths and the error analysis,
# were ported with ROADMAP.md, Queue A item 2)
CORE_KNOWN_GAPS: set[str] = set()


def _reference_all(path: pathlib.Path) -> list[str]:
    """``__all__`` of a reference module, read from its source (importing
    it would import jax)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no __all__ in {path}")


def test_core_exports_the_reference_names_that_are_ported():
    import repro_torch.core as core
    ref = set(_reference_all(ROOT / "src" / "repro" / "core" / "__init__.py"))
    assert CORE_KNOWN_GAPS <= ref
    assert set(core.__all__) == ref - CORE_KNOWN_GAPS
    for name in core.__all__:
        assert getattr(core, name) is not None, name
    for name in CORE_KNOWN_GAPS:       # a gap closed: move it to __all__
        assert not hasattr(core, name), name
    from repro_torch.core import ActivationEngine, get_engine
    eng = get_engine({"impl": "cr", "depth": 16})
    assert isinstance(eng, ActivationEngine) and eng.cfg.depth == 16
    assert get_engine().cfg.impl == "exact"
