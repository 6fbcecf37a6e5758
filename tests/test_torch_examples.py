"""The port's examples (``examples/torch_*.py``) run in-process through
their ``main(argv)`` on the CPU (``--device cpu``) at their smallest
size, each reaching its own assertions: the quickstart whole, the
training driver for 3 steps and again to resume, the serving scenario's
two invariants, and the activation ablation (every scheme; and the
per-layer autotuner at 1 step, the fewest at which the reference's own
example passes its assertion). Without a GPU the default device raises:
no example carries on on the CPU unasked."""
import importlib.util
import math
import pathlib

import pytest

torch = pytest.importorskip("torch")

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_train_lm", "torch_serve_spline_lm",
         "torch_activation_ablation")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op thread for these small models: the suite runs several
    workers on the host's cores, and a torch pool of one thread a core in
    each slows this file ~70x (six concurrent runs of the examples' file:
    433 s each, against 6 s with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def examples():
    return {n: _load(n) for n in NAMES}


def test_quickstart(examples, capsys):
    examples["torch_quickstart"].main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "plain version" in out and "(kernel launches: 0)" in out
    assert out.rstrip().endswith("quickstart OK")


def test_train_lm_tiny_then_resume(examples, tmp_path, capsys):
    argv = ["--preset", "tiny", "--steps", "3", "--batch", "2", "--seq",
            "32", "--ckpt-dir", str(tmp_path), "--device", "cpu"]
    main = examples["torch_train_lm"].main
    first = main(argv)
    assert first["steps"] == 3 and first["skipped"] == 0
    assert math.isfinite(first["loss_first"])
    assert math.isfinite(first["loss_last_avg8"])
    capsys.readouterr()
    again = main(argv)
    out = capsys.readouterr().out
    assert "[ft] resumed from checkpoint step 3" in out
    assert again["steps"] == 3 and again["loss_first"] is None
    assert "[train_lm] OK" in out


def test_serve_spline_lm(examples, capsys):
    got = examples["torch_serve_spline_lm"].main(
        ["--slots", "2", "--requests", "3", "--gen", "6", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "prefix consistency: cache path == full forward  OK" in out
    assert len(got["tokens_cr"]) == 3
    assert all(len(t) == 6 for t in got["tokens_cr"] + got["tokens_fixed"])
    assert got["agreement"] > 0.85


def test_activation_ablation_every_scheme(examples, capsys):
    got = examples["torch_activation_ablation"].main(
        ["--method", "all", "--steps", "3", "--batch", "2", "--seq", "32",
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert {"exact", "cr (paper)", "cr_fixed (Q2.13)", "pwl-32",
            "poly (approximant)", "rational (approximant)"} <= set(
                got["final"])
    assert all(g < 0.05 for g in got["gaps"].values())
    assert "rational" in out and "CR engines match exact training" in out


def test_activation_ablation_per_layer(examples, capsys):
    res = examples["torch_activation_ablation"].main(
        ["--per-layer", "--steps", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    assert len(res.assignment) == 2
    assert res.loss <= res.base_loss and res.gates < res.base_gates
    assert "beats the uniform baseline; OK" in out


@pytest.mark.parametrize("name", NAMES)
def test_default_device_raises_without_cuda(examples, name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    argv = {"torch_train_lm": ["--preset", "tiny", "--steps", "1"],
            "torch_activation_ablation": ["--steps", "1"]}.get(name, [])
    with pytest.raises((RuntimeError, AssertionError)):
        examples[name].main(argv)
