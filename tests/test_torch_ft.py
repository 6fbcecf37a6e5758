"""The port's fault-tolerant training driver and launcher, on the CPU.

The cases of ``tests/test_ft.py`` on a synthetic scalar 'model'
(preemption and resume, NaN skip, rollback, straggler watchdog,
checkpoint cadence), and the counterparts of ``tests/test_system.py``'s
training tests on ``qwen3-0.6b`` smoke (the port has no ``olmo-1b``
yet): resume after a simulated preemption gives bit-identical losses
(torch on the CPU is deterministic), the in-step NaN guard, and the
learning threshold with the reference's hyperparameters (drop >= 0.3
nats over 100 steps; the reference drops 0.539 on qwen3-0.6b smoke, the
port 0.496 on its own weights and data). Then the training launcher: a
3-step CPU run prints its summary, and the flags of unported parts fail
with their ROADMAP item.
"""
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.ft import FTConfig, SimulatedPreemption, TrainDriver  # noqa: E402
from repro_torch.launch import steps as steps_mod  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class FakePipeline:
    """batch(step) = the step index (deterministic, trivially resumable)."""

    def __call__(self, step):
        return torch.tensor(float(step))

    def state(self, step):
        return {"step": int(step)}


def make_step(poison_steps=(), slow_steps=(), sleep_s=0.05):
    """params' = params + batch; loss = params. Poisoned steps report a
    non-finite loss and gradient norm and keep the params."""

    def step_fn(params, opt_state, batch, step):
        assert isinstance(step, int)       # the driver passes a host int
        if step in slow_steps:
            time.sleep(sleep_s)
        bad = step in poison_steps
        nan = torch.tensor(float("nan"))
        return (params if bad else params + batch, opt_state,
                {"loss": nan if bad else params,
                 "gnorm": nan if bad else torch.tensor(1.0),
                 "skipped": torch.tensor(int(bad), dtype=torch.int32)})

    return step_fn


def drv(tmp_path, step_fn, **ft_kw):
    ft = FTConfig(ckpt_dir=str(tmp_path), log_every=0, **ft_kw)
    return TrainDriver(step_fn, FakePipeline(), torch.tensor(0.0), {}, ft,
                       log=lambda *_: None)


def test_preemption_and_resume_identical(tmp_path):
    ref = drv(tmp_path / "a", make_step(), ckpt_every=4)
    ref.run(10)
    d1 = drv(tmp_path / "b", make_step(), ckpt_every=4)
    with pytest.raises(SimulatedPreemption):
        d1.run(10, preempt_at={6})
    d2 = TrainDriver.resume(make_step(), FakePipeline(), torch.tensor(0.0),
                            {}, FTConfig(ckpt_dir=str(tmp_path / "b"),
                                         log_every=0, ckpt_every=4),
                            log=lambda *_: None)
    assert d2.step == 6
    d2.run(4)
    assert float(d2.params) == float(ref.params)


def test_nan_step_skipped_params_protected(tmp_path):
    d = drv(tmp_path, make_step(poison_steps={3}), ckpt_every=100)
    d.run(6)
    assert float(d.params) == sum((0, 1, 2, 4, 5))
    assert sum(r.skipped for r in d.history) == 1


def test_consecutive_nans_trigger_rollback(tmp_path):
    d = drv(tmp_path, make_step(poison_steps={4, 5, 6, 7, 8}),
            ckpt_every=2, rollback_after=3, max_rollbacks=1)
    d.run(7)
    assert sum(r.rolled_back for r in d.history) == 1
    assert float(d.params) == sum((0, 1, 2, 3))


def test_straggler_detected(tmp_path):
    seen = []
    ft = FTConfig(ckpt_dir=str(tmp_path), log_every=0,
                  straggler_factor=5.0, ckpt_every=100)
    d = TrainDriver(make_step(slow_steps={12}, sleep_s=0.25), FakePipeline(),
                    torch.tensor(0.0), {}, ft, log=lambda *_: None,
                    on_straggler=seen.append)
    d.run(14)
    assert [r.step for r in seen] == [12]


def test_checkpoint_cadence(tmp_path):
    d = drv(tmp_path, make_step(), ckpt_every=5)
    d.run(12)
    assert d.store.steps() == [5, 10]


# ---------------------------------------------------------------------------
# the real model (qwen3-0.6b smoke, CPU)
# ---------------------------------------------------------------------------

def build(*, hyper=None, batch=8, seq=32):
    cfg = registry.get("qwen3-0.6b", smoke=True)
    params = M.materialize_params(cfg, seed=0, device="cpu")
    hyper = hyper or steps_mod.TrainHyper(
        remat="none", opt=adamw.AdamWConfig(lr_peak=2e-2, warmup_steps=5,
                                            decay_steps=200))
    pipe = SyntheticPipeline(cfg, DataConfig(seed=1,
                                             vocab_size=cfg.vocab_size),
                             batch, seq, device="cpu")
    return cfg, params, adamw.init_state(params), pipe, \
        steps_mod.make_train_step(cfg, hyper)


def test_training_learns():
    """The reference's threshold and hyperparameters
    (``test_system.py::test_training_learns``): the loss falls >= 0.3
    nats below its start within 100 steps."""
    hyper = steps_mod.TrainHyper(
        remat="none", opt=adamw.AdamWConfig(lr_peak=2e-2, warmup_steps=5,
                                            decay_steps=100))
    _, params, opt, pipe, step = build(hyper=hyper)
    losses = []
    for i in range(100):
        params, opt, m = step(params, opt, pipe(i), i)
        losses.append(float(m["loss"]))
    losses = np.asarray(losses)
    assert losses[-8:].mean() < losses[:4].mean() - 0.3, losses[::8]


def test_model_level_resume_bit_identical(tmp_path):
    hyper = steps_mod.TrainHyper(remat="none")
    cfg, params, opt, pipe, step = build(hyper=hyper, batch=4, seq=16)
    ref = TrainDriver(step, pipe, params, opt,
                      FTConfig(ckpt_dir=str(tmp_path / "a"), ckpt_every=4,
                               log_every=0), log=lambda *_: None)
    ref.run(10)

    ft2 = FTConfig(ckpt_dir=str(tmp_path / "b"), ckpt_every=4, log_every=0)
    d1 = TrainDriver(step, pipe, params, opt, ft2, log=lambda *_: None)
    with pytest.raises(SimulatedPreemption):
        d1.run(10, preempt_at={6})
    # fresh process stand-in: zero templates, restore from disk
    zp = adamw.tree_map(torch.zeros_like,
                        M.materialize_params(cfg, seed=0, device="cpu"))
    d2 = TrainDriver.resume(step, pipe, zp, adamw.init_state(zp), ft2,
                            log=lambda *_: None)
    assert d2.step == 6
    d2.run(4)
    resumed = np.concatenate([d1.losses(), d2.losses()])
    np.testing.assert_array_equal(ref.losses(), resumed)


def test_nan_guard_in_real_step():
    """Poisoned params (an inf embedding) trip the guard inside the step:
    the returned params are the inputs, and the skip is reported."""
    _, params, opt, pipe, step = build()
    poisoned = dict(params, embed=torch.full_like(params["embed"],
                                                  float("inf")))
    new_params, new_opt, m = step(poisoned, opt, pipe(0), 0)
    assert int(m["skipped"]) == 1
    assert not np.isfinite(float(m["loss"]))
    assert torch.equal(new_params["embed"], poisoned["embed"])
    assert torch.equal(new_params["lm_head"], params["lm_head"])
    assert int(new_opt["count"]) == 0


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_launcher_runs_on_cpu_and_prints_summary(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--steps", "3", "--ckpt-dir",
         str(tmp_path / "ck"), "--metrics-out", str(tmp_path / "m.json")],
        capture_output=True, text=True, timeout=300, cwd=ROOT,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
             "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "[train] done:" in proc.stdout
    summary = json.loads((tmp_path / "m.json").read_text())
    assert summary["arch"] == "olmo-1b-smoke" and summary["steps"] == 3
    assert summary["skipped"] == 0 and np.isfinite(summary["loss_first"])
    assert set(summary) == {"arch", "activation", "steps", "loss_first",
                            "loss_last_avg8", "wall_s", "tokens_per_s",
                            "stragglers", "skipped"}
    # re-running resumes from the committed checkpoint at step 3
    again = train_mod.main(["--smoke", "--device", "cpu", "--steps", "4",
                            "--ckpt-dir", str(tmp_path / "ck"),
                            "--log-every", "0"])
    assert again["steps"] == 4


@pytest.mark.parametrize("argv,item", [
    (["--data-parallel", "2"], "item 12"),
    (["--model-parallel", "2"], "item 12"),
    (["--arch", "qwen2-vl-2b"], None),
    (["--arch", "falcon-mamba-7b"], None)])
def test_launcher_unported_flags_name_their_item(tmp_path, argv, item,
                                                 monkeypatch):
    """The flags of ROADMAP item 12 (sharded training, ported with its
    part 12b) start a rank a device of the (data, model) mesh, over gloo
    on the CPU, and refuse nccl there (tests/test_torch_train_sharded.py
    trains through them); the families that once raised (M-RoPE with
    patch embeddings, Mamba) now train a step."""
    run = lambda *extra: train_mod.main(
        ["--smoke", "--device", "cpu", "--steps", "1", "--batch", "2",
         "--seq", "16", "--ckpt-dir", str(tmp_path), "--log-every", "0"]
        + argv + list(extra))
    if item is not None:
        seen = {}

        def spawn(fn, world, *, backend, device, args=()):
            seen.update(fn=fn, world=world, backend=backend, device=device)
            return [{"steps": 1}]

        monkeypatch.setattr(train_mod.mesh_mod, "spawn_ranks", spawn)
        assert run() == {"steps": 1}
        assert seen == {"fn": train_mod.train_rank, "world": 2,
                        "backend": "gloo", "device": "cpu"}
        with pytest.raises(SystemExit, match="nccl backend needs CUDA"):
            run("--dist-backend", "nccl")
        return
    summary = run()
    assert summary["arch"] == argv[1] + "-smoke" and summary["steps"] == 1
    assert summary["skipped"] == 0 and np.isfinite(summary["loss_first"])


def test_launcher_trains_through_the_fixed_datapath(tmp_path):
    """``--activation cr_fixed`` trains (quantization-aware) and resumes
    from its checkpoint under the same tag."""
    run = lambda steps: train_mod.main(
        ["--smoke", "--device", "cpu", "--steps", str(steps), "--activation",
         "cr_fixed", "--ckpt-dir", str(tmp_path), "--log-every", "0"])
    first = run(2)
    assert first["activation"] == "cr_fixed-d32" and first["skipped"] == 0
    assert np.isfinite(first["loss_first"])
    assert run(3)["steps"] == 3
