"""End-to-end driver of the PyTorch/CUDA port: train a ~100M-param LM with
the CR-spline activation engine, fault-tolerant loop included
(checkpoint/restart, NaN guard).

    # full run (~112M params, a few hundred steps; sized for a GPU)
    PYTHONPATH=src python examples/torch_train_lm.py --steps 300

    # CPU-quick variant for laptops/CI
    PYTHONPATH=src python examples/torch_train_lm.py --preset tiny --steps 60 \\
        --device cpu

The twin of ``examples/train_lm.py``: an olmo-style dense LLaMA-family
stack whose every nonlinearity routes through the paper's Catmull-Rom
engine (cr-d32), trained through ``repro_torch.launch.train`` on the
port's deterministic synthetic mixture. Loss falling well below
ln(vocab) demonstrates actual learning, and the run is resumable:
re-invoke the same command after an interruption and it continues from
the last committed checkpoint.
"""
import argparse
import os
import tempfile

from repro_torch.configs import registry
from repro_torch.core.activations import ActivationConfig
from repro_torch.launch import train as train_mod
from repro_torch.models.config import ModelConfig

PRESETS = {
    # ~112M params: 12L x 768d, 12 heads, SwiGLU 3072, 32k vocab
    "100m": ModelConfig(
        name="crlm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
        d_ff=3072, vocab_size=32000, mlp_act="silu", glu=True,
        activation=ActivationConfig(impl="cr", depth=32),
        q_chunk=512, kv_chunk=512),
    # ~4M params: CI-speed
    "tiny": ModelConfig(
        name="crlm-tiny", n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
        d_ff=1024, vocab_size=4096, vocab_pad_multiple=64,
        mlp_act="silu", glu=True,
        activation=ActivationConfig(impl="cr", depth=32),
        q_chunk=128, kv_chunk=128),
}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--preset", default="100m", choices=list(PRESETS))
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=512)
    p.add_argument("--activation", default=None,
                   help="exact|cr|cr_fixed|pwl (default: preset's cr)")
    p.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                      "repro_torch_train_lm"))
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    args = p.parse_args(argv)

    cfg = PRESETS[args.preset]
    if args.preset == "tiny":
        args.seq = min(args.seq, 128)
    n = cfg.param_count()
    print(f"[train_lm] {cfg.name}: {n/1e6:.1f}M params, "
          f"{args.steps} steps @ batch {args.batch} x seq {args.seq}")

    # route through the shared launcher via dynamic registration
    name = f"_example_{cfg.name}"
    registry.register(name, cfg)
    summary = train_mod.main([
        "--arch", name, "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--ckpt-dir", args.ckpt_dir, "--log-every", "10",
        "--device", args.device,
    ] + (["--activation", args.activation] if args.activation else []))
    assert summary["loss_last_avg8"] is None or \
        summary["loss_last_avg8"] < summary["loss_first"] + 0.1, \
        "loss did not improve"
    print("[train_lm] OK")
    return summary


if __name__ == "__main__":
    main()
