"""Quickstart of the PyTorch/CUDA port: the paper's technique in five minutes.

    PYTHONPATH=src python examples/torch_quickstart.py               # on the GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu

The same walk as ``examples/quickstart.py``, on ``repro_torch``:

1. Build the paper's Catmull-Rom tanh engine and compare it to exact tanh
   and the PWL baseline (paper Tables I/II, one row).
2. Run the bit-accurate Q2.13 hardware datapath (paper Fig. 3).
3. Drop the engine into a transformer block: one forward+backward step of
   a small LLaMA-family model where EVERY nonlinearity (SwiGLU's SiLU)
   runs through the spline unit.
4. Call the hand-written CUDA kernel (``elementwise_2d`` behind
   ``ops.cr_act``) and check it against its plain version
   (``kernels/ref.py``). On the CPU the same call runs the plain route,
   and the walk says so.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core import catmull_rom as cr
from repro_torch.core.activations import ActivationConfig, ActivationEngine
from repro_torch.core.fixed_point import Q2_13, dequantize, quantize
from repro_torch.data import DataConfig, SyntheticPipeline
from repro_torch.kernels import epilogue as epi
from repro_torch.kernels import ops, ref
from repro_torch.launch import steps as steps_mod
from repro_torch.models import model as M
from repro_torch.optim import adamw


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    # -- 1. the spline engine vs exact tanh ------------------------------
    print("=" * 70)
    print("1. Catmull-Rom spline tanh (paper flagship: depth 32, range ±4)")
    x = torch.linspace(-5, 5, 11, device=dev)
    eng_cr = ActivationEngine(ActivationConfig(impl="cr", depth=32))
    eng_pwl = ActivationEngine(ActivationConfig(impl="pwl", depth=32))
    exact = np.tanh(x.cpu().numpy())
    print(f"{'x':>8} {'exact':>10} {'CR':>10} {'PWL':>10}")
    for xi, e, c, pw in zip(x.tolist(), exact, eng_cr.tanh(x).tolist(),
                            eng_pwl.tanh(x).tolist()):
        print(f"{xi:8.2f} {e:10.6f} {c:10.6f} {pw:10.6f}")
    grid = torch.linspace(-4, 4, 100001, device=dev)
    err_cr = float(torch.max(torch.abs(eng_cr.tanh(grid) - torch.tanh(grid))))
    err_pwl = float(torch.max(torch.abs(eng_pwl.tanh(grid)
                                        - torch.tanh(grid))))
    print(f"max |err| on (-4,4): CR {err_cr:.2e}  PWL {err_pwl:.2e}  "
          f"(paper: 1.52e-4 vs 1.58e-3)")
    assert err_cr < err_pwl, "CR spline must beat PWL at the same depth"

    # -- 2. bit-accurate Q2.13 datapath ----------------------------------
    print("\n" + "=" * 70)
    print("2. Bit-accurate Q2.13 datapath (paper Fig. 3: 16-bit in/out)")
    ftab = cr.build_fixed_table(np.tanh, 4.0, 32)
    xs_f = [-2.0, -0.5, 0.3, 1.7, 3.9]
    xq = quantize(torch.tensor(xs_f, device=dev), Q2_13)
    yq = cr.interpolate_fixed(ftab, xq)
    print("x (Q2.13 ints):  ", xq.cpu().numpy())
    print("tanh (Q2.13 ints):", yq.cpu().numpy())
    print("dequantized:      ", dequantize(yq, Q2_13).cpu().numpy())
    print("exact:            ", np.tanh(xs_f).round(6))

    # -- 3. the engine inside a real model -------------------------------
    print("\n" + "=" * 70)
    print("3. One train step of a small LLaMA-family model, all "
          "nonlinearities through the CR engine")
    cfg = registry.get("qwen3-0.6b", smoke=True)   # cr-d32 engine by default
    params = M.materialize_params(cfg, seed=0, device=dev)
    opt_state = adamw.init_state(params)
    pipe = SyntheticPipeline(cfg, DataConfig(seed=1,
                                             vocab_size=cfg.vocab_size),
                             global_batch=4, seq_len=32, device=dev)
    step = steps_mod.make_train_step(cfg, steps_mod.TrainHyper(remat="none"))
    params, opt_state, metrics = step(params, opt_state, pipe(0), 0)
    loss, gnorm = float(metrics["loss"]), float(metrics["gnorm"])
    print(f"arch={cfg.name} activation={cfg.activation.tag()} "
          f"loss={loss:.4f} gnorm={gnorm:.3f}")
    assert np.isfinite(loss) and np.isfinite(gnorm), (loss, gnorm)

    # -- 4. the CUDA kernel ----------------------------------------------
    print("\n" + "=" * 70)
    route = ("hand-written CUDA kernel elementwise_2d" if dev.type == "cuda"
             else "its plain version: a CPU tensor never reaches the kernel")
    print(f"4. ops.cr_act on {dev.type}: {route}; vs kernels/ref.py")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    xs = torch.randn((64, 256), generator=gen, device=dev) * 2
    n0 = epi.LAUNCHES["elementwise_2d"]
    y_kernel = ops.cr_act(xs, lookup="onehot")
    launched = epi.LAUNCHES["elementwise_2d"] - n0
    y_oracle = ref.cr_act_ref(xs, cr.build_table(np.tanh, 4.0, 32))
    err = float(torch.max(torch.abs(y_kernel - y_oracle)))
    print(f"max |kernel - oracle| = {err:.2e}  (kernel launches: {launched})")
    assert launched == (1 if dev.type == "cuda" else 0), launched
    assert err < 1e-5, err
    print("\nquickstart OK")


if __name__ == "__main__":
    main()
