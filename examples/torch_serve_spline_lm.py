"""Continuous-batching serving scenario of the PyTorch/CUDA port with the
CR activation unit.

    PYTHONPATH=src python examples/torch_serve_spline_lm.py --slots 2 --gen 24
    PYTHONPATH=src python examples/torch_serve_spline_lm.py --device cpu

The twin of ``examples/serve_spline_lm.py``: serves a small qwen3-family
model (CR-spline SwiGLU) through the port's continuous-batching
ServeEngine. Variable-length synthetic prompts are queued, admitted into
a 2-slot decode batch via bucketed ragged prefill, and decoded in
chunks. Two serving invariants are checked on-line:

  * prefix consistency: the first token decoded from the prefilled cache
    equals the argmax of a full no-cache forward pass at each prompt's
    last (real) position, for every request, at every prompt length;
  * activation-engine equivalence: serving with the bit-accurate Q2.13
    engine (cr_fixed) tracks the float CR engine's outputs (the two
    datapaths agree to ~1 output LSB, so greedy tokens rarely diverge;
    the agreement rate over the generated streams is reported).
"""
import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.core.activations import ActivationConfig, ActivationEngine
from repro_torch.models import model as M
from repro_torch.optim.adamw import tree_map
from repro_torch.serve import EngineConfig, ServeEngine


def serve_all(cfg, params, prompts, gen, slots, device):
    eng = ServeEngine(cfg, params, EngineConfig(
        slots=slots, max_prompt_len=64, max_len=64 + gen, chunk=4),
        device=device)
    for p in prompts:
        eng.submit(p, max_new=gen)
    done = eng.run()
    return [c.tokens for c in done], eng.stats


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--requests", type=int, default=5)
    p.add_argument("--slots", type=int, default=2)
    p.add_argument("--gen", type=int, default=24)
    p.add_argument("--device", default="cuda",
                   help="torch device (cuda, or cpu)")
    args = p.parse_args(argv)
    dev = torch.device(args.device)

    cfg = registry.get("qwen3-0.6b", smoke=True)           # cr-d32 engine
    # drawn on the host and moved: torch's CUDA generator draws other
    # numbers from the same seed, and this way every device serves one
    # model. (Invariant 2 depends on the draw: on random weights a greedy
    # stream that flips one near-tied token diverges from there on.)
    params = tree_map(lambda t: t.to(dev),
                      M.materialize_params(cfg, seed=0, device="cpu"))
    rng = np.random.RandomState(4)
    lens = rng.randint(8, 48, size=args.requests)
    prompts = [rng.randint(0, cfg.vocab_size, (n,)).astype(np.int32)
               for n in lens]

    # -- serve with the float CR engine ---------------------------------
    toks_cr, stats = serve_all(cfg, params, prompts, args.gen, args.slots,
                               dev)
    print(f"[serve] CR engine: {args.requests} reqs (len {lens.min()}.."
          f"{lens.max()}) through {args.slots} slots: prefill "
          f"{stats.prefill_tokens_per_s:,.0f} tok/s, decode "
          f"{stats.decode_tokens_per_s:,.1f} tok/s "
          f"({stats.decode_chunks} chunks)")

    # -- invariant 1: prefill+decode == full forward ---------------------
    engine = ActivationEngine(cfg.activation)
    with torch.no_grad():
        for prompt, toks in zip(prompts, toks_cr):
            full = M.forward_fn(params, {"tokens": torch.as_tensor(
                prompt[None, :], device=dev)}, cfg, engine)
            t_full = int(torch.argmax(full[0, -1]))
            assert t_full == toks[0], \
                "first decoded token != full-forward argmax"
    print("[serve] prefix consistency: cache path == full forward  OK")

    # -- invariant 2: fixed-point engine tracks float engine -------------
    cfg_fx = dataclasses.replace(
        cfg, activation=ActivationConfig(impl="cr_fixed", depth=32))
    toks_fx, _ = serve_all(cfg_fx, params, prompts, args.gen, args.slots,
                           dev)
    agree = float(np.mean(np.asarray(toks_cr) == np.asarray(toks_fx)))
    print(f"[serve] greedy-token agreement CR vs Q2.13 fixed: {agree:.1%}")
    assert agree > 0.85, "fixed-point engine diverged from float CR"
    print("[serve] OK")
    return dict(tokens_cr=toks_cr, tokens_fixed=toks_fx, agreement=agree)


if __name__ == "__main__":
    main()
