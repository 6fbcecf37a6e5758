"""Faults planted in the program underneath a run, to show that its check
catches them: the CPU tests plant them at the smoke sizes, and
``calibrate.py --fault`` reads them on the chip at a cell's own size.

A training fault wraps the program's step builder (a run's ``program``
argument for a training cell); a serving fault rewires a built engine's
decode chunks (the ``program`` argument for a serving cell)."""
from __future__ import annotations


def state_unchanged(cfg, hyper):
    """A train step that returns its params and optimizer state unchanged."""
    from repro_torch.launch import steps
    real = steps.make_train_step(cfg, hyper)

    def step(params, opt, batch, i):
        _, _, metrics = real(params, opt, batch, i)
        return params, opt, metrics
    return step


def half_batch(cfg, hyper):
    """A train step that leaves out half of the batch's rows (the mean taken
    over the rest)."""
    from repro_torch.launch import steps
    real = steps.make_train_step(cfg, hyper)

    def step(params, opt, batch, i):
        half = next(iter(batch.values())).shape[0] // 2
        return real(params, opt, {k: v[:half] for k, v in batch.items()}, i)
    return step


def token_altered(eng):
    """Every served decode token altered where it is produced."""
    orig = eng._decode_at

    def decode_at(n):
        fn = orig(n)

        def chunk(*a):
            cache, state, toks = fn(*a)
            return cache, state, (toks + 1) % eng.cfg.vocab_size
        return chunk
    eng._decode_at = decode_at


def half_rows_dropped(eng):
    """Half of the requests (the odd uids) left out of every decode batch."""
    orig = eng._decode_at

    def decode_at(n):
        fn = orig(n)

        def chunk(params, cache, state, seed, uids, *rest):
            for b, u in enumerate(uids):
                if u % 2:
                    state["active"][b] = False
            return fn(params, cache, state, seed, uids, *rest)
        return chunk
    eng._decode_at = decode_at


TRAIN = {"state_unchanged": state_unchanged, "half_batch": half_batch}
SERVE = {"token_altered": token_altered, "half_rows_dropped": half_rows_dropped}
