"""Sharded training of the port on the CPU: ``make_train_step(mesh=)``,
``train_shardings``, ``parallel/dp.py`` (FSDP over ``data``), the
blocks' collectives under autograd (``parallel/tp.py``), ``ShardedState``
checkpoints and ``launch/train.py --data-parallel / --model-parallel``.

The sharded step on a (data, model) mesh must equal the port's one-device
step and the reference's ``make_train_step`` on the reference's weights
(``repro.models.model.materialize_params``, as numpy) and the reference
pipeline's global batch, at meshes (2, 1), (1, 2), (2, 2) and (4, 1):
qwen3 smoke fused and kernelized, mixtral smoke under gshard and ragged
(experts FSDP over ``data``, the global aux) and hymba smoke (Mamba over
``dinner``, its 5 heads whole), f32 compute. One spawned group of four
gloo ranks (one thread a rank) runs every sharded case: ranks (0, 1) the
(2, 1) mesh and ranks (2, 3) the (1, 2) mesh at once, then all four the
(2, 2) and (4, 1) meshes, the options, ``build_cell``'s steps, the
checkpoints and the launcher's ranks. The references run in this process.
On (pod, data, model) meshes (2, 1, 1) and (2, 2, 1) each rank is given
its rows as the rule table splits the batch over ("pod", "data"), and the
step (qwen3 fused, mixtral gshard) must equal the one-device step: the
data mean, the gradients' sum and the norm span both batch axes.

Tolerances, ``tests/test_torch_train.py``'s: loss, nll, aux, gnorm, lr
relative 1e-5; gradients (``loss_fn`` differentiated once, at the start,
gathered whole) each leaf within 2e-5 of the largest |grad|; ``m`` and
``v`` after step 2 relative 2e-4 of the largest |value| (under
grad_compression 2/127); params absolute 0.05 x lr. Every rank's loss and
gnorm, and every block that several ranks hold, must be bitwise equal.

The rank function and its helpers import no jax (a spawned rank imports
this module); the reference is imported inside the fixtures.
"""
import dataclasses
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.configs.common import act_impl_of, fused_of  # noqa: E402
from repro_torch.data import DataConfig, SyntheticPipeline  # noqa: E402
from repro_torch.ft import FTConfig, TrainDriver  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import shapes as TSH  # noqa: E402
from repro_torch.launch import steps as TS  # noqa: E402
from repro_torch.launch import train as train_mod  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.optim import compress as TC  # noqa: E402
from repro_torch.optim.adamw import tree_map  # noqa: E402
from repro_torch.parallel import dp  # noqa: E402
from repro_torch.parallel import partition as part  # noqa: E402

LR_PEAK, WARMUP = 1e-2, 2
REL_SCALAR, REL_GRAD, REL_MOMENT, PARAM_OVER_LR = 1e-5, 2e-5, 2e-4, 0.05
REL_MOMENT_COMPRESSED = 2 / 127
# the port's one-device MoE step stands this far from the reference's
# (tests/test_torch_moe.py's limit; ragged gnorm read 1.2e-5): the MoE
# configs' loss, aux, gnorm and gradients against the reference
REL_MOE_REF = 1e-4
# the launcher trains olmo-1b smoke in bf16: the sharded run sums its
# bf16 products in another order, and the two loss trajectories part by
# ~1e-3 relative over 3 steps (read 3.4e-4 on the CPU)
LAUNCHER_REL = 3e-3
B, S = 4, 16
CONFIGS = {"qwen3_fused": ("qwen3-0.6b", "fused"),
           "qwen3_kernel": ("qwen3-0.6b", "kernel"),
           "mixtral_gshard": ("mixtral-8x22b", "gshard"),
           "mixtral_ragged": ("mixtral-8x22b", "ragged"),
           "hymba": ("hymba-1.5b", "plain")}
MESHES = ((2, 1), (1, 2), (2, 2), (4, 1))
# (pod, data, model) meshes: the batch split over ("pod", "data") as the
# rule table says, each rank given its rows of it (build_cell's args)
POD_MESHES = ((2, 1, 1), (2, 2, 1))
POD_CONFIGS = ("qwen3_fused", "mixtral_gshard")
# (config, TrainHyper fields), each run at (2, 2)
OPTIONS = {"grad_compression": ("qwen3_fused", {"grad_compression": True}),
           "microbatches": ("mixtral_gshard", {"microbatches": 2}),
           "train_act": ("qwen3_kernel", {"train_act": True})}
CKPT_CFG = "qwen3_fused"
LAUNCHER = ["--smoke", "--device", "cpu", "--steps", "3", "--batch", "4",
            "--seq", "16", "--log-every", "0"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _deploy(cfg, dep, fused, act_impl):
    if dep == "fused":
        return fused(cfg)
    if dep == "kernel":
        return act_impl(cfg, "cr_spline", use_kernel=True)
    if dep in ("gshard", "ragged"):
        return dataclasses.replace(cfg, moe_impl=dep)
    return cfg


def port_cfg(name):
    arch, dep = CONFIGS[name]
    return _deploy(TR.get(arch, smoke=True, compute_dtype="float32"), dep,
                   fused_of, act_impl_of)


def port_hyper(**kw):
    return TS.TrainHyper(opt=TA.AdamWConfig(lr_peak=LR_PEAK,
                                            warmup_steps=WARMUP), **kw)


def _np(tree):
    return tree_map(lambda t: t.detach().cpu().numpy(), tree)


def _flat(tree, prefix="", leaf=np.asarray):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}", leaf))
        return out
    return {prefix: leaf(tree)}


def _tensors(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# the one-device runs (this process and each rank)
# ---------------------------------------------------------------------------

def grads_at_start(cfg, params, batch, hyper, fsdp=None, split=True):
    """``loss_fn`` differentiated once; sharded (``fsdp``): the rank's
    rows (``batch`` is those already unless ``split``), the data mean
    taken, each leaf gathered whole (the mesh's first rank keeps them)."""
    p = tree_map(lambda t: t.detach().requires_grad_(), params)
    if fsdp is not None and fsdp.group is not None and split:
        batch = dp.local_rows(batch, fsdp.group.rank, fsdp.group.size)
    loss, _ = TM.loss_fn(p, batch, cfg, TS.make_engine(cfg),
                         remat=hyper.remat, z_loss=hyper.z_loss, fsdp=fsdp)
    leaves = TA.tree_leaves(p)
    got = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    grads = tree_map(lambda t: got[id(t)], p)
    if fsdp is None:
        return _np(grads)
    return fsdp.whole(fsdp.reduce_grads(grads), _leader(fsdp.mesh))


def _leader(mesh) -> bool:
    return all(mesh.get_local_rank(a) == 0 for a in mesh.mesh_dim_names)


def _init_opt(params, hyper):
    opt = TA.init_state(params)
    if hyper.grad_compression:
        opt["error"] = TC.init_error(params)
    return opt


def one_device(name, params_np, batch, **kw):
    """The port's one-device run: gradients at the start, then steps 1
    and 2 (metrics, params, m, v)."""
    cfg, hyper = port_cfg(name), port_hyper(**kw)
    params = TM.params_from_numpy(params_np, cfg, device="cpu")
    batch = _tensors(batch)
    out = {"grads": grads_at_start(cfg, params, batch, hyper)}
    step, opt, metrics = TS.make_train_step(cfg, hyper), \
        _init_opt(params, hyper), []
    for s in (1, 2):
        params, opt, m = step(params, opt, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
    out.update(metrics=metrics, params=_np(params), m=_np(opt["m"]),
               v=_np(opt["v"]))
    return out


# ---------------------------------------------------------------------------
# the spawned ranks
# ---------------------------------------------------------------------------

def rule_rows(batch, mesh):
    """This rank's rows of the global batch as the rule table splits its
    "batch" axis on ``mesh`` (over ("pod", "data") where there is a pod
    axis)."""
    return {k: part.make_sharding(("batch",) + (None,) * (v.dim() - 1),
                                  tuple(v.shape), mesh=mesh).shard(v)
            for k, v in batch.items()}


def sharded(inp, name, mesh, by_rules=False, **kw):
    """One sharded run on this rank (as ``one_device``): its metrics, its
    blocks' local shapes and slices, and on the mesh's first rank the
    gradients, params, m and v gathered whole. ``by_rules``: the rank is
    given its rows (``rule_rows``), not the global batch."""
    cfg, hyper = port_cfg(name), port_hyper(**kw)
    full = TM.params_from_numpy(inp["params"][name], cfg, device="cpu")
    psh, _ = TS.train_shardings(cfg, mesh, hyper=hyper)
    params = TM.shard_params(full, cfg, psh)
    fsdp = dp.FSDP(mesh, psh)
    batch = _tensors(inp["batch"][name])
    if by_rules:
        batch = rule_rows(batch, mesh)
    lead = _leader(mesh)
    with part.axis_rules(mesh):
        grads = grads_at_start(cfg, params, batch, hyper, fsdp,
                               split=not by_rules)
    step = TS.make_train_step(cfg, hyper, mesh=mesh, local_batch=by_rules)
    opt, metrics = _init_opt(params, hyper), []
    for s in (1, 2):
        params, opt, m = step(params, opt, batch, s)
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "rows": int(batch["tokens"].shape[0]),
           "shapes": {k: tree_map(lambda t: tuple(t.shape), v)
                      for k, v in (("params", params), ("m", opt["m"]),
                                   ("v", opt["v"]))},
           "blocks": _blocks(params, full, psh)}
    whole = {k: fsdp.whole(v, lead) for k, v in
             (("params", params), ("m", opt["m"]), ("v", opt["v"]))}
    if lead:
        out.update(grads=grads, **{k: _np(v) for k, v in whole.items()})
    return out


def _blocks(params, full, shardings):
    """{leaf path: (the rank's slices of the whole leaf, its block)}."""
    def one(t, f, sh):
        sl = sh.dim_slices(tuple(f.shape))
        return tuple((s.start, s.stop) for s in sl), t.detach().numpy()
    return _flat(tree_map(one, params, full, shardings), leaf=lambda t: t)


def _cell_run(inp, mesh):
    """``build_cell``'s train and decode steps on a real mesh, with inputs
    of its args' shapes: the train step on the rank's rows (its loss is
    the sharded step's), the decode step at f32 on the rank's (data,
    model) blocks of the params (its logits)."""
    cfg = port_cfg(CKPT_CFG)
    full = TM.params_from_numpy(inp["params"][CKPT_CFG], cfg, device="cpu")
    psh, _ = TS.train_shardings(cfg, mesh)
    params = TM.shard_params(full, cfg, psh)
    hyper = port_hyper()
    cell = TSH.ShapeCell("train_cell", S, B, "train")
    fn, args = TS.build_cell(cfg, cell, mesh, hyper=hyper)
    fsdp = dp.FSDP(mesh, psh)
    batch = dp.local_rows(_tensors(inp["batch"][CKPT_CFG]), fsdp.group.rank,
                          fsdp.dp)
    shapes_ok = [tree_map(lambda a, t: tuple(a.shape) == tuple(t.shape),
                          args[0], params),
                 {k: tuple(args[2][k].shape) == tuple(v.shape)
                  for k, v in batch.items()}]
    _, _, m = fn(params, _init_opt(params, hyper), batch, 1)
    dcell = TSH.ShapeCell("decode_cell", 8, B, "decode")
    dfn, dargs = TS.build_cell(cfg, dcell, mesh, serve_dtype="float32")
    cache = tree_map(lambda a: torch.zeros(a.shape, dtype=a.dtype), dargs[2])
    if "k_pos" in cache:
        cache["k_pos"].fill_(-1)
    toks = torch.as_tensor(inp["batch"][CKPT_CFG]["tokens"][:, :1])
    rows = dp.local_rows({"tokens": toks}, fsdp.group.rank, fsdp.dp)
    logits, _ = dfn(params, rows, cache)
    return {"loss": float(m["loss"]), "shapes_ok": shapes_ok,
            "decode_logits": logits.numpy(), "data_rank": fsdp.group.rank}


def _ckpt_runs(inp, mesh):
    """The checkpoint cases on this rank: resume a one-device checkpoint
    (``inp["ckpt_one"]``, step 2) on the mesh; train 2 steps from the
    weights and save at step 2 (``inp["ckpt_sharded"]``)."""
    cfg, hyper = port_cfg(CKPT_CFG), port_hyper()
    full = TM.params_from_numpy(inp["params"][CKPT_CFG], cfg, device="cpu")
    state = TS.ShardedState(cfg, mesh, hyper=hyper)
    params = TM.shard_params(full, cfg, state.shardings)
    pipe = SyntheticPipeline(cfg, DataConfig(seed=1, vocab_size=512), B, S,
                             device="cpu")
    step = TS.make_train_step(cfg, hyper, mesh=mesh)
    quiet = {"log": lambda *_: None, "sharded": state}
    zero = tree_map(torch.zeros_like, params)
    resumed = TrainDriver.resume(step, pipe, zero, _init_opt(zero, hyper),
                                 FTConfig(ckpt_dir=inp["ckpt_one"],
                                          log_every=0), **quiet)
    out = {"resumed_step": resumed.step,
           "resumed": _blocks(resumed.params, full, state.shardings),
           "resumed_m": _blocks(resumed.opt_state["m"], full,
                                state.shardings)}
    drv = TrainDriver(step, pipe, params, _init_opt(params, hyper),
                      FTConfig(ckpt_dir=inp["ckpt_sharded"], ckpt_every=2,
                               log_every=0), **quiet)
    drv.run(2)
    whole = state.fsdp.whole(drv.params, state.writer)
    if state.writer:
        out["saved_params"] = _np(whole)
    return out


def _rank(rank, world, device, path):
    """Every sharded case of this module on one of the four ranks."""
    with open(path, "rb") as f:
        inp = pickle.load(f)
    pairs = {(2, 1): LM.make_host_mesh(2, 1, device="cpu", ranks=(0, 1)),
             (1, 2): LM.make_host_mesh(1, 2, device="cpu", ranks=(2, 3))}
    wide = {shape: LM.make_host_mesh(*shape, device="cpu")
            for shape in ((2, 2), (4, 1))}
    out = {}
    mine = (2, 1) if rank < 2 else (1, 2)
    for name in CONFIGS:
        out[(name, mine)] = sharded(inp, name, pairs[mine])
    for shape, mesh in wide.items():
        for name in CONFIGS:
            out[(name, shape)] = sharded(inp, name, mesh)
    for opt, (name, kw) in OPTIONS.items():
        out[(opt, (2, 2))] = sharded(inp, name, wide[(2, 2)], **kw)
    pods = {shape: LM.make_mesh_auto(shape, ("pod", "data", "model"),
                                     device="cpu", ranks=_mesh_ranks(shape))
            for shape in POD_MESHES}
    for shape, mesh in pods.items():
        if rank in _mesh_ranks(shape):
            for name in POD_CONFIGS:
                out[(name, shape)] = sharded(inp, name, mesh, by_rules=True)
    out["cell"] = _cell_run(inp, wide[(2, 2)])
    out["ckpt"] = _ckpt_runs(inp, wide[(2, 2)])
    args = train_mod.build_parser().parse_args(
        LAUNCHER + ["--data-parallel", "2", "--model-parallel", "2",
                    "--dist-backend", "gloo", "--ckpt-dir",
                    inp["launcher_dir"]])
    out["launcher"] = train_mod.train_rank(rank, world, device, args)
    return out


# ---------------------------------------------------------------------------
# fixtures: the references, then the ranks
# ---------------------------------------------------------------------------

def _ref_cfg(name):
    from repro.configs import registry as JR
    from repro.configs.common import act_impl_of as j_act_impl_of
    from repro.configs.common import fused_of as j_fused_of
    arch, dep = CONFIGS[name]
    return _deploy(JR.get(arch, smoke=True, compute_dtype="float32"), dep,
                   j_fused_of, j_act_impl_of)


@pytest.fixture(scope="module")
def inputs():
    """Each config's reference weights (numpy) and global batch."""
    import jax

    from repro.data import DataConfig as JDataConfig
    from repro.data import SyntheticPipeline as JPipeline
    from repro.models import model as JM
    params, batch, drawn = {}, {}, {}
    for name, (arch, _) in CONFIGS.items():
        jc = _ref_cfg(name)
        # deployments of one arch and activation share one draw
        key = (arch, jc.layer_activation_configs())
        if key not in drawn:
            jp, _ = JM.materialize_params(jc, seed=0)
            drawn[key] = (jax.tree.map(np.asarray, jp),
                          jax.tree.map(np.asarray, JPipeline(
                              jc, JDataConfig(seed=1, vocab_size=512),
                              B, S)(0)))
        params[name], batch[name] = drawn[key]
    return {"params": params, "batch": batch}


def _ref_run(name, inp):
    """The reference's gradients at the start and steps 1 and 2 (one
    compiled function gives a step and the gradients at its input)."""
    import jax
    import jax.numpy as jnp

    from repro.launch import steps as JS
    from repro.models import model as JM
    from repro.optim import adamw as JA
    jc = _ref_cfg(name)
    jh = JS.TrainHyper(opt=JA.AdamWConfig(lr_peak=LR_PEAK,
                                          warmup_steps=WARMUP))
    jp = jax.tree.map(jnp.asarray, inp["params"][name])
    jb = {k: jnp.asarray(v) for k, v in inp["batch"][name].items()}
    eng, train = JS.make_engine(jc), JS.make_train_step(jc, jh)

    def grads_and_step(p, o, b, s):
        g = jax.grad(lambda q: JM.loss_fn(q, b, jc, eng, remat=jh.remat,
                                          z_loss=jh.z_loss)[0])(p)
        return g, train(p, o, b, s)

    fn, jo, metrics = jax.jit(grads_and_step), JA.init_state(jp), []
    for s in (1, 2):
        g, (jp, jo, m) = fn(jp, jo, jb, jnp.int32(s))
        grads = g if s == 1 else grads
        metrics.append({k: float(v) for k, v in m.items()})
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return {"grads": to_np(grads), "metrics": metrics, "params": to_np(jp),
            "m": to_np(jo["m"]), "v": to_np(jo["v"])}


def _refs(inputs):
    """{config: (the reference's run, the port's one-device run)}; an
    option: (None, the port's one-device run), which
    ``tests/test_torch_train_options.py`` holds against the reference."""
    out = {name: (_ref_run(name, inputs),
                  one_device(name, inputs["params"][name],
                             inputs["batch"][name]))
           for name in CONFIGS}
    out.update({opt: (None, one_device(name, inputs["params"][name],
                                       inputs["batch"][name], **kw))
                for opt, (name, kw) in OPTIONS.items()})
    return out


@pytest.fixture(scope="module")
def one_ckpt(inputs, tmp_path_factory):
    """A one-device run of CKPT_CFG saved at step 2: (directory, params)."""
    d = tmp_path_factory.mktemp("ckpt_one")
    cfg, hyper = port_cfg(CKPT_CFG), port_hyper()
    params = TM.params_from_numpy(inputs["params"][CKPT_CFG], cfg,
                                  device="cpu")
    pipe = SyntheticPipeline(cfg, DataConfig(seed=1, vocab_size=512), B, S,
                             device="cpu")
    drv = TrainDriver(TS.make_train_step(cfg, hyper), pipe, params,
                      _init_opt(params, hyper),
                      FTConfig(ckpt_dir=str(d), ckpt_every=2, log_every=0),
                      log=lambda *_: None)
    drv.run(2)
    return str(d), _np(drv.params), _np(drv.opt_state["m"])


@pytest.fixture(scope="module")
def results(inputs, one_ckpt, tmp_path_factory):
    """(every rank's results in rank order, the references): the ranks
    run in a spawned group while this process runs the references."""
    import threading
    d = tmp_path_factory.mktemp("sharded")
    path = d / "inputs.pkl"
    with open(path, "wb") as f:
        pickle.dump(dict(inputs, ckpt_one=one_ckpt[0],
                         ckpt_sharded=str(d / "ckpt_sharded"),
                         launcher_dir=str(d / "launcher")), f)
    got = {}

    def spawn():
        try:
            got["ranks"] = LM.spawn_ranks(_rank, 4, backend="gloo",
                                          device="cpu", args=(str(path),),
                                          threads=1)
        except BaseException as e:       # re-raised below
            got["error"] = e

    th = threading.Thread(target=spawn)
    th.start()
    try:
        refs = _refs(inputs)
    finally:
        th.join(timeout=900)
    assert not th.is_alive(), "the spawned ranks did not finish"
    if "error" in got:
        raise got["error"]
    return {"ranks": got["ranks"], "ckpt_sharded": str(d / "ckpt_sharded")
            }, refs


@pytest.fixture(scope="module")
def runs(results):
    return results[0]


@pytest.fixture(scope="module")
def refs(results):
    return results[1]


def _mesh_ranks(shape):
    return {(2, 1): (0, 1), (1, 2): (2, 3), (2, 1, 1): (0, 1)}.get(
        shape, (0, 1, 2, 3))


def _leader_result(runs, case, shape):
    return runs["ranks"][_mesh_ranks(shape)[0]][(case, shape)]


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def assert_leaves(got, ref, rel=None, atol=None, what=""):
    g, r = _flat(got), _flat(ref)
    assert set(g) == set(r), set(g) ^ set(r)
    for k in r:
        tol = atol if atol is not None else rel * max(
            float(np.abs(r[k]).max()), 1e-30)
        err = float(np.abs(g[k].astype(np.float64) - r[k]).max())
        assert err <= tol, (what, k, err, tol)


def assert_run(got, want, moment_rel=REL_MOMENT, scalar_rel=REL_SCALAR,
               grad_rel=REL_GRAD, what=""):
    for a, b in zip(got["metrics"], want["metrics"]):
        assert set(a) == set(b), (set(a), set(b))
        for k in ("loss", "nll", "aux", "gnorm", "lr"):
            np.testing.assert_allclose(a[k], b[k], rtol=scalar_rel,
                                       atol=1e-30, err_msg=f"{what} {k}")
        assert a["skipped"] == b["skipped"] == 0
    assert_leaves(got["grads"], want["grads"], rel=grad_rel, what=what)
    assert_leaves(got["params"], want["params"], atol=PARAM_OVER_LR * LR_PEAK,
                  what=what)
    for k in ("m", "v"):
        assert_leaves(got[k], want[k], rel=moment_rel, what=f"{what} {k}")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_step_equals_one_device_and_reference(runs, refs, name,
                                                      shape):
    """Loss, nll, aux, gnorm; every gradient leaf gathered; params, m and
    v after 2 steps: the sharded step = the one-device step = the
    reference's."""
    got = _leader_result(runs, name, shape)
    ref, one = refs[name]
    assert_run(got, one, what="one-device")
    moe = {"scalar_rel": REL_MOE_REF, "grad_rel": REL_MOE_REF} \
        if name.startswith("mixtral") else {}
    assert_run(got, ref, what="reference", **moe)
    if name.startswith("mixtral"):
        assert got["metrics"][0]["aux"] > 0     # the global aux is live


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_rank_agrees_bitwise(runs, shape):
    """Every rank of a mesh: the same loss and gnorm bits, and every block
    that several ranks hold (a leaf replicated over an axis) the same bits
    after the update."""
    ranks = _mesh_ranks(shape)
    for name in CONFIGS:
        res = [runs["ranks"][r][(name, shape)] for r in ranks]
        for r in res[1:]:
            assert r["metrics"] == res[0]["metrics"], (name, shape)
        for key in res[0]["blocks"]:
            held = {}
            for r in res:
                sl, block = r["blocks"][key]
                if sl in held:
                    assert np.array_equal(held[sl], block), (name, key)
                held.setdefault(sl, block)
            # the ranks' distinct blocks tile the leaf
            n = np.prod(res[0]["blocks"][key][1].shape) * len(held)
            assert n == np.prod([b - a for a, b in next(iter(held))]) \
                * len(held), (name, key)


class Mesh:
    def __init__(self, data, model):
        self.shape = {"data": data, "model": model}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_each_rank_stores_only_its_blocks(runs, shape):
    """Under FSDP each rank holds its block of every param and of m and v:
    the local shapes the reference's ``resolve_spec`` gives each leaf at
    this mesh under ``DEFAULT_RULES`` (embed over data, expert over data
    where it divides)."""
    from repro.models import model as JM
    from repro.parallel import partition as JP
    sizes = {"data": shape[0], "model": shape[1]}
    for name in CONFIGS:
        js, ja = JM.abstract_params(_ref_cfg(name))
        jsf = _flat(js, leaf=lambda t: t)
        jaf = _flat(ja, leaf=tuple)
        want = {}
        for key, full in jsf.items():
            spec = JP.resolve_spec(tuple(jaf[key]), tuple(full.shape),
                                   mesh=Mesh(*shape),
                                   rules=JP.DEFAULT_RULES)
            want[key] = tuple(
                n // int(np.prod([sizes[a] for a in
                                  ((p,) if isinstance(p, str) else p)]))
                if p is not None else n
                for n, p in zip(full.shape, tuple(spec) + (None,) * (
                    len(full.shape) - len(spec))))
        for r in _mesh_ranks(shape):
            got = runs["ranks"][r][(name, shape)]["shapes"]
            for tree in ("params", "m", "v"):
                flat = _flat(got[tree], leaf=tuple)
                assert flat == want, (name, tree, r)
    # and a sharded leaf is smaller than its whole
    if shape == (2, 2):
        one = runs["ranks"][0][("qwen3_fused", shape)]["shapes"]["params"]
        assert one["embed"] == (256, 32)


@pytest.mark.parametrize("shape", POD_MESHES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("name", POD_CONFIGS)
def test_pod_axis_step_equals_one_device(runs, refs, name, shape):
    """A (pod, data, model) mesh, each rank given its rows as the rule
    table splits the batch over ("pod", "data"): the data mean, the
    gradients' sum and the norm span both axes, so the step is the
    one-device step (loss, nll, aux, gnorm, every gradient leaf, params,
    m and v after 2 steps), the same bits on every rank."""
    res = [runs["ranks"][r][(name, shape)] for r in _mesh_ranks(shape)]
    assert {r["rows"] for r in res} == {B // (shape[0] * shape[1])}
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"], (name, shape)
    assert_run(res[0], refs[name][1], what="one-device")
    if name.startswith("mixtral"):
        assert res[0]["metrics"][0]["aux"] > 0


@pytest.mark.parametrize("option", list(OPTIONS))
def test_options_at_2x2(runs, refs, option):
    """Against the one-device step with the same option: grad_compression
    (each leaf's int8 scale over the whole leaf: an all_reduce MAX),
    microbatches=2 (each rank splits its rows of each global microbatch;
    mixtral's aux per microbatch global) and train_act (the act leaf read
    by every rank's FFN shard) at (2, 2)."""
    got = _leader_result(runs, option, (2, 2))
    rel = REL_MOMENT_COMPRESSED if option == "grad_compression" \
        else REL_MOMENT
    assert_run(got, refs[option][1], moment_rel=rel, what="one-device")


def test_build_cell_train_step_runs_on_a_real_mesh(runs):
    """``build_cell``'s train args have the shapes of the rank's blocks
    and rows, and its step on them gives the sharded step's loss bits."""
    for r in runs["ranks"]:
        got = r["cell"]
        assert all(_flat(got["shapes_ok"][0]).values()), got["shapes_ok"]
        assert all(got["shapes_ok"][1].values()), got["shapes_ok"]
        assert got["loss"] == runs["ranks"][0][(CKPT_CFG, (2, 2))][
            "metrics"][0]["loss"]


def test_build_cell_decode_matches_one_device(runs, inputs):
    """``build_cell``'s decode step at f32 on the (2, 2) blocks (the FSDP
    leaves gathered first), each data rank its rows: the one-device
    decode's logits within 1e-5 of the largest."""
    cfg = port_cfg(CKPT_CFG)
    params = TM.params_from_numpy(inputs["params"][CKPT_CFG], cfg,
                                  device="cpu")
    cache = TM.init_cache(cfg, B, 8, device="cpu")
    toks = torch.tensor(inputs["batch"][CKPT_CFG]["tokens"][:, :1])
    with torch.no_grad():
        want, _ = TS.make_serve_step(cfg)(params, {"tokens": toks}, cache)
    by_data = {r["cell"]["data_rank"]: r["cell"]["decode_logits"]
               for r in runs["ranks"]}
    got = np.concatenate([by_data[0], by_data[1]])
    scale = float(np.abs(want.numpy()).max())
    assert float(np.abs(got - want.numpy()).max()) <= 1e-5 * scale


def test_checkpoint_sharded_to_one_device(runs, inputs):
    """A (2, 2) run's checkpoint (every leaf gathered whole, rank 0 writes)
    is the reference's layout, keys and shapes, and a one-device driver
    resumes it bit for bit."""
    import jax

    from repro.checkpoint.store import flatten_tree
    from repro.optim import adamw as JA
    from repro_torch.checkpoint import CheckpointStore
    store = CheckpointStore(runs["ckpt_sharded"])
    assert store.latest_step() == 2
    flat, _ = store.load_flat(2)
    jp = jax.tree.map(np.asarray, inputs["params"][CKPT_CFG])
    want = flatten_tree({"params": jp, "opt_state": JA.init_state(jp)})
    assert {k: v.shape for k, v in flat.items()} == \
        {k: v.shape for k, v in want.items()}
    cfg, hyper = port_cfg(CKPT_CFG), port_hyper()
    zero = tree_map(torch.zeros_like, TM.params_from_numpy(jp, cfg, "cpu"))
    drv = TrainDriver.resume(
        TS.make_train_step(cfg, hyper), None, zero, _init_opt(zero, hyper),
        FTConfig(ckpt_dir=runs["ckpt_sharded"]), log=lambda *_: None)
    assert drv.step == 2
    saved = runs["ranks"][0]["ckpt"]["saved_params"]
    for k, v in _flat(_np(drv.params)).items():
        assert np.array_equal(v, _flat(saved)[k]), k


def test_checkpoint_one_device_to_sharded(runs, one_ckpt):
    """A one-device checkpoint resumed on a (2, 2) mesh: every rank's
    blocks of the params and of m are the saved leaves' bits."""
    _, params, m = one_ckpt
    for r in runs["ranks"]:
        got = r["ckpt"]
        assert got["resumed_step"] == 2
        for tree, want in (("resumed", params), ("resumed_m", m)):
            whole = _flat(want)
            for key, (sl, block) in got[tree].items():
                ref = whole[key][tuple(slice(a, b) for a, b in sl)]
                assert np.array_equal(block, ref), (tree, key)


def test_launcher_sharded_matches_one_device(runs, tmp_path):
    """``launch/train.py --data-parallel 2 --model-parallel 2
    --dist-backend gloo --device cpu --smoke``: every rank's summary the
    same, its losses the one-device launcher's within LAUNCHER_REL."""
    got = [r["launcher"] for r in runs["ranks"]]
    for g in got[1:]:
        assert {k: g[k] for k in ("loss_first", "loss_last_avg8")} == \
            {k: got[0][k] for k in ("loss_first", "loss_last_avg8")}
    want = train_mod.main(LAUNCHER + ["--ckpt-dir", str(tmp_path)])
    assert got[0]["steps"] == want["steps"] == 3
    assert got[0]["skipped"] == 0
    for k in ("loss_first", "loss_last_avg8"):
        np.testing.assert_allclose(got[0][k], want[k], rtol=LAUNCHER_REL,
                                   err_msg=k)
