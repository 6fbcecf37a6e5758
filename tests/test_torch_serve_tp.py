"""Tensor-parallel serving of the port (``ServeEngine(mesh=)``,
``serve_batch(mesh=)``, ``--model-parallel``, TP replicas) on the CPU.

The twin of ``tests/test_serve_tp.py``: serving under TP=2 and TP=4 must
emit token for token (greedy) what TP=1 emits. One spawned group of four
gloo ranks (file-store init, one torch thread a rank) serves every case
of this module: ranks (0, 1) and (2, 3) form two TP=2 meshes that run
different cases at once, all four a TP=4 mesh, and ranks 2 and 3 also
serve the TP=1 baselines (no mesh). Besides the reference's cases
(qwen3 paged / slot / chunked, musicgen's codebook planes) it covers the
layouts those miss: kv heads whole while heads shard (qwen2.5-3b, KV=1),
heads whole while Mamba shards (hymba-1.5b), the slot contract with
``dinner`` sharded (falcon-mamba-7b) and a ragged MoE with an
expert-sharded router (mixtral-8x22b). Each rank's shard shapes are held
against the reference's ``resolve_spec``, and TP=2 f32 logits on the
reference's weights against the reference's f32 forward.

The rank function lives here and imports no jax (a spawned rank imports
this module); the reference is imported inside the tests.
"""
import dataclasses
import json
import pickle

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.launch import mesh as LM  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.parallel import partition as part  # noqa: E402
from repro_torch.serve import (EngineConfig, InProcessReplica,  # noqa: E402
                               ProcessReplica, ReplicaSpec, Router,
                               ServeEngine)

GEN = 8
MUSIC_GEN = 6
# (case, arch, tp, engine kwargs): ranks (0, 1) run PAIR_A, (2, 3) PAIR_B
PAIR_A = (("qwen3_tp2", "qwen3-0.6b", {}),
          ("qwen3_tp2_slot", "qwen3-0.6b", {"cache": "slot"}),
          ("qwen3_tp2_chunked", "qwen3-0.6b", {"chunk_prefill": 4}),
          ("musicgen_tp2", "musicgen-large", {}),
          ("hymba_tp2", "hymba-1.5b", {}))
PAIR_B = (("qwen2.5_tp2", "qwen2.5-3b", {}),
          ("falcon_tp2", "falcon-mamba-7b", {}),
          ("mixtral_tp2", "mixtral-8x22b", {}))
TP1 = {"qwen3-0.6b": "qwen3_tp1", "musicgen-large": "musicgen_tp1",
       "hymba-1.5b": "hymba_tp1", "qwen2.5-3b": "qwen2.5_tp1",
       "falcon-mamba-7b": "falcon_tp1", "mixtral-8x22b": "mixtral_tp1"}
ARCH_OF = {name: arch for name, arch, _ in PAIR_A + PAIR_B}
ARCH_OF.update({v: k for k, v in TP1.items()}, qwen3_tp4="qwen3-0.6b")
LOGIT_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(tree):
    return tserve._tree_cast(tree, torch.bfloat16)


def _prompts(cfg):
    """The reference test's prompts: [3, 12] (musicgen [2, 10, K])."""
    rng = np.random.RandomState(0)
    if cfg.n_codebooks > 1:
        return rng.randint(0, cfg.vocab_size,
                           (2, 10, cfg.n_codebooks)).astype(np.int32)
    return rng.randint(0, cfg.vocab_size, (3, 12)).astype(np.int32)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tuple(tree.shape)}


def _serve(arch, mesh, **kw):
    """One served run of ``arch`` smoke (bf16 weights from seed 0) as
    ``serve_batch`` runs it; its tokens and the engine's local shapes."""
    cfg = TR.get(arch, smoke=True)
    prompts = _prompts(cfg)
    gen = MUSIC_GEN if cfg.n_codebooks > 1 else GEN
    B, S = prompts.shape[:2]
    params = _bf16(TM.materialize_params(cfg, seed=0, device="cpu"))
    eng = ServeEngine(cfg, params, EngineConfig(
        slots=B, max_prompt_len=S, max_len=S + gen, chunk=gen - 1, **kw),
        mesh=mesh, device="cpu")
    for p in prompts:
        eng.submit(p, gen)
    done = sorted(eng.run(), key=lambda c: c.uid)
    return {"tokens": np.asarray([c.tokens for c in done], np.int32),
            "params": _flat(eng.params), "cache": _flat(eng.cache),
            "paged": eng.paged}


def _f32_logits(ref_path, mesh):
    """TP=2 f32 forward logits of qwen3 smoke on the reference's weights."""
    from repro_torch.launch import steps as TS
    with open(ref_path, "rb") as f:
        ref = pickle.load(f)
    cfg = TR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    params = TM.params_from_numpy(ref["params"], cfg, device="cpu")
    psh, _, _ = TS.serve_shardings(cfg, 1, 32, mesh)
    local = TM.compute_params(TM.shard_params(params, cfg, psh), cfg)
    with part.axis_rules(mesh, part.serve_rules()):
        logits = TM.forward_fn(local, {"tokens": torch.from_numpy(
            ref["tokens"])}, cfg, TS.make_engine(cfg))
    return logits.numpy()


def _tp_rank(rank, world, device, ref_path):
    """Every case of this module on one of the four ranks."""
    m4 = LM.make_host_mesh(1, 4, device="cpu")
    pairs = [LM.make_host_mesh(1, 2, device="cpu", ranks=r)
             for r in ((0, 1), (2, 3))]
    m2 = pairs[rank // 2]
    out = {}
    if rank < 2:
        for name, arch, kw in PAIR_A:
            out[name] = _serve(arch, m2, **kw)
        out["f32_logits"] = _f32_logits(ref_path, m2)
    else:
        for name, arch, kw in PAIR_B:
            out[name] = _serve(arch, m2, **kw)
        for arch in list(TP1)[rank - 2::2]:
            out[TP1[arch]] = _serve(arch, None)
    # the TP=4 case through the launcher's serve_batch
    cfg = TR.get("qwen3-0.6b", smoke=True)
    toks, _ = tserve.serve_batch(
        cfg, _bf16(TM.materialize_params(cfg, seed=0, device="cpu")),
        _prompts(cfg), GEN, mesh=m4, device="cpu")
    out["qwen3_tp4"] = {"tokens": toks.numpy()}
    return out


@pytest.fixture(scope="module")
def ref():
    """The reference's qwen3 smoke weights and f32 forward logits."""
    import jax
    import jax.numpy as jnp

    from repro.configs import registry as JR
    from repro.launch import steps as JS
    from repro.models import model as JM
    jc = JR.get("qwen3-0.6b", smoke=True, compute_dtype="float32")
    jp, _ = JM.materialize_params(jc, seed=0)
    toks = np.random.RandomState(1).randint(0, 512, (2, 21)).astype(np.int32)
    logits = JM.forward_fn(jp, {"tokens": jnp.asarray(toks)}, jc,
                           JS.make_engine(jc))
    return {"params": jax.tree.map(np.asarray, jp), "tokens": toks,
            "logits": np.asarray(logits)}


@pytest.fixture(scope="module")
def runs(ref, tmp_path_factory):
    """Every rank's results, rank order."""
    path = tmp_path_factory.mktemp("tp") / "ref.pkl"
    with open(path, "wb") as f:
        pickle.dump({"params": ref["params"], "tokens": ref["tokens"]}, f)
    return LM.spawn_ranks(_tp_rank, 4, backend="gloo", device="cpu",
                          args=(str(path),), threads=1)


def _result(runs, name):
    for r in runs:
        if name in r:
            return r[name]
    raise KeyError(name)


@pytest.mark.parametrize("name", ["qwen3_tp2", "qwen3_tp4"])
def test_qwen3_tp_tokens_equal_tp1(runs, name):
    want = _result(runs, "qwen3_tp1")["tokens"]
    assert want.shape == (3, GEN)
    for r in runs:
        if name in r:
            np.testing.assert_array_equal(r[name]["tokens"], want)


@pytest.mark.parametrize("name", ["qwen3_tp2_slot", "qwen3_tp2_chunked"])
def test_qwen3_tp2_slot_and_chunked_equal_paged(runs, name):
    """The per-slot cache and the token-budget schedule stay pure layout /
    scheduling changes under TP."""
    got = _result(runs, name)
    assert got["paged"] == (name != "qwen3_tp2_slot")
    np.testing.assert_array_equal(got["tokens"],
                                  _result(runs, "qwen3_tp2")["tokens"])


@pytest.mark.parametrize("name", ["musicgen_tp2", "hymba_tp2", "qwen2.5_tp2",
                                  "falcon_tp2", "mixtral_tp2"])
def test_layouts_tp2_tokens_equal_tp1(runs, name):
    arch = ARCH_OF[name]
    want = _result(runs, TP1[arch])["tokens"]
    cfg = TR.get(arch, smoke=True)
    if cfg.n_codebooks > 1:
        assert want.shape == (2, MUSIC_GEN, cfg.n_codebooks)
    for r in runs:
        if name in r:
            np.testing.assert_array_equal(r[name]["tokens"], want)


def _ref_local_shapes(arch, tp, paged, ecfg):
    """(params, cache) local shapes by the reference's resolve_spec under
    serve_rules on a stand-in (1, tp) mesh."""
    from repro.configs import registry as JR
    from repro.models import model as JM
    from repro.parallel import partition as JP

    class Mesh:
        shape = {"data": 1, "model": tp}

    jc = JR.get(arch, smoke=True)
    rules = JP.serve_rules()

    def local(tree_shapes, tree_axes):
        out = {}
        flat_s = _flat(tree_shapes)
        flat_a = {}

        def walk(t, prefix=""):
            if isinstance(t, dict):
                for k, v in t.items():
                    walk(v, f"{prefix}{k}/")
            else:
                flat_a[prefix[:-1]] = t
        walk(tree_axes)
        for key, shape in flat_s.items():
            spec = JP.resolve_spec(tuple(flat_a[key]), shape, mesh=Mesh(),
                                   rules=rules)
            out[key] = tuple(n // (tp if i < len(spec) and spec[i] == "model"
                                   else 1) for i, n in enumerate(shape))
        return out

    pshapes, paxes = JM.abstract_params(jc)
    if paged:
        cspec = JM.paged_cache_spec(jc, ecfg["slots"], ecfg["n_pages"],
                                    ecfg["page_size"], ecfg["max_len"])
        caxes = JM.paged_cache_axes(jc)
    else:
        cspec = JM.cache_spec(jc, ecfg["slots"], ecfg["max_len"],
                              per_slot=True)
        caxes = JM.cache_axes(jc, per_slot=True)
    return local(pshapes, paxes), local(cspec, caxes)


@pytest.mark.parametrize("name", [n for n, _, kw in PAIR_A + PAIR_B
                                  if not kw])
def test_shard_shapes_equal_reference_spec(runs, name):
    """Every rank's parameter and cache shards have the local shapes the
    reference's resolve_spec gives on a (1, 2) mesh; sharded dims really
    shrink (the FFN's mlp dim is halved wherever the arch has an FFN)."""
    arch = ARCH_OF[name]
    cfg = TR.get(arch, smoke=True)
    got = _result(runs, name)
    S = _prompts(cfg).shape[1]
    gen = MUSIC_GEN if cfg.n_codebooks > 1 else GEN
    slots = _prompts(cfg).shape[0]
    n_pages = slots * TM.pages_per_slot(cfg, S + gen, 16) + 1
    want_p, want_c = _ref_local_shapes(
        arch, 2, got["paged"], dict(slots=slots, max_len=S + gen,
                                    n_pages=n_pages, page_size=16))
    assert got["params"] == want_p
    assert got["cache"] == want_c
    tp1 = _result(runs, TP1[arch])
    if cfg.has_ffn:
        key = "blocks/ffn/w_up"
        assert got["params"][key][-1] * 2 == tp1["params"][key][-1]


def test_every_rank_of_a_group_emits_the_same_tokens(runs):
    for name in [n for n, _, _ in PAIR_A + PAIR_B] + ["qwen3_tp4"]:
        toks = [r[name]["tokens"] for r in runs if name in r]
        assert len(toks) == (4 if name == "qwen3_tp4" else 2)
        for t in toks[1:]:
            np.testing.assert_array_equal(t, toks[0])


def test_tp2_f32_logits_match_reference(runs, ref):
    for r in runs[:2]:
        got = r["f32_logits"]
        assert got.shape == ref["logits"].shape
        np.testing.assert_allclose(got, ref["logits"], rtol=0,
                                   atol=LOGIT_TOL)
    np.testing.assert_array_equal(runs[0]["f32_logits"],
                                  runs[1]["f32_logits"])


def test_launcher_model_parallel_matches_tp1(tmp_path, capfd):
    argv = ["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len",
            "8", "--gen", "4"]
    tserve.main(argv + ["--json", str(tmp_path / "tp1.json")])
    tserve.main(argv + ["--json", str(tmp_path / "tp2.json"),
                        "--model-parallel", "2", "--dist-backend", "gloo"])
    a, b = (json.loads((tmp_path / f"{n}.json").read_text())
            for n in ("tp1", "tp2"))
    assert b["tokens"] == a["tokens"] and len(a["tokens"]) == 2
    out = capfd.readouterr().out          # rank 0 prints in its process
    assert "backend=gloo" in out and "'model': 2" in out


def test_process_replica_tp2_matches_in_process():
    """A TP=2 ProcessReplica (two spawned ranks, rank 0 relaying each RPC)
    serves an InProcessReplica's tokens and exits 0."""
    ecfg = dict(slots=2, max_prompt_len=16, max_len=32, chunk=4)
    spec = ReplicaSpec(arch="qwen3-0.6b", smoke=True, seed=0, bf16=True,
                       engine=ecfg, device="cpu", model_parallel=2,
                       dist_backend="gloo")
    cfg = TR.get("qwen3-0.6b", smoke=True)
    params = _bf16(TM.materialize_params(cfg, seed=0, device="cpu"))
    local = Router(lambda rid: InProcessReplica(
        ServeEngine(cfg, params, EngineConfig(**ecfg), device="cpu")))
    remote = ProcessReplica(spec)
    try:
        router = Router(lambda rid: remote)
        rng = np.random.RandomState(1)
        prompts = [rng.randint(0, 500, (n,)) for n in (5, 9, 12)]
        for r in (local, router):
            for p in prompts:
                r.submit(p, max_new=6)
        want = {c.uid: c.tokens for c in local.run()}
        assert {c.uid: c.tokens for c in router.run()} == want
        assert remote.load().free_slots == ecfg["slots"]
    finally:
        remote.close()
    assert remote.exitcode == 0


class _StandInMesh:
    """A DeviceMesh's surface for one rank of a (data, model) mesh, with
    no process group behind it."""

    mesh_dim_names = ("data", "model")

    def __init__(self, data, model, rank=0):
        self.mesh = torch.arange(data * model).reshape(data, model)
        self._rank = rank

    def get_local_rank(self, name):
        return {"data": 0, "model": self._rank}[name]


def test_sharded_weights_need_their_mesh():
    """A rank's shards used outside the mesh context raise; nothing falls
    back to computing a partial answer."""
    from repro_torch.launch import steps as TS
    cfg = TR.get("qwen3-0.6b", smoke=True)
    params = TM.materialize_params(cfg, seed=0, device="cpu")
    psh, _, _ = TS.serve_shardings(cfg, 1, 16, _StandInMesh(1, 2, rank=1))
    local = TM.shard_params(params, cfg, psh)
    assert local["blocks"]["attn"]["wq"].shape[2] == cfg.n_heads // 2
    np.testing.assert_array_equal(
        local["blocks"]["ffn"]["w_up"].numpy(),
        params["blocks"]["ffn"]["w_up"][..., cfg.d_ff // 2:].numpy())
    # sharding twice changes nothing
    again = TM.shard_params(local, cfg, psh)
    assert again["blocks"]["ffn"]["w_up"] is local["blocks"]["ffn"]["w_up"]
    toks = torch.zeros((1, 4), dtype=torch.int64)
    with pytest.raises(RuntimeError, match="sharded weights need"):
        TM.forward_fn(local, {"tokens": toks}, cfg, TS.make_engine(cfg))


def test_mamba_in_proj_halves_shard_separately():
    from repro_torch.launch import steps as TS
    cfg = TR.get("falcon-mamba-7b", smoke=True)
    params = TM.materialize_params(cfg, seed=0, device="cpu")
    di = cfg.d_inner_
    full = params["blocks"]["mamba"]["in_proj"]
    for rank in (0, 1):
        psh, _, _ = TS.serve_shardings(cfg, 1, 16, _StandInMesh(1, 2, rank))
        got = TM.shard_params(params, cfg, psh)["blocks"]["mamba"]["in_proj"]
        lo, hi = rank * di // 2, (rank + 1) * di // 2
        want = torch.cat([full[..., lo:hi], full[..., di + lo:di + hi]], -1)
        assert torch.equal(got, want)


def test_engine_is_tensor_parallel_only():
    cfg = TR.get("qwen3-0.6b", smoke=True)
    params = TM.materialize_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="tensor-parallel only"):
        ServeEngine(cfg, params, EngineConfig(slots=1, max_prompt_len=8,
                                              max_len=16),
                    mesh=_StandInMesh(2, 1), device="cpu")


def _rank_fails(rank, world, device):
    if rank == 1:
        raise ValueError("rank 1 fails")
    return rank


def test_a_failed_rank_fails_the_group():
    """spawn_ranks raises with the failed rank's traceback; no rank's
    failure is swallowed into partial results."""
    with pytest.raises(RuntimeError, match="rank 1 fails"):
        LM.spawn_ranks(_rank_fails, 2, backend="gloo", device="cpu",
                       threads=1)


def test_backend_is_chosen_never_switched():
    assert LM.default_backend("cpu") == "gloo"
    assert LM.default_backend("cuda") == "nccl"
    LM.check_backend("gloo", "cpu", 4)
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        LM.check_backend("nccl", "cpu", 2)
    with pytest.raises(ValueError, match="unknown backend"):
        LM.check_backend("mpi", "cpu", 2)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="card per rank|needs CUDA"):
            LM.check_backend("nccl", "cuda", 2)
    assert dataclasses.replace(ReplicaSpec(), device="cpu").backend == "gloo"
