"""The port's checkpoint store: the cases of ``tests/test_checkpoint.py``
(roundtrip, keep-last-k, atomicity, shape checks, stable key paths,
metadata readable without a framework), restore onto a template's dtype,
and restores across packages in both directions: a train state the
reference writes restores into the port, and the reverse, bit for bit."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import CheckpointStore as JStore  # noqa: E402
from repro.configs import registry as JR  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro_torch.checkpoint import CheckpointStore, flatten_tree, unflatten_like  # noqa: E402
from repro_torch.configs import registry as TR  # noqa: E402
from repro_torch.models import model as TM  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """One intra-op torch thread for this module's small models: the suite
    runs several workers on the host's cores, and a torch pool of one
    thread a core in each slows small-model tests many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tree():
    return {
        "params": {"w": torch.arange(12.0).reshape(3, 4),
                   "b": torch.ones((4,), dtype=torch.bfloat16)},
        "opt": [torch.zeros((2, 2)), torch.tensor(5, dtype=torch.int32)],
    }


def _leaves(tree):
    return [v for _, v in sorted(flatten_tree(tree).items())]


def test_roundtrip(tmp_path, tree):
    st = CheckpointStore(tmp_path)
    st.save(3, tree, metadata={"x": 1})
    out, meta = st.restore(3, tree)
    assert out["params"]["b"].dtype == torch.bfloat16
    assert out["opt"][1].dtype == torch.int32 and int(out["opt"][1]) == 5
    assert isinstance(out["opt"], list)
    for a, b in ((tree["params"]["w"], out["params"]["w"]),
                 (tree["params"]["b"], out["params"]["b"]),
                 (tree["opt"][0], out["opt"][0])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert meta["extra"]["x"] == 1


def test_keep_last_k(tmp_path, tree):
    st = CheckpointStore(tmp_path, keep_last=2)
    for s in (1, 2, 3, 4, 5):
        st.save(s, tree)
    assert st.steps() == [4, 5]


def test_uncommitted_checkpoint_invisible(tmp_path, tree):
    st = CheckpointStore(tmp_path)
    st.save(7, tree)
    d = tmp_path / "step_00000009"          # a crash mid-write
    d.mkdir()
    (d / "arrays.npz").write_bytes(b"garbage")
    assert st.latest_step() == 7
    with pytest.raises(FileNotFoundError):
        st.load_flat(9)


def test_restore_latest_none_when_empty(tmp_path, tree):
    assert CheckpointStore(tmp_path).restore_latest(tree) is None


def test_shape_mismatch_rejected(tmp_path, tree):
    st = CheckpointStore(tmp_path)
    st.save(1, tree)
    bad = {"params": {"w": torch.zeros(3, 4, 1), "b": torch.zeros(4, 1)},
           "opt": [torch.zeros(2, 2, 1), torch.zeros(1)]}
    with pytest.raises(ValueError, match="shape mismatch"):
        st.restore(1, bad)
    with pytest.raises(KeyError, match="missing"):
        st.restore(1, {"other": torch.zeros(1)})


def test_flatten_paths_stable(tree):
    flat = flatten_tree(tree)
    assert set(flat) == {"params/w", "params/b", "opt/0", "opt/1"}
    assert flat["params/b"].dtype == np.float32       # bf16 stored as f32
    rebuilt = unflatten_like(tree, flat)
    np.testing.assert_array_equal(rebuilt["params"]["w"],
                                  tree["params"]["w"].numpy())


def test_restore_casts_to_the_template(tmp_path, tree):
    """The stored arrays are device- and dtype-agnostic: restore takes
    each leaf's dtype (and device) from the template."""
    st = CheckpointStore(tmp_path)
    st.save(2, tree)
    tmpl = {"params": {"w": torch.zeros(3, 4, dtype=torch.bfloat16),
                       "b": torch.zeros(4)},
            "opt": [torch.zeros(2, 2, dtype=torch.float64),
                    torch.tensor(0, dtype=torch.int64)]}
    out, _ = st.restore(2, tmpl)
    assert out["params"]["w"].dtype == torch.bfloat16
    assert torch.equal(out["params"]["w"].float(), tree["params"]["w"])
    assert out["params"]["b"].dtype == torch.float32
    assert out["opt"][0].dtype == torch.float64 and int(out["opt"][1]) == 5


def test_meta_json_readable_without_framework(tmp_path, tree):
    st = CheckpointStore(tmp_path)
    path = st.save(4, tree, metadata={"arch": "x"})
    meta = json.loads((path / "meta.json").read_text())
    assert meta["step"] == 4 and meta["n_arrays"] == 4
    assert (path / "_COMMITTED").exists()


def _train_states():
    """The same train state in both packages: qwen3-0.6b smoke params
    (bf16 leaves among them) and an AdamW state at count 3."""
    jc = JR.get("qwen3-0.6b", smoke=True)
    tc = TR.get("qwen3-0.6b", smoke=True)
    jp, _ = JM.materialize_params(jc, seed=0)
    jp = dict(jp, embed=jp["embed"].astype(jnp.bfloat16))
    rng = np.random.RandomState(0)
    jopt = JA.init_state(jp)
    jopt = dict(jopt, m=jax.tree.map(
        lambda a: jnp.asarray(rng.normal(size=a.shape), a.dtype), jopt["m"]),
        count=jnp.int32(3))
    tp = TM.params_from_numpy(jax.tree.map(np.asarray, jp), tc, device="cpu")
    topt = {"m": TM.params_from_numpy(jax.tree.map(np.asarray, jopt["m"]),
                                      tc, device="cpu"),
            "v": TA.tree_map(torch.zeros_like, tp),
            "count": torch.tensor(3, dtype=torch.int32)}
    return {"params": jp, "opt_state": jopt}, {"params": tp,
                                                "opt_state": topt}


def _assert_same(jtree, ttree):
    jflat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                      for k in path): np.asarray(v, np.float32)
             if v.dtype == jnp.bfloat16 else np.asarray(v)
             for path, v in jax.tree_util.tree_flatten_with_path(jtree)[0]}
    tflat = flatten_tree(ttree)
    assert set(jflat) == set(tflat)
    for k in jflat:
        np.testing.assert_array_equal(tflat[k], jflat[k], err_msg=k)


def test_reference_checkpoint_restores_into_port(tmp_path):
    jstate, tstate = _train_states()
    JStore(tmp_path).save(5, jstate, metadata={"step": 5})
    zeros = TA.tree_map(torch.zeros_like, tstate)
    step, got, meta = CheckpointStore(tmp_path).restore_latest(zeros)
    assert step == 5 and meta["extra"]["step"] == 5
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt_state"]["count"].dtype == torch.int32
    _assert_same(jstate, got)


def test_port_checkpoint_restores_into_reference(tmp_path):
    jstate, tstate = _train_states()
    CheckpointStore(tmp_path).save(6, tstate, metadata={"step": 6})
    zeros = jax.tree.map(jnp.zeros_like, jstate)
    step, got, _ = JStore(tmp_path).restore_latest(zeros)
    assert step == 6 and got["params"]["embed"].dtype == jnp.bfloat16
    _assert_same(got, tstate)
