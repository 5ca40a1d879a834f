"""The port's checkpoint format (``repro_torch/checkpoint``) and its state
helpers against the JAX package's, on the CPU.

The format: a save/restore round trip, an uncommitted step ignored, a
torn step skipped, a crc mismatch raising on an explicit step and falling
back on ``step=None``, retention, an async failure re-raised, an async
snapshot that does not alias live memory, and bf16 / fp8 through their
raw integer views. Both directions across packages: each package's
``restore_checkpoint`` reads the other's checkpoint with equal leaves,
dtypes (bf16 included), paths and metadata, and the two write the same
bytes for the same tree.

The state helpers: ``pack_rng_state``, the selector and the float map
round trip and equal the reference's arrays; the engines' ``ef_state``
and ``cache_state`` after the same round (ratio 1.0, so no top-k near-tie
can flip; losses and params rtol 1e-4, atol 1e-5 as in
``tests/test_torch_engine.py``), each loadable by the other package.
Everything else is compared exactly."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as jck
from repro.fl import sim as jsim
from repro.core.selector import ParticipantSelector as JSelector

from repro_torch.checkpoint import ckpt as tck
from repro_torch.core.selector import ParticipantSelector as TSelector
from repro_torch.fl import sim as tsim
from repro_torch.models.module import tree_paths

from test_torch_engine import _engines, _worlds

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the other trajectory files run
    (``tests/test_torch_fedavg.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ttree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": torch.as_tensor(rng.randn(8, 4).astype(np.float32)),
            "b": {"c": torch.as_tensor(rng.randn(3)).to(torch.bfloat16),
                  "step": torch.tensor(7, dtype=torch.int32)},
            "lst": [np.arange(3, dtype=np.int64),
                    torch.ones(2, dtype=torch.float16)]}


def _jtree(seed=0):
    rng = np.random.RandomState(seed)
    return {"a": jnp.asarray(rng.randn(8, 4), jnp.float32),
            "b": {"c": jnp.asarray(rng.randn(3), jnp.bfloat16),
                  "step": jnp.int32(7)},
            "lst": [jnp.arange(3, dtype=jnp.int32),
                    jnp.ones(2, jnp.float16)]}


def _bits(x) -> np.ndarray:
    """The raw bits of a restored leaf of either package."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    x = np.asarray(x)
    return x.view(np.uint16) if str(x.dtype) == "bfloat16" else x


# ---------------------------------------------------------------------------
# the format
# ---------------------------------------------------------------------------


def test_tree_paths_match_the_reference():
    jp = [p for p, _ in jck.tree_paths(_jtree())]
    tp = [p for p, _ in tree_paths(_ttree())]
    assert tp == jp
    assert tree_paths({"x": None, "y": {}}) == []


def test_roundtrip_layout_and_dtypes(tmp_path):
    t = _ttree()
    commit = tck.save_checkpoint(str(tmp_path), 5, t, metadata={
        "stage": np.int64(2), "clock": np.float32(1.5),
        "frozen": np.bool_(True), "ids": np.arange(2)})
    assert os.path.basename(commit) == "step_5.COMMIT"
    assert sorted(os.listdir(tmp_path / "step_5")) == [
        "a.npy", "b__c.npy", "b__step.npy", "lst__[0].npy", "lst__[1].npy",
        "manifest.json"]
    man = json.load(open(tmp_path / "step_5" / "manifest.json"))
    assert man["metadata"] == {"stage": 2, "clock": 1.5, "frozen": True,
                               "ids": [0, 1]}
    dtypes = {e["file"]: e["dtype"] for e in man["leaves"]}
    assert dtypes["b__c.npy"] == "bfloat16"
    assert np.load(tmp_path / "step_5" / "b__c.npy").dtype == np.uint16
    out = tck.restore_checkpoint(str(tmp_path))
    assert out["step"] == 5 and out["metadata"]["stage"] == 2
    c = out["tree"]["b"]["c"]
    assert isinstance(c, torch.Tensor) and c.dtype == torch.bfloat16
    assert torch.equal(c, t["b"]["c"])
    np.testing.assert_array_equal(out["tree"]["a"], t["a"].numpy())
    assert out["tree"]["b"]["step"].dtype == np.int32
    np.testing.assert_array_equal(out["tree"]["lst"]["[0]"], np.arange(3))
    assert out["tree"]["lst"]["[1]"].dtype == np.float16
    on_dev = tck.restore_checkpoint(str(tmp_path), device="cpu")["tree"]
    assert isinstance(on_dev["a"], torch.Tensor)
    assert on_dev["b"]["c"].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", [torch.float8_e4m3fn, torch.float8_e5m2])
def test_fp8_through_its_uint8_view(tmp_path, dtype):
    x = torch.linspace(-2, 2, 16).to(dtype)
    tck.save_checkpoint(str(tmp_path), 0, {"x": x})
    assert np.load(tmp_path / "step_0" / "x.npy").dtype == np.uint8
    back = tck.restore_checkpoint(str(tmp_path))["tree"]["x"]
    assert back.dtype == dtype
    assert torch.equal(back.view(torch.uint8), x.view(torch.uint8))
    ref = jck.restore_checkpoint(str(tmp_path))["tree"]["x"]
    assert str(ref.dtype) == str(dtype).split(".")[1]
    np.testing.assert_array_equal(ref.view(np.uint8),
                                  x.view(torch.uint8).numpy())


def test_uncommitted_and_torn_steps(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3):
        tck.save_checkpoint(d, s, _ttree(s))
    os.remove(tmp_path / "step_3.COMMIT")        # a crash mid-commit
    os.remove(tmp_path / "step_2" / "a.npy")     # a torn directory
    assert tck.latest_step(d) == 1
    assert tck.restore_checkpoint(d)["step"] == 1
    with pytest.raises(OSError):
        tck.restore_checkpoint(d, 2)


def test_crc_mismatch_raises_on_explicit_step_and_falls_back(tmp_path):
    d = str(tmp_path)
    tck.save_checkpoint(d, 1, _ttree(1))
    tck.save_checkpoint(d, 2, _ttree(2))
    arr = np.load(tmp_path / "step_2" / "a.npy")
    arr[0, 0] += 1.0
    np.save(tmp_path / "step_2" / "a.npy", arr)  # bit rot after commit
    with pytest.raises(tck.CheckpointCorruptError):
        tck.restore_checkpoint(d, 2)
    assert tck.restore_checkpoint(d)["step"] == 1
    with pytest.raises(TypeError, match="A14"):
        tck.restore_checkpoint(d, shardings={"a": None})


def test_manager_retention_async_and_failure(tmp_path):
    mgr = tck.CheckpointManager(str(tmp_path / "ck"), keep=2)
    for s in range(5):
        mgr.save(s, _ttree(s))
    mgr.wait()
    assert sorted(mgr._committed()) == [3, 4]
    assert mgr.restore()["step"] == 4
    bad = tck.CheckpointManager(str(tmp_path / "bad"))
    bad.ckpt_dir = str(tmp_path / "missing" / "\0")  # unwritable path
    bad.save(0, _ttree())
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        bad.wait()
    bad.save(1, _ttree())
    with pytest.raises(RuntimeError, match="async checkpoint save failed"):
        bad.save(2, _ttree())


def test_async_snapshot_does_not_alias_live_memory(tmp_path, monkeypatch):
    """The round engine updates its residual pools in place: a leaf
    changed after ``save`` returns, before the write thread writes, must
    not reach the disk."""
    gate, write = threading.Event(), tck._write
    monkeypatch.setattr(tck, "_write",
                        lambda *a: (gate.wait(30), write(*a))[1])
    mgr = tck.CheckpointManager(str(tmp_path))
    pool = torch.zeros(4, 1 << 16)
    arr = np.zeros(7)
    mgr.save(0, {"pool": pool, "arr": arr})
    pool[1] = 5.0
    arr[:] = 3.0
    gate.set()
    mgr.wait()
    tree = mgr.restore()["tree"]
    assert not tree["pool"].any() and not tree["arr"].any()


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A checkpoint of either package restores in the other with equal
    leaves, dtypes and metadata; both write the same bytes."""
    meta = {"stage": 1, "round_idx": 4, "clock": 2.25, "frozen": False}
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    jck.save_checkpoint(jd, 3, _jtree(), metadata=meta)
    jt = _jtree()
    tt = _ttree()
    tt["lst"][0] = tt["lst"][0].astype(np.int32)
    tck.save_checkpoint(td, 3, tt, metadata=meta)
    jm = json.load(open(os.path.join(jd, "step_3", "manifest.json")))
    tm = json.load(open(os.path.join(td, "step_3", "manifest.json")))
    assert tm == jm
    src = jd if writer == "reference" else td
    j_out = jck.restore_checkpoint(src)
    t_out = tck.restore_checkpoint(src)
    assert j_out["metadata"] == t_out["metadata"] == meta
    assert j_out["step"] == t_out["step"] == 3
    jl, tl = tree_paths(j_out["tree"]), tree_paths(t_out["tree"])
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (_, a), (_, b), (_, want) in zip(jl, tl, jck.tree_paths(jt)):
        assert str(np.asarray(a).dtype) == str(np.asarray(want).dtype)
        np.testing.assert_array_equal(_bits(b), _bits(a))
    c = t_out["tree"]["b"]["c"]
    assert c.dtype == torch.bfloat16 and torch.equal(c, _ttree()["b"]["c"])


# ---------------------------------------------------------------------------
# the state helpers
# ---------------------------------------------------------------------------


def test_rng_state_roundtrip_equals_reference():
    rs = np.random.RandomState(42)
    rs.rand(17)
    rs.randn()  # a cached Gaussian
    t, j = tsim.pack_rng_state(rs), jsim.pack_rng_state(rs)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype
    rs2 = tsim.unpack_rng_state(j)
    np.testing.assert_array_equal(rs.rand(8), rs2.rand(8))
    assert rs.randn() == rs2.randn()


def test_selector_and_float_map_equal_reference():
    sim = np.random.RandomState(0).rand(8, 8)
    sim = (sim + sim.T) / 2
    js, ts = JSelector(seed=3), TSelector(seed=3)
    js.fit_communities(sim)
    ts.fit_communities(sim)
    for sel in (js, ts):
        for cid in range(8):
            sel._bandit.update(cid, float(cid) * 0.5)
        sel._bandit.next_round()
        sel._bandit.update(2, 9.0)
    j, t = jsim.selector_state_tree(js), tsim.selector_state_tree(ts)
    assert sorted(t) == sorted(j)
    for k in j:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype
    fresh = TSelector(seed=3)
    tsim.load_selector_state(fresh, j)
    assert fresh._communities == ts._communities
    assert (fresh._bandit._util, fresh._bandit._last_seen,
            fresh._bandit._round) == (ts._bandit._util,
                                      ts._bandit._last_seen,
                                      ts._bandit._round)
    d = {3: 0.25, 1: 1.5, 7: -2.0}
    fm = tsim.pack_float_map(d)
    for k, v in jsim.pack_float_map(d).items():
        np.testing.assert_array_equal(fm[k], v)
    assert tsim.unpack_float_map(fm) == jsim.unpack_float_map(fm) == d


def test_tree_like_casts_onto_the_template():
    tmpl = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
            "bn": {"m": torch.zeros(3)}, "empty": {}}
    got = tsim.tree_like(tmpl, {"w": np.ones((2, 3), np.float32),
                                "bn": {"m": np.arange(3.0)}})
    assert got["w"].dtype == torch.bfloat16 and got["bn"]["m"].dtype == \
        torch.float32
    assert got["empty"] == {}
    assert torch.equal(got["bn"]["m"], torch.arange(3.0))


def _state_equal(j, t):
    assert sorted(j) == sorted(t)
    for k in j:
        a, b = np.asarray(j[k]), t[k]
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b)


def test_ef_state_against_reference(tmp_path):
    jclients, tclients = _worlds()
    je, te, (ja, js), (ta, ts) = _engines(0, 1.0, jclients)
    assert te.ef_state() is None and je.ef_state() is None
    for r, cohort in enumerate(([2, 0], [1, 3, 0])):
        ja, js, _ = je.run_round({c.client_id: c for c in jclients}, cohort,
                                 ja, js, r)
        ta, ts, _ = te.run_round({c.client_id: c for c in tclients}, cohort,
                                 ta, ts, r)
    j, t = je.ef_state(), te.ef_state()
    assert sorted(t) == sorted(j)
    for k in j:
        b = t[k].numpy() if isinstance(t[k], torch.Tensor) else t[k]
        assert b.shape == np.asarray(j[k]).shape and b.dtype == \
            np.asarray(j[k]).dtype, k
        np.testing.assert_allclose(b, np.asarray(j[k]), **TOL)
    # residuals of the reference's, carried into the port bit for bit
    rng = np.random.RandomState(0)
    carried = dict(j, **{k: rng.randn(*np.asarray(v).shape).astype(np.float32)
                         for k, v in j.items() if k.startswith("pool")})
    jck.save_checkpoint(str(tmp_path), 0, {"ef": carried})
    _, te2, _, _ = _engines(0, 1.0, jclients)
    te2.load_ef_state(tck.restore_checkpoint(str(tmp_path))["tree"]["ef"])
    _state_equal(carried, te2.ef_state())
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in te2._res_pool)
    assert te2.client_residuals(1)[0].shape == (carried["pool0"].shape[1],)


def test_cache_state_against_reference(tmp_path):
    jclients, tclients = _worlds()
    je, te, _, _ = _engines(1, None, jclients)
    assert te.cache_state() is None and te.cache_state_if_changed() is None
    for cid, tier in ((0, "int8"), (1, "fp16"), (2, "f32")):
        je.features_for(jclients[cid], tier)
        te.features_for(tclients[cid], tier)
    j, t = je.cache_state(), te.cache_state()
    assert sorted(t) == sorted(j)
    np.testing.assert_array_equal(t["ids"], j["ids"])
    np.testing.assert_array_equal(t["tiers"], j["tiers"])
    for k in j:
        if k.startswith(("val", "scale")):
            a, b = np.asarray(j[k]), t[k].numpy()
            assert a.dtype == b.dtype and a.shape == b.shape, k
            if a.dtype == np.int8:  # codes may round apart by one
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
            else:
                np.testing.assert_allclose(b.astype(np.float32),
                                           a.astype(np.float32),
                                           rtol=1e-3, atol=1e-4)
    assert te.cache_state_if_changed() is not None
    assert te.cache_state_if_changed() is None   # unchanged since
    te.features_for(tclients[2], "fp16")          # a re-tier
    assert te.cache_state_if_changed() is not None
    # the reference's cache, carried into the port bit for bit, and back
    jck.save_checkpoint(str(tmp_path / "j"), 0, {"cache": j})
    _, te2, _, _ = _engines(1, None, jclients)
    te2.load_cache_state(
        tck.restore_checkpoint(str(tmp_path / "j"))["tree"]["cache"])
    _state_equal(j, te2.cache_state())
    assert te2.cache_tiers() == je.cache_tiers()
    assert te2.cache_nbytes() == je.cache_nbytes()
    assert te2.cache_state_if_changed() is not None  # a load is a change
    tck.save_checkpoint(str(tmp_path / "t"), 0, {"cache": te2.cache_state()})
    back = jck.restore_checkpoint(str(tmp_path / "t"))["tree"]["cache"]
    _state_equal(back, te2.cache_state())
