"""The port's ``FedAvgServer``, host compression API and ``fl`` exports
against the JAX package's, on the CPU.

``FedAvgServer`` runs a (1, 1)-stage ResNet of widths (8, 16) over four
clients of 16x16 images (client 0 20x slower), three a round, batch 16,
against ``repro.fl.server.FedAvgServer(use_pallas=False)`` from the
reference's initial params: fused sync rounds with a memory floor that
excludes the poorest client, the absolute deadline over an
``AvailabilityTrace`` (straggler rounds on the sequential path), and
async-buffered with a watchdog and compressed uplinks at ratio 1.0 (top-k
keeps every entry, so no near-tie can flip). The loop's records
(selected, dropped, staleness, retries, sequential) and uplink bytes
equal; losses, params and BN state rtol 1e-3, atol 1e-5; the virtual
clock rtol 1e-6.

The host compression API holds the reference bit for bit: payloads (ties
included), ``compressed_bytes``, decompressed trees and ``ErrorFeedback``
residuals over three calls."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.fl as jfl
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl import compression as jcomp
from repro.fl import sim as jsim
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.server import FedAvgServer as JFedAvg
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg

import repro_torch.fl as tfl
from repro_torch.convert import to_torch
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl import compression as tcomp
from repro_torch.fl import sim as tsim
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.server import FedAvgServer as TFedAvg
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves

CFG = dict(name="tiny", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
SRV = dict(clients_per_round=3, batch_size=16, seed=0)
TOL = dict(rtol=1e-3, atol=1e-5)
CLOCK = dict(rtol=1e-6, atol=0)


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU convolutions sum in an order that follows torch's
    thread count, and a free f32 trajectory can amplify a ReLU input within
    that rounding of zero past the tolerance
    (``tests/test_torch_policies_drift.py``); one thread makes the
    trajectories the same on every machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# FedAvgServer
# ---------------------------------------------------------------------------


def _clients(vision, dirichlet, fleet):
    train = vision(num_classes=4, image_size=16, seed=0).sample(256, seed=1)
    clients = fleet(train, dirichlet(train["y"], 4, alpha=1.0, seed=0),
                    scenario="low", seed=0)
    clients[0].capability /= 20.0   # a straggler, 20x slower
    clients[3].memory_bytes = 2.0 ** 30  # under the sync case's floor
    return clients


def _policy(name, pkg, clients):
    """(server kwargs, rounds) of one policy case over ``pkg``'s ``sim``."""
    times = sorted(c.num_samples / c.capability for c in clients)
    if name == "sync":
        return dict(mem_required=2.0 ** 31), 3
    if name == "deadline":
        return dict(aggregation=pkg.DeadlineAggregation(
            deadline_s=(times[-1] + times[-2]) / 2),
            availability=pkg.AvailabilityTrace(0.9, 0.25, seed=2)), 4
    return dict(aggregation=pkg.AsyncBufferedAggregation(
        buffer_size=2, concurrency=3, timeout_s=times[1], max_retries=1),
        compress_ratio=1.0), 4


def _recorded(monkeypatch, pkg, policy):
    """Keep every tick's ``RoundRecord`` of ``policy``'s class."""
    cls = type(policy) if policy is not None else pkg.SyncAggregation
    out, tick = [], cls.tick
    monkeypatch.setattr(cls, "tick", lambda self, loop, r: out.append(
        tick(self, loop, r)) or out[-1])
    return out


@pytest.mark.parametrize("name", ["sync", "deadline", "async"])
def test_fedavg_matches_reference(monkeypatch, name):
    jclients = _clients(JVision, j_dirichlet, j_fleet)
    tclients = _clients(TVision, t_dirichlet, t_fleet)
    jkw, rounds = _policy(name, jsim, jclients)
    tkw, _ = _policy(name, tsim, tclients)
    jrecs = _recorded(monkeypatch, jsim, jkw.get("aggregation"))
    trecs = _recorded(monkeypatch, tsim, tkw.get("aggregation"))
    params, state = JCNN(JCfg(**CFG)).init(jax.random.PRNGKey(0))
    jsrv = JFedAvg(JCNN(JCfg(**CFG)), jclients, use_pallas=False, **jkw,
                   **SRV)
    tsrv = TFedAvg(TCNN(TCfg(**CFG), device="cpu"), tclients, device="cpu",
                   **tkw, **SRV)
    evals = []
    j_out = jsrv.run(params, state, rounds=rounds)
    t_out = tsrv.run(to_torch(params), to_torch(state), rounds=rounds,
                     eval_fn=lambda p, s, st: evals.append(st) or 0.5,
                     eval_every=2)

    assert t_out["participation"] == j_out["participation"]
    np.testing.assert_allclose(t_out["virtual_time"], j_out["virtual_time"],
                               **CLOCK)
    assert len(trecs) == len(jrecs) == rounds
    for t, j in zip(trecs, jrecs):
        assert (t.round_idx, t.selected, t.dropped, t.policy, t.sequential,
                t.staleness, t.retries) == \
            (j.round_idx, [int(c) for c in j.selected], j.dropped, j.policy,
             j.sequential, j.staleness, j.retries)
        assert list(t.losses) == list(j.losses)
        np.testing.assert_allclose(list(t.losses.values()),
                                   list(j.losses.values()), **TOL)
        np.testing.assert_allclose([t.duration, t.t_end],
                                   [j.duration, j.t_end], **CLOCK)
    for jr, tr in zip(j_out["history"], t_out["history"]):
        assert (tr.round_idx, tr.stage, tr.uplink_bytes) == \
            (jr.round_idx, jr.stage, jr.uplink_bytes)
        np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
    assert evals == [1] * len(range(0, rounds, 2))
    assert [r.test_acc for r in t_out["history"]][::2] == [0.5] * len(evals)
    t_leaves = tree_leaves(t_out["params"]) + tree_leaves(t_out["state"])
    for a, b in zip(jax.tree.leaves((j_out["params"], j_out["state"])),
                    t_leaves):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    if name == "sync":
        assert t_out["participation"] == 0.75
        assert all(sorted(r.selected) == [0, 1, 2] for r in trecs)
    if name == "deadline":
        assert any(r.dropped for r in trecs)
        assert all(r.sequential for r in trecs if r.selected)
    if name == "async":
        assert any(v > 0 for r in trecs for v in r.staleness.values())
        assert any(r.retries for r in trecs)


def test_fedavg_without_eligible_clients_returns_at_once():
    clients = _clients(TVision, t_dirichlet, t_fleet)
    model = TCNN(TCfg(**CFG), device="cpu")
    params, state = model.init(torch.Generator().manual_seed(0))
    srv = TFedAvg(model, clients, device="cpu", mem_required=float("inf"),
                  **SRV)
    out = srv.run(params, state, rounds=3)
    assert out["participation"] == 0.0 and out["history"] == []
    assert out["params"] is params and out["virtual_time"] == 0.0


@pytest.mark.parametrize("kwargs", [dict(mesh=None), dict(faults=None),
                                    dict(screen_updates=True),
                                    dict(aggregator="mean"),
                                    dict(use_pallas=False)])
def test_unported_fedavg_arguments_raise(kwargs):
    """``mesh`` and ``use_pallas`` are not ported and raise. ``faults``,
    ``screen_updates`` and ``aggregator`` are: each is accepted, and a
    one-round run with it (on the sequential path, whose reference
    compiles once) matches the reference's."""
    if "mesh" in kwargs or "use_pallas" in kwargs:
        clients = _clients(TVision, t_dirichlet, t_fleet)
        with pytest.raises(TypeError):
            TFedAvg(TCNN(TCfg(**CFG), device="cpu"), clients, device="cpu",
                    **kwargs)
        return
    params, state = JCNN(JCfg(**CFG)).init(jax.random.PRNGKey(0))
    j_out = JFedAvg(JCNN(JCfg(**CFG)), _clients(JVision, j_dirichlet,
                                                 j_fleet),
                    use_pallas=False, fused=False, **kwargs,
                    **SRV).run(params, state, rounds=1)
    t_out = TFedAvg(TCNN(TCfg(**CFG), device="cpu"),
                    _clients(TVision, t_dirichlet, t_fleet), device="cpu",
                    fused=False, **kwargs, **SRV).run(
        to_torch(params), to_torch(state), rounds=1)
    (jr,), (tr,) = j_out["history"], t_out["history"]
    assert (tr.selected, tr.screened) == ([int(c) for c in jr.selected],
                                          jr.screened)
    np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
    for a, b in zip(jax.tree.leaves((j_out["params"], j_out["state"])),
                    tree_leaves(t_out["params"])
                    + tree_leaves(t_out["state"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


@pytest.mark.parametrize("kwargs", [
    dict(async_save=False, fused=False),
    dict(async_save=True, fused=True),
    dict(async_save=True, fused=True, compress_ratio=0.5)])
def test_unported_fedavg_run_arguments_raise(tmp_path, kwargs):
    """``run``'s checkpoint arguments: four rounds without a break equal
    two rounds checkpointed every round followed by a resume to four, bit
    for bit (selections from the restored rng stream, losses, params and
    BN state), on the sequential and the fused path, and with compressed
    uplinks whose error-feedback pools the resume carries."""
    from repro_torch.checkpoint import CheckpointManager
    mgr = CheckpointManager(str(tmp_path / "ck"),
                            async_save=kwargs.pop("async_save"))
    clients = _clients(TVision, t_dirichlet, t_fleet)
    model = TCNN(TCfg(**CFG), device="cpu")
    params, state = model.init(torch.Generator().manual_seed(0))

    def make():
        return TFedAvg(model, clients, device="cpu", **kwargs,
                       **dict(SRV, seed=4))
    out_a = make().run(params, state, rounds=4)
    srv_b = make()
    srv_b.run(params, state, rounds=2, ckpt_manager=mgr, ckpt_every=1)
    out_c = make().run(params, state, rounds=4, ckpt_manager=mgr,
                       resume=True)
    combined = srv_b.history + out_c["history"]
    assert len(combined) == 4
    for a, b in zip(out_a["history"], combined):
        assert (a.round_idx, a.selected, a.loss, a.virtual_time) == \
            (b.round_idx, b.selected, b.loss, b.virtual_time)
    assert out_c["virtual_time"] == out_a["virtual_time"]
    for a, b in zip(tree_leaves(out_a["params"]) + tree_leaves(out_a["state"]),
                    tree_leaves(out_c["params"]) + tree_leaves(out_c["state"])):
        assert torch.equal(a, b)
    if "compress_ratio" in kwargs:
        assert "ef" in mgr.restore(step=1)["tree"]
    # resuming a finished run trains nothing
    done = make().run(params, state, rounds=2, ckpt_manager=mgr,
                      resume=True)
    assert done["history"] == [] and done["virtual_time"] == \
        combined[1].virtual_time


# ---------------------------------------------------------------------------
# the host compression API
# ---------------------------------------------------------------------------


def _delta_trees(seed):
    """The same delta as a reference tree and a port tree: f32 leaves with
    magnitude ties (equal values and opposite signs), a bf16 leaf and a
    0-d leaf."""
    rng = np.random.RandomState(seed)
    tied = rng.choice([-0.5, 0.5, 0.25, -0.25, 0.0], size=(7, 9))
    tree = {"conv": {"w": rng.randn(3, 3, 4, 5).astype(np.float32)},
            "tied": tied.astype(np.float32),
            "scalar": np.float32(rng.randn()),
            "b": rng.randn(11).astype(np.float32)}
    bf = rng.randn(6, 10).astype(np.float32)
    j = dict(tree, bf16=jnp.asarray(bf, jnp.bfloat16))
    t = dict(to_torch(tree), bf16=torch.as_tensor(bf).to(torch.bfloat16))
    return jax.tree.map(jnp.asarray, j), t


@pytest.mark.parametrize("ratio", [0.01, 0.1, 0.37, 1.0])
def test_topk_payload_equals_reference_bitwise(ratio):
    jd, td = _delta_trees(0)
    jp, tp = jcomp.topk_compress(jd, ratio), tcomp.topk_compress(td, ratio)
    assert list(tp) == list(jp)
    for i in jp:
        (ji, jv, js), (ti, tv, ts) = jp[i], tp[i]
        assert ti.dtype == np.int32 and tv.dtype == np.float32
        np.testing.assert_array_equal(ti, ji)
        np.testing.assert_array_equal(tv, jv)
        assert ts == tuple(js)
        assert list(ti) == sorted(ti)
    assert tcomp.compressed_bytes(tp) == jcomp.compressed_bytes(jp)
    jt, tt = jcomp.topk_decompress(jp, jd), tcomp.topk_decompress(tp, td)
    for a, b, tmpl in zip(jax.tree.leaves(jt), tree_leaves(tt),
                          tree_leaves(td)):
        assert b.dtype == tmpl.dtype and b.device == tmpl.device
        np.testing.assert_array_equal(b.float().numpy(),
                                      np.asarray(a, np.float32))


def test_topk_ties_go_to_the_lower_index():
    flat = np.array([0.5, -0.5, 0.25, 0.5, -0.25, 0.0], np.float32)
    got = tcomp.deterministic_topk_indices(flat, 3)
    np.testing.assert_array_equal(got, jcomp.deterministic_topk_indices(
        flat, 3))
    np.testing.assert_array_equal(got, [0, 1, 3])
    np.testing.assert_array_equal(
        tcomp.deterministic_topk_indices(flat, 4), [0, 1, 2, 3])


def test_error_feedback_residuals_equal_reference_over_three_calls():
    jef, tef = jcomp.ErrorFeedback(ratio=0.1), tcomp.ErrorFeedback(ratio=0.1)
    for call in range(3):
        jd, td = _delta_trees(call + 1)
        jp, jdec = jef.compress(jd)
        tp, tdec = tef.compress(td)
        for i in jp:
            np.testing.assert_array_equal(tp[i][0], jp[i][0])
            np.testing.assert_array_equal(tp[i][1], jp[i][1])
        for a, b in zip(jax.tree.leaves(jdec), tree_leaves(tdec)):
            np.testing.assert_array_equal(b.float().numpy(),
                                          np.asarray(a, np.float32))
        for a, b in zip(jax.tree.leaves(jef._residual),
                        tree_leaves(tef._residual)):
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the residual carries what was not sent: it is never all zero here
    assert any(bool(r.any()) for r in tree_leaves(tef._residual))


# ---------------------------------------------------------------------------
# the exports
# ---------------------------------------------------------------------------


def test_fl_exports_level_with_reference():
    """Every public name of ``repro.fl`` but its submodules is exported by
    ``repro_torch.fl``, and ``baselines`` is a submodule of both."""
    import types
    import repro.fl.baselines  # noqa: F401
    import repro_torch.fl.baselines as tb
    names = {n for n in dir(jfl) if not n.startswith("_")
             and not isinstance(getattr(jfl, n), types.ModuleType)}
    assert names <= set(tfl.__all__), sorted(names - set(tfl.__all__))
    assert all(hasattr(tfl, n) for n in tfl.__all__)
    assert tfl.FedAvgServer is TFedAvg
    assert tfl.topk_compress is tcomp.topk_compress
    for n in ("run_allsmall", "run_exclusivefl", "run_depthfl",
              "run_heterofl", "run_tifl", "run_oort"):
        assert callable(getattr(tb, n))
    from repro_torch.fl import quant
    assert tfl.CACHE_TIERS == quant.CACHE_TIERS == jfl.CACHE_TIERS
    assert tfl.EncodedFeatures is quant.EncodedFeatures
