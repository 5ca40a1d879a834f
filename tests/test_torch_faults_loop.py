"""The aggregation policies' fault branches (``repro_torch.fl.sim``)
against the JAX package's, on the CPU.

  * the loop with stub hooks and a hand-built time model: under sync and
    deadline a crashed or hung client loses its update while its compute
    still counts toward the barrier, and the corruption kinds reach the
    hook as ``faults=``; under async a crash spends its slot, a hang
    completes only through the watchdog (or parks the tick without one),
    each retry draws its fault again, and the merge-time screen drops a
    non-finite delta. Every ``RoundRecord`` (selected, dropped, faults,
    staleness, retries, the clock) and every hook call equals the
    reference's; the merged model within rtol 1e-6;
  * ``FedAvgServer`` with compressed uplinks at ratio 1.0 (top-k keeps
    every entry, so no near-tie can flip) under crash and hang faults,
    sync (fused: B1 folds the survivors of a crashed round at K > 1) and
    async with a watchdog (K = 1), against
    ``repro.fl.server.FedAvgServer(use_pallas=False)``: records equal,
    losses, params and BN state rtol 1e-3, atol 1e-5.

Torch on one thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl import faults as jfaults
from repro.fl import sim as jsim
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.server import FedAvgServer as JFedAvg
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg

from repro_torch.convert import to_torch
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl import faults as tfaults
from repro_torch.fl import sim as tsim
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.server import FedAvgServer as TFedAvg
from repro_torch.kernels import ops as kernel_ops
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves, tree_map

CFG = dict(name="tiny", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
TOL = dict(rtol=1e-3, atol=1e-5)
CLOCK = dict(rtol=1e-6, atol=0)
PKG = {jsim: jfaults, tsim: tfaults}
TIMES = [1.0, 1.2, 0.9, 30.0, 1.1, 1.3, 50.0, 1.05]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the CPU convolutions' summation order follows the
    thread count (``tests/test_torch_policies_drift.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _time_model(pkg, times, jitter=0.2):
    return pkg.FleetTimeModel(np.arange(len(times)),
                              np.asarray(times, np.float32),
                              np.full(len(times), np.inf, np.float32),
                              jitter=jitter, seed=3)


def _same_records(tr, jr):
    assert len(tr) == len(jr)
    for t, j in zip(tr, jr):
        assert (t.round_idx, t.selected, t.dropped, t.policy, t.sequential,
                t.staleness, t.retries, t.faults) == \
            (j.round_idx, j.selected, j.dropped, j.policy, j.sequential,
             j.staleness, j.retries, j.faults)
        assert list(t.losses) == list(j.losses)
        np.testing.assert_allclose(list(t.losses.values()),
                                   list(j.losses.values()), rtol=1e-6)
        np.testing.assert_allclose([t.t_start, t.duration, t.t_end],
                                   [j.t_start, j.duration, j.t_end], **CLOCK)


# ---------------------------------------------------------------------------
# sync and deadline: crash and hang lose the update, charge the time
# ---------------------------------------------------------------------------


def _run_stub(pkg, policy, injector, k=6, rounds=6):
    calls = []

    def train_fn(cohort, r, sequential=None, faults=None):
        calls.append((list(cohort), r, sequential, faults))
        return {c: 0.1 * c + r for c in cohort}

    loop = pkg.FederatedLoop(
        select_fn=lambda r, avail: [c for c in avail if (c + r) % 4][:k],
        train_fn=train_fn, client_ids=list(range(len(TIMES))),
        aggregation=policy, time_model=_time_model(pkg, TIMES),
        faults=injector)
    return loop.run(rounds), calls, loop.clock


@pytest.mark.parametrize("policy,p,kinds,seed", [
    ("sync", 1.0, ("crash",), 0),
    ("sync", 0.5, ("nan", "crash", "hang", "signflip"), 4),
    ("deadline", 0.5, ("crash", "hang", "amplify"), 1),
    ("deadline", 1.0, ("hang",), 0)])
def test_sync_and_deadline_fault_records_equal_reference(policy, p, kinds,
                                                         seed):
    out = {}
    for pkg in (jsim, tsim):
        pol = (pkg.SyncAggregation() if policy == "sync"
               else pkg.DeadlineAggregation(factor=1.5))
        out[pkg] = _run_stub(pkg, pol, PKG[pkg].FaultInjector(
            p_fault=p, kinds=kinds, seed=seed))
    (jr, jcalls, jclock), (tr, tcalls, tclock) = out[jsim], out[tsim]
    _same_records(tr, jr)
    assert tcalls == jcalls
    np.testing.assert_allclose(tclock, jclock, **CLOCK)
    crashed = [c for r in tr for c, k in r.faults.items()
               if k in ("crash", "hang")]
    assert crashed
    for r in tr:
        # a crashed client is dropped, its update never trained, its
        # compute charged: the round lasts at least its completion time
        lost = [c for c, k in r.faults.items() if k in ("crash", "hang")]
        assert set(lost) <= set(r.dropped)
        assert not set(lost) & set(r.selected)
        assert not any(set(lost) & set(cohort) for cohort, rr, _, _ in tcalls
                       if rr == r.round_idx)
        if lost and policy == "sync":
            t = _time_model(tsim, TIMES).cohort_times(lost, r.round_idx)
            assert r.duration >= max(t.values())
    if p == 1.0:
        assert not tcalls and all(not r.selected for r in tr)
    if "nan" in kinds or "amplify" in kinds:
        assert any(f for _, _, _, f in tcalls)


# ---------------------------------------------------------------------------
# async: crash, hang, watchdog, retries, the merge-time screen
# ---------------------------------------------------------------------------


def _run_async(pkg, policy, injector, times=TIMES, rounds=6):
    conv = jnp.asarray if pkg is jsim else torch.as_tensor
    fmap = jax.tree.map if pkg is jsim else tree_map
    rng = np.random.RandomState(0)
    box = {"p": fmap(conv, {"a": rng.randn(5).astype(np.float32),
                            "b": {"w": rng.randn(2, 3).astype(np.float32)}}),
           "s": fmap(conv, {"m": rng.rand(4).astype(np.float32)})}

    def train_one(cid, p, s, r):
        return (fmap(lambda a: a * 0.9 + 0.01 * (cid + 1) + 0.001 * r, p),
                fmap(lambda a: a * 0.5 + cid, s), 0.1 * cid + r)

    loop = pkg.FederatedLoop(
        select_fn=lambda r, avail: sorted(avail, key=lambda c: (7 * c + r)
                                          % len(times))[:5],
        train_fn=None, client_ids=list(range(len(times))),
        clients={c: type("C", (), {"num_samples": 10 + 3 * c})()
                 for c in range(len(times))},
        aggregation=policy, time_model=_time_model(pkg, times, 0.0),
        faults=injector,
        snapshot_fn=lambda: (box["p"], box["s"]), train_one_fn=train_one,
        get_model_fn=lambda: (box["p"], box["s"]),
        set_model_fn=lambda p, s: box.update(p=p, s=s))
    recs = loop.run(rounds)
    leaves = ([np.asarray(x) for x in jax.tree.leaves((box["p"], box["s"]))]
              if pkg is jsim else
              [t.numpy() for t in tree_leaves(box["p"]) + tree_leaves(
                  box["s"])])
    return recs, leaves, loop.async_state["version"], loop.clock


@pytest.mark.parametrize("kw,p,kinds,seed", [
    (dict(buffer_size=2, concurrency=3, timeout_s=5.0, max_retries=1),
     1.0, ("hang",), 3),
    (dict(buffer_size=2, concurrency=4, timeout_s=10.0, max_retries=2),
     0.5, ("hang", "crash", "nan", "amplify", "signflip"), 3),
    (dict(buffer_size=2, concurrency=4), 0.4, ("crash", "inf"), 0),
    (dict(buffer_size=1, concurrency=3), 1.0, ("nan",), 0),
    (dict(buffer_size=2, concurrency=3), 0.5, ("hang",), 0)],
    ids=["hang, watchdog", "every kind, watchdog", "crash and inf",
         "merge-time screen", "hang parks the tick"])
def test_async_fault_records_equal_reference(kw, p, kinds, seed):
    out = {}
    for pkg in (jsim, tsim):
        out[pkg] = _run_async(pkg, pkg.AsyncBufferedAggregation(**kw),
                              PKG[pkg].FaultInjector(p_fault=p, kinds=kinds,
                                                     seed=seed))
    (jr, jl, jv, jclock), (tr, tl, tv, tclock) = out[jsim], out[tsim]
    _same_records(tr, jr)
    assert tv == jv
    np.testing.assert_allclose(tclock, jclock, **CLOCK)
    assert np.isfinite(tclock)
    for a, b in zip(jl, tl):
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    faulted = {k for r in tr for k in r.faults.values()}
    if "timeout_s" in kw and "hang" in kinds:
        assert any(r.retries for r in tr)
    if kinds == ("nan",):
        # every completion screened at merge: nothing merged, NaN losses
        assert tv == 0 and all(not r.selected and r.dropped for r in tr)
        assert all(np.isnan(v) for r in tr for v in r.losses.values())
    if "timeout_s" not in kw and "hang" in kinds:
        # a parked hang: some tick returned short of its buffer
        assert any(len(r.selected) < kw["buffer_size"] for r in tr)
    if "crash" in kinds:
        assert "crash" in faulted


# ---------------------------------------------------------------------------
# FedAvgServer: B1 folds the survivors of a crashed compressed round
# ---------------------------------------------------------------------------


def _clients(vision, dirichlet, fleet):
    train = vision(num_classes=4, image_size=16, seed=0).sample(256, seed=1)
    clients = fleet(train, dirichlet(train["y"], 4, alpha=1.0, seed=0),
                    scenario="low", seed=0)
    clients[0].capability /= 20.0   # a straggler, 20x slower
    return clients


def _recorded(monkeypatch, cls):
    out, tick = [], cls.tick
    monkeypatch.setattr(cls, "tick", lambda self, loop, r: out.append(
        tick(self, loop, r)) or out[-1])
    return out


@pytest.mark.parametrize("policy", ["sync", "async"])
def test_fedavg_crash_and_hang_compressed_matches_reference(monkeypatch,
                                                            policy):
    folds = []
    fold = kernel_ops.sparse_cohort_add
    monkeypatch.setattr(kernel_ops, "sparse_cohort_add",
                        lambda idx, *a, **kw: folds.append(idx.shape[0])
                        or fold(idx, *a, **kw))
    jclients = _clients(JVision, j_dirichlet, j_fleet)
    tclients = _clients(TVision, t_dirichlet, t_fleet)
    times = sorted(c.num_samples / c.capability for c in tclients)
    kw = {}
    for pkg in (jsim, tsim):
        kw[pkg] = dict(compress_ratio=1.0, clients_per_round=4,
                       batch_size=16, seed=0,
                       faults=PKG[pkg].FaultInjector(
                           p_fault=0.4, kinds=("crash", "hang"), seed=6))
        if policy == "async":
            kw[pkg]["aggregation"] = pkg.AsyncBufferedAggregation(
                buffer_size=2, concurrency=3, timeout_s=times[1],
                max_retries=2)
    cls = "AsyncBufferedAggregation" if policy == "async" else \
        "SyncAggregation"
    jrecs = _recorded(monkeypatch, getattr(jsim, cls))
    trecs = _recorded(monkeypatch, getattr(tsim, cls))
    params, state = JCNN(JCfg(**CFG)).init(jax.random.PRNGKey(0))
    j_out = JFedAvg(JCNN(JCfg(**CFG)), jclients, use_pallas=False,
                    **kw[jsim]).run(params, state, rounds=3)
    t_out = TFedAvg(TCNN(TCfg(**CFG), device="cpu"), tclients, device="cpu",
                    **kw[tsim]).run(to_torch(params), to_torch(state),
                                    rounds=3)
    assert len(trecs) == len(jrecs) == 3
    for t, j in zip(trecs, jrecs):
        assert (t.selected, t.dropped, t.faults, t.staleness, t.retries) == \
            ([int(c) for c in j.selected], [int(c) for c in j.dropped],
             {int(c): k for c, k in j.faults.items()}, j.staleness,
             j.retries)
        np.testing.assert_allclose(list(t.losses.values()),
                                   list(j.losses.values()), **TOL)
        np.testing.assert_allclose([t.duration, t.t_end],
                                   [j.duration, j.t_end], **CLOCK)
    for a, b in zip(jax.tree.leaves((j_out["params"], j_out["state"])),
                    tree_leaves(t_out["params"])
                    + tree_leaves(t_out["state"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    assert any(r.faults for r in trecs)
    leaves = len(tree_leaves(t_out["params"]))
    if policy == "sync":
        # one fold a leaf a round with survivors, over exactly them
        crashed = [r for r in trecs if r.faults and r.selected]
        assert any(len(r.selected) > 1 for r in crashed)
        assert folds == [len(r.selected) for r in trecs if r.selected
                         for _ in range(leaves)]
    else:
        assert any(r.retries for r in trecs)
        assert set(folds) == {1}
        assert len(folds) == leaves * sum(len(r.selected) for r in trecs)
