"""The port's aggregation policies, availability traces and the engine's
sequential escape hatch against the JAX package's, on the CPU.

Three levels:
  * the loop, with stub hooks and a hand-built time model: availability
    draws bit for bit; deadline and sync records (selected, dropped,
    duration, t_end, sequential) and the hooks' calls equal; async records
    (staleness, retries, dropped) equal, its merge arithmetic within rtol
    1e-6 (f32 products and sums in the same order);
  * the engine: ``run_round(sequential=True)`` against the reference's,
    plain, compressed at ratio 1.0 (top-k keeps every entry, so no near-tie
    can flip between the packages), with f32 / fp16 / int8 tier groups, in
    f32 and in bf16; params, BN state and losses rtol 1e-3, atol 1e-5 in
    f32. In bf16 the two packages' convolutions round at other places (one
    bf16 rounding is 2^-8 relative), so a bf16 round holds the reference at
    ``tests/test_torch_quant.py``'s bf16 tolerance, rtol 2e-2, atol 2e-3,
    and the port's own fused bf16 round within rtol 1e-6;
  * the server: two-stage trajectories under deadline with availability
    and under async, against ``repro.fl.server.SmartFreezeServer(
    use_pallas=False)``; the loop's records (selected, dropped, staleness,
    retries, sequential) equal, losses and params rtol 1e-3, atol 1e-5, the
    virtual clock rtol 1e-6. As in ``tests/test_torch_server.py``, the
    Eq. 8 similarity and each stage's output module come from the
    reference. One trajectory (the absolute deadline over availability
    seed 0) drifts past that tolerance in one element of 1,152 when run
    free: a ReLU input within the convolution's f32 rounding of zero flips
    in round 1, and a one-client stage-1 round amplifies the 3e-6 stage-0
    difference it leaves, as it does in the reference itself
    (``tests/test_torch_policies_drift.py``); its every round is held
    instead from the reference's own inputs.

The port's own claims (the dispatched bases are never written in place,
the sequential path's residual rows are the fused path's, the reference's
``tests/test_sim.py`` cases) run on the port alone."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freezing_cnn as jfz
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl import sim as jsim
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.engine import RoundEngine as JEngine
from repro.fl.faults import hash_draws as j_hash_draws
from repro.fl.server import SmartFreezeServer as JServer
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
from repro.optim import sgd as j_sgd

import repro_torch.core.freezing_cnn as tfz
from repro_torch.convert import to_numpy, to_torch
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl import sim as tsim
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.engine import RoundEngine as TEngine, weighted_avg
from repro_torch.fl.server import SmartFreezeServer as TServer
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves, tree_map
from repro_torch.optim import sgd as t_sgd

CFG = dict(name="tiny", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
TOL = dict(rtol=1e-3, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-3)
CLOCK = dict(rtol=1e-6, atol=0)
MIXED = {2: "int8", 0: "f32", 4: None, 3: "fp16", 1: "int8", 5: "fp16"}


# ---------------------------------------------------------------------------
# the loop: availability, deadline, sync and async with stub hooks
# ---------------------------------------------------------------------------


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread. The port's CPU work in this file is small ops,
    and in a parallel run of the suite every pytest worker's torch pool
    spinning over all the cores oversubscribes them: in such a run a test
    whose port work takes 1.5 s alone took 167 s. The results do not
    depend on it beyond the stated tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed,round_idx,ids", [
    (0, 0, range(40)), (5, 3, range(40)), (7, 123456, [3, 1, 2, 99, 5]),
    (2 ** 40 + 3, 2 ** 62 + 11, range(10_000, 10_064)),
    (1, 2, [2 ** 63 + 5, 2 ** 64 - 1])])
def test_hash_draws_equal_reference_bitwise(seed, round_idx, ids):
    got = tsim.hash_draws(seed, round_idx, list(ids))
    want = j_hash_draws(seed, round_idx, list(ids))
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("p_avail,p_drop,seed", [
    (0.5, 0.3, 5), (1.0, 0.0, 0), (0.9, 0.1, 0), (0.15, 1.0, 2),
    (0.0, 0.5, 1)])
def test_availability_trace_equals_reference(p_avail, p_drop, seed):
    """The reference's ``test_availability_trace_replayable`` for the port,
    with every draw equal to the reference's."""
    t = tsim.AvailabilityTrace(p_available=p_avail, p_dropout=p_drop,
                               seed=seed)
    j = jsim.AvailabilityTrace(p_available=p_avail, p_dropout=p_drop,
                               seed=seed)
    ids = list(range(40))
    for r in range(6):
        assert t.available(ids, r) == j.available(ids, r)
        assert t.dropouts(ids, r) == j.dropouts(ids, r)
        assert t.available(ids[::-1], r) == j.available(ids[::-1], r)
    assert t.available(ids, 3) == t.available(ids, 3)
    if 0.0 < p_avail < 1.0:
        assert t.available(ids, 3) != t.available(ids, 4)
        assert 0 < len(t.available(ids, 3)) < 40


def _time_models(compute, jitter=0.0):
    ids = np.arange(len(compute))
    rate = np.full(len(compute), np.inf, np.float32)
    compute = np.asarray(compute, np.float32)
    return (jsim.FleetTimeModel(ids, compute, rate, jitter=jitter, seed=3),
            tsim.FleetTimeModel(ids, compute, rate, jitter=jitter, seed=3))


# fast clients near 1 s, stragglers far past any 1.5x median deadline
TIMES = [1.0, 1.2, 0.9, 30.0, 1.1, 1.3, 50.0, 1.05]
# more than half of the fleet straggles: the relative trim does not apply
MOSTLY_SLOW = [1.0, 30.0, 0.9, 30.0, 40.0, 1.3, 50.0, 60.0]


def _select(k):
    return lambda r, avail: [c for c in avail if (c + r) % 4 != 0][:k]


def _run_stub(pkg, policy, times, k, availability=None, rounds=6):
    calls = []

    def train_fn(cohort, r, sequential=None):
        calls.append((list(cohort), r, sequential))
        return {c: 0.1 * c + r for c in cohort}

    tm = _time_models(times, jitter=0.2)[pkg is tsim]
    loop = pkg.FederatedLoop(select_fn=_select(k), train_fn=train_fn,
                             client_ids=list(range(len(times))),
                             aggregation=policy, time_model=tm,
                             availability=availability)
    return loop.run(rounds), calls, loop.clock


def _same_records(tr, jr, loss_tol=None):
    assert len(tr) == len(jr)
    for t, j in zip(tr, jr):
        assert (t.round_idx, t.selected, t.dropped, t.policy, t.sequential,
                t.staleness, t.retries) == \
            (j.round_idx, j.selected, j.dropped, j.policy, j.sequential,
             j.staleness, j.retries)
        if loss_tol is None:
            assert t.losses == j.losses
        else:
            assert list(t.losses) == list(j.losses)
            np.testing.assert_allclose(list(t.losses.values()),
                                       list(j.losses.values()), **loss_tol)
        np.testing.assert_allclose([t.t_start, t.duration, t.t_end],
                                   [j.t_start, j.duration, j.t_end], **CLOCK)


@pytest.mark.parametrize("policy,times,k,avail", [
    ("relative trim", TIMES, 6, None),
    ("relative, trim not applied", MOSTLY_SLOW, 6, None),
    ("relative, min_keep 5", TIMES, 6, None),
    ("relative, cohort of 2", TIMES, 2, None),
    ("absolute, cohort of 2", TIMES, 2, None),
    ("absolute, everyone late", TIMES, 6, None),
    ("relative with availability", TIMES, 6, (0.8, 0.25, 3)),
    ("absolute with availability", TIMES, 3, (0.7, 0.3, 1)),
    ("sync with availability", TIMES, 6, (0.8, 0.25, 3)),
    ("sync, everyone drops", TIMES, 4, (1.0, 1.0, 0))])
def test_deadline_and_sync_records_equal_reference(policy, times, k, avail):
    kw = {"relative trim": dict(factor=1.5),
          "relative, trim not applied": dict(factor=1.5),
          "relative, min_keep 5": dict(factor=1.5, min_keep=5),
          "relative, cohort of 2": dict(factor=1.5),
          "absolute, cohort of 2": dict(deadline_s=5.0),
          "absolute, everyone late": dict(deadline_s=0.5),
          "relative with availability": dict(factor=1.5),
          "absolute with availability": dict(deadline_s=5.0)}.get(policy)
    out = {}
    for pkg in (jsim, tsim):
        pol = (pkg.DeadlineAggregation(**kw) if kw is not None
               else pkg.SyncAggregation())
        trace = None if avail is None else pkg.AvailabilityTrace(*avail)
        out[pkg] = _run_stub(pkg, pol, times, k, trace)
    (jr, jcalls, jclock), (tr, tcalls, tclock) = out[jsim], out[tsim]
    _same_records(tr, jr)
    assert tcalls == jcalls
    np.testing.assert_allclose(tclock, jclock, **CLOCK)
    if policy == "absolute, everyone late":
        assert not tcalls
        assert all(r.selected == [] and r.dropped and r.duration == 0.5
                   and r.sequential for r in tr)
    if policy == "relative trim":
        assert any(r.dropped for r in tr) and all(r.sequential for r in tr)
    if policy == "sync, everyone drops":
        assert all(r.selected == [] and r.duration == 0.0 for r in tr)


def _stub_model(pkg):
    rng = np.random.RandomState(0)
    p = {"a": rng.randn(5).astype(np.float32),
         "b": {"w": rng.randn(2, 3).astype(np.float32)}}
    s = {"m": rng.rand(4).astype(np.float32)}
    conv = jnp.asarray if pkg is jsim else torch.as_tensor
    fmap = jax.tree.map if pkg is jsim else tree_map
    return fmap(conv, p), fmap(conv, s), fmap


def _run_async(pkg, policy, times, availability, rounds=6):
    p0, s0, fmap = _stub_model(pkg)
    box = {"p": p0, "s": s0}

    def train_one(cid, p, s, r):
        return (fmap(lambda a: a * 0.9 + 0.01 * (cid + 1) + 0.001 * r, p),
                fmap(lambda a: a * 0.5 + cid, s), 0.1 * cid + r)

    tm = _time_models(times)[pkg is tsim]
    loop = pkg.FederatedLoop(
        select_fn=lambda r, avail: sorted(avail, key=lambda c: (7 * c + r)
                                          % len(times))[:5],
        train_fn=None, client_ids=list(range(len(times))),
        clients={c: type("C", (), {"num_samples": 10 + 3 * c})()
                 for c in range(len(times))},
        aggregation=policy, time_model=tm, availability=availability,
        snapshot_fn=lambda: (box["p"], box["s"]), train_one_fn=train_one,
        get_model_fn=lambda: (box["p"], box["s"]),
        set_model_fn=lambda p, s: box.update(p=p, s=s))
    recs = loop.run(rounds)
    leaves = [np.asarray(x) for x in (jax.tree.leaves((box["p"], box["s"]))
                                      if pkg is jsim else
                                      tree_leaves(box["p"])
                                      + tree_leaves(box["s"]))]
    return recs, leaves, loop.async_state["version"], loop.clock


FIB = [1.0, 2.0, 3.0, 5.0, 8.0, 13.0, 21.0, 34.0]


@pytest.mark.parametrize("kw,avail", [
    (dict(buffer_size=2, concurrency=4), None),
    (dict(buffer_size=1, concurrency=1), None),
    (dict(buffer_size=3, concurrency=6, staleness_power=1.0), (0.8, 0.0, 4)),
    (dict(buffer_size=2, concurrency=4, timeout_s=10.0), None),
    (dict(buffer_size=2, concurrency=5, timeout_s=10.0, max_retries=1),
     None),
    (dict(buffer_size=2, concurrency=4, timeout_s=4.0, max_retries=0,
          retry_backoff=3.0), (0.9, 0.0, 2))],
    ids=["buffer 2", "buffer 1", "availability", "watchdog",
         "watchdog drops", "watchdog, no retries"])
def test_async_records_equal_reference(kw, avail):
    out = {}
    for pkg in (jsim, tsim):
        trace = None if avail is None else pkg.AvailabilityTrace(*avail)
        out[pkg] = _run_async(pkg, pkg.AsyncBufferedAggregation(**kw), FIB,
                              trace)
    (jr, jl, jv, jclock), (tr, tl, tv, tclock) = out[jsim], out[tsim]
    _same_records(tr, jr)
    assert tv == jv
    np.testing.assert_allclose(tclock, jclock, **CLOCK)
    for a, b in zip(jl, tl):
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=0)
    if "timeout_s" in kw:
        assert any(r.retries or r.dropped for r in tr)
    if kw["concurrency"] > kw["buffer_size"]:
        assert any(v > 0 for r in tr for v in r.staleness.values())


@pytest.mark.parametrize("name", ["sync", "deadline", "async",
                                  "async-buffered", "fedbuff"])
def test_resolve_policy_equals_reference(name):
    try:
        want = type(jsim.resolve_policy(name)).__name__
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tsim.resolve_policy(name)
        assert str(got.value) == str(e)
        return
    assert type(tsim.resolve_policy(name)).__name__ == want
    pol = tsim.DeadlineAggregation(factor=3.0)
    assert tsim.resolve_policy(pol) is pol


@pytest.mark.parametrize("kw", [dict(faults=None), dict(mesh=None)])
def test_loop_rejects_unported_arguments(kw):
    """The client mesh is not ported: the loop raises rather than ignoring
    it. Fault injection is ported: ``faults`` is accepted, and a one-round
    run with it records what the reference's does."""
    if "mesh" in kw:
        with pytest.raises(TypeError):
            tsim.FederatedLoop(select_fn=lambda r, a: a, client_ids=[0],
                               **kw)
        return
    recs = {pkg: pkg.FederatedLoop(
        select_fn=lambda r, a: a,
        train_fn=lambda cohort, r, sequential=None: {c: 0.5 for c in cohort},
        client_ids=[0, 1], **kw).run(1) for pkg in (jsim, tsim)}
    _same_records(recs[tsim], recs[jsim])
    assert recs[tsim][0].faults == {}


def test_async_needs_the_model_hooks():
    loop = tsim.FederatedLoop(select_fn=lambda r, a: a, train_fn=None,
                              client_ids=[0, 1], aggregation="async")
    with pytest.raises(ValueError, match="hooks"):
        loop.run(1)


# ---------------------------------------------------------------------------
# the engine's sequential escape hatch
# ---------------------------------------------------------------------------


def _worlds(n=600, k=6):
    out = []
    for vision, dirichlet, fleet in ((JVision, j_dirichlet, j_fleet),
                                     (TVision, t_dirichlet, t_fleet)):
        train = vision(num_classes=4, image_size=16, seed=0).sample(n, seed=1)
        parts = dirichlet(train["y"], k, alpha=1.0, seed=0)
        out.append({c.client_id: c for c in fleet(train, parts,
                                                  scenario="low", seed=0)})
    return out


@functools.lru_cache(maxsize=None)
def _reference_init():
    """The reference's initial params and BN state (immutable jax arrays,
    built once: their eager init dominates a small test's time)."""
    return JCNN(JCfg(**CFG)).init(jax.random.PRNGKey(0))


def _engine_pair(stage, compute_dtype=None, compress_ratio=None):
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = _reference_init()
    frozen, active = jfz.init_cnn_stage_active(jm, params, stage,
                                               jax.random.PRNGKey(1))
    kw = dict(batch_size=32, local_epochs=1, compute_dtype=compute_dtype,
              compress_ratio=compress_ratio)
    t_frozen, t_state = to_torch(frozen), to_torch(state)
    jc = tc = {}
    if stage > 0:
        jc = dict(cached_loss_fn=jfz.cnn_cached_stage_loss_fn(jm, stage),
                  feature_fn=lambda x: jfz.cnn_prefix_features(
                      jm, frozen, state, x, stage))
        tc = dict(cached_loss_fn=tfz.cnn_cached_stage_loss_fn(tm, stage),
                  feature_fn=lambda x: tfz.cnn_prefix_features(
                      tm, t_frozen, t_state, x, stage))
    je = JEngine(loss_fn=jfz.cnn_stage_loss_fn(jm, stage),
                 optimizer=j_sgd(0.05), frozen=frozen, use_pallas=False,
                 **jc, **kw)
    te = TEngine(loss_fn=tfz.cnn_stage_loss_fn(tm, stage),
                 optimizer=t_sgd(0.05), frozen=t_frozen, device="cpu",
                 **tc, **kw)
    return je, te, (active, state), (to_torch(active), t_state)


def _close_trees(j_tree, t_tree, tol=TOL):
    lj, lt = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.detach().numpy(),
                                   np.asarray(a, np.float32), **tol)


@pytest.mark.parametrize("stage,ratio,cdt,use_cache", [
    (0, None, None, None),
    (0, 1.0, None, None),
    (1, None, None, MIXED),
    (1, 1.0, None, MIXED),
    (1, None, "bfloat16", {c: None for c in range(4)}),
    (1, None, "bfloat16", MIXED)],
    ids=["plain", "compressed", "tiers", "tiers compressed", "bf16",
         "bf16 tiers"])
def test_sequential_round_matches_reference(stage, ratio, cdt, use_cache):
    """Two sequential rounds: each client alone from the round-start params
    with a fresh optimizer state; with compression each client's leaves go
    through the K = 1 fold with its own residual row."""
    jby, tby = _worlds()
    je, te, (ja, js), (ta, ts) = _engine_pair(stage, cdt, ratio)
    tol = TOL if cdt is None else BF16
    sel = list(use_cache) if use_cache else [3, 0, 5, 1]
    for r in range(2):
        ja, js, jl = je.run_round(jby, sel, ja, js, r, use_cache=use_cache,
                                  sequential=True)
        t_in = (ta, ts)
        ta, ts, tl = te.run_round(tby, sel, ta, ts, r, use_cache=use_cache,
                                  sequential=True)
        assert list(tl) == list(jl)
        np.testing.assert_allclose([tl[c] for c in jl], [jl[c] for c in jl],
                                   **tol)
        _close_trees(ja, ta, tol)
        _close_trees(js, ts, tol)
        assert te.last_uplink_bytes == je.last_uplink_bytes
        if cdt is not None:
            # the same local step as the port's fused round
            fp, fs, fl = te.run_round(tby, sel, *t_in, r,
                                      use_cache=use_cache, sequential=False)
            np.testing.assert_allclose([tl[c] for c in fl],
                                       list(fl.values()), rtol=1e-6)
            for a, b in zip(tree_leaves(ta) + tree_leaves(ts),
                            tree_leaves(fp) + tree_leaves(fs)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                           atol=1e-7)
    if use_cache:
        assert te.cache_tiers() == je.cache_tiers()
    if ratio is not None:
        assert te._res_row == je._res_row
        for a, b in zip(je._res_pool, te._res_pool):
            np.testing.assert_allclose(b.numpy()[:len(te._res_row)],
                                       np.asarray(a)[:len(je._res_row)],
                                       **TOL)


def test_fused_false_engine_runs_sequential_and_matches_reference():
    """``RoundEngine(fused=False)`` sends a round with ``sequential=None``
    to the escape hatch, as the reference's does."""
    jby, tby = _worlds()
    je, te, (ja, js), (ta, ts) = _engine_pair(0)
    je.fused = te.fused = False
    calls = []
    run_seq = te._run_sequential
    te._run_sequential = lambda *a, **k: calls.append(1) or run_seq(*a, **k)
    jp, jst, jl = je.run_round(jby, [0, 2], ja, js, 0)
    tp, tst, tl = te.run_round(tby, [0, 2], ta, ts, 0)
    assert calls == [1]
    np.testing.assert_allclose([tl[c] for c in jl], [jl[c] for c in jl],
                               **TOL)
    _close_trees(jp, tp)
    _close_trees(jst, tst)


def test_sequential_residual_rows_equal_fused_rows():
    """At ratio 0.1 a client's top-k, its residual row and the sent entries
    are the same on both paths of the port (the K = 1 fold is the fused
    fold's row), and the two aggregates agree."""
    _, tby = _worlds()
    _, te_f, _, (ta, ts) = _engine_pair(0, compress_ratio=0.1)
    _, te_s, _, _ = _engine_pair(0, compress_ratio=0.1)
    pf, ps = ta, ta
    for r in range(2):
        pf, _, lf = te_f.run_round(tby, [1, 4, 2], pf, ts, r,
                                   sequential=False)
        ps, _, ls = te_s.run_round(tby, [1, 4, 2], ps, ts, r,
                                   sequential=True)
        np.testing.assert_allclose(list(ls.values()), list(lf.values()),
                                   rtol=1e-6)
        for a, b in zip(tree_leaves(pf), tree_leaves(ps)):
            np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-5,
                                       atol=1e-6)
        if r == 0:
            rows = len(te_f._res_row)
            for a, b in zip(te_f._res_pool, te_s._res_pool):
                assert torch.equal(a[:rows], b[:rows])
    assert te_f._res_row == te_s._res_row


def test_staleness_weight_cancels_for_one_client():
    """The reference's ``test_async_staleness_weight_formula``: a buffer of
    one with one client in flight merges at staleness 0, so the merged
    params are the client's own trained params."""
    _, tby = _worlds()
    _, te, _, (ta, ts) = _engine_pair(0)
    p_i, _, _ = te.run_round(tby, [2], ta, ts, 0, sequential=True)
    box = {"p": ta, "s": ts}
    loop = tsim.FederatedLoop(
        select_fn=lambda r, avail: [2], train_fn=None, clients=tby,
        aggregation=tsim.AsyncBufferedAggregation(buffer_size=1,
                                                  concurrency=1),
        snapshot_fn=lambda: (box["p"], box["s"]),
        train_one_fn=lambda c, p, s, r: te.run_round(
            tby, [c], p, s, r, sequential=True)[:2] + (0.0,),
        get_model_fn=lambda: (box["p"], box["s"]),
        set_model_fn=lambda p, s: box.update(p=p, s=s))
    rec, = loop.run(1)
    assert rec.staleness == {2: 0}
    for a, b in zip(tree_leaves(box["p"]), tree_leaves(p_i)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-6)


def test_deadline_round_equals_hand_masked_eq1():
    """The reference's ``test_deadline_partial_agg_equals_hand_masked_eq1``
    for the port: a deadline round through the loop and the engine equals
    Eq. 1 computed by hand over exactly the finishing cohort."""
    _, tby = _worlds()
    _, te, _, (ta, ts) = _engine_pair(0)
    for c in tby.values():
        c.capability = 1e7 if c.client_id in (0, 1) else 1e9
    box = {"p": ta, "s": ts}

    def train_fn(cohort, r, sequential=None):
        box["p"], box["s"], losses = te.run_round(
            tby, cohort, box["p"], box["s"], r, sequential=sequential)
        return losses

    loop = tsim.FederatedLoop(select_fn=lambda r, avail: avail,
                              train_fn=train_fn, clients=tby,
                              aggregation=tsim.DeadlineAggregation(factor=2.0))
    rec, = loop.run(1)
    assert sorted(rec.dropped) == [0, 1] and rec.sequential
    ups = [te.run_round(tby, [c], ta, ts, 0, sequential=True)
           for c in rec.selected]
    w = np.asarray([tby[c].num_samples for c in rec.selected], np.float64)
    w /= w.sum()
    for got, want in ((box["p"], weighted_avg([u[0] for u in ups], w)),
                      (box["s"], weighted_avg([u[1] for u in ups], w))):
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-5,
                                       atol=2e-5)
    times = loop.time_model.cohort_times(list(tby), 0)
    assert rec.duration < max(times.values())


# ---------------------------------------------------------------------------
# the server: two-stage trajectories against the reference
# ---------------------------------------------------------------------------


SRV = dict(clients_per_round=3, batch_size=16, compress_ratio=1.0, seed=0)


def _server_data(vision, dirichlet, fleet):
    train = vision(num_classes=4, image_size=16, seed=0).sample(256, seed=1)
    clients = fleet(train, dirichlet(train["y"], 4, alpha=1.0, seed=0),
                    scenario="low", seed=0)
    clients[0].capability /= 20.0   # a straggler, 20x slower
    return clients


def _policy(name, clients):
    """(policy factory over a package's ``sim``, availability args)."""
    times = sorted(c.num_samples / c.capability for c in clients)
    if name == "deadline relative":
        return (lambda m: m.DeadlineAggregation(factor=1.5)), (0.9, 0.25, 0)
    if name.startswith("deadline absolute"):
        seed = 0 if name.endswith("seed 0") else 2
        return (lambda m: m.DeadlineAggregation(
            deadline_s=(times[-1] + times[-2]) / 2)), (0.9, 0.25, seed)
    if name == "async":
        return (lambda m: m.AsyncBufferedAggregation(
            buffer_size=2, concurrency=3)), None
    return (lambda m: m.AsyncBufferedAggregation(
        buffer_size=2, concurrency=3, timeout_s=times[1],
        max_retries=1)), None


def _server_pair(monkeypatch, name):
    """Both servers on the same fleet and policy; the port's similarity and
    output modules are the reference's. Every tick's ``RoundRecord`` is
    kept, per package."""
    jclients = _server_data(JVision, j_dirichlet, j_fleet)
    tclients = _server_data(TVision, t_dirichlet, t_fleet)
    make, avail = _policy(name, tclients)
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = _reference_init()
    records = {}
    for pkg in (jsim, tsim):
        pol = make(pkg)
        tick, out = type(pol).tick, records.setdefault(pkg, [])
        monkeypatch.setattr(type(pol), "tick", lambda self, loop, r, _t=tick,
                            _o=out: _o.append(_t(self, loop, r)) or _o[-1])
        records[pkg, "srv"] = dict(
            aggregation=pol,
            availability=avail and pkg.AvailabilityTrace(*avail))
    jsrv = JServer(jm, jclients, use_pallas=False, **records[jsim, "srv"],
                   **SRV)
    tsrv = TServer(tm, tclients, device="cpu", **records[tsim, "srv"], **SRV)
    j_sim = jsrv.bootstrap_similarity(params, state)
    monkeypatch.setattr(tsrv, "bootstrap_similarity", lambda p, s: j_sim)
    j_ops = {s: jfz.init_cnn_stage_active(jm, params, s,
                                          jax.random.PRNGKey(SRV["seed"] + s)
                                          )[1].get("op") for s in range(2)}
    port_init = tfz.init_cnn_stage_active

    def init_with_reference_op(model, p, stage, generator, **kw):
        frozen, active = port_init(model, p, stage, generator, **kw)
        if "op" in active:
            active["op"] = to_torch(j_ops[stage])
        return frozen, active

    monkeypatch.setattr(tfz, "init_cnn_stage_active", init_with_reference_op)
    return jsrv, tsrv, tm, (params, state), records


@pytest.mark.parametrize("name", ["deadline relative", "deadline absolute",
                                  "async", "async watchdog"])
def test_two_stage_policy_trajectory_matches_reference(monkeypatch, name):
    jsrv, tsrv, _, (params, state), recs = _server_pair(monkeypatch, name)
    j_out = jsrv.run(params, state, schedule=[2, 2])
    t_out = tsrv.run(to_torch(params), to_torch(state), schedule=[2, 2])

    assert t_out["rounds"] == j_out["rounds"] == 4
    assert [r.stage for r in t_out["history"]] == [0, 0, 1, 1]
    _same_records(recs[tsim], recs[jsim], loss_tol=TOL)
    for jr, tr in zip(j_out["history"], t_out["history"]):
        assert (tr.round_idx, tr.stage, tr.selected, tr.dropped,
                tr.uplink_bytes, tr.cache_bytes) == \
            (jr.round_idx, jr.stage, jr.selected, jr.dropped,
             jr.uplink_bytes, jr.cache_bytes)
        np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
        np.testing.assert_allclose([tr.duration, tr.virtual_time],
                                   [jr.duration, jr.virtual_time], **CLOCK)
    for a, b in zip(jax.tree.leaves((j_out["params"], j_out["state"])),
                    jax.tree.leaves(to_numpy(t_out["params"]))
                    + jax.tree.leaves(to_numpy(t_out["state"]))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    ticks = recs[tsim]
    if name.startswith("deadline"):
        assert all(r.sequential for r in ticks if r.selected)
        assert any(r.dropped for r in ticks)
    else:
        assert all(len(r.selected) == 2 for r in ticks)
        assert any(v > 0 for r in ticks for v in r.staleness.values())
    if name == "deadline absolute":
        # everyone available was late or dropped: nothing aggregated, the
        # loss carried over, and the round cost the deadline
        empty = [i for i, r in enumerate(ticks) if not r.selected]
        assert empty
        hist = t_out["history"]
        assert all(hist[i].loss == hist[i - 1].loss for i in empty)
    if name == "async watchdog":
        assert any(r.retries for r in ticks)


def test_free_running_drift_is_not_a_round_fault(monkeypatch):
    """The absolute-deadline trajectory over availability seed 0, whose
    free run drifts past the tolerance in one stage-1 weight: every round
    of the reference's run, replayed by the port's engine from the
    reference's own inputs (params, BN state, frozen prefix, cohort, cache
    plan and ``sequential``), agrees within the tolerance."""
    import repro.fl.engine as jengine
    jsrv, tsrv, tm, (params, state), recs = _server_pair(
        monkeypatch, "deadline absolute, seed 0")
    calls = []
    run_round = jengine.RoundEngine.run_round

    def recorded(eng, clients, selected, p, s, r, **kw):
        out = run_round(eng, clients, selected, p, s, r, **kw)
        calls.append((eng, list(selected), p, s, r, kw, out))
        return out

    monkeypatch.setattr(jengine.RoundEngine, "run_round", recorded)
    jsrv.run(params, state, schedule=[2, 2])
    assert [c[4] for c in calls] == [0, 1, 2, 3]
    assert any(len(c[1]) == 1 for c in calls)
    engines = {}
    for eng, sel, p, s, r, kw, (jp, js, jl) in calls:
        if id(eng) not in engines:  # one per stage, built at its start
            engines[id(eng)] = tsrv._stage_engine(int(r >= 2),
                                                  to_torch(eng.frozen),
                                                  to_torch(s))
        tp, ts, tl = engines[id(eng)].run_round(
            tsrv.clients, sel, to_torch(p), to_torch(s), r,
            use_cache=kw["use_cache"], sequential=kw["sequential"])
        assert kw["sequential"] is True and list(tl) == list(jl)
        np.testing.assert_allclose(list(tl.values()), list(jl.values()),
                                   **TOL)
        _close_trees(jp, tp)
        _close_trees(js, ts)


def test_async_dispatched_bases_are_never_written(monkeypatch):
    """Every in-flight entry keeps references to the trees it was
    dispatched from. A fingerprint of each base, taken at dispatch, must
    still hold after every later merge, on the compressed path (whose
    residual rows are written in place) and across stale completions."""
    records = []

    class Fingerprinted(tsim.AsyncBufferedAggregation):
        def _dispatch(self, loop, r, cid, now, **kw):
            super()._dispatch(loop, r, cid, now, **kw)
            entry = max(loop.async_state["in_flight"], key=lambda e: e[1])
            leaves = tree_leaves(entry[3]) + tree_leaves(entry[4])
            records.append((leaves, [t.clone() for t in leaves]))

    clients = _server_data(TVision, t_dirichlet, t_fleet)
    tm = TCNN(TCfg(**CFG), device="cpu")
    params, state = tm.init(torch.Generator().manual_seed(0))
    srv = TServer(tm, clients, device="cpu", clients_per_round=3,
                  batch_size=16, compress_ratio=0.1, seed=0,
                  aggregation=Fingerprinted(buffer_size=1, concurrency=3))
    out = srv.run(params, state, schedule=[3, 2])
    stale = [r for r in srv.history if r.selected]
    assert len(stale) == 5 and len(records) >= 7
    assert len({id(t) for leaves, _ in records for t in leaves}) > len(
        records[0][0])
    for leaves, prints in records:
        assert all(torch.equal(t, p) for t, p in zip(leaves, prints))
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(out["params"]))


def test_dropout_and_empty_cohort_round():
    """The reference's ``test_dropout_and_empty_cohort_round`` for the
    port: with every selected client dropping out, rounds aggregate nobody,
    cost 0.0 virtual seconds and leave the params as they were."""
    clients = _server_data(TVision, t_dirichlet, t_fleet)
    tm = TCNN(TCfg(**CFG), device="cpu")
    params, state = tm.init(torch.Generator().manual_seed(0))
    srv = TServer(tm, clients, device="cpu", clients_per_round=3,
                  batch_size=16, seed=0, fused=False,
                  availability=tsim.AvailabilityTrace(p_dropout=1.0))
    out = srv.run(params, state, schedule=[2, 0])
    for rr in out["history"]:
        assert rr.selected == [] and rr.dropped and rr.duration == 0.0
    for a, b in zip(tree_leaves(out["params"]["stages"]["stage0"]),
                    tree_leaves(params["stages"]["stage0"])):
        assert torch.equal(a, b)


def test_smartfreeze_survives_availability_dips():
    """The reference's ``test_smartfreeze_survives_availability_dips``: a
    round with too few available clients is skipped (0.0 virtual seconds)
    rather than raising ``InfeasibleStageError``."""
    clients = _server_data(TVision, t_dirichlet, t_fleet)
    tm = TCNN(TCfg(**CFG), device="cpu")
    params, state = tm.init(torch.Generator().manual_seed(0))
    srv = TServer(tm, clients, device="cpu", clients_per_round=3,
                  batch_size=16, seed=1, fused=False,
                  pace_kwargs=dict(min_rounds=99), rounds_per_stage=2,
                  availability=tsim.AvailabilityTrace(p_available=0.3,
                                                      seed=2))
    out = srv.run(params, state, total_rounds=4)
    assert len(out["history"]) == 4
    skipped = [r for r in out["history"] if not r.selected]
    assert skipped
    assert all(r.duration == 0.0 for r in skipped)
