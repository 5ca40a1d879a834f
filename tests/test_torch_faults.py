"""The port's fault injection, update screening and robust aggregation
(``repro_torch.fl.faults``, ``repro_torch.fl.engine``) against the JAX
package's, on the CPU.

  * ``hash_draws`` and ``FaultInjector.schedule`` equal the reference bit
    for bit over seeds, rounds and permuted subsets (hypothesis);
    ``apply_fault_to_update`` equals it for each kind;
  * ``_keep_mask`` equals the reference's exactly and ``_robust_leaf``
    within 1e-6, with the reference's own properties
    (``tests/test_faults.py``) restated for the port;
  * the engine, on the reference's ``world`` (a (1, 1)-stage ResNet of
    widths (8, 16), six clients over 400 16x16 samples, a stage-0 round of
    four): a zero-fault defended round is bitwise the undefended one,
    fused and sequential; each corruption kind is screened as in the
    reference; signflip passes the screen and needs a robust aggregator;
    an all-screened round is a no-op; defenses with ``compress_ratio``
    raise the reference's ``ValueError``.

Tolerances: decisions (schedules, screen verdicts) exactly; f32 params and
BN state rtol 1e-3, atol 1e-5 (``tests/test_torch_server.py``'s); torch on
one thread."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import freezing_cnn as jfz
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl import engine as jeng
from repro.fl import faults as jfaults
from repro.fl.client import make_client_fleet as j_fleet
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
from repro.optim import sgd as j_sgd

import repro_torch.core.freezing_cnn as tfz
from repro_torch.convert import to_torch
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl import engine as teng
from repro_torch.fl import faults as tfaults
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves
from repro_torch.optim import sgd as t_sgd

CFG = dict(name="tiny_resnet", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
TOL = dict(rtol=1e-3, atol=1e-5)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the CPU convolutions' summation order follows the
    thread count (``tests/test_torch_policies_drift.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the schedule
# ---------------------------------------------------------------------------


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 2 ** 63 + 5), round_idx=st.integers(0, 2 ** 62),
       ids=st.lists(st.integers(0, 2 ** 64 - 1), min_size=1, max_size=40))
def test_hash_draws_equal_reference_bitwise(seed, round_idx, ids):
    got = tfaults.hash_draws(seed, round_idx, ids)
    want = jfaults.hash_draws(seed, round_idx, ids)
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)


@settings(max_examples=25, deadline=None)
@given(seed=st.integers(0, 10 ** 6), round_idx=st.integers(0, 10 ** 6),
       p=st.floats(0.0, 1.0),
       kinds=st.lists(st.sampled_from(tfaults.FAULT_KINDS), min_size=1,
                      max_size=6),
       start=st.integers(0, 3), perm_seed=st.integers(0, 1000))
def test_schedule_equals_reference(seed, round_idx, p, kinds, start,
                                   perm_seed):
    """The whole fleet, a permuted subset and single clients: the port's
    schedule is the reference's, and a subset's verdicts are the fleet's."""
    t = tfaults.FaultInjector(p_fault=p, kinds=tuple(kinds), seed=seed,
                              start_round=start)
    j = jfaults.FaultInjector(p_fault=p, kinds=tuple(kinds), seed=seed,
                              start_round=start)
    fleet = list(range(60))
    sub = list(np.random.RandomState(perm_seed).permutation(60)[:17])
    full = t.schedule(fleet, round_idx)
    assert full == j.schedule(fleet, round_idx)
    assert t.schedule(sub, round_idx) == j.schedule(sub, round_idx) == {
        c: full[c] for c in sub if c in full}
    for c in sub[:5]:
        assert t.fault_for(c, round_idx) == j.fault_for(c, round_idx)
    tc, jc = t.corrupt_codes(full, sub), j.corrupt_codes(full, sub)
    assert (tc is None and jc is None) or np.array_equal(tc, jc)


def test_injector_rejects_unknown_kinds():
    with pytest.raises(ValueError, match="unknown fault kinds"):
        tfaults.FaultInjector(kinds=("nan", "melt"))
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS
    assert tfaults.CORRUPT_KINDS == jfaults.CORRUPT_KINDS
    assert tfaults.FAULT_CODE == jfaults.FAULT_CODE
    assert tfaults.corrupt_codes({1: "crash"}, [1, 2]) is None
    assert tfaults.corrupt_codes(None, [1]) is None


@pytest.mark.parametrize("kind", tfaults.CORRUPT_KINDS)
def test_apply_fault_to_update_equals_reference(kind):
    rng = np.random.RandomState(3)
    p0 = {"a": rng.randn(3, 4).astype(np.float32),
          "b": {"c": rng.randn(5).astype(np.float32)}}
    p1 = {"a": p0["a"] + rng.randn(3, 4).astype(np.float32) * 0.1,
          "b": {"c": p0["b"]["c"] + rng.randn(5).astype(np.float32) * 0.1}}
    want = jfaults.apply_fault_to_update(kind, p0, p1, amplify=7.5)
    got = tfaults.apply_fault_to_update(kind, to_torch(p0), to_torch(p1),
                                        amplify=7.5)
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    with pytest.raises(ValueError, match="not a corruption kind"):
        tfaults.apply_fault_to_update("crash", to_torch(p0), to_torch(p1))


# ---------------------------------------------------------------------------
# screening and the robust combine
# ---------------------------------------------------------------------------


@settings(max_examples=20, deadline=None)
@given(K=st.integers(1, 9), seed=st.integers(0, 1000),
       mult=st.sampled_from([1.5, 8.0]))
def test_keep_mask_equals_reference(K, seed, mult):
    """Finite and non-finite norms and losses, inert weight-0 rows and
    outliers: the port's verdict is the reference's."""
    rng = np.random.RandomState(seed)
    norms = rng.uniform(0.5, 1.5, K).astype(np.float32)
    norms[rng.rand(K) < 0.2] *= 40.0
    norms[rng.rand(K) < 0.15] = np.nan
    losses = rng.uniform(0.1, 3.0, K).astype(np.float32)
    losses[rng.rand(K) < 0.15] = np.inf
    weights = (rng.rand(K) + 0.1).astype(np.float32)
    weights[rng.rand(K) < 0.2] = 0.0
    want = np.asarray(jeng._keep_mask(jnp.asarray(norms), jnp.asarray(losses),
                                      jnp.asarray(weights), mult))
    got = teng._keep_mask(torch.as_tensor(norms), torch.as_tensor(losses),
                          torch.as_tensor(weights), mult)
    np.testing.assert_array_equal(got.numpy(), want)


@settings(max_examples=10, deadline=None)
@given(K=st.integers(2, 8), seed=st.integers(0, 1000))
def test_keep_mask_zero_fault_identity(K, seed):
    """Clean rows under the median multiplier keep every row, and masking
    the weights through the mask is bitwise the identity."""
    rng = np.random.RandomState(seed)
    norms = torch.as_tensor(rng.uniform(0.5, 1.5, K).astype(np.float32))
    losses = torch.as_tensor(rng.uniform(0.1, 3.0, K).astype(np.float32))
    weights = torch.as_tensor((rng.rand(K) + 0.1).astype(np.float32))
    mask = teng._keep_mask(norms, losses, weights, 8.0)
    assert bool(mask.all())
    assert torch.equal(torch.where(mask, weights, 0.0), weights)


@settings(max_examples=20, deadline=None)
@given(K=st.integers(1, 9), seed=st.integers(0, 1000),
       agg=st.sampled_from(["coord_median", "trimmed_mean"]),
       beta=st.sampled_from([0.0, 0.2, 0.25, 0.5]))
def test_robust_leaf_equals_reference(K, seed, agg, beta):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-1.0, 1.0, size=(K, 3, 4)).astype(np.float32)
    keep = rng.rand(K) > 0.3
    keep[0] = True
    want = np.asarray(jeng._robust_leaf(
        jnp.asarray(x), jnp.asarray(keep), jnp.asarray(int(keep.sum())),
        agg, beta))
    got = teng._robust_leaf(torch.as_tensor(x), torch.as_tensor(keep),
                            int(keep.sum()), agg, beta)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@settings(max_examples=10, deadline=None)
@given(K=st.integers(3, 9), seed=st.integers(0, 1000),
       agg=st.sampled_from(["coord_median", "trimmed_mean"]))
def test_robust_leaf_permutation_invariant(K, seed, agg):
    """Order statistics over the kept rows: a client permutation leaves
    the combine bitwise unchanged."""
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(K, 5)).astype(
        np.float32))
    keep = torch.as_tensor(np.random.RandomState(seed + 1).rand(K) > 0.3)
    keep[0] = True
    perm = torch.as_tensor(np.random.RandomState(seed + 2).permutation(K))
    n = int(keep.sum())
    assert torch.equal(teng._robust_leaf(x, keep, n, agg, 0.2),
                       teng._robust_leaf(x[perm], keep[perm], n, agg, 0.2))


@settings(max_examples=10, deadline=None)
@given(K=st.integers(4, 9), seed=st.integers(0, 1000),
       agg=st.sampled_from(["coord_median", "trimmed_mean"]))
def test_robust_leaf_bounded_under_minority_outliers(K, seed, agg):
    """A tolerable minority of kept rows at +-1e6 is discarded by the
    order statistics: the combine stays inside the clean envelope."""
    beta = 0.25
    n_bad = (K - 1) // 2 if agg == "coord_median" else int(np.floor(beta * K))
    rng = np.random.RandomState(seed)
    x = torch.as_tensor(rng.uniform(-1.0, 1.0, size=(K, 5)).astype(
        np.float32))
    for r in rng.choice(K, size=n_bad, replace=False):
        x[r] = 1e6 * (1 if rng.rand() < 0.5 else -1)
    out = teng._robust_leaf(x, torch.ones(K, dtype=torch.bool), K, agg, beta)
    assert bool((out.abs() <= 1.0 + 1e-6).all()), (agg, n_bad, out)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def world():
    """``tests/test_faults.py``'s world in both packages, the port holding
    the reference's initial params and stage-0 output module."""
    out = {}
    for name, vision, dirichlet, fleet in (
            ("j", JVision, j_dirichlet, j_fleet),
            ("t", TVision, t_dirichlet, t_fleet)):
        train = vision(num_classes=4, image_size=16, seed=0).sample(400,
                                                                    seed=1)
        parts = dirichlet(train["y"], 6, alpha=1.0, seed=0)
        out[name] = {c.client_id: c for c in fleet(train, parts,
                                                   scenario="low", seed=0)}
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    frozen, active = jfz.init_cnn_stage_active(jm, params, 0,
                                               jax.random.PRNGKey(1))
    return dict(j_clients=out["j"], t_clients=out["t"], jm=jm, tm=tm,
                j_engines={},
                j=(frozen, active, state),
                t=(to_torch(frozen), to_torch(active), to_torch(state)))


def _j_engine(w, **kw):
    """The reference's engine of this configuration, one a module: its
    compiled rounds are reused across tests."""
    key = tuple(sorted(kw.items()))
    if key not in w["j_engines"]:
        w["j_engines"][key] = jeng.RoundEngine(
            loss_fn=jfz.cnn_stage_loss_fn(w["jm"], 0), optimizer=j_sgd(0.05),
            frozen=w["j"][0], batch_size=32, local_epochs=1, **kw)
    return w["j_engines"][key]


def _t_engine(w, **kw):
    return teng.RoundEngine(loss_fn=tfz.cnn_stage_loss_fn(w["tm"], 0),
                            optimizer=t_sgd(0.05), frozen=w["t"][0],
                            batch_size=32, local_epochs=1, device="cpu",
                            **kw)


def _bytes(tree):
    return b"".join(t.numpy().tobytes() for t in tree_leaves(tree))


def _close(jtree, ttree):
    for a, b in zip(jax.tree.leaves(jtree), tree_leaves(ttree)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _both(w, round_kw, **engine_kw):
    """One round in each package; (reference out, port out, engines)."""
    sel = sorted(w["t_clients"])[:4]
    je, te = _j_engine(w, **engine_kw), _t_engine(w, **engine_kw)
    jout = je.run_round(w["j_clients"], sel, w["j"][1], w["j"][2], 3,
                        **round_kw)
    tout = te.run_round(w["t_clients"], sel, w["t"][1], w["t"][2], 3,
                        **round_kw)
    return jout, tout, je, te, sel


@pytest.mark.parametrize("sequential", [False, True])
def test_zero_fault_defended_round_bit_identity(world, sequential):
    """Screening on, no faults: the port's defended round is bitwise its
    undefended one, and the verdicts and the aggregate are the
    reference's."""
    w = world
    (ja, js, jl), (ta, ts, tl), je, te, sel = _both(
        w, dict(sequential=sequential), screen=True)
    a0, s0, l0 = _t_engine(w).run_round(w["t_clients"], sel, w["t"][1],
                                        w["t"][2], 3, sequential=sequential)
    assert _bytes(ta) == _bytes(a0) and _bytes(ts) == _bytes(s0)
    assert tl == l0
    assert te.last_screened == je.last_screened == {c: False for c in sel}
    _close(ja, ta)
    _close(js, ts)
    np.testing.assert_allclose([tl[c] for c in sel], [jl[c] for c in sel],
                               **TOL)


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("kind", ["nan", "inf", "amplify"])
def test_corrupted_update_screened_as_reference(world, kind, sequential):
    w = world
    sel = sorted(w["t_clients"])[:4]
    (ja, js, jl), (ta, ts, tl), je, te, _ = _both(
        w, dict(sequential=sequential, faults={sel[0]: kind}), screen=True)
    assert te.last_screened == je.last_screened
    assert te.last_screened[sel[0]] is True
    assert not any(te.last_screened[c] for c in sel[1:])
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(ta) + tree_leaves(ts))
    _close(ja, ta)
    _close(js, ts)
    assert np.isnan(tl[sel[0]]) == np.isnan(jl[sel[0]])


@pytest.mark.parametrize("sequential", [False, True])
@pytest.mark.parametrize("aggregator", ["trimmed_mean", "coord_median"])
def test_signflip_needs_a_robust_aggregator(world, aggregator, sequential):
    """A sign-flipped delta keeps its norm: the screen passes it, as in the
    reference; a robust aggregator combines around it, and with a NaN row
    too the combine stays finite and equals the reference's."""
    w = world
    sel = sorted(w["t_clients"])[:4]
    (ja, _, _), (ta, _, _), je, te, _ = _both(
        w, dict(sequential=sequential, faults={sel[0]: "signflip"}),
        screen=True)
    assert te.last_screened[sel[0]] is False == je.last_screened[sel[0]]
    _close(ja, ta)
    (ja, js, _), (ta, ts, _), je, te, _ = _both(
        w, dict(sequential=sequential,
                faults={sel[0]: "signflip", sel[1]: "nan"}),
        aggregator=aggregator)
    assert te.last_screened == je.last_screened == {}
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(ta) + tree_leaves(ts))
    _close(ja, ta)
    _close(js, ts)


@pytest.mark.parametrize("sequential", [False, True])
def test_all_screened_round_is_a_noop(world, sequential):
    w = world
    sel = sorted(w["t_clients"])[:3]
    te = _t_engine(w, screen=True)
    a, s, losses = te.run_round(w["t_clients"], sel, w["t"][1], w["t"][2], 3,
                                sequential=sequential,
                                faults={c: "nan" for c in sel})
    assert _bytes(a) == _bytes(w["t"][1]) and _bytes(s) == _bytes(w["t"][2])
    assert te.last_screened == {c: True for c in sel}
    assert all(np.isnan(v) for v in losses.values())


def test_defenses_with_compression_raise_as_reference(world):
    w = world
    sel = sorted(w["t_clients"])[:2]
    msg = {}
    for name, make, clients, tree in (
            ("j", _j_engine, w["j_clients"], w["j"]),
            ("t", _t_engine, w["t_clients"], w["t"])):
        with pytest.raises(ValueError) as err:
            make(w, screen=True, compress_ratio=0.5).run_round(
                clients, sel, tree[1], tree[2], 0)
        msg[name] = str(err.value)
        with pytest.raises(ValueError, match="unknown aggregator"):
            make(w, aggregator="median").run_round(clients, sel, tree[1],
                                                   tree[2], 0)
    assert msg["t"] == msg["j"]
    with pytest.raises(ValueError, match="compressed uplink"):
        teng.make_fused_round(tfz.cnn_stage_loss_fn(w["tm"], 0), t_sgd(0.05),
                              compress_ratio=0.1, inject_faults=True)
    # crash and hang never reach the engine: compression takes them
    te = _t_engine(w, compress_ratio=1.0)
    te.run_round(w["t_clients"], sel, w["t"][1], w["t"][2], 0,
                 faults={sel[0]: "crash", sel[1]: "hang"})
    assert te.last_screened == {}
