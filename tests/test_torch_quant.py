"""The port's memory tiers and bf16 local training (``fl/quant.py``, the
tiered ``RoundEngine``, ``SmartFreezeServer(cache_tiers=...,
compute_dtype=...)``) against the JAX package's, on the CPU at a small
size: a (1, 1)-stage ResNet, channels (8, 16), 16 x 16 images. Inputs come
from numpy seeds; the reference's initial params cross over with
``repro_torch.convert``.

Tolerances, each with its reason:
  * quantization: scales bit for bit and int8 codes equal on shared
    inputs; fed features from each package's own prefix (f32 convolutions
    summed in other orders), codes at most one step apart, and fewer than
    1 in 10,000 of them;
  * f32 rounds, any tier: params, BN state and losses rtol 1e-4, atol 1e-5,
    the port's f32 engine tests' tolerance (a few SGD steps of f32
    convolutions summed in another order);
  * bf16 rounds: rtol 2e-2, atol 2e-3 against the reference's bf16 round
    (bf16 has 8 bits: one rounding is 2^-8 = 3.9e-3 relative, and the two
    packages' bf16 convolutions round at other places); the reference's own
    bf16-against-f32 claim, rtol 2e-2 / atol 2e-2 for losses and rtol 0.1 /
    atol 0.05 for params, ported as it stands;
  * the quant-aware int8 round: the reference harness's ``_close``, rtol
    1e-5 and atol 1e-5 * max(1, max |want|);
  * the tiered bf16 server trajectory: losses rtol 2e-2, params atol 2e-2;
    the tier plans, selections, stages and cache bytes exactly."""
import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freezing_cnn as jfz
from repro.core.memory_model import cnn_stage_memory_bytes as j_stage_bytes
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl import quant as jq
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.engine import RoundEngine as JEngine
from repro.fl.engine import make_fused_round as j_fused_round
from repro.fl.server import SmartFreezeServer as JServer
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
from repro.optim import sgd as j_sgd

import repro_torch.core.freezing_cnn as tfz
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.memory_model import CACHE_TIERS
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl import quant as tq
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.engine import RoundEngine as TEngine
from repro_torch.fl.engine import make_fused_round as t_fused_round
from repro_torch.fl.server import SmartFreezeServer as TServer
from repro_torch.kernels import dequant_matmul as dqmm
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves
from repro_torch.optim import sgd as t_sgd

CFG = dict(name="tiny", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
F32 = dict(rtol=1e-4, atol=1e-5)
BF16 = dict(rtol=2e-2, atol=2e-3)


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


def _worlds(n=600, k=6):
    """The reference's ``tests/test_quant.py`` world (600 samples of 16 x 16
    images over 6 clients), built by each package."""
    out = []
    for vision, dirichlet, fleet in ((JVision, j_dirichlet, j_fleet),
                                     (TVision, t_dirichlet, t_fleet)):
        sv = vision(num_classes=4, image_size=16, seed=0)
        train = sv.sample(n, seed=1)
        parts = dirichlet(train["y"], k, alpha=1.0, seed=0)
        out.append((fleet(train, parts, scenario="low", seed=0),
                    sv.sample(200, seed=2)))
    return out


def _close_trees(j_tree, t_tree, tol):
    lj, lt = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        assert b.dtype == torch.float32
        np.testing.assert_allclose(b.detach().numpy(),
                                   np.asarray(a, np.float32), **tol)


def _models():
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    return jm, tm, params, state


def _stage1_engines(jm, tm, params, state, compute_dtype=None,
                    compress_ratio=None):
    frozen, active = jfz.init_cnn_stage_active(jm, params, 1,
                                               jax.random.PRNGKey(1))
    kw = dict(batch_size=32, local_epochs=1, compute_dtype=compute_dtype,
              compress_ratio=compress_ratio)
    je = JEngine(loss_fn=jfz.cnn_stage_loss_fn(jm, 1), optimizer=j_sgd(0.05),
                 frozen=frozen,
                 cached_loss_fn=jfz.cnn_cached_stage_loss_fn(jm, 1),
                 feature_fn=lambda x: jfz.cnn_prefix_features(
                     jm, frozen, state, x, 1),
                 fused=True, use_pallas=False, **kw)
    t_frozen, t_state = to_torch(frozen), to_torch(state)
    te = TEngine(loss_fn=tfz.cnn_stage_loss_fn(tm, 1), optimizer=t_sgd(0.05),
                 frozen=t_frozen,
                 cached_loss_fn=tfz.cnn_cached_stage_loss_fn(tm, 1),
                 feature_fn=lambda x: tfz.cnn_prefix_features(
                     tm, t_frozen, t_state, x, 1),
                 device="cpu", **kw)
    return je, te, active


# ---------------------------------------------------------------------------
# quantization
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape,mag", [((8, 6, 6, 5), 1e-3), ((8, 6, 6, 5), 1.0),
                                       ((3, 16, 16, 8), 1e4), ((4, 32, 12), 1.0),
                                       ((7, 9), 3.0), ((2000, 64), 3.0)])
def test_quantize_matches_reference_bitwise(shape, mag):
    """Shared inputs: the scales bit for bit and the codes equal, an
    all-zero channel included (scale 1.0, codes 0)."""
    x = (np.random.RandomState(0).randn(*shape) * mag).astype(np.float32)
    x[..., 0] = 0.0
    qj, sj = jq.quantize_int8(jnp.asarray(x))
    qt, st = tq.quantize_int8(torch.as_tensor(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.float32
    assert st.shape == sj.shape
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(tq.dequantize_int8(qt, st).numpy(),
                                  np.asarray(jq.dequantize_int8(qj, sj)))


def test_int8_roundtrip_error_bound():
    """The reference's claim, ported: |dequant(quant(x)) - x| <= scale / 2
    elementwise, heavy tails included."""
    rng = np.random.RandomState(0)
    for shape in [(8, 6, 6, 5), (3, 16, 16, 8), (4, 32, 12), (7, 9)]:
        for mag in (1e-3, 1.0, 1e4):
            x = torch.as_tensor((rng.randn(*shape) * mag).astype(np.float32))
            q, s = tq.quantize_int8(x)
            bound = (s / 2).expand_as(x)
            assert bool(((tq.dequantize_int8(q, s) - x).abs()
                         <= bound + 1e-12 * mag).all()), shape
    x = torch.as_tensor(rng.standard_cauchy((6, 8, 8, 4)).astype(np.float32))
    q, s = tq.quantize_int8(x)
    assert bool(((tq.dequantize_int8(q, s) - x).abs()
                 <= (s / 2).expand_as(x) + 1e-9).all())


def test_codes_from_each_prefix_at_most_one_step_apart():
    """Each package quantizes the stage-1 features its own prefix computes
    from the same images; the features differ in their last bits, so a
    code can round the other way at a .5 boundary: at most one step apart,
    and fewer than 1 in 10,000 codes."""
    jm, tm, params, state = _models()
    frozen, _ = jfz.init_cnn_stage_active(jm, params, 1, jax.random.PRNGKey(1))
    x = np.random.RandomState(3).randn(64, 16, 16, 3).astype(np.float32)
    fj = jfz.cnn_prefix_features(jm, frozen, state, jnp.asarray(x), 1)
    ft = tfz.cnn_prefix_features(tm, to_torch(frozen), to_torch(state),
                                 torch.as_tensor(x), 1)
    qj, _ = jq.quantize_int8(fj)
    qt, _ = tq.quantize_int8(ft)
    diff = np.abs(qt.numpy().astype(np.int32) - np.asarray(qj, np.int32))
    assert diff.max() <= 1
    assert (diff > 0).sum() < diff.size / 10_000, (diff > 0).sum()


@pytest.mark.parametrize("tier", CACHE_TIERS)
def test_encode_features_matches_reference(tier):
    x = np.random.RandomState(1).randn(50, 8, 8, 16).astype(np.float32)
    ej, et = jq.encode_features(x, tier), tq.encode_features(
        torch.as_tensor(x), tier)
    assert et.tier == ej.tier and et.nbytes == ej.nbytes
    assert str(et.values.dtype).split(".")[-1] == {
        "f32": "float32", "fp16": "float16", "int8": "int8"}[tier]
    np.testing.assert_array_equal(et.values.numpy(), ej.values)
    np.testing.assert_array_equal(tq.decode_features(et).numpy(),
                                  jq.decode_features(ej))
    arrays = tq.feature_batch_arrays(et)
    assert set(arrays) == set(jq.feature_batch_arrays(ej))
    # the reference's doctest: [2, 4] features, 32 / 16 / 16 bytes
    small = torch.linspace(-1.0, 1.0, 8).reshape(2, 4)
    assert tq.encode_features(small, tier).nbytes == {
        "f32": 32, "fp16": 16, "int8": 16}[tier]


def test_normalize_tier_matches_reference():
    for t in (None, False, True, np.bool_(True), np.bool_(False), "f32",
              "fp16", "int8"):
        assert tq.normalize_tier(t) == jq.normalize_tier(t)
    for bad in ("int4", "bf16"):
        with pytest.raises(ValueError):
            tq.normalize_tier(bad)


# ---------------------------------------------------------------------------
# loss wrappers
# ---------------------------------------------------------------------------


def _probe_loss(xp):
    """A loss that reports what batch it was handed: a weighted sum of x
    in f32, and the batch's keys and x's dtype by name. The reference's
    quant-aware branch also hands over ``use_pallas``, which the port has
    no counterpart of (the tensors' device picks the kernel)."""
    seen = {}

    def loss_fn(params, frozen, state, batch):
        x = batch["x"]
        seen.update(keys=sorted(k for k in batch if k != "use_pallas"),
                    x=str(x.dtype).split(".")[-1],
                    scale=(str(batch["x_scale"].dtype).split(".")[-1]
                           if "x_scale" in batch else None))
        if xp is torch:
            return (x.float() * params["p"]).sum(), state
        return (x.astype(jnp.float32) * params["p"]).sum(), state
    return loss_fn, seen


@pytest.mark.parametrize("tier", [None, "f32", "fp16", "int8", "int8-aware"])
@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_make_tiered_loss_matches_reference(tier, compute_dtype):
    """All four branches, each under the input cast of bf16 training too:
    the batch the wrapped loss sees (keys, x's dtype, the scale's dtype)
    and its value are the reference's."""
    rng = np.random.RandomState(5)
    x = rng.randn(6, 4, 4, 3).astype(np.float32)
    p = rng.randn(6, 4, 4, 3).astype(np.float32)
    enc_t = tq.encode_features(torch.as_tensor(x), tier.split("-")[0]
                               if tier else "f32")
    enc_j = jq.encode_features(x, tier.split("-")[0] if tier else "f32")
    t_batch = {**tq.feature_batch_arrays(enc_t),
               "y": torch.zeros(6, dtype=torch.int32)}
    j_batch = {k: jnp.asarray(v) for k, v in {
        **jq.feature_batch_arrays(enc_j), "y": np.zeros(6, np.int32)}.items()}
    out = {}
    for xp, q, batch, pp in ((torch, tq, t_batch, torch.as_tensor(p)),
                             (jnp, jq, j_batch, jnp.asarray(p))):
        fn, seen = _probe_loss(xp)
        if tier == "int8-aware":
            fn.consumes_quantized = True
        wrapped = q.make_input_cast_loss(
            q.make_tiered_loss(fn, tier.split("-")[0] if tier else None,
                               compute_dtype), compute_dtype)
        val, _ = wrapped({"p": pp}, {}, {}, batch)
        out[xp.__name__] = (float(val), dict(seen))
    (tv, ts), (jv, js) = out["torch"], out["jax.numpy"]
    assert ts == js
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    if tier == "int8-aware":
        assert ts["x"] == "int8" and ts["scale"] == "float32"
    elif tier == "int8":
        assert "x_scale" not in ts["keys"]


def test_make_input_cast_loss_keeps_scales_f32():
    seen = {}

    def fn(params, frozen, state, batch):
        seen.update({k: v.dtype for k, v in batch.items()})
        return torch.zeros(()), state
    batch = {"x": torch.ones(2, 3), "x_scale": torch.ones(2, 1),
             "y": torch.zeros(2, dtype=torch.int32)}
    tq.make_input_cast_loss(fn, "bfloat16")({}, {}, {}, batch)
    assert seen == {"x": torch.bfloat16, "x_scale": torch.float32,
                    "y": torch.int32}
    assert tq.make_input_cast_loss(fn, None) is fn
    tree = {"a": torch.ones(2), "b": {"c": torch.ones(1, dtype=torch.int64)}}
    cast = tq.cast_floating(tree, "bfloat16")
    assert cast["a"].dtype == torch.bfloat16
    assert cast["b"]["c"].dtype == torch.int64


# ---------------------------------------------------------------------------
# the server's admission ladder
# ---------------------------------------------------------------------------


def _ladder_fleets():
    """The reference test's fixture (``tests/test_quant.py:141``): clients
    0-2 just fit stage 1 with an int8, fp16 and f32 cache, client 3 fits the
    stage without one."""
    (jc, _), (tc, _) = _worlds()
    jm, tm, _, _ = _models()
    out = []
    for clients, model in ((jc, jm), (tc, jm)):
        clients = [dataclasses.replace(c) for c in clients]
        need = lambda c, dt: j_stage_bytes(model, 1, 32, 16,
                                           cache_samples=c.num_samples,
                                           cache_dtype=dt)
        clients[0].memory_bytes = need(clients[0], "int8") + 1.0
        clients[1].memory_bytes = need(clients[1], "float16") + 1.0
        clients[2].memory_bytes = need(clients[2], "float32") + 1.0
        clients[3].memory_bytes = j_stage_bytes(model, 1, 32, 16) + 1.0
        out.append(clients)
    return jm, tm, out


def test_server_ladder_matches_reference():
    jm, tm, (jc, tc) = _ladder_fleets()
    for tiers in ("all", ("f32",), ("f32", "int8"), ("fp16", "int8")):
        js = JServer(jm, jc, cache_tiers=tiers)
        ts = TServer(tm, tc, cache_tiers=tiers, device="cpu")
        assert ts.cache_tiers == js.cache_tiers
        for stage in (0, 1):
            assert ts._cache_plan(stage) == js._cache_plan(stage)
    ts = TServer(tm, tc, cache_tiers="all", device="cpu")
    plan = ts._cache_plan(1)
    assert (plan[0], plan[1], plan[2], plan[3]) == ("int8", "fp16", "f32",
                                                    None)
    with pytest.raises(ValueError, match="unknown cache tiers"):
        TServer(tm, tc, cache_tiers=("int4",), device="cpu")


def test_resnet18_fleet_ladder_matches_reference():
    """The chip run's fleet: CIFAR-10's 50,000 samples over 10 clients,
    Dirichlet alpha 1.0, the high-contention pool, full-width ResNet-18.
    Only the labels (drawn first by ``SyntheticVision.sample``) and the
    image size decide the plan, so the images are a [N, 32, 1, 1]
    stand-in. Both packages give the plan ``chip_smoke.py`` asserts."""
    from repro.models.cnn import RESNET18 as J18
    from repro_torch.models.cnn import RESNET18 as T18
    y = np.random.RandomState(1).randint(0, 10, 50_000).astype(np.int32)
    data = {"x": np.zeros((50_000, 32, 1, 1), np.float32), "y": y}
    want = {1: {"f32": 6, "int8": 3, None: 1},
            2: {"f32": 6, "fp16": 3, "int8": 1},
            3: {"f32": 8, "fp16": 2}}
    js = JServer(JCNN(J18), j_fleet(data, j_dirichlet(y, 10, alpha=1.0,
                                                      seed=0),
                                    scenario="high", seed=0),
                 cache_tiers="all")
    ts = TServer(TCNN(T18, device="cpu"),
                 t_fleet(data, t_dirichlet(y, 10, alpha=1.0, seed=0),
                         scenario="high", seed=0),
                 cache_tiers="all", device="cpu")
    for stage, counts in want.items():
        plan = ts._cache_plan(stage)
        assert plan == js._cache_plan(stage)
        assert dict(Counter(plan.values())) == counts


# ---------------------------------------------------------------------------
# tiered rounds against the reference's fused engine
# ---------------------------------------------------------------------------


def _round_pair(compute_dtype, use_cache, rounds=2, compress_ratio=None):
    (jc, _), (tc, _) = _worlds()
    jm, tm, params, state = _models()
    je, te, active = _stage1_engines(jm, tm, params, state, compute_dtype,
                                     compress_ratio)
    jby, tby = {c.client_id: c for c in jc}, {c.client_id: c for c in tc}
    sel = list(use_cache)
    ja, js = active, state
    ta, ts = to_torch(active), to_torch(state)
    for r in range(rounds):
        ja, js, jl = je.run_round(jby, sel, ja, js, r, use_cache=use_cache)
        ta, ts, tl = te.run_round(tby, sel, ta, ts, r, use_cache=use_cache)
        yield (ja, js, jl), (ta, ts, tl), je, te


MIXED = {2: "int8", 0: "f32", 4: None, 3: "fp16", 1: "int8", 5: "fp16"}


@pytest.mark.parametrize("use_cache", [
    MIXED, {c: "int8" for c in range(4)}, {c: "fp16" for c in range(4)},
    {0: True, 1: False, 2: "f32"}], ids=["mixed", "int8", "fp16", "legacy"])
def test_tiered_round_matches_reference(use_cache):
    """Two f32 rounds over a cohort split into tier groups (in the order
    their first clients appear) plus a recompute group; the cache's tiers
    and stored bytes equal the reference's."""
    for (ja, js, jl), (ta, ts, tl), je, te in _round_pair(None, use_cache):
        assert list(tl) == list(jl)
        np.testing.assert_allclose([tl[c] for c in jl],
                                   [jl[c] for c in jl], **F32)
        _close_trees(ja, ta, F32)
        _close_trees(js, ts, F32)
    assert te.cache_tiers() == je.cache_tiers()
    assert te.cache_nbytes() == je.cache_nbytes()


def test_tiered_compressed_round_matches_reference():
    """The tiers with the compressed uplink at ratio 1.0 (top-k keeps every
    entry): one B1 fold per leaf per tier group."""
    for (ja, js, jl), (ta, ts, tl), je, te in _round_pair(
            None, MIXED, rounds=1, compress_ratio=1.0):
        np.testing.assert_allclose([tl[c] for c in jl],
                                   [jl[c] for c in jl], **F32)
        _close_trees(ja, ta, F32)
        assert te.last_uplink_bytes == je.last_uplink_bytes


@pytest.mark.parametrize("use_cache", [{}, MIXED], ids=["recompute", "mixed"])
def test_bf16_round_matches_reference(use_cache):
    """bf16 local training against the reference's bf16 round: the master
    params and BN state come back f32 (``_close_trees`` checks the dtype)
    and track the reference's."""
    use_cache = use_cache or {c: None for c in range(4)}
    for (ja, js, jl), (ta, ts, tl), _, _ in _round_pair("bfloat16",
                                                         use_cache):
        np.testing.assert_allclose([tl[c] for c in jl],
                                   [jl[c] for c in jl], **BF16)
        _close_trees(ja, ta, BF16)
        _close_trees(js, ts, BF16)


def test_bf16_round_tracks_f32_round():
    """The reference's own claim (``test_bf16_fused_round_loss_allclose_f32``)
    for the port: bf16 losses within rtol 2e-2 / atol 2e-2 of f32, params
    within rtol 0.1 / atol 0.05, master params and BN state f32."""
    _, (tc, _) = _worlds()
    _, tm, params, state = _models()
    tby = {c.client_id: c for c in tc}
    _, active = jfz.init_cnn_stage_active(JCNN(JCfg(**CFG)), params, 0,
                                          jax.random.PRNGKey(1))
    out = {}
    for cd in (None, "bfloat16"):
        eng = TEngine(loss_fn=tfz.cnn_stage_loss_fn(tm, 0),
                      optimizer=t_sgd(0.05), batch_size=32, compute_dtype=cd,
                      device="cpu")
        out[cd] = eng.run_round(tby, [0, 1], to_torch(active),
                                to_torch(state), 0)
    (af, sf, lf), (ab, sb, lb) = out[None], out["bfloat16"]
    for c in (0, 1):
        np.testing.assert_allclose(lb[c], lf[c], rtol=2e-2, atol=2e-2)
    assert {l.dtype for l in tree_leaves(ab) + tree_leaves(sb)} == {
        torch.float32}
    for x, y in zip(tree_leaves(ab), tree_leaves(af)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=0.1, atol=0.05)


def test_int8_cached_training_within_one_point_of_f32():
    """The reference's claim (``tests/test_quant.py``), for the port: eight
    stage-1 rounds on int8-cached features end within one accuracy point of
    the f32-cached run, and the per-round losses stay close."""
    _, (tc, test) = _worlds()
    _, tm, params, state = _models()
    frozen, active = jfz.init_cnn_stage_active(JCNN(JCfg(**CFG)), params, 1,
                                               jax.random.PRNGKey(1))
    tby = {c.client_id: c for c in tc}
    sel = [0, 1, 2, 3]
    t_frozen, t_state, t_params = (to_torch(frozen), to_torch(state),
                                   to_torch(params))

    def run(tier, rounds=8):
        eng = TEngine(loss_fn=tfz.cnn_stage_loss_fn(tm, 1),
                      optimizer=t_sgd(0.05), frozen=t_frozen,
                      cached_loss_fn=tfz.cnn_cached_stage_loss_fn(tm, 1),
                      feature_fn=lambda x: tfz.cnn_prefix_features(
                          tm, t_frozen, t_state, x, 1),
                      batch_size=32, device="cpu")
        a, st, losses = to_torch(active), t_state, []
        for r in range(rounds):
            a, st, l = eng.run_round(tby, sel, a, st, r,
                                     use_cache={c: tier for c in sel})
            losses.append(float(np.mean(list(l.values()))))
        merged = tfz.merge_cnn_params(tm, t_params, 1, a)
        with torch.no_grad():
            logits, _ = tm.apply(merged, st, torch.as_tensor(test["x"]),
                                 train=False)
        acc = float((logits.argmax(-1).numpy() == test["y"]).mean())
        return acc, losses

    acc_f32, loss_f32 = run("f32")
    acc_i8, loss_i8 = run("int8")
    assert abs(acc_f32 - acc_i8) <= 0.01, (acc_f32, acc_i8)
    np.testing.assert_allclose(loss_i8, loss_f32, rtol=0.05, atol=0.02)


def test_cache_nbytes_reports_stored_dtype():
    """The reference's claim, for the port: ``cache_nbytes`` counts the
    stored dtypes, int8's f32 scales included; a tier change re-encodes."""
    _, (tc, _) = _worlds()
    jm, tm, params, state = _models()
    _, te, _ = _stage1_engines(jm, tm, params, state)
    c0 = tc[0]
    per_tier = {}
    for tier in CACHE_TIERS:
        enc = te.features_for(c0, tier)
        assert isinstance(enc, tq.EncodedFeatures) and enc.tier == tier
        per_tier[tier] = te.cache_nbytes()
        assert per_tier[tier] == enc.nbytes
        assert te.cache_tiers() == {c0.client_id: tier}
    assert per_tier["fp16"] == per_tier["f32"] // 2
    assert per_tier["f32"] / per_tier["int8"] >= 3.5
    assert per_tier["int8"] == (c0.num_samples * 16 * 16 * 8
                                + c0.num_samples * 8 * 4)


# ---------------------------------------------------------------------------
# the quant-aware int8 round (the path that launches B2 on the card)
# ---------------------------------------------------------------------------


def _mlp_world(seed=1, K=3, nb=2, B=8, D=12, H=8, C=4):
    """The reference harness's ``_mlp_world`` (tests/test_kernel_conformance.py)."""
    rng = np.random.RandomState(seed)
    params = {"w1": (rng.randn(D, H) * 0.3).astype(np.float32),
              "b1": np.zeros((H,), np.float32),
              "w2": (rng.randn(H, C) * 0.3).astype(np.float32)}
    x = rng.randn(K, nb, B, D).astype(np.float32)
    y = rng.randint(0, C, size=(K, nb, B)).astype(np.int32)
    return params, x, y


def _t_consumer(params, frozen, state, batch):
    h = torch.tanh(tq.tiered_matmul(batch["x"], batch.get("x_scale"),
                                    params["w1"]) + params["b1"])
    logp = torch.log_softmax(h @ params["w2"].to(h.dtype), dim=-1)
    return -logp.gather(1, batch["y"].long()[:, None]).mean(), state


_t_consumer.consumes_quantized = True


def _j_consumer(params, frozen, state, batch):
    h = jnp.tanh(jq.tiered_matmul(batch["x"], batch.get("x_scale"),
                                  params["w1"],
                                  use_pallas=batch.get("use_pallas", False))
                 + params["b1"])
    logp = jax.nn.log_softmax(h @ params["w2"])
    nll = -jnp.take_along_axis(logp, batch["y"][:, None], axis=1)
    return jnp.mean(nll), state


_j_consumer.consumes_quantized = True


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    atol = tol * max(1.0, float(np.max(np.abs(want))))
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("compute_dtype", [None, "bfloat16"])
def test_quant_aware_int8_round_matches_reference(compute_dtype):
    """``test_quant_aware_int8_round_pallas_parity``'s world: int8 rows and
    [B, 1] scales per minibatch, the MLP consumer routing its first product
    through ``tiered_matmul``; the reference with ``use_pallas=True`` (the
    Pallas body in interpret mode). bf16 compute against the reference's
    bf16 round at the bf16 tolerance."""
    params, x, y = _mlp_world()
    K, nb = x.shape[:2]
    qs = np.zeros(x.shape, np.int8)
    ss = np.zeros(x.shape[:3] + (1,), np.float32)
    for ki in range(K):
        for ni in range(nb):
            qb, sb = jq.quantize_int8(jnp.asarray(x[ki, ni]))
            qs[ki, ni], ss[ki, ni] = np.asarray(qb), np.asarray(sb)
    j_fn = j_fused_round(jq.make_tiered_loss(_j_consumer, "int8",
                                             compute_dtype, use_pallas=True),
                         j_sgd(0.05), compute_dtype=compute_dtype,
                         unroll=True)
    jp, _, jl = j_fn({k: jnp.asarray(v) for k, v in params.items()}, {}, {},
                     {"x": jnp.asarray(qs), "x_scale": jnp.asarray(ss),
                      "y": jnp.asarray(y)},
                     jnp.full((K,), nb, jnp.int32),
                     jnp.ones((K,), jnp.float32) / K)
    t_fn = t_fused_round(tq.make_tiered_loss(_t_consumer, "int8",
                                             compute_dtype), t_sgd(0.05),
                         compute_dtype=compute_dtype)
    batches = [{"x": torch.as_tensor(qs[k]), "x_scale": torch.as_tensor(ss[k]),
                "y": torch.as_tensor(y[k])} for k in range(K)]
    before = dqmm.launches
    tp, _, tl = t_fn(to_torch(params), {}, {}, batches,
                     torch.ones(K) / K)
    assert dqmm.launches == before  # CPU tensors: the plain version
    if compute_dtype is None:
        _close(tl.numpy(), np.asarray(jl))
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            _close(b.numpy(), np.asarray(a))
    else:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **BF16)
        _close_trees(jp, tp, BF16)


def test_quant_aware_engine_round_keeps_int8_and_row_scales():
    """Through ``RoundEngine``: a quant-aware consumer over an int8 cache of
    flattened features (the images themselves, so that both packages
    quantize the same bits) receives int8 rows and [B, 1] scales gathered
    by the batch plan, and the round matches the reference engine's
    (f32)."""
    (jc, _), (tc, _) = _worlds(n=200, k=3)
    consumer, _, _ = _mlp_world(D=16 * 16 * 3)
    seen = []

    def t_loss(p, f, s, b):
        seen.append((b["x"].dtype, tuple(b["x_scale"].shape)))
        return _t_consumer(p, f, s, b)
    t_loss.consumes_quantized = True
    te = TEngine(loss_fn=t_loss, optimizer=t_sgd(0.05), cached_loss_fn=t_loss,
                 feature_fn=lambda x: x.reshape(x.shape[0], -1),
                 batch_size=16, device="cpu")
    je = JEngine(loss_fn=_j_consumer, optimizer=j_sgd(0.05),
                 cached_loss_fn=_j_consumer,
                 feature_fn=lambda x: x.reshape(x.shape[0], -1),
                 batch_size=16, fused=True, use_pallas=True)
    sel = [0, 1, 2]
    use_cache = {c: "int8" for c in sel}
    jp, _, jl = je.run_round({c.client_id: c for c in jc}, sel,
                             {k: jnp.asarray(v) for k, v in consumer.items()},
                             {}, 0, use_cache=use_cache)
    tp, _, tl = te.run_round({c.client_id: c for c in tc}, sel,
                             to_torch(consumer), {}, 0, use_cache=use_cache)
    assert seen and all(d == torch.int8 and s == (16, 1) for d, s in seen)
    np.testing.assert_allclose([tl[c] for c in sel], [jl[c] for c in sel],
                               **F32)
    _close_trees(jp, tp, F32)


# ---------------------------------------------------------------------------
# the server end to end: tiers and bf16
# ---------------------------------------------------------------------------


def test_tiered_bf16_server_trajectory_matches_reference(monkeypatch):
    """``SmartFreezeServer(cache_tiers="all", compute_dtype="bfloat16")``,
    2 stages x 2 rounds, compressed uplinks at ratio 1.0, on the ladder
    fixture: the stage-1 tier plan, selections, stages and cache bytes
    exactly; losses and params at the bf16 trajectory's tolerance. As in
    ``tests/test_torch_server.py``, the similarity and the output modules
    come from the reference."""
    jm, tm, (jc, tc) = _ladder_fleets()
    _, _, params, state = _models()
    kw = dict(clients_per_round=6, batch_size=32, compress_ratio=1.0, seed=0,
              cache_tiers="all", compute_dtype="bfloat16")
    jsrv = JServer(jm, jc, use_pallas=False, **kw)
    tsrv = TServer(tm, tc, device="cpu", **kw)
    j_sim = jsrv.bootstrap_similarity(params, state)
    monkeypatch.setattr(tsrv, "bootstrap_similarity", lambda p, s: j_sim)
    j_ops = {s: jfz.init_cnn_stage_active(jm, params, s,
                                          jax.random.PRNGKey(s))[1].get("op")
             for s in range(2)}
    port_init = tfz.init_cnn_stage_active

    def init_with_reference_op(model, p, stage, generator, **k):
        frozen, active = port_init(model, p, stage, generator, **k)
        if "op" in active:
            active["op"] = to_torch(j_ops[stage])
        return frozen, active

    monkeypatch.setattr(tfz, "init_cnn_stage_active", init_with_reference_op)
    j_out = jsrv.run(params, state, schedule=[2, 2])
    t_out = tsrv.run(to_torch(params), to_torch(state), schedule=[2, 2])
    assert tsrv.cache_tier_plan == jsrv.cache_tier_plan
    assert set(tsrv.cache_tier_plan.values()) >= {"int8", "fp16", "f32",
                                                  None}
    for jr, tr in zip(j_out["history"], t_out["history"]):
        assert (tr.round_idx, tr.stage, tr.selected, tr.uplink_bytes,
                tr.cache_bytes) == (jr.round_idx, jr.stage, jr.selected,
                                    jr.uplink_bytes, jr.cache_bytes)
        np.testing.assert_allclose(tr.loss, jr.loss, rtol=2e-2)
    for a, b in zip(jax.tree.leaves(j_out["params"]),
                    jax.tree.leaves(to_numpy(t_out["params"]))):
        assert b.dtype == np.float32
        np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=2e-2)
