"""The rest of the port's LM modules against the JAX package, on the CPU:
AdamW and the learning-rate schedules, ``make_train_step`` over a
``TrainState``, the output module's ``lm_op_apply`` and ``op_overhead``,
the LM memory and time models (every registered arch, published and
reduced), and the cached LM round (``make_lm_cached_fed_round_step``) at
its three feature tiers.

Models are reduced (4 layers, d_model 64, 4 q heads of 16, vocab 256, two
freeze blocks); params come from ``jax.random`` and are converted
(``repro_torch.convert``). Every other input is a numpy ``RandomState``
draw fed to both packages.

Tolerances:
  * schedules: rtol 1e-6 (one f32 ulp of ``cos`` or ``pow``, computed by
    XLA and by torch);
  * AdamW over 20 steps: moments and f32 params rtol 1e-5, atol 1e-7 (XLA
    may contract ``b * m + c * g`` into one rounding, and ``pow`` and the
    schedules may part by an ulp; these differences carry from step to
    step); bf16 params rtol 8e-3, atol 1e-5, two bf16 ulps, since an f32
    update one ulp apart can flip a bf16 rounding;
  * f32 train steps and rounds: rtol 1e-3, atol 1e-5 on losses, norms,
    params and moments, the bf16 output module's leaves as bf16 params
    above (as ``tests/test_torch_lm.py``);
  * a bf16 compute dtype: rtol 2e-2, atol 2e-3 on params and rtol 2e-2 on
    the loss, as the bf16 engine rounds are held (both round every matrix
    product to bf16, after sums in another order);
  * the cached round against the recompute round on a bf16 model: the
    reference's own test's rtol and atol 2e-2 on params, 1e-3 on the loss
    (``tests/test_engine.py``);
  * memory and time models: exact (the same integer and float arithmetic
    in the same order), or 1e-12 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.core import freezing as jfz
from repro.core import memory_model as jmm
from repro.core import output_module as jop
from repro.core import time_model as jtm
from repro.data.synthetic import make_lm_batch
from repro.fl import quant as jquant
from repro.fl.engine import make_lm_cached_fed_round_step as j_cached
from repro.models import transformer as jtr

from repro_torch import configs as tconfigs
from repro_torch import optim as toptim
from repro_torch.convert import to_torch
from repro_torch.core import freezing as tfz
from repro_torch.core import memory_model as tmm
from repro_torch.core import output_module as top
from repro_torch.core import time_model as ttm
from repro_torch.fl import make_lm_cached_fed_round_step as t_cached
from repro_torch.models import transformer as ttr
from repro_torch.models.module import param_count, tree_leaves


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: this file's CPU work is small ops, and in a
    parallel run of the suite every pytest worker's torch pool spinning
    over all the cores oversubscribes them (``tests/test_torch_quant.py``).
    The results do not depend on it beyond the stated tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SMALL = dict(num_layers=4, num_freeze_blocks=2)
F32 = dict(param_dtype="float32", compute_dtype="float32")
SCHED_TOL = dict(rtol=1e-6, atol=0)
ADAM_TOL = dict(rtol=1e-5, atol=1e-7)
TRAJ_TOL = dict(rtol=1e-3, atol=1e-5)
BF16_LEAF_TOL = dict(rtol=8e-3, atol=1e-5)
BF16_COMPUTE_TOL = dict(rtol=2e-2, atol=2e-3)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(t):
    return t.detach().float().numpy()


def _close_trees(t_tree, j_tree, tol, bf16_tol=None):
    """Leafwise allclose; bfloat16 leaves take ``bf16_tol`` when given."""
    tl_, jl_ = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl_) == len(jl_)
    for a, b in zip(tl_, jl_):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, jnp.dtype(b.dtype).name)
        leaf_tol = bf16_tol if bf16_tol and a.dtype == torch.bfloat16 else tol
        np.testing.assert_allclose(_tnp(a), _np(b), **leaf_tol)


def _cfgs(name, **over):
    return (jconfigs.get(name).reduced(**SMALL, **over),
            tconfigs.get(name).reduced(**SMALL, **over))


def _world(name, stage, seed=11, **over):
    """Reference and port models, params and the stage's trees (the port's
    output module converted from the reference's)."""
    jcfg, tcfg = _cfgs(name, **over)
    jm = jtr.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm, tparams = ttr.build(tcfg, "cpu"), to_torch(params)
    jplan = jfz.make_stage_plan(jcfg, stage)
    tplan = tfz.make_stage_plan(tcfg, stage)
    jfr, jac = jfz.init_stage_active(jm, params, jplan,
                                     jax.random.PRNGKey(seed))
    tfr, tac = tfz.split_stage_params(tm, tparams, tplan)
    if "op" in jac:
        tac["op"] = to_torch(jac["op"])
    return (jm, params, jplan, jfr, jac), (tm, tparams, tplan, tfr, tac)


# --------------------------------------------------------------------------
# schedules, AdamW
# --------------------------------------------------------------------------

SCHEDULES = {"constant": lambda m: m.constant(3e-3),
             "cosine": lambda m: m.cosine(3e-3, 40, final_frac=0.2),
             "warmup_cosine": lambda m: m.warmup_cosine(3e-3, 5, 40)}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_schedules_match_reference(name):
    """Steps 0 to 60: warm-up, decay, and past the end."""
    js, ts = SCHEDULES[name](joptim), SCHEDULES[name](toptim)
    for step in range(61):
        got, want = ts(step), js(jnp.int32(step))
        assert got.dtype == torch.float32 and got.dim() == 0
        np.testing.assert_allclose(float(got), float(want), **SCHED_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("lr", ["float", "constant", "cosine",
                                "warmup_cosine"])
def test_adamw_matches_reference(lr, weight_decay, dtype):
    """20 steps of AdamW on a three-leaf tree, gradients drawn from a seed:
    the reference's f32 moments, integer step and bias correction, its
    updates and the params cast back to ``dtype``."""
    rng = np.random.RandomState(4)
    shapes = {"a": (16, 8), "b": (5,), "n": {"c": (3, 4)}}

    def draw(tree, scale):
        return {k: draw(v, scale) if isinstance(v, dict) else
                (scale * rng.randn(*v)).astype(np.float32)
                for k, v in tree.items()}
    p0 = draw(shapes, 1.0)
    grads = [draw(shapes, 0.5 + s % 3) for s in range(20)]
    jdt = jnp.dtype(dtype)
    sched = 2e-2 if lr == "float" else None

    def opt(m):
        return m.adamw(sched if sched is not None else SCHEDULES[lr](m),
                       weight_decay=weight_decay)
    jo, to = opt(joptim), opt(toptim)
    jp = jax.tree.map(lambda x: jnp.asarray(x, jdt), p0)
    tp = to_torch(jp)
    js, ts = jo.init(jp), to.init(tp)
    for g in grads:
        jg = jax.tree.map(lambda x: jnp.asarray(x, jdt), g)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(to_torch(jg), ts, tp)
        jp, tp = joptim.apply_updates(jp, ju), toptim.apply_updates(tp, tu)
    assert ts["step"] == int(js["step"]) == 20
    _close_trees(ts["m"], js["m"], ADAM_TOL)
    _close_trees(ts["v"], js["v"], ADAM_TOL)
    _close_trees(tp, jp, ADAM_TOL, BF16_LEAF_TOL)
    assert not to.zero_grad_noop
    assert toptim.sgd(0.1).zero_grad_noop and toptim.momentum(0.1).zero_grad_noop


# --------------------------------------------------------------------------
# make_train_step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name,stage", [("llama3-8b", 1),
                                        ("hubert-xlarge", 0)])
def test_make_train_step_matches_reference(name, stage):
    """Three AdamW steps (weight decay 0.1) of ``make_train_step`` against
    the reference's, with the reference's own checks: the frozen tree is
    untouched, the active block moves, and the optimizer state covers
    exactly the active tree, smaller than the model. HuBERT's stage 0 has
    the token embed and the frontend in the active tree behind the
    stop-gradient boundary: their gradients are zeros in the reference,
    so weight decay still moves them, and the port gives them zeros.

    AdamW's eps is 1e-3 here. At the default 1e-8 its step is about lr
    sign(g) for an element whose gradient lies within the f32 summation
    noise of its terms, so two correct packages part there by up to 2 lr a
    step (measured: 1 element of Llama's 8,192-element head by 9.3e-5
    after three steps, 56 of HuBERT's 16,384 bf16 proxy-head elements by up
    to 2.4e-4); eps 1e-3 keeps the step linear in such gradients. The
    optimizer's arithmetic at the default eps is held on equal gradients
    by ``test_adamw_matches_reference``. For the same reason the output
    module (drawn in bf16) is cast to f32 in both packages: a bf16 leaf
    whose rounding flips once parts by a whole bf16 ulp of the largest
    value it passed through (measured: 52 of HuBERT's 16,384 proxy-head
    elements past two ulps of their final value); AdamW on bf16 params is
    held on equal gradients there too."""
    (jm, params, jplan, jfr, jac), (tm, tparams, tplan, tfr, tac) = \
        _world(name, stage, **F32)
    if "op" in jac:
        jac["op"] = jax.tree.map(lambda a: a.astype(jnp.float32), jac["op"])
        tac["op"] = to_torch(jac["op"])
    jo, to = joptim.adamw(1e-2, eps=1e-3, weight_decay=0.1), \
        toptim.adamw(1e-2, eps=1e-3, weight_decay=0.1)
    jstep = jax.jit(jfz.make_train_step(jm, jplan, jo, remat=False))
    tstep = tfz.make_train_step(tm, tplan, to, remat=False)
    jst = jfz.TrainState(jac, jfr, jo.init(jac), jnp.int32(0))
    tst = tfz.TrainState(tac, tfr, to.init(tac), 0)
    assert param_count(tst.opt_state["m"]) == param_count(tac) \
        < param_count(tparams)
    frozen_before = [t.clone() for t in tree_leaves(tfr)]
    d = make_lm_batch(jm.cfg, 2, 24, seed=6)
    jb = {k: jnp.asarray(v) for k, v in d.items()}
    tb = {k: torch.as_tensor(v) for k, v in d.items()}
    for _ in range(3):
        jst, jmet = jstep(jst, jb)
        tst, tmet = tstep(tst, tb)
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(tmet[k]), float(jmet[k]),
                                       **TRAJ_TOL)
    assert tst.step == int(jst.step) == 3
    _close_trees(tst.active, jst.active, TRAJ_TOL, BF16_LEAF_TOL)
    _close_trees(tst.opt_state["m"], jst.opt_state["m"], TRAJ_TOL)
    _close_trees(tst.opt_state["v"], jst.opt_state["v"], TRAJ_TOL)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tst.frozen),
                                                  frozen_before))
    assert max(float((a - b).abs().max()) for a, b in zip(
        tree_leaves(tst.active["runs"]), tree_leaves(tac["runs"]))) > 0
    if stage == 0:
        assert not torch.equal(tst.active["embed"], tac["embed"])


def test_fed_round_with_adamw_matches_reference():
    """``make_fed_round_step`` with AdamW (weight decay 0.1, eps 1e-3 and
    the output module in f32, as in ``test_make_train_step_matches_
    reference``) at HuBERT's stage 0, two pods of two steps: the token
    embed and the frontend take zero gradients, as the reference's do, so
    the decay moves them (an SGD round skips them and leaves them
    equal)."""
    (jm, params, jplan, jfr, jac), (tm, tparams, tplan, tfr, tac) = \
        _world("hubert-xlarge", 0, **F32)
    jac["op"] = jax.tree.map(lambda a: a.astype(jnp.float32), jac["op"])
    tac["op"] = to_torch(jac["op"])
    d = make_lm_batch(jm.cfg, 2 * 2 * 2, 16, seed=9)
    fed = {k: v.reshape((2, 2, 2) + v.shape[1:]) for k, v in d.items()}
    w = np.asarray([1.0, 3.0], np.float32)
    kw = dict(num_pods=2, local_steps=2, remat=False)
    jnew, jmet = jfz.make_fed_round_step(
        jm, jplan, joptim.adamw(1e-2, eps=1e-3, weight_decay=0.1), **kw)(
        jac, jfr, {k: jnp.asarray(v) for k, v in fed.items()}, jnp.asarray(w))
    tnew, tmet = tfz.make_fed_round_step(
        tm, tplan, toptim.adamw(1e-2, eps=1e-3, weight_decay=0.1), **kw)(
        tac, tfr, {k: torch.as_tensor(v) for k, v in fed.items()},
        torch.as_tensor(w))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **TRAJ_TOL)
    _close_trees(tnew, jnew, TRAJ_TOL)
    for key in ("embed", "frontend"):
        assert all(not torch.equal(a, b) for a, b in zip(
            tree_leaves(tnew[key]), tree_leaves(tac[key])))


# --------------------------------------------------------------------------
# output module
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "hubert-xlarge"])
def test_lm_op_apply_matches_reference(name):
    """Stage 0's output module (one proxy layer, norm, head; HuBERT's
    proxy attends non-causally) on a random f32 hidden state."""
    (jm, params, jplan, jfr, jac), (tm, tparams, tplan, tfr, tac) = \
        _world(name, 0, **F32)
    assert "proxy" in jac["op"]
    op32 = jax.tree.map(lambda a: a.astype(jnp.float32), jac["op"])
    h = np.random.RandomState(8).randn(2, 12, 64).astype(np.float32)
    want = jop.lm_op_apply(op32, jnp.asarray(h), jm.cfg)
    got = top.lm_op_apply(to_torch(op32), torch.as_tensor(h), tm.cfg)
    assert tuple(got.shape) == want.shape == (2, 12, 256)
    np.testing.assert_allclose(_tnp(got), _np(want), rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# memory and time models
# --------------------------------------------------------------------------


def _same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _same(got[k], want[k])
        return
    if isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _same(a, b)
        return
    assert type(got) in (int, float) and float(got) == pytest.approx(
        float(want), rel=1e-12, abs=0), (got, want)


@pytest.mark.parametrize("name", jconfigs.names())
def test_lm_memory_and_time_models_match_reference(name):
    """Every registered arch, as published and reduced: parameter counts
    (``ArchConfig.param_count`` and ``active_param_count`` too), per-block
    and per-layer counts, activation and cache bytes, Eq. 4 at every stage
    under each optimizer, with and without a cache at each tier and a
    given output-module depth, the full model's bytes, Eq. 5 FLOPs, the
    6 N D count, Eq. 6-7 times, the speedups, the cached compute scale and
    the output module's overhead."""
    for jc, tc in ((jconfigs.get(name), tconfigs.get(name)),
                   (jconfigs.get(name).reduced(),
                    tconfigs.get(name).reduced())):
        assert tc.param_count() == jc.param_count()
        assert tc.active_param_count() == jc.active_param_count()
        assert tmm._abstract_counts(tc) == jmm._abstract_counts(jc)
        for fn in ("arch_param_count", "arch_active_param_count",
                   "block_param_counts", "_layer_param_counts",
                   "_proxy_layer_params"):
            _same(getattr(tmm, fn)(tc), getattr(jmm, fn)(jc))
        kinds = sorted(set(jc.layer_kinds()) | {"attn_mlp"})
        for kind in kinds:
            _same(tmm.layer_activation_bytes(tc, 4, 1024, kind),
                  jmm.layer_activation_bytes(jc, 4, 1024, kind))
            _same(tmm.layer_fwd_flops_per_token(tc, kind, 1024),
                  jmm.layer_fwd_flops_per_token(jc, kind, 1024))
        for dt in (None, "float32", "float16", "int8"):
            _same(tmm.feature_cache_bytes(tc, 5000, dt, scale_vectors=7),
                  jmm.feature_cache_bytes(jc, 5000, dt, scale_vectors=7))
        clients = [{"num_samples": 100 + 37 * i, "capability": 1e12 * (i + 1)}
                   for i in range(4)]
        for stage in range(jc.num_freeze_blocks):
            for kw in (dict(), dict(optimizer="sgd"),
                       dict(optimizer="sgdm", op_module_layers=1),
                       dict(cache_tokens=9000),
                       dict(cache_tokens=9000, cache_dtype="float16"),
                       dict(cache_tokens=9000, cache_dtype="int8")):
                _same(tmm.stage_memory_bytes(tc, stage, 4, 1024, **kw),
                      jmm.stage_memory_bytes(jc, stage, 4, 1024, **kw))
            _same(tmm.stage_flops(tc, stage, 4, 1024),
                  jmm.stage_flops(jc, stage, 4, 1024))
            _same(ttm.client_stage_time(tc, stage, 300, 2e12, batch=4,
                                        seq=128, rho=1.3),
                  jtm.client_stage_time(jc, stage, 300, 2e12, batch=4,
                                        seq=128, rho=1.3))
            _same(ttm.round_time(tc, stage, clients, batch=2, seq=64),
                  jtm.round_time(jc, stage, clients, batch=2, seq=64))
            _same(ttm.stage_speedup(tc, stage),
                  jtm.stage_speedup(jc, stage))
            _same(ttm.lm_cached_compute_scale(tc, stage, batch=2, seq=256),
                  jtm.lm_cached_compute_scale(jc, stage, batch=2, seq=256))
            _same(top.op_overhead(tc, stage, 4, 1024),
                  jop.op_overhead(jc, stage, 4, 1024))
        assert ttm.round_time(tc, 0, []) == jtm.round_time(jc, 0, []) == 0.0
        for opt in ("adamw", "sgd", "sgdm"):
            _same(tmm.full_model_memory_bytes(tc, 4, 1024, optimizer=opt),
                  jmm.full_model_memory_bytes(jc, 4, 1024, optimizer=opt))
        _same(tmm.full_model_flops(tc, 4, 1024),
              jmm.full_model_flops(jc, 4, 1024))
        _same(tmm.model_flops_6nd(tc, 4, 1024),
              jmm.model_flops_6nd(jc, 4, 1024))


# --------------------------------------------------------------------------
# the cached LM round
# --------------------------------------------------------------------------

PODS, STEPS, B, S = 2, 2, 2, 16


def _fed_batches(cfg, seed=5):
    d = make_lm_batch(cfg, PODS * STEPS * B, S, seed=seed)
    return {k: v.reshape((PODS, STEPS, B) + v.shape[1:]) for k, v in d.items()}


def _ref_features(jm, jfr, jac, jplan, fed):
    """The reference's prefix features of every (pod, step) minibatch:
    h0 [PODS, STEPS, B, S, d] and aux0 [PODS, STEPS]."""
    pf = jax.jit(lambda f, a, bb: jfz.stage_prefix_features(jm, f, a, bb,
                                                            jplan))
    hs, auxs = [], []
    for p in range(PODS):
        for k in range(STEPS):
            h, a = pf(jfr, jac, {kk: jnp.asarray(v[p, k])
                                 for kk, v in fed.items()})
            hs.append(np.asarray(h))
            auxs.append(np.asarray(a))
    d = hs[0].shape
    return (np.stack(hs).reshape((PODS, STEPS) + d),
            np.stack(auxs).reshape(PODS, STEPS))


def _tier_batch(fed, h0, aux0, tier):
    """The cached batch at ``tier``: f32 keeps h0, fp16 stores float16,
    int8 the reference's ``quantize_int8`` codes of each minibatch with
    their f32 per-(sample, channel) scales."""
    out = {"labels": fed["labels"], "aux0": aux0}
    if tier == "f32":
        out["h0"] = h0
    elif tier == "fp16":
        out["h0"] = h0.astype(np.float16)
    else:
        qs = [jquant.quantize_int8(jnp.asarray(h0[p, k]))
              for p in range(PODS) for k in range(STEPS)]
        lead = (PODS, STEPS)
        out["h0"] = np.stack([np.asarray(q) for q, _ in qs]).reshape(
            lead + h0.shape[2:])
        out["h0_scale"] = np.stack([np.asarray(s) for _, s in qs]).reshape(
            lead + qs[0][1].shape)
    return out


@pytest.mark.parametrize("tier,compute_dtype", [("f32", None),
                                                ("fp16", None),
                                                ("int8", None),
                                                ("int8", "bfloat16")])
def test_lm_cached_round_matches_reference(tier, compute_dtype):
    """internvl2-2b (reduced, f32, 2 kv heads) at stage 1: two pods of two
    SGD steps on the reference's prefix features (the image positions in
    front, the loss on the text) stored at ``tier``, in both packages."""
    (jm, params, jplan, jfr, jac), (tm, tparams, tplan, tfr, tac) = \
        _world("internvl2-2b", 1, num_kv_heads=2, **F32)
    fed = _fed_batches(jm.cfg)
    h0, aux0 = _ref_features(jm, jfr, jac, jplan, fed)
    assert h0.shape == (PODS, STEPS, B, S, 64)
    cb = _tier_batch(fed, h0, aux0, tier)
    w = np.asarray([1.0, 3.0], np.float32)
    kw = dict(num_pods=PODS, local_steps=STEPS, remat=False,
              feature_tier=tier, compute_dtype=compute_dtype)
    jnew, jmet = j_cached(jm, jplan, joptim.sgd(0.05), donate=False, **kw)(
        jac, {k: jnp.asarray(v) for k, v in cb.items()}, jnp.asarray(w))
    tnew, tmet = t_cached(tm, tplan, toptim.sgd(0.05), **kw)(
        tac, {k: torch.as_tensor(v) for k, v in cb.items()},
        torch.as_tensor(w))
    if compute_dtype is None:
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   **TRAJ_TOL)
        _close_trees(tnew, jnew, TRAJ_TOL, BF16_LEAF_TOL)
    else:
        assert tmet["loss"].dtype == torch.float32
        np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                                   rtol=BF16_COMPUTE_TOL["rtol"])
        _close_trees(tnew, jnew, BF16_COMPUTE_TOL)
    # the start tree is not written
    _close_trees(tac, jac, dict(rtol=0, atol=0))


def test_lm_cached_round_matches_recompute_round():
    """The reference's test: a bf16 Llama (reduced) at stage 1, the cached
    round on the port's own prefix features against the recompute round
    on the same minibatches."""
    _, (tm, tparams, tplan, tfr, tac) = _world("llama3-8b", 1)
    fed = {k: torch.as_tensor(v) for k, v in _fed_batches(tm.cfg).items()}
    feats = [[tfz.stage_prefix_features(tm, tfr, tac,
                                        {k: v[p, s] for k, v in fed.items()},
                                        tplan) for s in range(STEPS)]
             for p in range(PODS)]
    cb = {"labels": fed["labels"],
          "h0": torch.stack([torch.stack([h for h, _ in row])
                             for row in feats]),
          "aux0": torch.stack([torch.stack([a for _, a in row])
                               for row in feats])}
    assert cb["h0"].dtype == torch.bfloat16
    w = torch.as_tensor([1.0, 3.0])
    kw = dict(num_pods=PODS, local_steps=STEPS, remat=False)
    ref_new, ref_m = tfz.make_fed_round_step(tm, tplan, toptim.sgd(0.05),
                                             **kw)(tac, tfr, fed, w)
    got_new, got_m = t_cached(tm, tplan, toptim.sgd(0.05), **kw)(tac, cb, w)
    for a, b in zip(tree_leaves(got_new), tree_leaves(ref_new)):
        np.testing.assert_allclose(_tnp(a), _tnp(b), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(float(got_m["loss"]), float(ref_m["loss"]),
                               rtol=1e-3, atol=1e-3)


def test_lm_cached_round_refuses_a_moving_prefix():
    """Stage 0 (the embedding trains) and a Zamba2 prefix holding a tied
    shared-attention layer: the reference's ValueError; ``prefix_is_static``
    agrees with the reference's on every stage of both."""
    for name in ("llama3-8b", "zamba2-7b"):
        jcfg, tcfg = _cfgs(name)
        tm = ttr.build(tcfg, "cpu")
        for stage in range(tcfg.num_freeze_blocks):
            tplan = tfz.make_stage_plan(tcfg, stage)
            static = tfz.prefix_is_static(tplan)
            assert static == jfz.prefix_is_static(
                jfz.make_stage_plan(jcfg, stage))
            if static:
                continue
            with pytest.raises(ValueError,
                               match="not a fixed feature extractor"):
                t_cached(tm, tplan, toptim.sgd(0.05), num_pods=1,
                         local_steps=1)
    assert not tfz.prefix_is_static(tfz.make_stage_plan(tcfg, 1))
