"""The port's SmartFreeze LM path against the JAX package, on the CPU at a
small size: ``llama3-8b.reduced(num_layers=4, num_freeze_blocks=2,
num_kv_heads=2)`` (d_model 64, 4 q heads over 2 kv heads so g = 2,
head_dim 16, d_ff 128, vocab 256).

What cannot be carried bit for bit is carried across explicitly: model
params come from ``jax.random`` in the reference and are converted
(``repro_torch.convert``); in ``train()`` the port's ``LM.init`` and
``init_stage_active`` are patched to return the reference's params and
output modules.

Tolerances:
  * float32 layers, forward and loss: rtol 1e-5, atol 1e-5 (the same f32
    arithmetic summed in another order);
  * float32 round steps and whole trajectories: rtol 1e-3, atol 1e-5 on
    losses, perturbations and params, as the CNN server test: a few SGD
    steps through bf16 output modules (the reference draws them in bf16);
    the bf16 leaves themselves (the output module) get rtol 8e-3, atol 1e-5,
    two bf16 ulps: an f32 difference of one ulp can flip the rounding of a
    bf16 update;
  * bfloat16: rtol 2e-2, atol 2e-2 on one layer's activations. Both sides
    round to bf16 at the same places (embedding, norms, RoPE, the dense
    path's probabilities), but bf16 matrix products round their outputs
    after sums taken in another order. Through the whole 4-layer model the
    logits get atol 6e-2: at this size the reference's own bf16 logits
    differ from its f32 logits by 0.045, and the port's from the
    reference's by the same order;
  * host data: bitwise."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import freezing as jfz
from repro.data.synthetic import make_lm_batch as j_batch
from repro.launch import train as jtrain_mod
from repro.models import attention as jattn
from repro.models import layers as jl
from repro.models import transformer as jtr
from repro.optim import sgd as jsgd

from repro_torch import configs as tconfigs
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import freezing as tfz
from repro_torch.data.synthetic import make_lm_batch as t_batch
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import train as ttrain_mod
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tl
from repro_torch.models import transformer as ttr
from repro_torch.models.module import tree_leaves
from repro_torch.optim import sgd as tsgd

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


SMALL = dict(num_layers=4, num_freeze_blocks=2, num_kv_heads=2)
F32 = dict(param_dtype="float32", compute_dtype="float32")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-3, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LM_BF16_TOL = dict(rtol=2e-2, atol=6e-2)
BF16_LEAF_TOL = dict(rtol=8e-3, atol=1e-5)


def _cfgs(**over):
    j = jconfigs.get("llama3-8b").reduced(**SMALL, **over)
    t = tconfigs.get("llama3-8b").reduced(**SMALL, **over)
    return j, t


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


def _model_and_params(jcfg, tcfg, seed=0):
    jm = jtr.build(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, ttr.build(tcfg, "cpu"), to_torch(params)


def _batch(cfg, b=2, s=24, seed=0):
    d = j_batch(cfg, b, s, seed=seed)
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


# --------------------------------------------------------------------------
# configs, data
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-72b",
                                  "deepseek-coder-33b", "zamba2-7b",
                                  "xlstm-350m", "minicpm3-4b",
                                  "deepseek-v2-236b", "grok-1-314b",
                                  "internvl2-2b", "hubert-xlarge"])
def test_configs_match_reference(name):
    j, t = jconfigs.get(name), tconfigs.get(name)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.segments() == j.segments()
    assert t.block_boundaries() == j.block_boundaries()
    assert dataclasses.asdict(t.reduced(**SMALL)) == \
        dataclasses.asdict(j.reduced(**SMALL))
    assert dataclasses.asdict(t.reduced()) == dataclasses.asdict(j.reduced())


@pytest.mark.parametrize("seed", [0, 7])
def test_lm_batches_are_bitwise_equal(seed):
    for cfg in (jconfigs.get("llama3-8b"), jconfigs.get("llama3-8b").reduced()):
        a, b = j_batch(cfg, 3, 33, seed=seed), t_batch(cfg, 3, 33, seed=seed)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norms_match_reference(kind, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 5, 32).astype(np.float32) * 3
    p = {"scale": rng.randn(32).astype(np.float32),
         "bias": rng.randn(32).astype(np.float32)}
    if kind == "rmsnorm":
        p.pop("bias")
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jl.norm({k: jnp.asarray(v, jdt) for k, v in p.items()},
                   jnp.asarray(x, jdt), kind)
    got = tl.norm({k: torch.as_tensor(v).to(tdt) for k, v in p.items()},
                  torch.as_tensor(x).to(tdt), kind)
    assert got.dtype == tdt
    np.testing.assert_allclose(_tnp(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rope_matches_reference(dtype):
    x = np.random.RandomState(1).randn(2, 12, 3, 16).astype(np.float32)
    pos = np.arange(12)[None, :]
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jl.apply_rope(jnp.asarray(x, jdt), jnp.asarray(pos), 500000.0)
    got = tl.apply_rope(torch.as_tensor(x).to(tdt), torch.as_tensor(pos),
                        500000.0)
    np.testing.assert_allclose(_tnp(tl.rope_freqs(16, 500000.0)),
                               _np(jl.rope_freqs(16, 500000.0)), rtol=1e-6)
    np.testing.assert_allclose(_tnp(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("act", ["silu", "gelu", "relu"])
def test_activations_match_reference(act):
    x = np.linspace(-6, 6, 101).astype(np.float32)
    np.testing.assert_allclose(_tnp(tl.activation(act)(torch.as_tensor(x))),
                               _np(jl.activation(act)(jnp.asarray(x))),
                               **F32_TOL)


@pytest.mark.parametrize("S,impl", [(40, "xla"), (2048, "xla"),
                                    (40, "pallas")])
def test_gqa_forward_matches_reference(S, impl):
    """S = 2048 is the XLA path's blockwise online softmax; the Pallas path
    runs the reference's kernel in interpret mode."""
    jcfg, tcfg = _cfgs(**F32, attention_impl=impl)
    jm, params, _, tparams = _model_and_params(jcfg, tcfg)
    lp = jax.tree.map(lambda a: a[0], params["segments"]["0"]["attn"])
    tp = to_torch(lp)
    x = np.random.RandomState(2).randn(1, S, 64).astype(np.float32)
    want = jattn.gqa_forward(lp, jnp.asarray(x), jcfg)
    got = tattn.gqa_forward(tp, torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)


def test_blockwise_attention_matches_dense():
    rng = np.random.RandomState(3)
    q, k, v = (torch.as_tensor(rng.randn(1, 256, 2, 16).astype(np.float32))
               for _ in range(3))
    want = jattn.blockwise_attention(*(jnp.asarray(t.numpy()) for t in (q, k, v)),
                                     causal=True, scale=0.25, block_q=64,
                                     block_k=32)
    got = tattn.blockwise_attention(q, k, v, causal=True, scale=0.25,
                                    block_q=64, block_k=32)
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_apply_matches_reference(dtype):
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(**over)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = jax.tree.map(lambda a: a[1], params["segments"]["0"])
    x = np.random.RandomState(4).randn(2, 24, 64).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, _ = jtr.layer_apply(lp, jnp.asarray(x, jdt), jcfg, "attn_mlp")
    got, aux = ttr.layer_apply(to_torch(lp), torch.as_tensor(x).to(tdt), tcfg,
                               "attn_mlp")
    assert got.dtype == tdt and float(aux) == 0.0
    np.testing.assert_allclose(_tnp(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_bf16_params_cross_bit_for_bit():
    jcfg, _ = _cfgs()
    params = jtr.build(jcfg).init(jax.random.PRNGKey(0))
    back = to_numpy(to_torch(params))
    for a, b in zip(jax.tree.leaves(params), tree_leaves(back)):
        assert b.dtype == a.dtype == jnp.bfloat16
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      b.view(np.uint16))


def test_init_layout_matches_reference():
    jcfg, tcfg = _cfgs()
    params = jtr.build(jcfg).init(jax.random.PRNGKey(0))
    mine = ttr.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    ja, ta = jax.tree_util.tree_flatten_with_path(params)[0], tree_leaves(mine)
    assert len(ja) == len(ta)
    for (path, a), b in zip(ja, ta):
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == torch.bfloat16
    # the same init rules: std of a 64 -> 128 dense weight is 1/sqrt(64)
    w = mine["segments"]["0"]["mlp"]["gate"]["w"].float()
    assert abs(float(w.std()) - 64 ** -0.5) < 0.01
    assert float(mine["embed"].float().std()) == pytest.approx(0.02, rel=0.05)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lm_forward_and_loss_match_reference(dtype):
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(**over)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    jlog, _ = jm.forward(params, jb)
    tlog, aux = tm.forward(tparams, tb)
    tol = F32_TOL if dtype == "float32" else LM_BF16_TOL
    np.testing.assert_allclose(_tnp(tlog), _np(jlog), **tol)
    np.testing.assert_allclose(float(tm.loss(tparams, tb)),
                               float(jm.loss(params, jb)), **tol)
    np.testing.assert_allclose(float(ttr.token_loss(tlog, tb, tcfg)),
                               float(jtr.token_loss(jlog, jb, jcfg)), **tol)


def test_lm_forward_bf16_matches_reference_op_by_op():
    """bf16 logits through the whole model against the reference run op by
    op (``jax.disable_jit``; compiled, XLA keeps bf16 intermediates in f32
    inside its fusions), held by the reference's own spread rule: no
    farther from the reference's bf16 logits than those lie from its f32
    logits on the same params (0.054 at this size; the port lies 0.039
    away, where it lies 0.047 from the compiled reference), and within
    twice that of the f32 logits. The op that parts the packages is the
    MLP's ``activation("silu")`` (``F.silu``, one rounding, as
    ``tests/test_torch_mla.py`` found): with ``layers.silu`` in its place
    the gap is 0.023, in a ninth of the logits, from the matrix products'
    summation order."""
    jcfg, tcfg = _cfgs()
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jm32 = jtr.build(dataclasses.replace(jcfg, **F32))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jb, tb = _batch(jcfg)
    with jax.disable_jit():
        ref16 = _np(jm.forward(params, jb)[0])
    ref32 = _np(jax.jit(jm32.forward)(params32, jb)[0])
    got = _tnp(tm.forward(tparams, tb)[0])
    spread = np.abs(ref16 - ref32).max()
    assert np.abs(got - ref16).max() <= spread
    assert np.abs(got - ref32).max() <= 2 * spread


def test_chunked_ce_loss_matches_reference_with_masked_labels():
    rng = np.random.RandomState(5)
    h = rng.randn(2, 30, 16).astype(np.float32)
    w = rng.randn(16, 50).astype(np.float32)
    y = rng.randint(-1, 50, (2, 30)).astype(np.int32)
    cfg = jconfigs.get("llama3-8b")
    want = jtr.chunked_ce_loss(jnp.asarray(h), jnp.asarray(w),
                               {"labels": jnp.asarray(y)}, cfg, chunk=8)
    hh = torch.as_tensor(h).requires_grad_()
    got = ttr.chunked_ce_loss(hh, torch.as_tensor(w),
                              {"labels": torch.as_tensor(y)}, cfg, chunk=8)
    np.testing.assert_allclose(float(got.detach()), float(want), **F32_TOL)
    jg = jax.grad(lambda a: jtr.chunked_ce_loss(
        a, jnp.asarray(w), {"labels": jnp.asarray(y)}, cfg, chunk=8))(
        jnp.asarray(h))
    got.backward()
    np.testing.assert_allclose(hh.grad.numpy(), np.asarray(jg), **F32_TOL)


def test_bf16_clipped_sgd_step_matches_reference():
    """sgd updates in f32 and apply_updates casts back to bf16, in both
    packages; the clip scales bf16 grads by a bf16-cast factor. Bitwise."""
    from repro.optim import apply_updates as j_apply
    from repro.optim import clip_by_global_norm as j_clip
    from repro_torch.optim import apply_updates as t_apply
    from repro_torch.optim import clip_by_global_norm as t_clip

    rng = np.random.RandomState(6)
    p = {"a": rng.randn(64, 32).astype(np.float32),
         "b": rng.randn(7).astype(np.float32)}
    g = {k: v * 3 for k, v in p.items()}
    jp, jg = ({k: jnp.asarray(v, jnp.bfloat16) for k, v in t.items()}
              for t in (p, g))
    tp, tg = to_torch(jp), to_torch(jg)
    jg2, _ = j_clip(jg, 1.0)
    ju, _ = jsgd(0.05).update(jg2, jsgd(0.05).init(jp), jp)
    tg2, _ = t_clip(tg, 1.0)
    tu, _ = tsgd(0.05).update(tg2, tsgd(0.05).init(tp), tp)
    want, got = j_apply(jp, ju), t_apply(tp, tu)
    for k in p:
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(got[k].view(torch.int16).numpy(),
                                      np.asarray(want[k]).view(np.int16))


# --------------------------------------------------------------------------
# freezing
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["llama3-8b", "qwen2-72b"])
def test_stage_plans_match_reference(name):
    for j, t in (_cfgs(), (jconfigs.get(name), tconfigs.get(name))):
        for stage in list(range(j.num_freeze_blocks)) + [None]:
            assert tuple(tfz.make_stage_plan(t, stage)) == \
                tuple(jfz.make_stage_plan(j, stage))


@pytest.mark.parametrize("stage", [0, 1])
def test_split_and_merge_round_trip_matches_reference(stage):
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jplan, tplan = jfz.make_stage_plan(jcfg, stage), tfz.make_stage_plan(tcfg, stage)
    jfr, jac = jfz.split_stage_params(jm, params, jplan)
    tfr, tac = tfz.split_stage_params(tm, tparams, tplan)
    _close_trees(tfr, jfr, dict(rtol=0, atol=0))
    _close_trees(tac, jac, dict(rtol=0, atol=0))
    # identity merge, then a merge of a changed active tree
    _close_trees(tfz.merge_stage_params(tm, tparams, tplan, tac), params,
                 dict(rtol=0, atol=0))
    jac2 = jax.tree.map(lambda a: a + 1.0, jac)
    want = jfz.merge_stage_params(jm, params, jplan, jac2)
    got = tfz.merge_stage_params(tm, tparams, tplan, to_torch(jac2))
    _close_trees(got, want, dict(rtol=0, atol=0))


def _stage_trees(jm, params, tm, tparams, stage, seed=11):
    jplan = jfz.make_stage_plan(jm.cfg, stage)
    tplan = tfz.make_stage_plan(tm.cfg, stage)
    jfr, jac = jfz.init_stage_active(jm, params, jplan,
                                     jax.random.PRNGKey(seed))
    tfr, tac = tfz.split_stage_params(tm, tparams, tplan)
    if "op" in jac:
        tac["op"] = to_torch(jac["op"])
    return jplan, tplan, jfr, jac, tfr, tac


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_loss_matches_reference(stage):
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jplan, tplan, jfr, jac, tfr, tac = _stage_trees(jm, params, tm, tparams,
                                                    stage)
    jb, tb = _batch(jcfg, seed=3)
    want = jfz.stage_loss_fn(jm, jplan, remat=False)(jac, jfr, jb)
    for remat in (False, True):
        got = tfz.stage_loss_fn(tm, tplan, remat=remat)(tac, tfr, tb)
        np.testing.assert_allclose(float(got), float(want), **F32_TOL)
    assert tfz.prefix_is_static(tplan) == jfz.prefix_is_static(jplan)


def test_init_stage_active_draws_a_bf16_output_module():
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jplan, tplan = jfz.make_stage_plan(jcfg, 0), tfz.make_stage_plan(tcfg, 0)
    _, jac = jfz.init_stage_active(jm, params, jplan, jax.random.PRNGKey(0))
    _, tac = tfz.init_stage_active(tm, tparams, tplan,
                                   torch.Generator().manual_seed(0))
    ja = jax.tree_util.tree_flatten_with_path(jac["op"])[0]
    ta = tree_leaves(tac["op"])
    assert [a.shape for _, a in ja] == [tuple(b.shape) for b in ta]
    assert all(b.dtype == torch.bfloat16 for b in ta)


@pytest.mark.parametrize("stage", [0, 1])
def test_fed_round_step_with_two_pods_matches_reference(stage):
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jplan, tplan, jfr, jac, tfr, tac = _stage_trees(jm, params, tm, tparams,
                                                    stage)
    pods, steps, b, s = 2, 2, 2, 16
    d = j_batch(jcfg, pods * steps * b, s, seed=5)
    jfed = {k: jnp.asarray(v).reshape((pods, steps, b, s)) for k, v in d.items()}
    tfed = {k: torch.as_tensor(v).reshape(pods, steps, b, s) for k, v in d.items()}
    w = np.asarray([1.0, 3.0], np.float32)
    jstep = jfz.make_fed_round_step(jm, jplan, jsgd(0.05), num_pods=pods,
                                    local_steps=steps, remat=False)
    tstep = tfz.make_fed_round_step(tm, tplan, tsgd(0.05), num_pods=pods,
                                    local_steps=steps, remat=False)
    jnew, jmet = jstep(jac, jfr, jfed, jnp.asarray(w))
    tnew, tmet = tstep(tac, tfr, tfed, torch.as_tensor(w))
    np.testing.assert_allclose(float(tmet["loss"]), float(jmet["loss"]),
                               **TRAJ_TOL)
    _close_trees(tnew, jnew, TRAJ_TOL, BF16_LEAF_TOL)
    # the embedding sits behind the stop-gradient boundary: unchanged
    if stage == 0:
        assert torch.equal(tnew["embed"], tac["embed"])


# --------------------------------------------------------------------------
# train()
# --------------------------------------------------------------------------

TEST_ARCH = "llama3-8b-f32-kv2"


@pytest.fixture
def test_arch():
    """A float32 Llama-3-8B whose ``reduced()`` has 2 kv heads, registered in
    both packages for the length of a test."""
    base = dict(name=TEST_ARCH, num_kv_heads=2, **F32)
    jconfigs.register(dataclasses.replace(jconfigs.get("llama3-8b"), **base))
    tconfigs.register(dataclasses.replace(tconfigs.get("llama3-8b"), **base))
    yield TEST_ARCH
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    jbase._REGISTRY.pop(TEST_ARCH, None)
    tbase._REGISTRY.pop(TEST_ARCH, None)


def _patch_port_init(monkeypatch, seed=0):
    """The port's LM.init and output modules return the reference's."""
    ops = {}

    def init(self, generator):
        jm = jtr.build(jconfigs.get(TEST_ARCH).reduced())
        return to_torch(jm.init(jax.random.PRNGKey(seed)), self.device)

    port_init_stage = tfz.init_stage_active

    def init_stage(model, params, plan, generator):
        frozen, active = port_init_stage(model, params, plan, generator)
        if "op" in active:
            jcfg = dataclasses.replace(jconfigs.get(TEST_ARCH).reduced(),
                                       attention_impl=model.cfg.attention_impl)
            jm = jtr.build(jcfg)
            jp = jm.init(jax.random.PRNGKey(seed))
            _, jac = jfz.init_stage_active(
                jm, jp, jfz.make_stage_plan(jcfg, plan.stage),
                jax.random.PRNGKey(seed + 100 + plan.stage))
            active["op"] = to_torch(jac["op"], model.device)
            ops[plan.stage] = jac["op"]
        return frozen, active

    monkeypatch.setattr(ttr.LM, "init", init)
    monkeypatch.setattr(tfz, "init_stage_active", init_stage)
    return ops


@pytest.mark.parametrize("use_pallas", [False, True])
def test_train_trajectory_matches_reference(monkeypatch, test_arch,
                                            use_pallas):
    kw = dict(reduced=True, steps=4, batch=2, seq=40, use_pallas=use_pallas,
              log_every=100, pace_kwargs=dict(min_rounds=1, mu=1,
                                              slope_lambda=5e-3, fit_window=3))
    want = jtrain_mod.train(test_arch, **kw)
    _patch_port_init(monkeypatch)
    before = tfa.launches
    got = ttrain_mod.train(test_arch, device="cpu", **kw)
    assert tfa.launches == before  # the CPU never launches the kernel
    assert got["config"].attention_impl == ("pallas" if use_pallas else "xla")
    assert [(h["stage"], h["round"]) for h in got["history"]] == \
        [(h["stage"], h["round"]) for h in want["history"]]
    assert len(got["history"]) == 4
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], **TRAJ_TOL)
        assert (a["perturbation"] is None) == (b["perturbation"] is None)
        if a["perturbation"] is not None:
            np.testing.assert_allclose(a["perturbation"], b["perturbation"],
                                       **TRAJ_TOL)
        assert a["seconds"] > 0
    _close_trees(got["params"], want["params"], TRAJ_TOL)


@pytest.mark.parametrize("legacy", ["bare params", "params without rng"])
def test_train_resumes_legacy_checkpoints_as_reference(monkeypatch, tmp_path,
                                                       test_arch, legacy):
    """The reference's ``train(resume=True)`` takes two older checkpoint
    forms: a tree of bare params (no "params" key), and params without an
    "rng" entry (the data stream then starts from the seed). Each is
    written with the reference's checkpoint writer (stage 0, round 0, the
    reference's init params moved by seeded noise, so that the resumed
    runs start from what was saved), resumed in both packages from copies
    of one directory, and the trajectories held as
    ``test_train_trajectory_matches_reference`` holds them."""
    import shutil

    from repro.checkpoint import save_checkpoint as j_save

    jm = jtr.build(jconfigs.get(test_arch).reduced())
    rng = np.random.RandomState(3)
    saved = jax.tree.map(
        lambda a: np.asarray(a) + 0.01 * rng.randn(*a.shape).astype(
            np.asarray(a).dtype), jm.init(jax.random.PRNGKey(0)))
    tree = saved if legacy == "bare params" else {"params": saved}
    j_save(str(tmp_path / "j"), 0, tree, metadata={"stage": 0, "round": 0})
    shutil.copytree(tmp_path / "j", tmp_path / "t")
    kw = dict(reduced=True, steps=4, batch=2, seq=40, log_every=100,
              resume=True, pace_kwargs=dict(min_rounds=1, mu=1,
                                            slope_lambda=5e-3, fit_window=3))
    want = jtrain_mod.train(test_arch, ckpt_dir=str(tmp_path / "j"), **kw)
    _patch_port_init(monkeypatch)
    got = ttrain_mod.train(test_arch, ckpt_dir=str(tmp_path / "t"),
                           device="cpu", **kw)
    assert [(h["stage"], h["round"]) for h in got["history"]] == \
        [(h["stage"], h["round"]) for h in want["history"]] == \
        [(0, 1), (1, 0), (1, 1)]
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], **TRAJ_TOL)
        assert (a["perturbation"] is None) == (b["perturbation"] is None)
        if a["perturbation"] is not None:
            np.testing.assert_allclose(a["perturbation"], b["perturbation"],
                                       **TRAJ_TOL)
    _close_trees(got["params"], want["params"], TRAJ_TOL)


def test_train_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        ttrain_mod.train("llama3-8b", steps=2, batch=1, seq=8)


@pytest.mark.parametrize("kwargs", [dict(ckpt_dir="ckpts"), dict(resume=True),
                                    dict(mesh_clients=2)])
def test_train_refuses_unported_arguments(monkeypatch, tmp_path, kwargs):
    """``mesh_clients > 1`` is not ported and raises. The checkpoint
    arguments are, on the bf16 ``llama3-8b.reduced()``: ``ckpt_dir``
    writes the reference's format, whose last step the reference restores
    with the final params bit for bit (bf16 through its uint16 view) and
    the run's metadata; ``resume=True`` after a crash in stage 0's third
    round (the data draw raises) continues mid-stage from the second
    round's step, restoring the active tree with its output module, the
    pace window and the data stream, and the resumed rounds and final
    params equal the uninterrupted run's bit for bit."""
    if "mesh_clients" in kwargs:
        with pytest.raises(TypeError, match="ROADMAP"):
            ttrain_mod.train("llama3-8b", steps=2, batch=1, seq=8,
                             device="cpu", **kwargs)
        return
    from repro.checkpoint import restore_checkpoint as j_restore
    ckpts = str(tmp_path / "ckpts")
    kw = dict(steps=6, batch=2, seq=16, device="cpu", log_every=100,
              ckpt_every=1)
    want = ttrain_mod.train("llama3-8b", **kw)
    if "ckpt_dir" in kwargs:
        got = ttrain_mod.train("llama3-8b", ckpt_dir=ckpts, **kw)
        ck = j_restore(ckpts)
        assert ck["step"] == 6 and ck["metadata"] == {
            "stage": 1, "round": 3, "global_round": 6,
            "compute_dtype": "bfloat16"}
        for a, b in zip(jax.tree.leaves(ck["tree"]["params"]),
                        tree_leaves(got["params"])):
            assert str(a.dtype) == str(b.dtype).split(".")[1]
            np.testing.assert_array_equal(
                np.asarray(a).view(np.uint16) if b.dtype == torch.bfloat16
                else np.asarray(a), b.view(torch.int16).numpy().view(
                    np.uint16) if b.dtype == torch.bfloat16 else b.numpy())
        return
    draws = {"n": 0}
    real_batch = ttrain_mod.make_lm_batch

    def crashing_batch(*a, **k):
        draws["n"] += 1
        if draws["n"] == 3:
            raise RuntimeError("crash")
        return real_batch(*a, **k)
    monkeypatch.setattr(ttrain_mod, "make_lm_batch", crashing_batch)
    # synchronous saves: the crash must not race the last one
    monkeypatch.setattr(ttrain_mod, "CheckpointManager", functools.partial(
        ttrain_mod.CheckpointManager, async_save=False))
    with pytest.raises(RuntimeError, match="crash"):
        ttrain_mod.train("llama3-8b", ckpt_dir=ckpts, **kw)
    got = ttrain_mod.train("llama3-8b", ckpt_dir=ckpts, resume=True, **kw)
    tail = want["history"][2:]
    assert [(h["stage"], h["round"]) for h in got["history"]] == \
        [(h["stage"], h["round"]) for h in tail] == \
        [(0, 2), (1, 0), (1, 1), (1, 2)]
    for a, b in zip(tail, got["history"]):
        assert (a["loss"], a["perturbation"]) == (b["loss"],
                                                   b["perturbation"])
    assert got["history"][0]["perturbation"] is not None
    for a, b in zip(tree_leaves(want["params"]), tree_leaves(got["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_train_main_parses_the_reference_flags(monkeypatch):
    seen = {}
    monkeypatch.setattr(ttrain_mod, "train",
                        lambda arch, **kw: seen.update(kw, arch=arch) or
                        {"history": [{"loss": 1.0}]})
    ttrain_mod.main(["--arch", "llama3-8b", "--full", "--steps", "8",
                     "--batch", "4", "--seq", "1024", "--use-pallas",
                     "--compute-dtype", "float32", "--remat", "--pods", "2"])
    assert seen["arch"] == "llama3-8b" and seen["reduced"] is False
    assert (seen["steps"], seen["batch"], seen["seq"], seen["num_pods"]) == \
        (8, 4, 1024, 2)
    assert seen["use_pallas"] and seen["remat"]
    assert seen["compute_dtype"] == "float32" and seen["device"] == "cuda"
    assert (seen["ckpt_dir"], seen["resume"], seen["mesh_clients"]) == \
        (None, False, 0)
