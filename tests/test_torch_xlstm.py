"""The port's xLSTM family (mLSTM and sLSTM blocks) against the JAX package,
on the CPU at a small size: ``xlstm-350m.reduced()`` (4 layers, the last an
sLSTM block, the rest mLSTM; d_model 64, 4 heads, mLSTM inner width 128 in
heads of 32, sLSTM heads of 16, conv kernel 4, 2 freeze blocks, vocab 256;
the output module's proxy layers are GQA, 4 heads of 16).

Model params come from ``jax.random`` in the reference and are carried
across with ``repro_torch.convert``; in ``train()`` and ``serve()`` the
port's ``LM.init`` and ``init_stage_active`` are patched to return the
reference's params and output modules.

Tolerances, as ``tests/test_torch_hybrid.py`` states them:
  * float32 layers, forward, loss, stage losses, decode: rtol 1e-5, atol
    4e-5 (the same f32 arithmetic summed in another order: at this size
    each package's mLSTM output lies 1.5e-5 to 2.2e-5 from an f64 run of
    the port, the reference's the farther, because the chunked form's
    sums over a chunk's 256 positions are divided by a normalizer of the
    same sums); gradients of one layer: rtol 1e-4 and an atol of 3e-5 of
    the leaf's largest reference entry (the entries reach 180, and each
    package's f32 gradients lie up to 1e-5 of that scale from an f64 run of
    the port, so the two up to 1.2e-5 of it from each other);
  * log-sigmoid: ``F.logsigmoid`` against ``jax.nn.log_sigmoid``, rtol
    1e-6, atol 1e-7 (each is one or two ulps of the other);
  * a whole float32 training trajectory: rtol 1e-3, atol 1e-5 on losses,
    perturbations and params;
  * bfloat16: rtol 2e-2, atol 2e-2 on one layer; the whole model's bf16
    logits and loss no farther from the reference's bf16 result than the
    reference's own bf16 result lies from its f32 result;
  * a whole f32 ``serve()`` trajectory: the generated tokens bit for bit;
  * a resumed training run against an unbroken one, in the port: bit for
    bit."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro import configs as jconfigs
from repro.checkpoint import restore_checkpoint as j_restore
from repro.core import freezing as jfz
from repro.data.synthetic import make_lm_batch as j_batch
from repro.launch import serve as jserve_mod
from repro.launch import train as jtrain_mod
from repro.models import ssm as jssm
from repro.models import transformer as jtr

from repro_torch import configs as tconfigs
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import freezing as tfz
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve_mod
from repro_torch.launch import train as ttrain_mod
from repro_torch.models import ssm as tssm
from repro_torch.models import transformer as ttr
from repro_torch.models.module import ParamFactory, tree_leaves

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


ARCH = "xlstm-350m"
F32 = dict(param_dtype="float32", compute_dtype="float32")
F32_TOL = dict(rtol=1e-5, atol=4e-5)
TRAJ_TOL = dict(rtol=1e-3, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _cfgs(**over):
    return jconfigs.get(ARCH).reduced(**over), tconfigs.get(ARCH).reduced(**over)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(t):
    return t.detach().float().numpy()


def _close_trees(t_tree, j_tree, tol):
    tl_, jl_ = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl_) == len(jl_)
    for a, b in zip(tl_, jl_):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, jnp.dtype(b.dtype).name)
        np.testing.assert_allclose(_tnp(a), _np(b), **tol)


def _model_and_params(jcfg, tcfg, seed=0):
    jm = jtr.build(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, ttr.build(tcfg, "cpu"), to_torch(params)


def _batch(cfg, b=2, s=32, seed=0):
    d = j_batch(cfg, b, s, seed=seed)
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


def _layer(params, kind):
    """Layer 1 (mLSTM) or layer 3 (sLSTM) of the reduced model."""
    seg, i = ("0", 1) if kind == "mlstm" else ("1", 0)
    return jax.tree.map(lambda a: a[i], params["segments"][seg])


# --------------------------------------------------------------------------
# config, params
# --------------------------------------------------------------------------


def test_layout_and_plans_match_reference():
    j, t = jconfigs.get(ARCH), tconfigs.get(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.head_dim == 256  # the output module's GQA proxies: 4 heads of 256
    assert t.layer_kinds() == j.layer_kinds()
    assert [i for i, k in enumerate(t.layer_kinds()) if k == "slstm"] == \
        [7, 15, 23]
    assert t.block_boundaries() == j.block_boundaries() == (0, 6, 12, 18, 24)
    for jc, tc in ((j, t), _cfgs()):
        assert tc.segments() == jc.segments()
        for stage in list(range(jc.num_freeze_blocks)) + [None]:
            jp, tp = jfz.make_stage_plan(jc, stage), tfz.make_stage_plan(tc, stage)
            assert tuple(tp) == tuple(jp)
            assert tfz.prefix_is_static(tp) == jfz.prefix_is_static(jp)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_init_layout_matches_reference(dtype):
    """The port's init has the reference's tree, shapes and dtypes; the
    reference's params cross to the port and back bit for bit, and the
    port's cross to numpy and back bit for bit (``r``, ``w_if`` and
    ``b_if`` among them)."""
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(**over)
    params = jtr.build(jcfg).init(jax.random.PRNGKey(0))
    mine = ttr.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(params) == jax.tree.structure(to_numpy(mine))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            tree_leaves(mine)):
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == getattr(torch, jnp.dtype(a.dtype).name), path
    mix = mine["segments"]["0"]["mix"]
    assert sorted(mix) == ["b_if", "conv", "down_proj", "norm", "up_proj",
                           "w_if", "wk", "wq", "wv"]
    assert not bool(mix["b_if"].any())
    slstm = mine["segments"]["1"]["mix"]
    assert tuple(slstm["r"].shape) == (1, 4, 16, 64)
    assert tuple(slstm["ff_up"]["w"].shape) == (1, 64, 64)
    # at full width r draws with fan-in hd = 256, not its leading dim 4
    fac = ParamFactory(torch.Generator().manual_seed(0), "cpu", torch.float32)
    r = ttr.layer_init(fac, tconfigs.get(ARCH), "slstm")["mix"]["r"]
    assert abs(float(r.std()) - 256 ** -0.5) < 0.005
    for a, b in zip(jax.tree.leaves(params), tree_leaves(to_numpy(to_torch(
            params)))):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8))
    for a, b in zip(tree_leaves(mine), tree_leaves(to_torch(to_numpy(mine)))):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_key_root_rounds_as_the_reference():
    """k is divided by ``jnp.sqrt(hd).astype(dtype)``: the bf16-rounded
    root (22.625 for 512 at full width, 5.65625 for 32 reduced)."""
    for hd in (512, 32, 16, 256):
        for dtype in ("bfloat16", "float32"):
            want = float(jnp.sqrt(hd).astype(jnp.dtype(dtype)))
            assert tssm._key_root(hd, getattr(torch, dtype)) == want
    assert tssm._key_root(512, torch.bfloat16) == 22.625
    assert tssm._key_root(32, torch.bfloat16) == 5.65625


def test_log_sigmoid_matches_reference():
    x = np.concatenate([np.linspace(-40, 40, 2001),
                        [-200.0, -90.0, 0.0, 90.0, 200.0]]).astype(np.float32)
    np.testing.assert_allclose(F.logsigmoid(torch.as_tensor(x)).numpy(),
                               np.asarray(jax.nn.log_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------


def _grads(jfn, tfn, p, u, seed=9):
    """d/d(params, u) of sum(f(p, u) * r) in both packages; the port's
    gradients, all finite, held to the reference's leaf by leaf."""
    r = np.random.RandomState(seed).randn(*u.shape).astype(np.float32)
    jgp, jgu = jax.jit(jax.grad(lambda pp, uu: jnp.sum(jfn(pp, uu) * r),
                                argnums=(0, 1)))(p, jnp.asarray(u))
    tp = to_torch(p)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    tu = torch.as_tensor(u).requires_grad_()
    (tfn(tp, tu) * torch.as_tensor(r)).sum().backward()
    for got, want in zip([t.grad for t in tree_leaves(tp)] + [tu.grad],
                         jax.tree.leaves(jgp) + [jgu]):
        assert bool(torch.isfinite(got).all())
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=3e-5 * np.abs(want).max())


@pytest.mark.parametrize("S", [256, 512])
def test_mlstm_forward_and_grads_match_reference(S):
    """One chunk of 256 and two: the second enters with the carried
    state. f32 values and gradients against jax.grad, all finite."""
    jcfg, tcfg = _cfgs(**F32)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    mp = _layer(params, "mlstm")["mix"]
    u = np.random.RandomState(2).randn(1, S, 64).astype(np.float32)
    want = jax.jit(lambda p, x: jssm.mlstm_forward(p, x, jcfg))(
        mp, jnp.asarray(u))
    got = tssm.mlstm_forward(to_torch(mp), torch.as_tensor(u), tcfg)
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)
    _grads(lambda p, x: jssm.mlstm_forward(p, x, jcfg),
           lambda p, x: tssm.mlstm_forward(p, x, tcfg), mp, u)


def test_mlstm_forward_matches_reference_bf16():
    jcfg, tcfg = _cfgs()
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    mp = _layer(params, "mlstm")["mix"]
    u = np.random.RandomState(2).randn(1, 512, 64).astype(np.float32)
    want = jax.jit(lambda p, x: jssm.mlstm_forward(p, x, jcfg))(
        mp, jnp.asarray(u, jnp.bfloat16))
    got = tssm.mlstm_forward(to_torch(mp), torch.as_tensor(u).bfloat16(), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_tnp(got), _np(want), **BF16_TOL)


def test_mlstm_chunk_must_divide_the_sequence():
    """S = 300 is no multiple of the 256-row chunk: both packages raise
    (the port before any work, the reference in its reshape)."""
    jcfg, tcfg = _cfgs(**F32)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    mp = _layer(params, "mlstm")["mix"]
    u = np.zeros((1, 300, 64), np.float32)
    with pytest.raises(TypeError):
        jssm.mlstm_forward(mp, jnp.asarray(u), jcfg)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        tssm.mlstm_forward(to_torch(mp), torch.as_tensor(u), tcfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_and_grads_match_reference(dtype):
    """The cell loop from m = -inf: values (f32 and bf16) and, in f32,
    gradients against jax.grad, all finite."""
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(**over)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    sp = _layer(params, "slstm")["mix"]
    u = np.random.RandomState(3).randn(2, 24, 64).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = jax.jit(lambda p, x: jssm.slstm_forward(p, x, jcfg))(
        sp, jnp.asarray(u, jdt))
    got = tssm.slstm_forward(to_torch(sp), torch.as_tensor(u).to(tdt), tcfg)
    assert got.dtype == tdt
    if dtype == "bfloat16":
        np.testing.assert_allclose(_tnp(got), _np(want), **BF16_TOL)
        return
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)
    _grads(lambda p, x: jssm.slstm_forward(p, x, jcfg),
           lambda p, x: tssm.slstm_forward(p, x, tcfg), sp, u)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_step_matches_reference(kind, dtype):
    """Four steps from the one-layer state init (m = -inf); the port
    writes its state in place."""
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(**over)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = _layer(params, kind)["mix"]
    tp = to_torch(lp)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jinit, tinit = {"mlstm": (jssm.mlstm_init_state, tssm.mlstm_init_state),
                    "slstm": (jssm.slstm_init_state, tssm.slstm_init_state)}[kind]
    jstep, tstep = {"mlstm": (jssm.mlstm_step, tssm.mlstm_step),
                    "slstm": (jssm.slstm_step, tssm.slstm_step)}[kind]
    jst, tst = jinit(jcfg, 2, jdt), tinit(tcfg, 2, tdt, "cpu")
    assert sorted(tst) == sorted(jst)
    assert bool(torch.isinf(tst["m"]).all())
    u = np.random.RandomState(4).randn(2, 4, 64).astype(np.float32)
    for t in range(4):
        jy, jst = jstep(lp, jnp.asarray(u[:, t:t + 1], jdt), jst, jcfg)
        ty, out = tstep(tp, torch.as_tensor(u[:, t:t + 1]).to(tdt), tst, tcfg)
        assert out is tst and ty.dtype == tdt
        np.testing.assert_allclose(_tnp(ty), _np(jy), **tol)
    for k in sorted(jst):
        assert tst[k].dtype == getattr(torch, jnp.dtype(jst[k].dtype).name)
        np.testing.assert_allclose(_tnp(tst[k]), _np(jst[k]), **tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_layer_apply_matches_reference(kind, dtype):
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(**over)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = _layer(params, kind)
    x = np.random.RandomState(5).randn(2, 32, 64).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, _ = jax.jit(lambda p, h: jtr.layer_apply(p, h, jcfg, kind))(
        lp, jnp.asarray(x, jdt))
    got, aux = ttr.layer_apply(to_torch(lp), torch.as_tensor(x).to(tdt), tcfg,
                               kind)
    assert got.dtype == tdt and float(aux) == 0.0
    np.testing.assert_allclose(_tnp(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_lm_forward_loss_and_finite_grads_f32():
    """Logits, loss and layers [1, 4) against the reference; the loss's
    gradients finite everywhere, with m starting at -inf in every sLSTM
    cell and the mLSTM's masked decay entries at -inf."""
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    jlog, _ = jax.jit(jm.forward)(params, jb)
    tlog, aux = tm.forward(tparams, tb)
    np.testing.assert_allclose(_tnp(tlog), _np(jlog), **F32_TOL)
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_()
    loss = tm.loss(tparams, tb)
    np.testing.assert_allclose(float(loss.detach()),
                               float(jax.jit(jm.loss)(params, jb)), **F32_TOL)
    loss.backward()
    assert all(bool(torch.isfinite(t.grad).all()) for t in tree_leaves(tparams)
               if t.grad is not None)
    assert tparams["segments"]["1"]["mix"]["r"].grad.abs().sum() > 0
    h = np.random.RandomState(6).randn(2, 16, 64).astype(np.float32)
    want, _ = jax.jit(lambda p, x: jm.run_layers(p, x, 1, 4))(params,
                                                              jnp.asarray(h))
    got, _ = tm.run_layers(to_torch(params), torch.as_tensor(h), 1, 4)
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)


def test_lm_forward_and_loss_match_reference_bf16():
    """bf16 logits and loss held to the reference's bf16 result no farther
    than the reference's own bf16 result lies from its f32 result; the
    bf16 loss's gradients finite."""
    jcfg, tcfg = _cfgs()
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jm32 = jtr.build(dataclasses.replace(jcfg, **F32))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jb, tb = _batch(jcfg)
    ref16 = _np(jax.jit(jm.forward)(params, jb)[0])
    ref32 = _np(jax.jit(jm32.forward)(params32, jb)[0])
    got = _tnp(tm.forward(tparams, tb)[0])
    spread = np.abs(ref16 - ref32).max()
    assert np.abs(got - ref16).max() <= spread
    assert np.abs(got - ref32).max() <= 2 * spread
    for leaf in tree_leaves(tparams):
        leaf.requires_grad_()
    loss = tm.loss(tparams, tb)
    l16 = float(jax.jit(jm.loss)(params, jb))
    l32 = float(jax.jit(jm32.loss)(params32, jb))
    assert abs(float(loss.detach()) - l16) <= max(abs(l16 - l32), 1e-2)
    loss.backward()
    assert all(bool(torch.isfinite(t.grad.float()).all())
               for t in tree_leaves(tparams) if t.grad is not None)


# --------------------------------------------------------------------------
# freezing
# --------------------------------------------------------------------------


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
    """Stage 0 trains two mLSTM layers under a GQA proxy; stage 1 an mLSTM
    and the sLSTM behind a frozen prefix."""
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jplan, tplan, jfr, jac, tfr, tac = _stage_trees(jm, params, tm, tparams,
                                                    stage)
    jb, tb = _batch(jcfg, seed=3)
    want = jfz.stage_loss_fn(jm, jplan, remat=False)(jac, jfr, jb)
    for remat in (False, True):
        got = tfz.stage_loss_fn(tm, tplan, remat=remat)(tac, tfr, tb)
        np.testing.assert_allclose(float(got), float(want), **F32_TOL)


# --------------------------------------------------------------------------
# train(), serve()
# --------------------------------------------------------------------------

TEST_ARCH = "xlstm-350m-f32"


@pytest.fixture
def test_arch():
    """A float32 xLSTM-350M, registered in both packages for the length of
    a test."""
    base = dict(name=TEST_ARCH, **F32)
    jconfigs.register(dataclasses.replace(jconfigs.get(ARCH), **base))
    tconfigs.register(dataclasses.replace(tconfigs.get(ARCH), **base))
    yield TEST_ARCH
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    jbase._REGISTRY.pop(TEST_ARCH, None)
    tbase._REGISTRY.pop(TEST_ARCH, None)


def _patch_port_init(monkeypatch, seed=0):
    """The port's LM.init and output modules return the reference's."""
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
            _, jac = jfz.init_stage_active(
                jm, jm.init(jax.random.PRNGKey(seed)),
                jfz.make_stage_plan(jcfg, plan.stage),
                jax.random.PRNGKey(seed + 100 + plan.stage))
            active["op"] = to_torch(jac["op"], model.device)
        return frozen, active

    monkeypatch.setattr(ttr.LM, "init", init)
    monkeypatch.setattr(tfz, "init_stage_active", init_stage)


def test_train_trajectory_matches_reference(monkeypatch, test_arch):
    """``use_pallas=True`` routes the output module's GQA proxies through
    the flash kernel's plain version (the reference: its Pallas kernel in
    interpret mode); the xLSTM layers call no kernel."""
    kw = dict(reduced=True, steps=4, batch=2, seq=32, use_pallas=True,
              log_every=100, pace_kwargs=dict(min_rounds=1, mu=1,
                                              slope_lambda=5e-3, fit_window=3))
    want = jtrain_mod.train(test_arch, **kw)
    _patch_port_init(monkeypatch)
    before = tfa.launches
    got = ttrain_mod.train(test_arch, device="cpu", **kw)
    assert tfa.launches == before  # the CPU launches none
    assert got["config"].attention_impl == "pallas"
    assert [(h["stage"], h["round"]) for h in got["history"]] == \
        [(h["stage"], h["round"]) for h in want["history"]]
    assert len(got["history"]) == 4
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], **TRAJ_TOL)
        assert (a["perturbation"] is None) == (b["perturbation"] is None)
        if a["perturbation"] is not None:
            np.testing.assert_allclose(a["perturbation"], b["perturbation"],
                                       **TRAJ_TOL)
    _close_trees(got["params"], want["params"], TRAJ_TOL)


def test_train_checkpoint_resumes_bit_for_bit(monkeypatch, tmp_path):
    """The bf16 ``xlstm-350m.reduced()`` trainer with a checkpoint every
    round, crashed in stage 0's third round (the data draw raises) and
    resumed, equals the unbroken run bit for bit; the reference restores
    the final checkpoint's params bit for bit."""
    ckpts = str(tmp_path / "ckpts")
    kw = dict(steps=6, batch=2, seq=16, device="cpu", log_every=100,
              ckpt_every=1)
    want = ttrain_mod.train(ARCH, **kw)
    draws = {"n": 0}
    real_batch = ttrain_mod.make_lm_batch

    def crashing_batch(*a, **k):
        draws["n"] += 1
        if draws["n"] == 3:
            raise RuntimeError("crash")
        return real_batch(*a, **k)
    monkeypatch.setattr(ttrain_mod, "make_lm_batch", crashing_batch)
    monkeypatch.setattr(ttrain_mod, "CheckpointManager", functools.partial(
        ttrain_mod.CheckpointManager, async_save=False))
    with pytest.raises(RuntimeError, match="crash"):
        ttrain_mod.train(ARCH, ckpt_dir=ckpts, **kw)
    got = ttrain_mod.train(ARCH, ckpt_dir=ckpts, resume=True, **kw)
    tail = want["history"][2:]
    assert [(h["stage"], h["round"]) for h in got["history"]] == \
        [(h["stage"], h["round"]) for h in tail]
    for a, b in zip(tail, got["history"]):
        assert (a["loss"], a["perturbation"]) == (b["loss"], b["perturbation"])
    for a, b in zip(tree_leaves(want["params"]), tree_leaves(got["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    ck = j_restore(ckpts)
    for a, b in zip(jax.tree.leaves(ck["tree"]["params"]),
                    tree_leaves(to_numpy(got["params"]))):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8))


@pytest.mark.parametrize("kw", [dict(batch=2, prompt_len=5, gen_len=7, seed=0),
                                dict(batch=3, prompt_len=1, gen_len=4, seed=3)])
def test_serve_trajectory_matches_reference(monkeypatch, capsys, test_arch, kw):
    want = jserve_mod.serve(test_arch, **kw)
    jline = capsys.readouterr().out

    def init(self, generator):
        jm = jtr.build(jconfigs.get(test_arch).reduced())
        return to_torch(jm.init(jax.random.PRNGKey(kw["seed"])), self.device)

    monkeypatch.setattr(ttr.LM, "init", init)
    got = tserve_mod.serve(test_arch, device="cpu", **kw)
    tline = capsys.readouterr().out
    assert got["generated"].dtype == want["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert tline.split(" in ")[0] == jline.split(" in ")[0]
