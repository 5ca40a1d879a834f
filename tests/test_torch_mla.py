"""The port's MLA (multi-head latent attention) and the MiniCPM3 family
against the JAX package, on the CPU at a small size:
``minicpm3-4b.reduced()`` (4 layers, d_model 64, 4 heads, q through a
32-rank LoRA, k/v through a 32-rank latent, q.k width 16 + 8 (rope), v
width 16, d_ff 128, 2 freeze blocks, vocab 256; the output module's proxy
layers are GQA, 4 heads of 16), and with ``q_lora_rank=0`` (a plain q
projection).

Model params come from ``jax.random`` in the reference and are carried
across with ``repro_torch.convert``; in ``train()`` and ``serve()`` the
port's ``LM.init`` and ``init_stage_active`` are patched to return the
reference's params and output modules.

Tolerances, as ``tests/test_torch_lm.py`` states them:
  * float32 attention, layers, forward, loss, stage losses, decode: rtol
    1e-5, atol 1e-5 (the same f32 arithmetic summed in another order);
    gradients: rtol 1e-4 and an atol of 1e-5 of the leaf's largest
    reference entry;
  * bfloat16: rtol 2e-2, atol 2e-2 on one attention or layer, rtol 2e-2,
    atol 6e-2 on decode outputs and caches; both sides round the two score
    products, their sum and the probabilities to bf16 at the same places.
    The whole model's bf16 logits and loss at the dense LM's rtol 2e-2,
    atol 6e-2;
  * a whole float32 training trajectory: rtol 1e-3, atol 1e-5 on losses,
    perturbations and params;
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

from repro import configs as jconfigs
from repro.checkpoint import restore_checkpoint as j_restore
from repro.core import freezing as jfz
from repro.data.synthetic import make_lm_batch as j_batch
from repro.launch import serve as jserve_mod
from repro.launch import train as jtrain_mod
from repro.models import attention as jattn
from repro.models import transformer as jtr

from repro_torch import configs as tconfigs
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import freezing as tfz
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve_mod
from repro_torch.launch import train as ttrain_mod
from repro_torch.models import attention as tattn
from repro_torch.models import transformer as ttr
from repro_torch.models.module import tree_leaves

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


ARCH = "minicpm3-4b"
F32 = dict(param_dtype="float32", compute_dtype="float32")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-3, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
LM_BF16_TOL = dict(rtol=2e-2, atol=6e-2)
MLA_LEAVES = ("wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo")


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


def _batch(cfg, b=2, s=24, seed=0):
    d = j_batch(cfg, b, s, seed=seed)
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


def _attn_params(params, i=1):
    return jax.tree.map(lambda a: a[i], params["segments"]["0"]["attn"])


# --------------------------------------------------------------------------
# config, params
# --------------------------------------------------------------------------


def test_layout_and_plans_match_reference():
    j, t = jconfigs.get(ARCH), tconfigs.get(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.attention == "mla" and t.layer_kinds() == ("attn_mlp",) * 62
    # the output module's proxies are GQA with the arch's head geometry
    assert (t.num_heads, t.num_kv_heads, t.head_dim) == (40, 40, 64)
    assert t.block_boundaries() == j.block_boundaries() == \
        (0, 11, 22, 32, 42, 52, 62)
    for jc, tc in ((j, t), _cfgs()):
        for stage in list(range(jc.num_freeze_blocks)) + [None]:
            assert tuple(tfz.make_stage_plan(tc, stage)) == \
                tuple(jfz.make_stage_plan(jc, stage))


@pytest.mark.parametrize("dtype,q_lora", [("bfloat16", 32), ("float32", 32),
                                          ("float32", 0)])
def test_init_layout_matches_reference(dtype, q_lora):
    """The port's init has the reference's tree, shapes and dtypes; the
    MLA leaves cross from the reference to the port and back, and from the
    port to numpy and back, bit for bit."""
    over = dict(F32 if dtype == "float32" else {}, q_lora_rank=q_lora)
    jcfg, tcfg = _cfgs(**over)
    params = jtr.build(jcfg).init(jax.random.PRNGKey(0))
    mine = ttr.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    assert jax.tree.structure(params) == jax.tree.structure(to_numpy(mine))
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(params)[0],
                            tree_leaves(mine)):
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == getattr(torch, jnp.dtype(a.dtype).name), path
    want = sorted(MLA_LEAVES) if q_lora else sorted(
        ("wq",) + MLA_LEAVES[3:])
    assert sorted(mine["segments"]["0"]["attn"]) == want
    for a, b in zip(jax.tree.leaves(params), tree_leaves(to_numpy(to_torch(
            params)))):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8))
    for a, b in zip(tree_leaves(mine), tree_leaves(to_torch(to_numpy(mine)))):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("S,causal,q_lora", [
    (40, True, 32), (40, False, 32), (40, True, 0), (40, False, 0),
    (2048, True, 32), (2048, False, 0)])
def test_mla_forward_matches_reference(S, causal, q_lora):
    """Below ``ATTN_BLOCK_THRESHOLD`` the dense softmax, at it the
    blockwise online softmax with dk = nope + rope = 24 and dv = 16."""
    jcfg, tcfg = _cfgs(**F32, q_lora_rank=q_lora)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = _attn_params(params)
    x = np.random.RandomState(2).randn(1, S, 64).astype(np.float32)
    want = jax.jit(lambda p, h: jattn.mla_forward(p, h, jcfg, causal=causal))(
        lp, jnp.asarray(x))
    got = tattn.mla_forward(to_torch(lp), torch.as_tensor(x), tcfg,
                            causal=causal)
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)


def test_mla_forward_matches_reference_bf16():
    jcfg, tcfg = _cfgs()
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = _attn_params(params)
    x = np.random.RandomState(3).randn(2, 40, 64).astype(np.float32)
    want = jax.jit(lambda p, h: jattn.mla_forward(p, h, jcfg))(
        lp, jnp.asarray(x, jnp.bfloat16))
    got = tattn.mla_forward(to_torch(lp), torch.as_tensor(x).bfloat16(), tcfg)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_tnp(got), _np(want), **BF16_TOL)


def test_mla_grads_match_reference():
    jcfg, tcfg = _cfgs(**F32)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = _attn_params(params)
    x = np.random.RandomState(4).randn(2, 24, 64).astype(np.float32)
    r = np.random.RandomState(5).randn(2, 24, 64).astype(np.float32)
    jgp, jgx = jax.jit(jax.grad(lambda p, h: jnp.sum(
        jattn.mla_forward(p, h, jcfg) * r), argnums=(0, 1)))(lp, jnp.asarray(x))
    tp = to_torch(lp)
    for leaf in tree_leaves(tp):
        leaf.requires_grad_()
    tx = torch.as_tensor(x).requires_grad_()
    (tattn.mla_forward(tp, tx, tcfg) * torch.as_tensor(r)).sum().backward()
    for got, want in zip([t.grad for t in tree_leaves(tp)] + [tx.grad],
                         jax.tree.leaves(jgp) + [jgx]):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_mla_never_takes_the_flash_kernel(monkeypatch):
    """The reference's MLA calls no Pallas kernel, so the port's MLA never
    reaches B4's wrapper, whatever ``attention_impl`` says."""
    def refuse(*args, **kwargs):
        raise AssertionError("MLA reached the flash kernel")
    monkeypatch.setattr(tops, "flash_attention", refuse)
    _, tcfg = _cfgs(**F32, attention_impl="pallas")
    model = ttr.build(tcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    toks = torch.zeros((1, 8), dtype=torch.int32)
    assert bool(torch.isfinite(model.forward(params, {"tokens": toks})[0]).all())


@pytest.mark.parametrize("dtype,q_lora", [("float32", 32), ("bfloat16", 32),
                                          ("float32", 0)])
def test_mla_decode_matches_reference(dtype, q_lora):
    """Seven one-token decodes into a 12-row cache (rows past ``pos``
    zero, masked at -1e9 over the whole preallocated cache): each output,
    and the whole cache after the writes, which the port makes in place."""
    over = dict(F32 if dtype == "float32" else {}, q_lora_rank=q_lora)
    jcfg, tcfg = _cfgs(**over)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = _attn_params(params)
    tp = to_torch(lp)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else LM_BF16_TOL
    B, S = 2, 12
    jcache = jattn.mla_init_cache(jcfg, B, S, jdt)
    tcache = tattn.mla_init_cache(tcfg, B, S, tdt, "cpu")
    x = np.random.RandomState(6).randn(7, B, 1, 64).astype(np.float32)
    step = jax.jit(lambda p, h, c, pos: jattn.mla_decode(p, h, c, pos, jcfg))
    for pos in range(7):
        want, jcache = step(lp, jnp.asarray(x[pos], jdt), jcache,
                            jnp.int32(pos))
        got, out = tattn.mla_decode(tp, torch.as_tensor(x[pos]).to(tdt),
                                    tcache, pos, tcfg)
        assert out is tcache and got.dtype == tdt
        np.testing.assert_allclose(_tnp(got), _np(want), **tol)
    for n in ("ckv", "kpe"):
        assert tcache[n].dtype == tdt and not bool(tcache[n][:, 7:].any())
        np.testing.assert_allclose(_tnp(tcache[n]), _np(jcache[n]), **tol)


# --------------------------------------------------------------------------
# layers, LM
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_apply_matches_reference(dtype):
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(**over)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = jax.tree.map(lambda a: a[2], params["segments"]["0"])
    x = np.random.RandomState(7).randn(2, 24, 64).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want, _ = jax.jit(lambda p, h: jtr.layer_apply(p, h, jcfg, "attn_mlp"))(
        lp, jnp.asarray(x, jdt))
    got, aux = ttr.layer_apply(to_torch(lp), torch.as_tensor(x).to(tdt), tcfg,
                               "attn_mlp")
    assert got.dtype == tdt and float(aux) == 0.0
    np.testing.assert_allclose(_tnp(got), _np(want),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def test_lm_forward_and_loss_match_reference_f32():
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    jlog, _ = jax.jit(jm.forward)(params, jb)
    tlog, _ = tm.forward(tparams, tb)
    np.testing.assert_allclose(_tnp(tlog), _np(jlog), **F32_TOL)
    np.testing.assert_allclose(float(tm.loss(tparams, tb)),
                               float(jax.jit(jm.loss)(params, jb)), **F32_TOL)
    np.testing.assert_allclose(float(ttr.token_loss(tlog, tb, tcfg)),
                               float(jtr.token_loss(jlog, jb, jcfg)), **F32_TOL)


def test_lm_forward_and_loss_match_reference_bf16():
    """bf16 logits through the whole model against the reference run op by
    op (``jax.disable_jit``: compiled, XLA keeps bf16 intermediates in f32
    inside its fusions, as ``tests/test_torch_xlstm.py`` found), held by
    the reference's own spread rule: no farther from the reference's bf16
    logits than those lie from its f32 logits on the same params (0.060 at
    this size; the port lies 0.047 away), and within twice that of the f32
    logits. The loss within the larger of the reference's own bf16-f32
    loss gap and 1e-2.

    What parts the two packages, op by op: the MLP's activation.
    ``activation("silu")`` is ``F.silu``, which rounds x * sigmoid(x) to
    bf16 once, where the reference rounds each of ``jax.nn.silu``'s ops;
    it differs from the reference in about two fifths of a layer's gate
    outputs by one bf16 ulp (``layers.silu`` keeps the reference's
    roundings and agrees bit for bit, but costs four more elementwise
    passes a layer on the card). Past it, the layer's norms, MLA attention
    and residuals agree bit for bit, and the down projection's GEMM
    differs in one output in 3,072 by one ulp (its summation order)."""
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
    l16 = float(jax.jit(jm.loss)(params, jb))
    l32 = float(jax.jit(jm32.loss)(params32, jb))
    assert abs(float(tm.loss(tparams, tb)) - l16) <= max(abs(l16 - l32), 1e-2)


@pytest.mark.parametrize("stage", [0, 1])
def test_stage_loss_matches_reference(stage):
    """MLA layers in the active block and the frozen prefix, GQA proxies in
    stage 0's output module."""
    jcfg, tcfg = _cfgs(**F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jplan = jfz.make_stage_plan(jcfg, stage)
    tplan = tfz.make_stage_plan(tcfg, stage)
    jfr, jac = jfz.init_stage_active(jm, params, jplan, jax.random.PRNGKey(11))
    tfr, tac = tfz.split_stage_params(tm, tparams, tplan)
    if "op" in jac:
        tac["op"] = to_torch(jac["op"])
    jb, tb = _batch(jcfg, seed=3)
    want = jfz.stage_loss_fn(jm, jplan, remat=False)(jac, jfr, jb)
    for remat in (False, True):
        got = tfz.stage_loss_fn(tm, tplan, remat=remat)(tac, tfr, tb)
        np.testing.assert_allclose(float(got), float(want), **F32_TOL)


# --------------------------------------------------------------------------
# train(), serve()
# --------------------------------------------------------------------------

TEST_ARCH = "minicpm3-4b-f32"


@pytest.fixture
def test_arch():
    """A float32 MiniCPM3-4B, registered in both packages for the length of
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
            jcfg = jconfigs.get(TEST_ARCH).reduced()
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
    kw = dict(reduced=True, steps=4, batch=2, seq=24, log_every=100,
              pace_kwargs=dict(min_rounds=1, mu=1, slope_lambda=5e-3,
                               fit_window=3))
    want = jtrain_mod.train(test_arch, **kw)
    _patch_port_init(monkeypatch)
    got = ttrain_mod.train(test_arch, device="cpu", **kw)
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


def test_train_use_pallas_exits_for_mla():
    """The reference's ``SystemExit``: only GQA has a kernel."""
    with pytest.raises(SystemExit, match="'mla'"):
        jtrain_mod.train(ARCH, steps=2, batch=1, seq=8, use_pallas=True)
    with pytest.raises(SystemExit, match="'mla'"):
        ttrain_mod.train(ARCH, steps=2, batch=1, seq=8, use_pallas=True,
                         device="cpu")


def test_train_checkpoint_resumes_bit_for_bit(monkeypatch, tmp_path):
    """The bf16 ``minicpm3-4b.reduced()`` trainer with a checkpoint every
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
