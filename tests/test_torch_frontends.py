"""The port's modality frontends against the JAX package, on the CPU at a
small size: InternVL2-2B's vision stub (``internvl2-2b``, patch
embeddings through proj1, tanh gelu and proj2 in front of the text) and
HuBERT-XLarge's audio stub (``hubert-xlarge``, frame features through one
projection, an encoder with full attention and layernorm / gelu layers).
Both reduced: 4 layers, d_model 64, 4 q heads of 16, vocab 256, two freeze
blocks; InternVL2 with 2 kv heads (g = 2), 8 patch positions of 32
features; HuBERT with 4 kv heads (g = 1, as published), 32-feature frames.

Params come from ``jax.random`` in the reference and are converted
(``repro_torch.convert``); in ``train()`` and ``serve()`` the port's
``LM.init`` and ``init_stage_active`` are patched to return the
reference's params and output modules. Batches are numpy ``RandomState``
draws in both packages.

Tolerances:
  * float32 embed, forward, losses and logits: rtol 1e-5, atol 1e-5 (the
    same f32 arithmetic summed in another order);
  * float32 round steps and whole trajectories: rtol 1e-3, atol 1e-5 on
    losses, perturbations and params, as ``tests/test_torch_lm.py``; the
    bf16 output module's leaves rtol 8e-3 (two bf16 ulps: an f32 update
    one ulp apart can flip a bf16 rounding);
  * bfloat16 embed and forward: the spread rule of
    ``tests/test_torch_lm.py::test_lm_forward_bf16_matches_reference_op_by_op``
    against the reference run op by op: no farther from its bf16 result
    than that lies from its f32 result on the same params, and within
    twice that of the f32 result;
  * batches, specs and served tokens: exact."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import freezing as jfz
from repro.data import synthetic as jsyn
from repro.launch import serve as jserve_mod
from repro.launch import train as jtrain_mod
from repro.models import transformer as jtr
from repro.optim import sgd as jsgd

from repro_torch import configs as tconfigs
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core import freezing as tfz
from repro_torch.data import synthetic as tsyn
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve_mod
from repro_torch.launch import train as ttrain_mod
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


ARCHS = ["internvl2-2b", "hubert-xlarge"]
# InternVL2 at g = 2; HuBERT keeps its own g = 1 (reduced: 4 of 4 heads)
SMALL = {"internvl2-2b": dict(num_layers=4, num_freeze_blocks=2,
                              num_kv_heads=2),
         "hubert-xlarge": dict(num_layers=4, num_freeze_blocks=2)}
F32 = dict(param_dtype="float32", compute_dtype="float32")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-3, atol=1e-5)
BF16_LEAF_TOL = dict(rtol=8e-3, atol=1e-5)


def _cfgs(name, **over):
    return (jconfigs.get(name).reduced(**SMALL[name], **over),
            tconfigs.get(name).reduced(**SMALL[name], **over))


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
    d = jsyn.make_lm_batch(cfg, b, s, seed=seed)
    return ({k: jnp.asarray(v) for k, v in d.items()},
            {k: torch.as_tensor(v) for k, v in d.items()})


# --------------------------------------------------------------------------
# batches and specs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_stub_batches_are_bitwise_equal(seed):
    """VLM: ``seq`` counts the patch positions (tokens and labels get the
    rest), drawn tokens, patches, labels; audio: frames, labels."""
    for name in ARCHS:
        jc, tc = jconfigs.get(name), tconfigs.get(name)
        for cfg, tcfg in ((jc, tc), (jc.reduced(), tc.reduced())):
            a = jsyn.make_lm_batch(cfg, 3, 300, seed=seed)
            b = tsyn.make_lm_batch(tcfg, 3, 300, seed=seed)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
            if cfg.modality == "vision_stub":
                assert b["tokens"].shape == (3, 300 - cfg.num_image_tokens)
                assert b["patches"].shape == (3, cfg.num_image_tokens,
                                              cfg.frontend_dim)


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    """Every registered arch at every shape of ``kind``: the meta tensors'
    shapes and dtypes are the reference's ShapeDtypeStructs'; the audio
    encoder refuses decode with the reference's ValueError."""
    shapes = [s for s in jconfigs.SHAPES.values() if s.kind == kind]
    for name in jconfigs.names():
        jc, tc = jconfigs.get(name), tconfigs.get(name)
        for shape in shapes:
            tshape = tconfigs.SHAPES[shape.name]
            for kw in (dict(), dict(num_pods=2, local_steps=3)):
                try:
                    want = jsyn.input_specs(jc, shape, **kw)
                except ValueError as e:
                    with pytest.raises(ValueError, match=str(e)):
                        tsyn.input_specs(tc, tshape, **kw)
                    assert jc.modality == "audio_stub" and kind == "decode"
                    continue
                got = tsyn.input_specs(tc, tshape, **kw)
                assert sorted(got) == sorted(want), name
                for k, spec in want.items():
                    assert got[k].device.type == "meta"
                    assert tuple(got[k].shape) == spec.shape, (name, k)
                    assert got[k].dtype == getattr(
                        torch, jnp.dtype(spec.dtype).name), (name, k)


# --------------------------------------------------------------------------
# params, embed, forward, loss
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_frontend_layout_and_convert_match_reference(name):
    """The port's init has the reference's tree, frontend included, in the
    reference's leaf order; ``convert.py`` carries every leaf, the
    frontend's too, both ways bit for bit."""
    jcfg, tcfg = _cfgs(name)
    params = jtr.build(jcfg).init(jax.random.PRNGKey(0))
    mine = ttr.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    ja = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(ja) == len(tree_leaves(mine))
    for (path, a), b in zip(ja, tree_leaves(mine)):
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == torch.bfloat16
    want = {"internvl2-2b": {"proj1": (32, 64), "proj2": (64, 64)},
            "hubert-xlarge": {"proj": (32, 64)}}[name]
    assert {k: tuple(v["w"].shape) for k, v in mine["frontend"].items()} \
        == want
    back = to_numpy(to_torch(params))
    assert sorted(back["frontend"]) == sorted(params["frontend"])
    for a, b in zip(jax.tree.leaves(params), tree_leaves(back)):
        assert b.dtype == a.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint16),
                                      b.view(np.uint16))


@pytest.mark.parametrize("name", ARCHS)
def test_embed_and_forward_match_reference_f32(name):
    jcfg, tcfg = _cfgs(name, **F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jb, tb = _batch(jcfg)
    want_h = jm.embed(params, jb)
    got_h = tm.embed(tparams, tb)
    assert tuple(got_h.shape) == want_h.shape == (2, 24, 64)
    np.testing.assert_allclose(_tnp(got_h), _np(want_h), **F32_TOL)
    jlog, _ = jm.forward(params, jb)
    tlog, aux = tm.forward(tparams, tb)
    assert float(aux) == 0.0
    np.testing.assert_allclose(_tnp(tlog), _np(jlog), **F32_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_embed_and_forward_bf16_match_reference_op_by_op(name):
    """bf16 embed and logits against the reference run op by op, by the
    spread rule. The vision stub's gelu is ``jax.nn.gelu``'s tanh form in
    bf16 (``layers.gelu``), as is HuBERT's MLP activation."""
    jcfg, tcfg = _cfgs(name)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jm32 = jtr.build(dataclasses.replace(jcfg, **F32))
    params32 = jax.tree.map(lambda a: a.astype(jnp.float32), params)
    jb, tb = _batch(jcfg)
    with jax.disable_jit():
        ref16 = (_np(jm.embed(params, jb)), _np(jm.forward(params, jb)[0]))
    ref32 = (_np(jm32.embed(params32, jb)),
             _np(jax.jit(jm32.forward)(params32, jb)[0]))
    got = tm.embed(tparams, tb)
    assert got.dtype == torch.bfloat16
    got = (_tnp(got), _tnp(tm.forward(tparams, tb)[0]))
    for g, r16, r32 in zip(got, ref16, ref32):
        spread = np.abs(r16 - r32).max()
        assert 0 < spread
        assert np.abs(g - r16).max() <= spread
        assert np.abs(g - r32).max() <= 2 * spread


@pytest.mark.parametrize("name", ARCHS)
def test_losses_read_the_text_positions(name):
    """``LM.loss``, ``token_loss`` and ``chunked_ce_loss`` match the
    reference; for the VLM they read only the positions after the 8 patch
    positions: the loss equals the chunked CE of the text slice alone, and
    a changed patch-position hidden state moves nothing."""
    jcfg, tcfg = _cfgs(name, **F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jb, tb = _batch(jcfg, seed=2)
    np.testing.assert_allclose(float(tm.loss(tparams, tb)),
                               float(jm.loss(params, jb)), **F32_TOL)
    jlog, _ = jm.forward(params, jb)
    tlog, _ = tm.forward(tparams, tb)
    np.testing.assert_allclose(float(ttr.token_loss(tlog, tb, tcfg)),
                               float(jtr.token_loss(jlog, jb, jcfg)),
                               **F32_TOL)
    rng = np.random.RandomState(3)
    h = rng.randn(2, 24, 16).astype(np.float32)
    w = rng.randn(16, 256).astype(np.float32)
    labels = tb["labels"].numpy()
    want = jtr.chunked_ce_loss(jnp.asarray(h), jnp.asarray(w),
                               {"labels": jnp.asarray(labels)}, jcfg, chunk=8)
    got = ttr.chunked_ce_loss(torch.as_tensor(h), torch.as_tensor(w),
                              {"labels": tb["labels"]}, tcfg, chunk=8)
    np.testing.assert_allclose(float(got), float(want), **F32_TOL)
    n_img = 24 - labels.shape[1]
    assert n_img == (8 if name == "internvl2-2b" else 0)
    if n_img:
        text = ttr.chunked_ce_loss(torch.as_tensor(h[:, n_img:]),
                                   torch.as_tensor(w),
                                   {"labels": tb["labels"]}, tcfg, chunk=8)
        h2 = h.copy()
        h2[:, :n_img] += 100.0
        moved = ttr.chunked_ce_loss(torch.as_tensor(h2), torch.as_tensor(w),
                                    {"labels": tb["labels"]}, tcfg, chunk=8)
        assert float(got) == float(text) == float(moved)


# --------------------------------------------------------------------------
# freezing: stage loss, logits, federated round
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
@pytest.mark.parametrize("name", ARCHS)
def test_stage_loss_logits_and_fed_round_match_reference(name, stage):
    """Split and merge carry the frontend with the embedding (active at
    stage 0, frozen after). ``stage_loss_fn``, ``stage_logits`` and a
    two-pod, two-step ``make_fed_round_step`` match the reference. At stage
    0 the embedding and the frontend sit behind the stop-gradient boundary
    (HuBERT's token embed is not even read): the reference's zero
    gradients leave them unchanged, and so does the port."""
    jcfg, tcfg = _cfgs(name, **F32)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    jplan, tplan, jfr, jac, tfr, tac = _stage_trees(jm, params, tm, tparams,
                                                    stage)
    assert ("frontend" in tac) == ("frontend" in jac) == (stage == 0)
    assert ("frontend" in tfr) == ("frontend" in jfr) == (stage == 1)
    merged = tfz.merge_stage_params(tm, tparams, tplan,
                                    {k: v for k, v in tac.items()
                                     if k != "op"})
    _close_trees(merged, params, dict(rtol=0, atol=0))
    jb, tb = _batch(jcfg, seed=3)
    want = jfz.stage_loss_fn(jm, jplan, remat=False)(jac, jfr, jb)
    got = tfz.stage_loss_fn(tm, tplan, remat=True)(tac, tfr, tb)
    np.testing.assert_allclose(float(got), float(want), **F32_TOL)
    jlog, jaux = jfz.stage_logits(jm, jfr, jac, jb, jplan, remat=False)
    tlog, taux = tfz.stage_logits(tm, tfr, tac, tb, tplan)
    assert float(taux) == float(jaux) == 0.0
    np.testing.assert_allclose(_tnp(tlog), _np(jlog), **F32_TOL)

    pods, steps, b, s = 2, 2, 2, 16
    d = jsyn.make_lm_batch(jcfg, pods * steps * b, s, seed=5)
    jfed = {k: jnp.asarray(v).reshape((pods, steps, b) + v.shape[1:])
            for k, v in d.items()}
    tfed = {k: torch.as_tensor(v).reshape((pods, steps, b) + v.shape[1:])
            for k, v in d.items()}
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
    if stage == 0:
        for key in ("embed", "frontend"):
            for a, b_ in zip(tree_leaves(tnew[key]), tree_leaves(tac[key])):
                assert torch.equal(a, b_)
            _close_trees(tnew[key], jac[key], dict(rtol=0, atol=0))


# --------------------------------------------------------------------------
# train() and serve()
# --------------------------------------------------------------------------


@pytest.fixture(params=ARCHS)
def test_arch(request):
    """A float32 copy of the arch (InternVL2 with 2 kv heads, so its
    ``reduced()`` has g = 2), registered in both packages for the length of
    a test."""
    name = request.param
    arch = f"{name}-f32-test"
    over = dict(name=arch, **F32)
    if name == "internvl2-2b":
        over["num_kv_heads"] = 2
    jconfigs.register(dataclasses.replace(jconfigs.get(name), **over))
    tconfigs.register(dataclasses.replace(tconfigs.get(name), **over))
    yield arch
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    jbase._REGISTRY.pop(arch, None)
    tbase._REGISTRY.pop(arch, None)


def _patch_port_init(monkeypatch, arch, seed=0):
    """The port's LM.init and output modules return the reference's."""
    def init(self, generator):
        jm = jtr.build(jconfigs.get(arch).reduced())
        return to_torch(jm.init(jax.random.PRNGKey(seed)), self.device)

    port_init_stage = tfz.init_stage_active

    def init_stage(model, params, plan, generator):
        frozen, active = port_init_stage(model, params, plan, generator)
        if "op" in active:
            jcfg = dataclasses.replace(jconfigs.get(arch).reduced(),
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
    """``use_pallas=True``: the reference's Pallas flash kernel in
    interpret mode against the port's plain version (causal at g = 2 for
    InternVL2, full attention for HuBERT); the CPU launches no kernel. The
    VLM's ``seq`` of 24 holds 8 patch and 16 text positions."""
    kw = dict(reduced=True, steps=4, batch=2, seq=24, use_pallas=True,
              log_every=100, pace_kwargs=dict(min_rounds=1, mu=1,
                                              slope_lambda=5e-3, fit_window=3))
    want = jtrain_mod.train(test_arch, **kw)
    _patch_port_init(monkeypatch, test_arch)
    before = tfa.launches
    got = ttrain_mod.train(test_arch, device="cpu", **kw)
    assert tfa.launches == before
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


def test_serve_trajectory_matches_reference(monkeypatch, capsys, test_arch):
    """Both archs decode their prompts through the token embed, as the
    reference's ``decode_step`` does (HuBERT causally over its cache):
    the generated tokens are the reference's."""
    kw = dict(batch=2, prompt_len=5, gen_len=7, seed=0)
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
