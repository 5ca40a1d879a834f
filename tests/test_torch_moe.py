"""The port's Mixture-of-Experts FFN (``models/moe.py``) and the MoE family
against the JAX package, on the CPU at a small size: ``grok-1-314b.
reduced()`` (4 MoE layers, d_model 64, 4 q heads over 4 kv heads of 16, 4
experts of 64, top-2, gelu, 2 freeze blocks, vocab 256) and
``deepseek-v2-236b.reduced()`` (the same widths with MLA attention, a
dense first layer, then 3 MoE layers with 1 shared expert).

Model params come from ``jax.random`` in the reference and are carried
across with ``repro_torch.convert``; in ``train()`` and ``serve()`` the
port's ``LM.init`` and ``init_stage_active`` are patched to return the
reference's params and output modules.

Tolerances:
  * float32 MoE outputs, aux losses, layers, forward, loss, decode: rtol
    1e-5, atol 1e-5 (the same f32 arithmetic summed in another order);
    the dispatch one-hots, and so every token's route, capacity slot and
    drop, exactly;
  * bfloat16 MoE outputs, by the reference's own spread rule, against the
    reference run op by op (``jax.disable_jit``): no farther from the
    reference's bf16 output than that lies from its f32 output on the
    same params, and within twice that of the f32 output (both packages
    route in f32, so the routes agree; the expert products round to bf16
    after sums taken in another order);
  * decode against the port's own full forward at ``capacity_factor=8``
    (no token drops): rtol 2e-3, atol 2e-3, as the reference's
    ``tests/test_decode_consistency.py``;
  * one federated round, a whole float32 training trajectory: rtol 1e-3,
    atol 1e-5 on losses, perturbations and params; bf16 leaves (the output
    module) rtol 8e-3, atol 1e-5 (``tests/test_torch_lm.py``);
  * a whole f32 ``serve()`` trajectory: the generated tokens bit for
    bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import freezing as jfz
from repro.data.synthetic import make_lm_batch as j_batch
from repro.launch import serve as jserve_mod
from repro.launch import train as jtrain_mod
from repro.models import moe as jmoe
from repro.models import transformer as jtr
from repro.optim import sgd as jsgd

from repro_torch import configs as tconfigs
from repro_torch.convert import to_torch
from repro_torch.core import freezing as tfz
from repro_torch.kernels import flash_attention as tfa
from repro_torch.launch import serve as tserve_mod
from repro_torch.launch import train as ttrain_mod
from repro_torch.models import moe as tmoe
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


ARCHS = ["grok-1-314b", "deepseek-v2-236b"]
F32 = dict(param_dtype="float32", compute_dtype="float32")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
TRAJ_TOL = dict(rtol=1e-3, atol=1e-5)
BF16_LEAF_TOL = dict(rtol=8e-3, atol=1e-5)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(t):
    return t.detach().float().numpy()


def _cfgs(name, **over):
    return jconfigs.get(name).reduced(**over), tconfigs.get(name).reduced(**over)


def _moe_params(jcfg, seed=0):
    """The first MoE layer's FFN params of a reference model."""
    params = jtr.build(jcfg).init(jax.random.PRNGKey(seed))
    seg = next(str(i) for i, (k, _) in enumerate(jcfg.segments())
               if k == "attn_moe")
    return jax.tree.map(lambda a: a[0], params["segments"][seg]["moe"])


def _x(shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _close_trees(t_tree, j_tree, tol, bf16_tol=None):
    tl_, jl_ = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl_) == len(jl_)
    for a, b in zip(tl_, jl_):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, jnp.dtype(b.dtype).name)
        leaf_tol = bf16_tol if bf16_tol and a.dtype == torch.bfloat16 else tol
        np.testing.assert_allclose(_tnp(a), _np(b), **leaf_tol)


# --------------------------------------------------------------------------
# configs, layout
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_models_build_with_the_reference_layout(name):
    """``LM`` builds the full-width config on the CPU (no params drawn) and
    the reduced one with the reference's tree: the same paths, shapes and
    dtypes (the router float32 in a bf16 model), expert weights drawn at
    their own fan-in."""
    ttr.build(tconfigs.get(name), "cpu")
    jcfg, tcfg = _cfgs(name)
    jp = jtr.build(jcfg).init(jax.random.PRNGKey(0))
    tp = ttr.build(tcfg, "cpu").init(torch.Generator().manual_seed(0))
    jleaves = jax.tree_util.tree_flatten_with_path(jp)[0]
    tleaves = tree_leaves(tp)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == a.shape, path
        assert b.dtype == getattr(torch, jnp.dtype(a.dtype).name), path
    moe = tp["segments"][str(len(tcfg.segments()) - 1)]["moe"]
    assert moe["router"].dtype == torch.float32
    for key, fan_in in (("w_gate", tcfg.d_model), ("w_up", tcfg.d_model),
                        ("w_down", tcfg.moe_d_ff)):
        std = float(moe[key].float().std())
        assert abs(std * fan_in ** 0.5 - 1) < 0.1, (key, std)


def test_capacities_match_reference():
    """Chunk capacity at full width (grok-1 40, deepseek-v2 6 at chunk 128)
    and at decode (twice the factor, the batch as the group: 5 and 1 at
    batch 8)."""
    for name, train_c, decode_c in (("grok-1-314b", 40, 5),
                                    ("deepseek-v2-236b", 6, 1)):
        j, t = jconfigs.get(name), tconfigs.get(name)
        dj = dataclasses.replace(j, capacity_factor=j.capacity_factor * 2)
        dt = dataclasses.replace(t, capacity_factor=t.capacity_factor * 2)
        assert tmoe._capacity(tmoe.MOE_CHUNK, t) == \
            jmoe._capacity(jmoe.MOE_CHUNK, j) == train_c
        assert tmoe._capacity(8, dt) == jmoe._capacity(8, dj) == decode_c
    assert tmoe.MOE_CHUNK == jmoe.MOE_CHUNK


# --------------------------------------------------------------------------
# dispatch and combine
# --------------------------------------------------------------------------


def _dispatch_pair(jcfg, tcfg, p, x):
    jd, jc, ja = jmoe._dispatch_combine(jnp.asarray(x), p, jcfg)
    td, tc, ta = tmoe._dispatch_combine(torch.as_tensor(x), to_torch(p), tcfg)
    np.testing.assert_array_equal(_tnp(td), _np(jd))
    np.testing.assert_allclose(_tnp(tc), _np(jc), **F32_TOL)
    np.testing.assert_allclose(float(ta), float(ja), **F32_TOL)
    return _tnp(td), _tnp(tc)


@pytest.mark.parametrize("name", ARCHS)
def test_dispatch_combine_matches_reference(name):
    jcfg, tcfg = _cfgs(name, **F32)
    p = _moe_params(jcfg)
    disp, comb = _dispatch_pair(jcfg, tcfg, p, _x((2, 32, 64), seed=1))
    C = tmoe._capacity(32, tcfg)
    assert disp.shape == (2, 32, tcfg.num_experts, C)


def test_tied_router_probabilities_pick_the_lower_expert():
    """A router whose experts 1 and 3 share one column (and experts 0 and
    2 another, lower one) ties every token's top two: both packages must
    pick experts 1 and 3 (at a capacity factor of 8, so that no choice
    drops)."""
    jcfg, tcfg = _cfgs("grok-1-314b", capacity_factor=8.0, **F32)
    p = dict(_moe_params(jcfg))
    col = _x((64,), seed=2)
    router = np.stack([col * 0.5, col, col * 0.5, col], axis=1)
    p["router"] = jnp.asarray(router, jnp.float32)
    x = np.abs(_x((1, 8, 64), seed=3))  # positive, so col . x > 0.5 col . x
    x = x * np.sign(col)[None, None]
    disp, _ = _dispatch_pair(jcfg, tcfg, p, x)
    routed = disp.sum(-1)  # [B, S, E]
    np.testing.assert_array_equal(routed[0, :, [1, 3]], 1.0)
    np.testing.assert_array_equal(routed[0, :, [0, 2]], 0.0)
    # fully tied: a zero router gives every expert the same probability
    p["router"] = jnp.zeros((64, 4), jnp.float32)
    disp, _ = _dispatch_pair(jcfg, tcfg, p, _x((1, 4, 64), seed=4))
    routed = disp.sum(-1)
    np.testing.assert_array_equal(routed[0, :, :2], 1.0)
    np.testing.assert_array_equal(routed[0, :, 2:], 0.0)


def test_capacity_overflow_drops_the_reference_choices():
    """Every token of a 32-token chunk prefers expert 2: its 20 slots (C =
    32 * 2 * 1.25 / 4) go to the earliest choices and the rest drop, in
    both packages alike; the dropped choices carry no combine weight."""
    jcfg, tcfg = _cfgs("grok-1-314b", **F32)
    p = dict(_moe_params(jcfg))
    router = np.asarray(p["router"]).copy()
    router[0, 2] = 50.0
    p["router"] = jnp.asarray(router)
    x = _x((2, 32, 64), seed=5)
    x[..., 0] = 4.0
    disp, comb = _dispatch_pair(jcfg, tcfg, p, x)
    C = tmoe._capacity(32, tcfg)
    assert C == 20
    kept = disp[:, :, 2].sum(-1)  # [B, S]: expert 2's slots taken
    np.testing.assert_array_equal(kept[:, :C], 1.0)
    np.testing.assert_array_equal(kept[:, C:], 0.0)
    assert comb[:, C:, 2].sum() == 0.0
    # the dropped share of token choices
    dropped = 1 - disp.sum() / (2 * 32 * tcfg.experts_per_token)
    assert dropped > 0


# --------------------------------------------------------------------------
# moe_forward, moe_decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_moe_forward_matches_reference_f32(name):
    """Two chunks of 128 and a short sequence (one chunk of S); the aux
    loss is the chunks' mean."""
    jcfg, tcfg = _cfgs(name, **F32)
    p = _moe_params(jcfg)
    for shape in ((2, 256, 64), (3, 24, 64)):
        x = _x(shape, seed=6)
        want, waux = jmoe.moe_forward(p, jnp.asarray(x), jcfg)
        got, gaux = tmoe.moe_forward(to_torch(p), torch.as_tensor(x), tcfg)
        assert got.dtype == torch.float32 and gaux.dtype == torch.float32
        np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)
        np.testing.assert_allclose(float(gaux), float(waux), **F32_TOL)
    with pytest.raises(AssertionError, match="moe chunk"):
        tmoe.moe_forward(to_torch(p), torch.zeros(1, 200, 64), tcfg)


@pytest.mark.parametrize("name", ARCHS)
def test_moe_forward_matches_reference_bf16(name):
    """bf16 by the spread rule against the reference run op by op."""
    jcfg, tcfg = _cfgs(name)
    p = _moe_params(jcfg)
    jcfg32 = dataclasses.replace(jcfg, **F32)
    p32 = jax.tree.map(lambda a: a.astype(jnp.float32), p)
    x = _x((2, 256, 64), seed=7)
    xb = jnp.asarray(x, jnp.bfloat16)
    with jax.disable_jit():
        ref16, aux16 = jmoe.moe_forward(p, xb, jcfg)
    ref32, aux32 = jmoe.moe_forward(p32, xb.astype(jnp.float32), jcfg32)
    got, gaux = tmoe.moe_forward(to_torch(p), torch.as_tensor(
        np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16), tcfg)
    assert got.dtype == torch.bfloat16
    ref16, ref32, got = _np(ref16), _np(ref32), _tnp(got)
    spread = np.abs(ref16 - ref32).max()
    assert 0 < spread
    assert np.abs(got - ref16).max() <= spread
    assert np.abs(got - ref32).max() <= 2 * spread
    # the routes are f32 in both: the aux losses agree as in f32
    np.testing.assert_allclose(float(gaux), float(aux16), **F32_TOL)


@pytest.mark.parametrize("name,batch", [("grok-1-314b", 8),
                                        ("deepseek-v2-236b", 8)])
def test_moe_decode_matches_reference(name, batch):
    jcfg, tcfg = _cfgs(name, **F32)
    p = _moe_params(jcfg)
    x = _x((batch, 1, 64), seed=8)
    want = jmoe.moe_decode(p, jnp.asarray(x), jcfg)
    got = tmoe.moe_decode(to_torch(p), torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)


def test_deepseek_decode_at_capacity_one_drops_as_reference():
    """deepseek-v2's full-width decode has C = 1 (batch 8, 160 experts,
    top-6): here 16 experts, top-2 and batch 3 give C = 1 too. Batch rows
    1 and 2 repeat row 0, so they want row 0's experts, whose one slot row
    0 holds: both drop every routed choice and keep only the shared
    expert's output, in both packages."""
    jcfg, tcfg = _cfgs("deepseek-v2-236b", num_experts=16, **F32)
    dcfg = dataclasses.replace(tcfg, capacity_factor=tcfg.capacity_factor * 2)
    assert tmoe._capacity(3, dcfg) == 1
    p = _moe_params(jcfg)
    x = np.repeat(_x((1, 1, 64), seed=9), 3, axis=0)
    want = jmoe.moe_decode(p, jnp.asarray(x), jcfg)
    got = tmoe.moe_decode(to_torch(p), torch.as_tensor(x), tcfg)
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)
    shared = _tnp(tmoe._shared(to_torch(p), torch.as_tensor(x), tcfg))
    np.testing.assert_allclose(_tnp(got)[1:], shared[1:], **F32_TOL)
    assert np.abs(_tnp(got)[0] - shared[0]).max() > 1e-3


# --------------------------------------------------------------------------
# layers, the LM, decode
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
def test_lm_forward_and_loss_match_reference(name):
    """Every layer (deepseek-v2's dense first layer included, with no aux
    loss) and the whole model's logits, aux loss and loss (with 0.01 aux)
    in f32."""
    jcfg, tcfg = _cfgs(name, **F32)
    jm = jtr.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm, tparams = ttr.build(tcfg, "cpu"), to_torch(params)
    x = _x((2, 32, 64), seed=10)
    for si, (kind, n) in enumerate(jcfg.segments()):
        lp = jax.tree.map(lambda a: a[0], params["segments"][str(si)])
        want, waux = jtr.layer_apply(lp, jnp.asarray(x), jcfg, kind)
        got, gaux = ttr.layer_apply(to_torch(lp), torch.as_tensor(x), tcfg,
                                    kind)
        np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)
        np.testing.assert_allclose(float(gaux), float(waux), **F32_TOL)
        assert (float(gaux) == 0.0) == (kind == "attn_mlp")
    assert [k for k, _ in tcfg.segments()][0] == (
        "attn_mlp" if tcfg.first_dense_layers else "attn_moe")
    d = j_batch(jcfg, 2, 128, seed=0)
    jb = {k: jnp.asarray(v) for k, v in d.items()}
    tb = {k: torch.as_tensor(v) for k, v in d.items()}
    jlog, jaux = jm.forward(params, jb)
    tlog, taux = tm.forward(tparams, tb)
    np.testing.assert_allclose(_tnp(tlog), _np(jlog), **F32_TOL)
    np.testing.assert_allclose(float(taux), float(jaux), **F32_TOL)
    np.testing.assert_allclose(float(tm.loss(tparams, tb)),
                               float(jm.loss(params, jb)), **F32_TOL)


@pytest.mark.parametrize("name", ARCHS)
def test_decode_matches_forward_and_reference(name):
    """8 decode steps from an empty cache at ``capacity_factor=8.0`` (no
    token drops) against the port's full forward, as the reference's
    ``tests/test_decode_consistency.py`` holds its own (grok-1 there), and
    every step's logits against the reference's decode step."""
    jcfg, tcfg = _cfgs(name, capacity_factor=8.0, **F32)
    jm = jtr.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm, tparams = ttr.build(tcfg, "cpu"), to_torch(params)
    B, T = 2, 8
    toks = np.random.RandomState(1).randint(0, tcfg.vocab_size, (B, T))
    full, _ = tm.forward(tparams, {"tokens": torch.as_tensor(toks)})
    jcache = jm.init_cache(batch=B, max_seq=T)
    tcache = tm.init_cache(batch=B, max_seq=T)
    step = jax.jit(jm.decode_step)
    for t in range(T):
        jlog, jcache = step(params, {"tokens": jnp.asarray(toks[:, t:t + 1])},
                            jcache, jnp.int32(t))
        tlog, tcache = tm.decode_step(
            tparams, {"tokens": torch.as_tensor(toks[:, t:t + 1])}, tcache, t)
        np.testing.assert_allclose(_tnp(tlog), _np(jlog), **F32_TOL)
    np.testing.assert_allclose(_tnp(tlog[:, 0]), _tnp(full[:, -1]),
                               **DECODE_TOL)


# --------------------------------------------------------------------------
# federated round, train(), serve()
# --------------------------------------------------------------------------


@pytest.mark.parametrize("name", ARCHS)
@pytest.mark.parametrize("stage", [0, 1])
def test_fed_round_step_matches_reference(name, stage):
    """One round of two pods x two local steps: the aux loss through the
    stage forward (stage 0: deepseek-v2's dense layer and a MoE layer
    active under GQA proxies; stage 1: MoE layers frozen and active, the
    real head)."""
    jcfg, tcfg = _cfgs(name, **F32)
    jm = jtr.build(jcfg)
    params = jm.init(jax.random.PRNGKey(0))
    tm, tparams = ttr.build(tcfg, "cpu"), to_torch(params)
    jplan = jfz.make_stage_plan(jcfg, stage)
    tplan = tfz.make_stage_plan(tcfg, stage)
    jfr, jac = jfz.init_stage_active(jm, params, jplan,
                                     jax.random.PRNGKey(11))
    tfr, tac = tfz.split_stage_params(tm, tparams, tplan)
    if "op" in jac:
        tac["op"] = to_torch(jac["op"])
    pods, steps, b, s = 2, 2, 2, 16
    d = j_batch(jcfg, pods * steps * b, s, seed=5)
    jfed = {k: jnp.asarray(v).reshape((pods, steps, b, s))
            for k, v in d.items()}
    tfed = {k: torch.as_tensor(v).reshape(pods, steps, b, s)
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


TEST_ARCH = "grok-1-314b-f32"


@pytest.fixture
def test_arch():
    """A float32 grok-1, registered in both packages for the length of a
    test."""
    base = dict(name=TEST_ARCH, **F32)
    jconfigs.register(dataclasses.replace(jconfigs.get(ARCHS[0]), **base))
    tconfigs.register(dataclasses.replace(tconfigs.get(ARCHS[0]), **base))
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
    """grok-1 through ``train(use_pallas=True)``: GQA, so the flash path
    (its plain version on the CPU, no launch) with the MoE aux loss in
    every stage loss."""
    kw = dict(reduced=True, steps=4, batch=2, seq=16, use_pallas=True,
              log_every=100, pace_kwargs=dict(min_rounds=1, mu=1,
                                              slope_lambda=5e-3, fit_window=3))
    want = jtrain_mod.train(test_arch, **kw)
    _patch_port_init(monkeypatch)
    before = tfa.launches
    got = ttrain_mod.train(test_arch, device="cpu", **kw)
    assert tfa.launches == before
    assert got["config"].attention_impl == "pallas"
    assert [(h["stage"], h["round"]) for h in got["history"]] == \
        [(h["stage"], h["round"]) for h in want["history"]]
    for a, b in zip(got["history"], want["history"]):
        np.testing.assert_allclose(a["loss"], b["loss"], **TRAJ_TOL)
        assert (a["perturbation"] is None) == (b["perturbation"] is None)
        if a["perturbation"] is not None:
            np.testing.assert_allclose(a["perturbation"], b["perturbation"],
                                       **TRAJ_TOL)
    _close_trees(got["params"], want["params"], TRAJ_TOL)


def test_train_use_pallas_exits_for_deepseek_mla():
    """The reference's ``SystemExit``: deepseek-v2's MLA has no kernel."""
    with pytest.raises(SystemExit, match="'mla'"):
        jtrain_mod.train(ARCHS[1], steps=2, batch=1, seq=8, use_pallas=True)
    with pytest.raises(SystemExit, match="'mla'"):
        ttrain_mod.train(ARCHS[1], steps=2, batch=1, seq=8, use_pallas=True,
                         device="cpu")


def test_serve_trajectory_matches_reference(monkeypatch, test_arch):
    """The f32 grok-1 decode loop: prompt steps and greedy tokens equal to
    the reference's, with its MoE decode dropping as the reference's."""
    kw = dict(reduced=True, batch=3, prompt_len=4, gen_len=5, seed=0)
    want = jserve_mod.serve(test_arch, **kw)
    _patch_port_init(monkeypatch)
    got = tserve_mod.serve(test_arch, device="cpu", **kw)
    assert got["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"],
                                  np.asarray(want["generated"]))
