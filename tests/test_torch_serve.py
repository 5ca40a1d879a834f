"""The port's KV-cache decode and serving driver against the JAX package,
on the CPU at a small size: the reduced dense GQA configs (4 layers,
d_model 64, 4 q heads, head_dim 16, vocab 256), with 2 kv heads (g = 2)
where a test says so, and the reduced xLSTM (recurrent states) and
MiniCPM3 (MLA latent caches) configs in the decode-step cases.

Model params come from ``jax.random`` in the reference and are converted
(``repro_torch.convert``); in ``serve()`` the port's ``LM.init`` is patched
to return the reference's params. Prompts are numpy ``RandomState``
draws in both packages, so they are the same tokens.

Tolerances:
  * float32 attention, layers, logits and caches: rtol 1e-5, atol 1e-5
    (the same f32 arithmetic summed in another order);
  * bfloat16: ``LM_BF16_TOL`` of ``tests/test_torch_lm.py`` (rtol 2e-2,
    atol 6e-2): both sides round scores, probabilities and every matrix
    product's output to bf16 at the same places, after sums taken in
    another order;
  * decode against the port's own full forward: rtol 2e-3, atol 2e-3, as
    the reference's ``tests/test_decode_consistency.py``;
  * a whole f32 ``serve()`` trajectory: the generated tokens bit for bit."""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import serve as jserve_mod
from repro.models import attention as jattn
from repro.models import transformer as jtr

from repro_torch import configs as tconfigs
from repro_torch.convert import to_numpy, to_torch
from repro_torch.kernels import decode_attention as tdec
from repro_torch.launch import serve as tserve_mod
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


F32 = dict(param_dtype="float32", compute_dtype="float32")
F32_TOL = dict(rtol=1e-5, atol=1e-5)
LM_BF16_TOL = dict(rtol=2e-2, atol=6e-2)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)
ARCHS = ["llama3-8b", "qwen2-72b", "deepseek-coder-33b", "xlstm-350m",
         "minicpm3-4b"]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tnp(t):
    return t.detach().float().numpy()


def _cfgs(name="llama3-8b", **over):
    return (jconfigs.get(name).reduced(**over),
            tconfigs.get(name).reduced(**over))


def _model_and_params(jcfg, tcfg, seed=0):
    jm = jtr.build(jcfg)
    params = jm.init(jax.random.PRNGKey(seed))
    return jm, params, ttr.build(tcfg, "cpu"), to_torch(params)


def _tokens(cfg, B, T, seed=1):
    return np.random.RandomState(seed).randint(0, cfg.vocab_size,
                                               (B, T)).astype(np.int32)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------


def test_shape_configs_match_reference():
    assert sorted(tconfigs.SHAPES) == sorted(jconfigs.SHAPES)
    for name, shape in jconfigs.SHAPES.items():
        assert dataclasses.asdict(tconfigs.SHAPES[name]) == \
            dataclasses.asdict(shape)
    assert tconfigs.DECODE_32K.seq_len == 32768
    assert (tconfigs.TRAIN_4K, tconfigs.PREFILL_32K, tconfigs.LONG_500K) == \
        (tconfigs.SHAPES["train_4k"], tconfigs.SHAPES["prefill_32k"],
         tconfigs.SHAPES["long_500k"])


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------


@pytest.mark.parametrize("pos", [0, 5, 11])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gqa_decode_matches_reference(dtype, pos):
    """One decode against a cache whose first ``pos`` rows hold values:
    the output and the whole cache after the write."""
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(num_kv_heads=2, **over)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = jax.tree.map(lambda a: a[0], params["segments"]["0"]["attn"])
    rng = np.random.RandomState(3)
    B, S = 2, 12
    x = rng.randn(B, 1, 64).astype(np.float32)
    kv = {n: rng.randn(B, S, 2, 16).astype(np.float32) for n in ("k", "v")}
    for a in kv.values():
        a[:, pos:] = 0.0  # rows at and past pos are not written yet
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jkv = {n: jnp.asarray(a, jdt) for n, a in kv.items()}
    want, jcache = jattn.gqa_decode(lp, jnp.asarray(x, jdt), jkv,
                                    jnp.int32(pos), jcfg)
    tcache = {n: torch.as_tensor(a).to(tdt) for n, a in kv.items()}
    got, out_cache = tattn.gqa_decode(to_torch(lp), torch.as_tensor(x).to(tdt),
                                      tcache, pos, tcfg)
    assert out_cache is tcache and got.dtype == tdt
    tol = F32_TOL if dtype == "float32" else LM_BF16_TOL
    np.testing.assert_allclose(_tnp(got), _np(want), **tol)
    for n in ("k", "v"):
        assert out_cache[n].dtype == tdt
        np.testing.assert_allclose(_tnp(out_cache[n]), _np(jcache[n]), **tol)


def test_unported_layer_kinds_raise():
    """The MoE kind ``attn_moe``, which raised here until the MoE slice
    ported it, decodes one token as the reference's ``layer_decode`` does
    (grok-1 reduced, f32: its GQA attention over a cache with 5 rows
    written, then the MoE FFN over the batch as one token group, at twice
    the capacity factor); an unknown kind still raises."""
    jcfg, tcfg = _cfgs("grok-1-314b", **F32)
    _, params, _, _ = _model_and_params(jcfg, tcfg)
    lp = jax.tree.map(lambda a: a[0], params["segments"]["0"])
    rng = np.random.RandomState(4)
    B, S, pos = 4, 12, 5
    x = rng.randn(B, 1, 64).astype(np.float32)
    kv = {n: rng.randn(B, S, tcfg.num_kv_heads, 16).astype(np.float32)
          for n in ("k", "v")}
    for a in kv.values():
        a[:, pos:] = 0.0
    want, jcache = jtr.layer_decode(
        lp, jnp.asarray(x), {n: jnp.asarray(a) for n, a in kv.items()},
        jnp.int32(pos), jcfg, "attn_moe")
    tcache = {n: torch.as_tensor(a) for n, a in kv.items()}
    got, out_cache = ttr.layer_decode(to_torch(lp), torch.as_tensor(x), tcache,
                                      pos, tcfg, "attn_moe")
    assert out_cache is tcache
    np.testing.assert_allclose(_tnp(got), _np(want), **F32_TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(_tnp(out_cache[n]), _np(jcache[n]),
                                   **F32_TOL)
    with pytest.raises(ValueError):
        ttr.layer_decode({}, torch.zeros(1, 1, 64), {}, 0, tcfg, "attn_vit")


# --------------------------------------------------------------------------
# LM.init_cache / LM.decode_step
# --------------------------------------------------------------------------


@pytest.mark.parametrize("arch,dtype", [
    pytest.param("llama3-8b", "float32", id="float32"),
    pytest.param("llama3-8b", "bfloat16", id="bfloat16"),
    ("xlstm-350m", "float32"), ("xlstm-350m", "bfloat16"),
    ("minicpm3-4b", "float32"), ("minicpm3-4b", "bfloat16")])
def test_init_cache_matches_reference_layout(arch, dtype):
    """Llama with 2 kv heads; xLSTM's mLSTM and sLSTM states (f32 but for
    "conv", the "m" stabilizers zero in the stacked cache, as the
    reference's); MiniCPM3's MLA latents."""
    over = F32 if dtype == "float32" else {}
    if arch == "llama3-8b":
        over = dict(over, num_kv_heads=2)
    jcfg, tcfg = _cfgs(arch, **over)
    want = jtr.build(jcfg).init_cache(batch=3, max_seq=10)
    got = ttr.build(tcfg, "cpu").init_cache(batch=3, max_seq=10)
    assert jax.tree.structure(want) == jax.tree.structure(to_numpy(got))
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(a.shape) == b.shape
        assert a.dtype == getattr(torch, jnp.dtype(b.dtype).name)
        assert not bool(a.any())


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(arch):
    """T decode steps from an empty cache give the full forward's
    last-token logits (the reference's test_decode_consistency, on the
    port alone, with params drawn by the port)."""
    tcfg = tconfigs.get(arch).reduced(**F32)
    model = ttr.build(tcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    B, T = 2, 8
    toks = torch.as_tensor(_tokens(tcfg, B, T))
    full, _ = model.forward(params, {"tokens": toks})
    cache = model.init_cache(batch=B, max_seq=T)
    for t in range(T):
        logits, cache = model.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                          cache, t)
        np.testing.assert_allclose(_tnp(logits[:, 0]), _tnp(full[:, t]),
                                   **DECODE_TOL)


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("llama3-8b", "bfloat16"),
                            ("xlstm-350m", "bfloat16"),
                            ("minicpm3-4b", "bfloat16")])
def test_decode_step_matches_reference(arch, dtype):
    """Teacher-forced: the same tokens at every step, logits compared step
    by step and the whole cache at the end. In bf16 the reference runs op by
    op (``jax.disable_jit``), as the port does: its compiled scan over the
    layers keeps bf16 intermediates in f32 (XLA's excess precision), which
    the port's eager ops round, and through xLSTM's four recurrent layers
    that parts the two by up to 0.094 in the logits (op by op, the reduced
    xLSTM's logits agree bit for bit)."""
    over = F32 if dtype == "float32" else {}
    jcfg, tcfg = _cfgs(arch, **over)
    jm, params, tm, tparams = _model_and_params(jcfg, tcfg)
    B, T, S = 2, 6, 9
    toks = _tokens(jcfg, B, T, seed=4)
    jcache = jm.init_cache(batch=B, max_seq=S)
    tcache = tm.init_cache(batch=B, max_seq=S)
    tol = F32_TOL if dtype == "float32" else LM_BF16_TOL
    eager = jax.disable_jit if dtype == "bfloat16" else contextlib.nullcontext
    for t in range(T):
        tok = toks[:, t:t + 1]
        with eager():
            jlog, jcache = jm.decode_step(params,
                                          {"tokens": jnp.asarray(tok)},
                                          jcache, jnp.int32(t))
        tlog, tcache = tm.decode_step(tparams,
                                      {"tokens": torch.as_tensor(tok)},
                                      tcache, t)
        assert tlog.shape == (B, 1, tcfg.vocab_size)
        np.testing.assert_allclose(_tnp(tlog), _np(jlog), **tol)
    for a, b in zip(tree_leaves(tcache), jax.tree.leaves(jcache)):
        np.testing.assert_allclose(_tnp(a), _np(b), **tol)


def test_decode_step_preserves_the_cache_structure():
    """The reference's test_smoke_archs decode check: finite [B, 1, V]
    logits, and the cache comes back with its structure; the port's is
    the same dict, written in place."""
    _, tcfg = _cfgs()
    model = ttr.build(tcfg, "cpu")
    params = model.init(torch.Generator().manual_seed(0))
    cache = model.init_cache(batch=2, max_seq=16)
    shapes = {k: {n: t.shape for n, t in c.items()} for k, c in cache.items()}
    before = tdec.launches
    logits, cache2 = model.decode_step(
        params, {"tokens": torch.zeros((2, 1), dtype=torch.int32)}, cache, 0)
    assert tdec.launches == before  # the CPU never launches the kernel
    assert logits.shape == (2, 1, tcfg.vocab_size)
    assert not bool(torch.isnan(logits.float()).any())
    assert cache2 is cache
    assert {k: {n: t.shape for n, t in c.items()} for k, c in cache2.items()} \
        == shapes
    assert bool(cache["0"]["k"][:, :, 0].any())
    assert not bool(cache["0"]["k"][:, :, 1:].any())


# --------------------------------------------------------------------------
# serve()
# --------------------------------------------------------------------------

TEST_ARCH = "llama3-8b-f32-serve"


@pytest.fixture
def test_arch():
    """A float32 Llama-3-8B whose ``reduced()`` has 2 kv heads, registered
    in both packages for the length of a test."""
    base = dict(name=TEST_ARCH, num_kv_heads=2, **F32)
    jconfigs.register(dataclasses.replace(jconfigs.get("llama3-8b"), **base))
    tconfigs.register(dataclasses.replace(tconfigs.get("llama3-8b"), **base))
    yield TEST_ARCH
    from repro.configs import base as jbase
    from repro_torch.configs import base as tbase
    jbase._REGISTRY.pop(TEST_ARCH, None)
    tbase._REGISTRY.pop(TEST_ARCH, None)


@pytest.mark.parametrize("kw", [dict(batch=2, prompt_len=5, gen_len=7, seed=0),
                                dict(batch=3, prompt_len=1, gen_len=4, seed=3)])
def test_serve_trajectory_matches_reference(monkeypatch, capsys, test_arch, kw):
    want = jserve_mod.serve(test_arch, **kw)
    jline = capsys.readouterr().out

    def init(self, generator):
        jm = jtr.build(jconfigs.get(test_arch).reduced())
        return to_torch(jm.init(jax.random.PRNGKey(kw["seed"])), self.device)

    monkeypatch.setattr(ttr.LM, "init", init)
    before = tdec.launches
    got = tserve_mod.serve(test_arch, device="cpu", **kw)
    tline = capsys.readouterr().out
    assert tdec.launches == before
    assert sorted(got) == sorted(want) == ["generated", "tokens_per_s"]
    assert got["generated"].dtype == want["generated"].dtype == np.int32
    np.testing.assert_array_equal(got["generated"], want["generated"])
    assert got["tokens_per_s"] > 0
    # the same printed line, up to the clock
    assert tline.split(" in ")[0] == jline.split(" in ")[0]
    assert tline.rstrip().endswith("tok/s)")


def test_serve_refuses_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tserve_mod.serve("llama3-8b", batch=1, prompt_len=2, gen_len=2)


@pytest.mark.parametrize("argv,expect", [
    ([], dict(arch="llama3-8b", reduced=True, batch=4, prompt_len=16,
              gen_len=32, device="cuda")),
    (["--arch", "qwen2-72b", "--full", "--batch", "8", "--prompt-len", "960",
      "--gen-len", "64", "--device", "cpu"],
     dict(arch="qwen2-72b", reduced=False, batch=8, prompt_len=960,
          gen_len=64, device="cpu"))])
def test_serve_main_parses_the_reference_flags(monkeypatch, argv, expect):
    seen = {}
    monkeypatch.setattr(tserve_mod, "serve",
                        lambda arch, **kw: seen.update(kw, arch=arch))
    tserve_mod.main(argv)
    assert seen == expect
