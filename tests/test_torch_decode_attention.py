"""The flash-decode of the port (kernel B6) against the JAX package.

The plain version, ``repro_torch.kernels.ref.decode_attention_ref``, is
held against the reference's plain ``repro.kernels.ref.decode_attention_ref``
and against the reference's Pallas kernel itself, run in interpret mode on
the CPU as the reference's own tests run it, with a small ``block_k`` so
that the cache spans several kv blocks and its ragged tail is padded.

Tolerances:
  * float32: rtol 1e-6, atol 1e-6. Every version computes f32 scores and
    an f32 softmax; only the summation order differs (the Pallas kernel
    sums over kv blocks online, the plain versions over the whole row).
  * bfloat16: one bf16 ulp, counted on the bit patterns. Inputs are the
    same bf16 values and every version computes in f32 inside, so the
    outputs differ only where nearly equal f32 results round to
    neighbouring bf16 values.
  * On the card the kernel is held against the plain version as
    ``chip_smoke.py`` holds it: |err| <= 1e-6 + 2^-7 |plain| in bf16 (one
    or two ulps of the output's own magnitude: the split merge sums in
    another order before both round once to bf16; 1e-6 covers outputs
    near zero only), 1e-5 + 1e-5 |plain| in f32.

The card's decode path (``LM.decode_step``, which launches the kernel in
every layer) is held against the port's CPU path, itself held against the
JAX package by ``tests/test_torch_serve.py``: rtol 1e-3, atol 1e-5 in f32.

The JAX package is imported inside the parity tests only, so that the
kernel tests collect on a machine with the card and without JAX:
``python -m pytest -q -m cuda tests/test_torch_decode_attention.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as dec
from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=1e-6, atol=1e-6)
KERNEL_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2 ** -7, 1e-6)}

# (B, S, Hq, Hkv, d, lengths): g in {1, 4}, S not a multiple of the blocks,
# rows with length 0, a row with the whole cache
CASES = [(2, 64, 4, 4, 16, (64, 0)),
         (3, 100, 8, 2, 32, (1, 57, 100)),
         (2, 40, 4, 1, 16, (0, 0)),
         (4, 130, 16, 4, 64, (130, 65, 0, 7)),
         (2, 50, 4, 4, 112, (50, 17)),  # Zamba2-7B's head dim
         (2, 70, 4, 2, 80, (70, 33))]   # hubert-xlarge's


def _inputs(B, S, Hq, Hkv, d, lengths, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Hq, d).astype(np.float32),
            rng.randn(B, S, Hkv, d).astype(np.float32),
            rng.randn(B, S, Hkv, d).astype(np.float32),
            np.asarray(lengths, np.int32))


def _torch(arrays, dtype, device="cpu"):
    q, k, v, length = arrays
    return ([torch.as_tensor(a, device=device).to(dtype) for a in (q, k, v)]
            + [torch.as_tensor(length, device=device)])


def _bf16_ulps(got: torch.Tensor, want) -> int:
    """Largest distance, in bf16 ulps, between two bf16 arrays: sign and
    magnitude bit patterns mapped onto one ordered integer line."""
    def ordered(bits):
        bits = bits.astype(np.int32)
        return np.where(bits < 0, -(bits & 0x7FFF), bits)
    a = ordered(got.view(torch.int16).numpy())
    b = ordered(np.asarray(want).view(np.int16))
    return int(np.abs(a - b).max())


def _check(got: torch.Tensor, want, dtype: str) -> None:
    assert tuple(got.shape) == tuple(want.shape)
    if dtype == "float32":
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    else:
        assert got.dtype == torch.bfloat16
        assert _bf16_ulps(got, want) <= 1


def _jax(arrays, dtype):
    import jax.numpy as jnp
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    q, k, v, length = arrays
    return [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(length)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_kernel(case, dtype):
    from repro.kernels.decode_attention import decode_attention

    arrays = _inputs(*case)
    want = decode_attention(*_jax(arrays, dtype), block_k=32, interpret=True)
    got = ref.decode_attention_ref(*_torch(arrays, getattr(torch, dtype)))
    _check(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_reference_oracle(case, dtype):
    from repro.kernels import ref as jref

    arrays = _inputs(*case, seed=1)
    want = jref.decode_attention_ref(*_jax(arrays, dtype))
    got = ops.flash_decode(*_torch(arrays, getattr(torch, dtype)))
    _check(got, want, dtype)


def test_plain_version_scale_matches_reference_oracle():
    from repro.kernels import ref as jref

    arrays = _inputs(*CASES[1], seed=2)
    want = jref.decode_attention_ref(*_jax(arrays, "float32"), scale=0.3)
    got = ref.decode_attention_ref(*_torch(arrays, torch.float32), scale=0.3)
    _check(got, want, "float32")


def test_empty_rows_are_exact_zeros():
    q, k, v, length = _torch(_inputs(*CASES[3]), torch.float32)
    out = ref.decode_attention_ref(q, k, v, length)
    assert torch.equal(out[2], torch.zeros_like(out[2]))
    assert bool(torch.isfinite(out).all())


def test_plain_version_rejects_uneven_groups():
    q, k, v, length = _torch(_inputs(1, 16, 6, 4, 16, (3,)), torch.float32)
    with pytest.raises(ValueError, match="multiple"):
        ref.decode_attention_ref(q, k, v, length)


@pytest.mark.parametrize("shape", [(8, 1024, 32, 8), (8, 32768, 32, 8),
                                   (8, 1024, 32, 32), (8, 1000, 32, 8),
                                   (1, 17, 56, 8), (2, 64, 32, 2),
                                   (1, 524288, 32, 8)])
@pytest.mark.parametrize("sms", [132, 1])
def test_split_plan_covers_the_cache(shape, sms):
    """Every allocated row lies in exactly one split, no split is empty,
    every q head of a group lies in exactly one head chunk, and the grid
    aims at 4 blocks per SM without splits shorter than 64 rows."""
    B, S, Hq, Hkv = shape
    gc, n_chunks, chunk_rows, splits = dec.plan(B, S, Hq, Hkv, sms)
    g = Hq // Hkv
    assert gc in (1, 2, 4, 8) and gc * (n_chunks - 1) < g <= gc * n_chunks
    assert chunk_rows % dec.SPLIT_ALIGN == 0
    assert (splits - 1) * chunk_rows < S <= splits * chunk_rows
    if splits > 1:
        assert B * Hkv * n_chunks * (splits - 1) < dec.BLOCKS_PER_SM * sms


def test_cpu_dispatch_never_launches_the_kernel():
    before = dec.launches
    ops.flash_decode(*_torch(_inputs(*CASES[0]), torch.float32))
    assert dec.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        dec.decode_attention(*_torch(_inputs(*CASES[0]), torch.float32))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(arrays, dtype, device):
    q, k, v, length = _torch(arrays, getattr(torch, dtype), device)
    before = dec.launches
    got = dec.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    assert dec.launches == before + 1
    want = ref.decode_attention_ref(q, k, v, length)
    assert got.dtype == want.dtype and got.shape == want.shape
    err = (got.float() - want.float()).abs()
    rtol, atol = KERNEL_TOL[dtype]
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())
    empty = length.cpu().numpy() == 0
    assert bool((got[torch.as_tensor(empty, device=device)] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES + [
    (8, 1024, 32, 8, 128, (1, 512, 1024, 1024, 3, 700, 64, 65)),
    (2, 1000, 32, 8, 128, (999, 1000)),
    (2, 300, 56, 8, 64, (300, 129)),       # g = 7: one padded head chunk
    (2, 200, 32, 2, 32, (200, 1)),         # g = 16: two head chunks
    (1, 4096, 32, 8, 128, (4096,)),
    (8, 256, 32, 32, 112, (256, 1, 255, 128, 0, 64, 200, 17)),  # Zamba2
    (2, 300, 32, 8, 112, (300, 129)),
    (4, 1024, 16, 16, 80, (1024, 1, 517, 0)),  # hubert-xlarge
    (2, 300, 16, 4, 80, (300, 129))])
def test_kernel_matches_plain_version(cuda_device, case, dtype):
    _kernel_vs_plain(_inputs(*case), dtype, cuda_device)


@pytest.mark.cuda
def test_kernel_lengths_past_the_cache_read_the_whole_cache(cuda_device):
    _kernel_vs_plain(_inputs(2, 96, 8, 2, 16, (97, 500)), "float32",
                     cuda_device)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    q, k, v, length = _torch(_inputs(1, 32, 6, 4, 16, (3,)), torch.float32,
                             cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        dec.decode_attention(q, k, v, length)
    q, k, v, length = _torch(_inputs(1, 32, 4, 2, 24, (3,)), torch.float32,
                             cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        dec.decode_attention(q, k, v, length)
    q, k, v, length = _torch(_inputs(2, 32, 4, 2, 16, (3, 4)), torch.float32,
                             cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        dec.decode_attention(q, k[:, :16], v[:, :16], length)
    with pytest.raises(TypeError, match="int32"):
        dec.decode_attention(q, k, v, length.long())
    with pytest.raises(TypeError, match="bfloat16"):
        dec.decode_attention(q, k.bfloat16(), v, length)


@pytest.mark.cuda
def test_decode_step_on_the_card_matches_the_cpu_path(cuda_device):
    """A reduced f32 Llama-3-8B with 2 kv heads (g = 2), the same params on
    both devices, six teacher-forced steps; every attention of every step
    on the card launches the kernel."""
    from repro_torch import configs
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.models.transformer import build

    cfg = configs.get("llama3-8b").reduced(
        num_kv_heads=2, param_dtype="float32", compute_dtype="float32")
    cpu, card = build(cfg, "cpu"), build(cfg, cuda_device)
    params = cpu.init(torch.Generator().manual_seed(0))
    card_params = to_torch(to_numpy(params), cuda_device)
    toks = torch.as_tensor(np.random.RandomState(1).randint(
        0, cfg.vocab_size, (2, 6)).astype(np.int32))
    cpu_cache, card_cache = cpu.init_cache(2, 8), card.init_cache(2, 8)
    before = dec.launches
    for t in range(6):
        want, _ = cpu.decode_step(params, {"tokens": toks[:, t:t + 1]},
                                  cpu_cache, t)
        got, _ = card.decode_step(card_params, {
            "tokens": toks[:, t:t + 1].to(cuda_device)}, card_cache, t)
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   rtol=1e-3, atol=1e-5)
    assert dec.launches == before + 6 * cfg.num_layers
