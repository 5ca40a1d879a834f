"""The flash attention of the port (kernel B4) against the JAX package.

The plain version, ``repro_torch.kernels.ref.flash_attention_ref``, is held
against the reference's Pallas kernel itself, run in interpret mode on the
CPU as the reference's own tests run it, and against the reference's plain
``repro.kernels.ref.flash_attention_ref``. The differentiable op's dq, dk
and dv are held against ``jax.vjp`` of ``repro.kernels.ops.flash_attention``.

Tolerances:
  * float32: rtol 1e-5, atol 1e-5. Both sides compute f32 scores and an f32
    softmax; only the summation order differs (the Pallas kernel sums over
    kv blocks online, the plain versions over the whole row).
  * bfloat16: rtol 1.6e-2, atol 1.6e-2, two bf16 ulps at magnitude 1. Inputs
    are the same bf16 values and every version computes in f32 inside, so
    the outputs differ only where the f32 results round to different bf16
    neighbours.
  * On the card the kernel is held against the plain version as
    ``chip_smoke.py`` holds it: |err| <= 1e-5 + 2^-7 |plain| in bf16 (it
    carries p as two bf16 terms on the tensor cores, so both versions
    compute in f32 before both round once to bf16: one or two ulps of the
    output's own magnitude; 1e-5 covers outputs near zero, where the
    tensor cores' f32 sums of q k^T leave about 1e-6), rtol 1e-5, atol
    1e-5 in f32.

The kernel's plan (``kernels/flash_attention.py:plan``), which decides
how the blocks cover the output and how much shared memory a block takes,
and its head-dim rule (``check_head_dims``: dk and dv whole 16-byte
vectors up to 256, dv apart from dk as the reference allows) are checked
here on the CPU.

The JAX package is imported inside the parity tests only, so that the
kernel test collects on a machine with the card and without JAX:
``python -m pytest -q -m cuda tests/test_torch_flash_attention.py``."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=1.6e-2, atol=1.6e-2)
KERNEL_BF16_TOL = dict(rtol=2 ** -7, atol=1e-5)

# (B, S, Hq, Hkv, d): g in {1, 2, 4}, ragged S (not a multiple of the
# reference's blocks), d = 16 (the reduced LM), 32, 112 (Zamba2-7B) and 80
# (hubert-xlarge)
CASES = [(1, 64, 4, 4, 16), (2, 40, 4, 1, 16), (1, 100, 8, 2, 32),
         (2, 128, 4, 2, 16), (1, 72, 4, 2, 112), (2, 56, 4, 4, 80)]


def _inputs(B, S, Hq, Hkv, d, seed=0, dv=None):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, Hq, d).astype(np.float32),
            rng.randn(B, S, Hkv, d).astype(np.float32),
            rng.randn(B, S, Hkv, dv or d).astype(np.float32))


def _torch(arrays, dtype, device="cpu"):
    return [torch.as_tensor(a, device=device).to(dtype) for a in arrays]


def _f32(t):
    return t.float().cpu().numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_version_matches_pallas_kernel(case, causal, dtype):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_fwd

    arrays = _inputs(*case)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jdt) for a in arrays)
    # small blocks so that S spans several q and kv blocks
    want = flash_attention_fwd(jq, jk, jv, causal=causal, block_q=32,
                               block_k=16, interpret=True)
    got = ref.flash_attention_ref(*_torch(arrays, tdt), causal=causal)
    assert got.dtype == tdt and got.shape == tuple(want.shape)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_version_matches_reference_oracle(causal, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref

    arrays = _inputs(2, 72, 8, 2, 16, seed=1)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = jref.flash_attention_ref(*(jnp.asarray(a, jdt) for a in arrays),
                                    causal=causal, scale=0.3)
    got = ops.flash_attention(*_torch(arrays, tdt), causal, 0.3)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads", [(4, 4), (4, 1), (8, 2)])
def test_gradients_match_reference_vjp(heads, causal):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    Hq, Hkv = heads
    arrays = _inputs(2, 48, Hq, Hkv, 16, seed=2)
    cot = np.random.RandomState(3).randn(2, 48, Hq, 16).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(q, k, v, causal,
                                                            None),
                       *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(cot))
    q, k, v = (t.requires_grad_() for t in _torch(arrays, torch.float32))
    got = ops.flash_attention(q, k, v, causal)
    np.testing.assert_allclose(_f32(got.detach()), np.asarray(out), **F32_TOL)
    grads = torch.autograd.grad(got, (q, k, v), torch.as_tensor(cot))
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


# dk != dv, as the reference's kernel takes them (its output is [B, S, Hq,
# dv]); the plain version and the differentiable op at both masks
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [(2, 40, 4, 2, 32, 16), (1, 50, 8, 2, 16, 48)])
def test_plain_version_matches_pallas_kernel_dk_ne_dv(case, causal, dtype):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_fwd

    B, S, Hq, Hkv, dk, dv = case
    arrays = _inputs(B, S, Hq, Hkv, dk, seed=4, dv=dv)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    want = flash_attention_fwd(*(jnp.asarray(a, jdt) for a in arrays),
                               causal=causal, block_q=32, block_k=16,
                               interpret=True)
    got = ref.flash_attention_ref(*_torch(arrays, tdt), causal=causal)
    assert got.dtype == tdt and got.shape == tuple(want.shape) == (B, S, Hq, dv)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))
    got = ops.flash_attention(*_torch(arrays, tdt), causal)
    np.testing.assert_allclose(_f32(got), np.asarray(want, np.float32),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("causal", [True, False])
def test_gradients_match_reference_vjp_dk_ne_dv(causal):
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops

    arrays = _inputs(2, 36, 4, 2, 32, seed=5, dv=16)
    cot = np.random.RandomState(6).randn(2, 36, 4, 16).astype(np.float32)
    out, vjp = jax.vjp(lambda q, k, v: jops.flash_attention(q, k, v, causal,
                                                            None),
                       *(jnp.asarray(a) for a in arrays))
    want = vjp(jnp.asarray(cot))
    q, k, v = (t.requires_grad_() for t in _torch(arrays, torch.float32))
    got = ops.flash_attention(q, k, v, causal)
    np.testing.assert_allclose(_f32(got.detach()), np.asarray(out), **F32_TOL)
    grads = torch.autograd.grad(got, (q, k, v), torch.as_tensor(cot))
    for g, w in zip(grads, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **F32_TOL)


PLAN_SEQS = (1, 17, 1000, 1024, 4096)
PLAN_WIDTHS = [(16, 16), (80, 80), (112, 112), (128, 128), (96, 64),
               (256, 256)]


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("widths", PLAN_WIDTHS)
@pytest.mark.parametrize("g", [1, 2, 4, 8])
def test_plan_covers_every_row_once(g, widths, itemsize):
    """Every (batch row, q head, position) of the output falls in exactly
    one row of one block, as the kernel assigns them; a block is its
    consumer warps x 16 rows (positions x heads); its shared memory fits a
    Hopper block with a ring of at least two slots."""
    dk, dv = widths
    Hkv = 2
    Hq = g * Hkv
    for B in (1, 3):
        for S in PLAN_SEQS:
            p = fa.plan(B, S, Hq, Hkv, dk, dv, itemsize)
            assert p.rows == p.warps * fa.MMA_ROWS == p.positions * p.heads
            assert p.heads * p.n_chunks == g and p.warps % p.heads == 0
            assert p.heads & (p.heads - 1) == 0 and p.heads <= fa.MAX_HEADS
            assert p.warps in fa.WARPS
            assert 2 <= p.stages <= fa.MAX_STAGES
            assert p.smem == fa.smem_bytes(dk, dv, itemsize, p.warps,
                                           p.stages) <= fa.SMEM_PER_BLOCK
            assert p.ceiling >= max(dk, dv) and p.kv_rows == \
                fa.KV_ROWS[itemsize]
            b, h, pos = fa.block_rows(p, B, S, Hq, Hkv)
            live = pos < S
            assert (pos >= 0).all() and (h < Hq).all() and (b < B).all()
            flat = (b[live] * S + pos[live]) * Hq + h[live]
            assert np.array_equal(np.bincount(flat, minlength=B * S * Hq),
                                  np.ones(B * S * Hq, np.int64))
            # a warp's rows are one head and 16 consecutive positions
            assert (h == h[..., :1]).all()
            assert (np.diff(pos, axis=-1) == 1).all()


def test_plan_puts_the_longest_causal_tiles_first():
    p = fa.plan(4, 1024, 32, 8, 128, 128, 2)
    _, _, pos = fa.block_rows(p, 4, 1024, 32, 8)
    first = pos[:, :, 0, 0]  # first position of each block
    assert (np.diff(first, axis=1) < 0).all()  # grid y: last tile first
    assert p.heads == 4


@pytest.mark.parametrize("dtype,dk,dv", [
    (torch.bfloat16, 8, 8), (torch.bfloat16, 24, 72),
    (torch.bfloat16, 192, 128), (torch.bfloat16, 256, 8),
    (torch.bfloat16, 200, 200), (torch.float32, 4, 4),
    (torch.float32, 12, 200), (torch.float32, 24, 24),
    (torch.float32, 256, 256)])
def test_check_head_dims_accepts_run_time_widths(dtype, dk, dv):
    itemsize = torch.tensor([], dtype=dtype).element_size()
    fa.check_head_dims(dk, dv, itemsize)
    p = fa.plan(2, 100, 8, 2, dk, dv, itemsize)
    assert p.smem <= fa.SMEM_PER_BLOCK and p.stages >= 2


@pytest.mark.parametrize("itemsize,dk,dv,bad", [
    (2, 4, 8, 4), (2, 12, 16, 12), (2, 16, 12, 12), (4, 2, 4, 2),
    (4, 8, 6, 6), (2, 264, 64, 264), (4, 64, 264, 264), (2, 0, 8, 0)])
def test_check_head_dims_names_the_bad_width(itemsize, dk, dv, bad):
    with pytest.raises(ValueError, match=f"head dim {bad} "):
        fa.check_head_dims(dk, dv, itemsize)


def test_cpu_dispatch_never_launches_the_kernel():
    q, k, v = _torch(_inputs(1, 32, 4, 2, 16), torch.float32)
    before = fa.launches
    ops.flash_attention(q, k, v, True).sum()
    q.requires_grad_()
    ops.flash_attention(q, k, v, True).sum().backward()
    assert fa.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    q, k, v = _torch(_inputs(1, 32, 4, 2, 16), torch.float32)
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention_fwd(q, k, v)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES + [(2, 1000, 32, 8, 128),
                                          (1, 257, 8, 8, 64),
                                          (2, 1024, 32, 32, 112),
                                          (1, 1000, 32, 8, 112),
                                          (4, 1024, 16, 16, 80),
                                          (1, 300, 16, 4, 80)])
def test_kernel_matches_plain_version(cuda_device, case, causal, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q, k, v = _torch(_inputs(*case), tdt, cuda_device)
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == tdt and got.shape == want.shape
    torch.testing.assert_close(
        got.float(), want.float(),
        **(F32_TOL if dtype == "float32" else KERNEL_BF16_TOL))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_shapes(cuda_device):
    q, k, v = _torch(_inputs(1, 32, 6, 4, 16), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q, k, v)
    # 18 f32 values are four 16-byte vectors and a half: off the rule
    q, k, v = _torch(_inputs(1, 32, 4, 2, 18), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dim 18 "):
        fa.flash_attention_fwd(q, k, v)


# run-time widths: (dk, dv) off the widths of the reference's configs, up
# to the ceiling of 256, dv apart from dk
RUN_TIME_WIDTHS = [(24, 24), (72, 72), (96, 96), (200, 200), (256, 256),
                   (192, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("S", [1, 17, 1000])
@pytest.mark.parametrize("widths", RUN_TIME_WIDTHS)
def test_kernel_matches_plain_version_at_run_time_widths(
        cuda_device, widths, S, causal, dtype):
    dk, dv = widths
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q, k, v = _torch(_inputs(2, S, 8, 2, dk, seed=7, dv=dv), tdt,
                     cuda_device)
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    again = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == tdt and got.shape == want.shape == (2, S, 8, dv)
    torch.testing.assert_close(
        got.float(), want.float(),
        **(F32_TOL if dtype == "float32" else KERNEL_BF16_TOL))
    bits = torch.int16 if tdt == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), again.view(bits))
