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
  * On the card the kernel rounds p to bf16 before p v on the tensor cores,
    an extra rounding of relative size 2^-9 per weight: bf16 cases are held
    at the same two ulps; f32 cases at rtol 1e-5, atol 1e-5.

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

# (B, S, Hq, Hkv, d): g in {1, 2, 4}, ragged S (not a multiple of the
# reference's blocks), d = 16 (the reduced LM), 32 and 112 (Zamba2-7B)
CASES = [(1, 64, 4, 4, 16), (2, 40, 4, 1, 16), (1, 100, 8, 2, 32),
         (2, 128, 4, 2, 16), (1, 72, 4, 2, 112)]


def _inputs(B, S, Hq, Hkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, S, Hq, d).astype(np.float32),
            rng.randn(B, S, Hkv, d).astype(np.float32),
            rng.randn(B, S, Hkv, d).astype(np.float32))


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
                                          (1, 1000, 32, 8, 112)])
def test_kernel_matches_plain_version(cuda_device, case, causal, dtype):
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q, k, v = _torch(_inputs(*case), tdt, cuda_device)
    before = fa.launches
    got = fa.flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    want = ref.flash_attention_ref(q, k, v, causal=causal)
    assert got.dtype == tdt and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(),
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_shapes(cuda_device):
    q, k, v = _torch(_inputs(1, 32, 6, 4, 16), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_attention_fwd(q, k, v)
    q, k, v = _torch(_inputs(1, 32, 4, 2, 24), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention_fwd(q, k, v)
