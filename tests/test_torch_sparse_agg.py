"""The compressed-uplink fold and top-k selection of the port against the
JAX package. The reference's Pallas body does not trace under every JAX
version, so the fold is held against its documented plain equivalent,
``repro.kernels.ref.sparse_cohort_add_ref`` (the XLA scatter-add).

Tolerances: the CPU fold sums in index_add_ order, the reference in XLA's
scatter order, so atol 1e-6 on values of order 1. On the card the kernel's
atomics make the order vary run to run: allclose at rtol 1e-5, atol 1e-6,
never bitwise.

The JAX package is imported inside the parity tests only, so that the
kernel test runs on a machine with the card and without JAX:
``python -m pytest -q -m cuda tests/test_torch_sparse_agg.py``."""
import numpy as np
import pytest
import torch

from repro_torch.fl import compression as tcomp
from repro_torch.kernels import ops, ref, sparse_agg


def _case(name):
    rng = np.random.RandomState(0)
    if name == "random":
        K, k, L = 4, 50, 300
        idx = np.stack([rng.choice(L, k, replace=False) for _ in range(K)])
    elif name == "dup_within_rows":
        K, k, L = 3, 40, 25
        idx = rng.randint(0, L, (K, k))
    elif name == "all_one_index":
        K, k, L = 5, 7, 10
        idx = np.full((K, k), 3)
    elif name == "k1":
        K, k, L = 6, 1, 9
        idx = rng.randint(0, L, (K, k))
    else:
        raise KeyError(name)
    vals = rng.randn(K, k).astype(np.float32)
    w = rng.rand(K).astype(np.float32)
    return idx.astype(np.int32), vals, w / w.sum(), L


CASES = ["random", "dup_within_rows", "all_one_index", "k1"]


@pytest.mark.parametrize("name", CASES)
def test_plain_fold_matches_reference(name):
    import jax.numpy as jnp
    from repro.kernels.ref import sparse_cohort_add_ref as j_fold

    idx, vals, w, L = _case(name)
    want = np.asarray(j_fold(jnp.asarray(idx), jnp.asarray(vals),
                             jnp.asarray(w), L))
    got = ops.sparse_cohort_add(torch.as_tensor(idx), torch.as_tensor(vals),
                                torch.as_tensor(w), L)
    assert got.dtype == torch.float32 and got.shape == (L,)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


def test_cpu_dispatch_never_launches_the_kernel():
    idx, vals, w, L = _case("random")
    before = sparse_agg.launches
    ops.sparse_cohort_add(torch.as_tensor(idx), torch.as_tensor(vals),
                          torch.as_tensor(w), L)
    assert sparse_agg.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    idx, vals, w, L = _case("random")
    with pytest.raises(ValueError, match="CUDA"):
        sparse_agg.sparse_cohort_add(torch.as_tensor(idx),
                                     torch.as_tensor(vals),
                                     torch.as_tensor(w), L)


def _planted_ties(n=97, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.choice(np.asarray([-2.0, -1.0, 0.0, 1.0, 2.0], np.float32), n)
    x[::7] = rng.randn(len(x[::7])).astype(np.float32)
    x[5] = -0.0
    return x.astype(np.float32)


@pytest.mark.parametrize("k", [1, 10, 33, 97])
def test_topk_tie_rule_matches_reference(k):
    import jax.numpy as jnp
    from repro.fl import compression as jcomp

    x = _planted_ties()
    ji, jv = jcomp.ingraph_topk(jnp.asarray(x), k)
    ti, tv = tcomp.ingraph_topk(torch.as_tensor(x), k)
    assert ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("ratio", [0.1, 0.3, 1.0])
def test_compress_leaf_matches_reference(ratio):
    """One leaf of the compressed round on the SAME per-client params in
    both packages: indices and values equal, residuals and the folded
    aggregate allclose."""
    import jax.numpy as jnp
    from repro.fl import compression as jcomp

    rng = np.random.RandomState(1)
    K, L = 4, 257
    start = rng.randn(L).astype(np.float32)
    end = (start[None] + 0.1 * rng.randn(K, L)).astype(np.float32)
    res = (0.01 * rng.randn(K, L)).astype(np.float32)
    w = rng.rand(K).astype(np.float32)
    w /= w.sum()
    ja, jr, ji, jv = jcomp.ingraph_compress_leaf(
        jnp.asarray(start), jnp.asarray(end), jnp.asarray(res),
        jnp.asarray(w), ratio)
    ta, tr, ti, tv = tcomp.ingraph_compress_leaf(
        torch.as_tensor(start), torch.as_tensor(end), torch.as_tensor(res),
        torch.as_tensor(w), ratio)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    assert jcomp.topk_keep(L, ratio) == tcomp.topk_keep(L, ratio)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_version(cuda_device, name):
    idx, vals, w, L = _case(name)
    args = [torch.as_tensor(a, device=cuda_device) for a in (idx, vals, w)]
    before = sparse_agg.launches
    got = sparse_agg.sparse_cohort_add(*args, L)
    torch.cuda.synchronize()
    assert sparse_agg.launches == before + 1
    want = ref.sparse_cohort_add_ref(*args, L)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
