"""The compressed-uplink fold and top-k selection of the port against the
JAX package. The reference's Pallas body does not trace under every JAX
version, so the fold is held against its documented plain equivalent,
``repro.kernels.ref.sparse_cohort_add_ref`` (the XLA scatter-add).

Order: XLA's CPU scatter and the port's CPU fold (``index_add_``) both add
the cohort's products one at a time, client by client and entry by entry,
each add rounded once, and so does the kernel on the card. The CPU cases
are therefore held bit for bit: against the reference, and against that
sequential f32 sum written out in numpy. On the card the kernel is held
``torch.equal`` to the plain version run on the CPU, and a rerun gives
the same bits. Rows that are not non-decreasing take the wrapper's sort
(the default route); with ``sorted_rows=True`` the CPU dispatch raises on
them and the kernel fails its launch.

The JAX package is imported inside the parity tests only, so that the
kernel tests run on a machine with the card and without JAX:
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
    elif name == "sorted_runs":
        # ascending rows mixing runs of equal indices with distinct ones,
        # some indices shared across rows
        K, k, L = 5, 60, 40
        idx = np.sort(rng.randint(0, L, (K, k)), axis=1)
    elif name == "unsorted":
        K, k, L = 4, 80, 50
        idx = rng.randint(0, L, (K, k))
        idx[:, ::9] = 7  # duplicates scattered through each row
    else:
        raise KeyError(name)
    vals = rng.randn(K, k).astype(np.float32)
    w = rng.rand(K).astype(np.float32)
    return idx.astype(np.int32), vals, w / w.sum(), L


CASES = ["random", "dup_within_rows", "all_one_index", "k1", "sorted_runs",
         "unsorted"]


def _sequential(idx, vals, w, L):
    """The fold as the reference's kernel writes it: for each client, then
    each entry, ``out[i] = out[i] + w * val``, product and sum rounded to
    f32 once each."""
    out = np.zeros(L, np.float32)
    for c in range(idx.shape[0]):
        for i, v in zip(idx[c], vals[c]):
            out[i] = np.float32(out[i] + np.float32(w[c] * v))
    return out


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


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
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(_bits(want), _bits(_sequential(idx, vals,
                                                                 w, L)))


@pytest.mark.parametrize("name", CASES)
def test_sorted_rows_promise_on_the_cpu(name):
    """``sorted_rows=True`` gives the same bits where every row ascends
    (equal indices allowed) and raises where one does not."""
    idx, vals, w, L = _case(name)
    args = [torch.as_tensor(a) for a in (idx, vals, w)]
    if (np.diff(idx, axis=1) < 0).any():
        with pytest.raises(ValueError, match="decreases"):
            ops.sparse_cohort_add(*args, L, sorted_rows=True)
        return
    got = ops.sparse_cohort_add(*args, L, sorted_rows=True)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_sequential(idx, vals, w, L)))


def test_stable_row_sort_keeps_the_sum():
    """The wrapper's route for rows that do not ascend: a stable sort of
    each row, vals permuted alongside, leaves every element's products in
    entry order, so the fold's bits do not change."""
    idx, vals, w, L = _case("unsorted")
    t_idx, order = torch.sort(torch.as_tensor(idx), dim=1, stable=True)
    t_vals = torch.gather(torch.as_tensor(vals), 1, order)
    got = ops.sparse_cohort_add(t_idx.contiguous(), t_vals.contiguous(),
                                torch.as_tensor(w), L, sorted_rows=True)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_sequential(idx, vals, w, L)))


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
    """The default route (rows sorted by the wrapper when they do not
    ascend) and, where they ascend, ``sorted_rows=True``: one launch a
    call, ``torch.equal`` to the plain version on the CPU, equal bits on a
    rerun."""
    idx, vals, w, L = _case(name)
    cpu = [torch.as_tensor(a) for a in (idx, vals, w)]
    want = ref.sparse_cohort_add_ref(*cpu, L)
    args = [a.to(cuda_device) for a in cpu]
    routes = [False] + ([True] if not (np.diff(idx, axis=1) < 0).any()
                        else [])
    for sorted_rows in routes:
        before = sparse_agg.launches
        got = sparse_agg.sparse_cohort_add(*args, L, sorted_rows=sorted_rows)
        again = sparse_agg.sparse_cohort_add(*args, L,
                                             sorted_rows=sorted_rows)
        torch.cuda.synchronize()
        assert sparse_agg.launches == before + 2
        assert torch.equal(got.cpu(), want), (name, sorted_rows)
        assert torch.equal(again, got)


@pytest.mark.cuda
def test_kernel_fails_a_broken_sorted_rows_promise(cuda_device):
    """An unsorted row under ``sorted_rows=True`` fails the launch with a
    device-side assert (the CUDA context is lost, so in a process of its
    own)."""
    import os
    import subprocess
    import sys
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                       "src")
    code = (
        f"import sys\nsys.path.insert(0, {src!r})\n"
        "import torch\n"
        "from repro_torch.kernels import sparse_agg\n"
        "idx = torch.tensor([[3, 1, 2]], dtype=torch.int32, device='cuda')\n"
        "vals = torch.ones(1, 3, device='cuda')\n"
        "w = torch.ones(1, device='cuda')\n"
        "sparse_agg.sparse_cohort_add(idx, vals, w, 8, sorted_rows=True)\n"
        "torch.cuda.synchronize()\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0
    assert "assert" in (r.stdout + r.stderr).lower(), r.stderr[-2000:]
