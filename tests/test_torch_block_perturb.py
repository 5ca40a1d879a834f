"""The block-perturbation reduction of the port (kernel B3) against the JAX
package.

The plain version, ``repro_torch.kernels.ref.diff_sqnorm_ref``, takes the
difference of the f32-widened operands in f32 and squares and sums it in
f64. It is held against:
  * the reference's Pallas kernel itself, run in interpret mode on the CPU
    as the reference's own tests run it, and its plain
    ``repro.kernels.ref.diff_sqnorm_ref``, with the reference's own
    tolerance, 1e-4 relative: both reference versions accumulate in f32;
  * numpy in float64 on the same f32 values (the reference pace
    controller's arithmetic), within 1e-12 relative: only the summation
    order differs.
``tree_diff_sqnorm`` and ``ops.update_sqnorm`` are held against the
reference's, at 1e-4 relative.

On the card the kernel is held against the plain version within 1e-12
relative (both sum in f64, in other orders), at every operand type pair,
at misaligned views, at extreme magnitudes, with a NaN, at more than 2^31
elements, and two runs must give the same bits. Those tests run with
``python -m pytest -q -m cuda tests/test_torch_block_perturb.py``; the JAX
package is imported inside the parity tests only."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import block_perturb, ops, ref

REF_RTOL = 1e-4      # the reference's own, for its f32 accumulator
F64_RTOL = 1e-12     # two f64 sums of the same squares in other orders

# (n, dtype): the reference sweep's range of n (3-100,000), f32 and bf16
SWEEP = [(3, "float32"), (5, "bfloat16"), (4097, "float32"),
         (10_001, "bfloat16"), (65_537, "float32"), (100_000, "bfloat16")]


def _pair(n, dtype, seed=0, magnitude=1.0):
    """Two f32 vectors of n values, rounded to ``dtype`` when it is bf16
    (as f32 arrays, so that numpy and JAX read the same values)."""
    rng = np.random.RandomState(seed)
    a = (rng.randn(n) * magnitude).astype(np.float32)
    b = (rng.randn(n) * magnitude).astype(np.float32)
    if dtype == "bfloat16":
        a = torch.as_tensor(a).bfloat16().float().numpy()
        b = torch.as_tensor(b).bfloat16().float().numpy()
    return a, b


def _t(x, dtype, device="cpu"):
    return torch.as_tensor(x, device=device).to(getattr(torch, dtype))


def _numpy_f64(a, b):
    d = a.astype(np.float32) - b.astype(np.float32)
    return float(np.sum(np.square(d, dtype=np.float64)))


@pytest.mark.parametrize("n,dtype", SWEEP)
def test_plain_version_matches_pallas_kernel(n, dtype):
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.block_perturb import diff_sqnorm as j_kernel
    a, b = _pair(n, dtype)
    ja, jb = (jnp.asarray(x, getattr(jnp, dtype)) for x in (a, b))
    got = ref.diff_sqnorm_ref(_t(a, dtype), _t(b, dtype))
    assert got.dtype == torch.float64 and got.shape == ()
    for want in (float(j_kernel(ja, jb, block=4096, interpret=True)),
                 float(jref.diff_sqnorm_ref(ja, jb))):
        assert abs(float(got) - want) <= REF_RTOL * max(abs(want), 1.0)


@pytest.mark.parametrize("magnitude", [1e-20, 1.0, 1e15])
@pytest.mark.parametrize("n,dtype", SWEEP)
def test_plain_version_matches_numpy_float64(n, dtype, magnitude):
    """Extreme magnitudes as in the reference's sweep: at 1e-20 the squares
    are far below f32's range and at 1e15 far above it, and the f64 sum
    holds both exactly where the reference's f32 accumulator would flush
    to 0 or saturate to inf."""
    a, b = _pair(n, dtype, magnitude=magnitude)
    got = float(ref.diff_sqnorm_ref(_t(a, dtype), _t(b, dtype)))
    want = _numpy_f64(_t(a, dtype).float().numpy(),
                      _t(b, dtype).float().numpy())
    assert np.isfinite(want) and want > 0
    assert abs(got - want) <= F64_RTOL * want


def test_plain_version_mixed_operands_and_non_finite():
    a, b = _pair(1000, "float32", seed=3)
    got = float(ref.diff_sqnorm_ref(_t(a, "bfloat16"), _t(b, "float32")))
    want = _numpy_f64(_t(a, "bfloat16").float().numpy(), b)
    assert abs(got - want) <= F64_RTOL * want
    a[17] = np.nan
    assert np.isnan(float(ref.diff_sqnorm_ref(_t(a, "float32"),
                                              _t(b, "float32"))))
    a[17] = np.inf
    assert float(ref.diff_sqnorm_ref(_t(a, "float32"),
                                     _t(b, "float32"))) == np.inf


def _trees(seed=0):
    rng = np.random.RandomState(seed)
    t1 = {"a": rng.randn(37, 5).astype(np.float32),
          "b": {"c": rng.randn(11).astype(np.float32)}}
    t2 = {"a": t1["a"] + 0.5, "b": {"c": t1["b"]["c"] - 0.25}}
    return t1, t2


def _tree(t, fn):
    return {k: _tree(v, fn) if isinstance(v, dict) else fn(v)
            for k, v in t.items()}


def test_update_sqnorm_matches_reference():
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    from repro.kernels.block_perturb import tree_diff_sqnorm as j_tree
    t1, t2 = _trees()
    j1, j2 = _tree(t1, jnp.asarray), _tree(t2, jnp.asarray)
    got = ops.update_sqnorm(_tree(t1, torch.as_tensor),
                            _tree(t2, torch.as_tensor))
    assert got.dtype == torch.float32 and got.shape == ()
    for want in (float(j_tree(j1, j2, interpret=True)),
                 float(jops.update_sqnorm(j1, j2))):
        assert abs(float(got) - want) <= REF_RTOL * max(abs(want), 1.0)
    # each leaf through ops.diff_sqnorm (f64), summed
    per_leaf = (float(ops.diff_sqnorm(torch.as_tensor(t1["a"]),
                                      torch.as_tensor(t2["a"])))
                + float(ops.diff_sqnorm(torch.as_tensor(t1["b"]["c"]),
                                        torch.as_tensor(t2["b"]["c"]))))
    assert abs(per_leaf - float(got)) <= 1e-6 * per_leaf


def test_cpu_dispatch_never_launches_the_kernel():
    a, b = _pair(100, "float32")
    before = block_perturb.launches
    ops.diff_sqnorm(_t(a, "float32"), _t(b, "float32"))
    ops.update_sqnorm({"x": _t(a, "float32")}, {"x": _t(b, "float32")})
    assert block_perturb.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    a, b = _pair(100, "float32")
    with pytest.raises(ValueError, match="CUDA"):
        block_perturb.diff_sqnorm_f64(_t(a, "float32"), _t(b, "float32"))


@pytest.mark.parametrize("n", [1, 3, 4095, 4096, 4097, 10 ** 6,
                               1_745_000_000, 2 ** 31 + 17])
@pytest.mark.parametrize("sms", [132, 1])
def test_plan_depends_on_n_and_sms_only(n, sms):
    blocks = block_perturb.plan(n, sms)
    assert 1 <= blocks <= block_perturb.BLOCKS_PER_SM * sms
    # every block has at least one iteration's elements, or there is one
    per_block = block_perturb.THREADS * block_perturb.ELEMS_PER_THREAD
    assert blocks == 1 or n >= (blocks - 1) * per_block
    assert block_perturb.plan(n, sms) == blocks


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


def _plain_chunked(a, b, chunk=1 << 26):
    """The plain version over chunks of a and b (flat), summed in f64: its
    f64 temporaries stay small at any n."""
    a, b = a.reshape(-1), b.reshape(-1)
    parts = [ref.diff_sqnorm_ref(a[i:i + chunk], b[i:i + chunk])
             for i in range(0, a.numel(), chunk)]
    return float(torch.stack(parts).sum())


def _kernel_vs_plain(a, b):
    before = block_perturb.launches
    got = block_perturb.diff_sqnorm_f64(a, b)
    again = block_perturb.diff_sqnorm_f64(a, b)
    torch.cuda.synchronize()
    assert block_perturb.launches == before + 2
    assert got.dtype == torch.float64 and got.shape == ()
    assert got.item() == again.item() or np.isnan(got.item())  # same bits
    want = _plain_chunked(a, b)
    if np.isnan(want):
        assert np.isnan(got.item())
    else:
        assert abs(got.item() - want) <= F64_RTOL * abs(want), (got, want)
    return got.item()


@pytest.mark.cuda
@pytest.mark.parametrize("da,db", [("float32", "float32"),
                                   ("bfloat16", "bfloat16"),
                                   ("bfloat16", "float32"),
                                   ("float32", "bfloat16")])
@pytest.mark.parametrize("n", [3, 7, 8, 9, 4097, 100_003, 10 ** 7 + 5])
def test_kernel_matches_plain_version(cuda_device, da, db, n):
    a, b = _pair(n, "float32", seed=n)
    _kernel_vs_plain(_t(a, da, cuda_device), _t(b, db, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("da,db", [("float32", "float32"),
                                   ("bfloat16", "float32"),
                                   ("bfloat16", "bfloat16")])
@pytest.mark.parametrize("off_a,off_b", [(1, 0), (0, 3), (1, 3), (2, 6),
                                         (5, 1), (7, 7)])
def test_kernel_at_misaligned_views(cuda_device, da, db, off_a, off_b):
    """Views at element offsets inside larger buffers, as a leaf's slice of
    a flat snapshot is: some reach a common 16-byte boundary after a short
    head, some never do (every load scalar)."""
    n = 1_000_003
    a, b = _pair(n + 8, "float32", seed=off_a * 8 + off_b)
    ta, tb = _t(a, da, cuda_device), _t(b, db, cuda_device)
    _kernel_vs_plain(ta[off_a:off_a + n], tb[off_b:off_b + n])


@pytest.mark.cuda
@pytest.mark.parametrize("magnitude", [1e-20, 1e15])
@pytest.mark.parametrize("n", [5, 4097, 10_001])
def test_kernel_at_extreme_magnitudes(cuda_device, magnitude, n):
    a, b = _pair(n, "float32", magnitude=magnitude)
    got = _kernel_vs_plain(_t(a, "float32", cuda_device),
                           _t(b, "float32", cuda_device))
    assert np.isfinite(got) and got > 0


@pytest.mark.cuda
def test_kernel_propagates_nan(cuda_device):
    a, b = _pair(100_000, "float32")
    a[54_321] = np.nan
    assert np.isnan(_kernel_vs_plain(_t(a, "float32", cuda_device),
                                     _t(b, "float32", cuda_device)))


@pytest.mark.cuda
def test_kernel_past_2_to_the_31_elements(cuda_device):
    """A bf16 pair of 2^31 + 4099 elements (8.6 GB): 64-bit indexing. The
    values are drawn on the card."""
    n = 2 ** 31 + 4099
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    a = torch.randn(n, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    b = torch.randn(n, generator=gen, device=cuda_device,
                    dtype=torch.bfloat16)
    _kernel_vs_plain(a, b)
    # the tail past 2^31 counts: change one element there
    b[-3] += 100.0
    _kernel_vs_plain(a, b)


@pytest.mark.cuda
def test_tree_diff_sqnorm_and_ops_on_the_card(cuda_device):
    t1, t2 = _trees()
    c1 = _tree(t1, lambda x: torch.as_tensor(x, device=cuda_device))
    c2 = _tree(t2, lambda x: torch.as_tensor(x, device=cuda_device))
    h1, h2 = _tree(t1, torch.as_tensor), _tree(t2, torch.as_tensor)
    before = block_perturb.launches
    got = block_perturb.tree_diff_sqnorm(c1, c2)
    via_ops = ops.update_sqnorm(c1, c2)
    leaf = block_perturb.diff_sqnorm(c1["a"], c2["a"])
    assert block_perturb.launches == before + 5
    assert leaf.dtype == torch.float32 and leaf.item() == \
        block_perturb.diff_sqnorm_f64(c1["a"], c2["a"]).float().item()
    want = ops.update_sqnorm(h1, h2)
    assert got.dtype == via_ops.dtype == torch.float32
    assert got.item() == via_ops.item()
    np.testing.assert_allclose(got.item(), want.item(), rtol=1e-6)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    a = torch.zeros(8, device=cuda_device)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        block_perturb.diff_sqnorm_f64(a.half(), a)
    with pytest.raises(ValueError, match="as many elements"):
        block_perturb.diff_sqnorm_f64(a, torch.zeros(9, device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        block_perturb.diff_sqnorm_f64(torch.zeros(4, 4, device=cuda_device).t(),
                                      torch.zeros(16, device=cuda_device))
    with pytest.raises(ValueError, match="CUDA"):
        block_perturb.diff_sqnorm_f64(a, torch.zeros(8))
    assert block_perturb.diff_sqnorm_f64(a[:0], a[:0]).item() == 0.0
