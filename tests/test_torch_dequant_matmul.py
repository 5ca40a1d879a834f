"""The port's dequantizing GEMM (``ops.dequant_matmul``, kernel B2) against
the JAX package's ``repro.kernels.ops.dequant_matmul``, whose Pallas body
runs here in interpret mode, on the cases of the reference's conformance
harness (``tests/test_kernel_conformance.py``): int8 rows with the 2-D
quantizer's [M, 1] scales, ragged shapes, every scale layout, float q,
zero-amax rows, denormal scales, near-overflow magnitudes, bf16 out, bad
scale shapes, and the gradients with respect to the scale and w.

Tolerances. Forward: the port's plain version (one f32 CPU product) and the
Pallas body (256-deep blocks summed in grid order) add the same products in
other orders, so rtol 1e-5 and atol 1e-5 * max(1, max |want|), the
reference harness's ``_close``; bf16 out 1e-2 (one bf16 rounding). The
gradients are linear probes of the output, held by the same ``_close``.

On the card the kernel is held against the plain version by the f32
summation bound for two orders of the same products, per output
``|kernel - plain| <= 2 K 2^-24 (|q s| @ |w|) + K 2^-149`` (the last term
is gradual underflow's absolute rounding, for denormal products), plus one
bf16 ulp of the plain value for bf16 out; the bound must fail for a plain
version missing the kernel's last split-K slice, and a rerun gives equal
bits. Those tests are marked ``cuda`` and skip without a card.

The JAX package is imported inside the parity tests only, so that the
kernel tests run on a machine with the card and without JAX:
``python -m pytest -q -m cuda tests/test_torch_dequant_matmul.py``."""
import numpy as np
import pytest
import torch

from repro_torch.fl import quant as tq
from repro_torch.kernels import dequant_matmul as dqmm
from repro_torch.kernels import ops, ref


def _close(got, want, tol=1e-5):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.all(np.isfinite(got) == np.isfinite(want))
    atol = tol * max(1.0, float(np.max(np.abs(want))) if want.size else 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _rand(seed, shape, scale=1.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale,
                      np.float32)


def _reference(q, scale, w, **kw):
    """``repro.kernels.ops.dequant_matmul`` (interpret mode off the TPU)
    on the numpy inputs, as numpy f32."""
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    out = jops.dequant_matmul(jnp.asarray(q), jnp.asarray(scale),
                              jnp.asarray(w), **kw)
    return np.asarray(out.astype(jnp.float32))


def _quantized(x):
    q, s = tq.quantize_int8(torch.as_tensor(x))
    return q.numpy(), s.numpy()


def _port(q, scale, w, **kw):
    return ops.dequant_matmul(torch.as_tensor(q), torch.as_tensor(scale),
                              torch.as_tensor(w), **kw)


# ---------------------------------------------------------------------------
# forward parity, CPU (the plain version) against the Pallas body
# ---------------------------------------------------------------------------


def test_int8_row_scales_match_reference():
    """The reference's production configuration: int8 rows and the [N, 1]
    scales the 2-D quantizer emits."""
    q, s = _quantized(_rand(0, (32, 48), 3.0))
    w = _rand(1, (48, 16))
    assert s.shape == (32, 1)
    _close(_port(q, s, w), _reference(q, s, w))


@pytest.mark.parametrize("m,k,n,block", [(1, 1, 1, 8), (7, 70, 3, 16),
                                         (70, 1, 70, 32), (33, 64, 5, 8),
                                         (64, 70, 1, 16), (19, 23, 41, 32)])
def test_shape_sweep_matches_reference(m, k, n, block):
    """Ragged (M, K, N) against several Pallas block tilings: the port
    masks the tails, the reference pads them."""
    q, s = _quantized(_rand(m * 1000 + k * 10 + n, (m, k), 2.0))
    w = _rand(7, (k, n))
    _close(_port(q, s, w),
           _reference(q, s, w, block_m=block, block_n=block, block_k=block))


@pytest.mark.parametrize("kind", ["row", "col", "full", "scalar"])
def test_scale_layouts_match_reference(kind):
    M, K, N = 19, 33, 11
    q = _rand(3, (M, K), 4.0).astype(np.int8)
    shapes = {"row": (M, 1), "col": (K,), "full": (M, K), "scalar": ()}
    scale = np.abs(_rand(4, shapes[kind])) + np.float32(0.01)
    w = _rand(5, (K, N))
    _close(_port(q, scale, w),
           _reference(q, scale, w, block_m=16, block_n=16, block_k=16))


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_float_q_matches_reference(dtype, tol):
    """Float q: widened to f32 before the scale multiply. bf16 q crosses
    bit for bit (``convert.leaf_to_torch``)."""
    import jax.numpy as jnp
    from repro_torch.convert import leaf_to_torch
    qj = jnp.asarray(_rand(11, (24, 40))).astype(getattr(jnp, dtype))
    scale = np.abs(_rand(12, (24, 1))) + np.float32(0.1)
    w = _rand(13, (40, 8))
    got = ops.dequant_matmul(leaf_to_torch(np.asarray(qj), "cpu"),
                             torch.as_tensor(scale), torch.as_tensor(w))
    _close(got, _reference(qj, scale, w, block_m=16, block_n=16,
                           block_k=16), tol)


@pytest.mark.parametrize("shape", [(1, 1, 1), (5, 3, 2), (257, 129, 65)])
def test_ragged_tails_match_reference(shape):
    M, K, N = shape
    q, s = _quantized(_rand(M + K + N, (M, K), 2.0))
    w = _rand(99, (K, N))
    _close(_port(q, s, w), _reference(q, s, w))


def test_zero_amax_rows_are_exact_zeros():
    x = _rand(21, (16, 24), 2.0)
    x[[3, 11]] = 0.0
    q, s = _quantized(x)
    assert (s[[3, 11]] == 1.0).all()
    w = _rand(22, (24, 6))
    got = _port(q, s, w)
    _close(got, _reference(q, s, w, block_m=8, block_n=8, block_k=8))
    assert (got.numpy()[[3, 11]] == 0.0).all()


def test_denormal_scales_match_reference():
    q = _rand(31, (12, 20), 40.0).astype(np.int8)
    scale = np.full((12, 1), 1e-40, np.float32)
    w = _rand(32, (20, 4))
    _close(_port(q, scale, w),
           _reference(q, scale, w, block_m=8, block_n=8, block_k=8))


def test_near_overflow_magnitudes_match_reference():
    q = np.asarray([[1, -2], [3, 4]], np.int8)
    scale = np.asarray([[1e19], [1e18]], np.float32)
    w = np.asarray([[1.0, -0.5], [0.25, 1.0]], np.float32)
    got = _port(q, scale, w)
    assert torch.isfinite(got).all()
    _close(got, _reference(q, scale, w, block_m=8, block_n=8, block_k=8))


def test_bf16_out_matches_reference():
    import jax.numpy as jnp
    q, s = _quantized(_rand(41, (16, 16)))
    w = _rand(42, (16, 16))
    got = _port(q, s, w, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    _close(got.float(), _reference(q, s, w, out_dtype=jnp.bfloat16), 1e-2)


def test_normalize_scale_follows_reference_order():
    """The reference's order of checks: a 1-D scale of length K is a column
    scale even when M == K; 0-d, (1,) and (1, 1) broadcast as columns."""
    from repro.kernels.dequant_matmul import normalize_scale as j_norm
    import jax.numpy as jnp
    for shape, M, K in [((4,), 4, 4), ((4,), 4, 6), ((6,), 4, 6), ((), 3, 5),
                        ((1,), 3, 5), ((1, 1), 3, 5), ((3, 1), 3, 5),
                        ((1, 5), 3, 5), ((3, 5), 3, 5)]:
        s = np.arange(1, 1 + int(np.prod(shape)), dtype=np.float32).reshape(
            shape)
        kind, view = ref.normalize_scale(torch.as_tensor(s), M, K)
        j_kind, j_view = j_norm(jnp.asarray(s), M, K)
        assert kind == j_kind, (shape, M, K)
        np.testing.assert_array_equal(view.numpy(), np.asarray(j_view))


@pytest.mark.parametrize("shape", [(4, 8, 1), (3, 5), (7,)])
def test_bad_scale_shape_raises(shape):
    q = torch.zeros(4, 8, dtype=torch.int8)
    with pytest.raises(ValueError):
        ref.normalize_scale(torch.ones(shape), 4, 8)
    with pytest.raises(ValueError):
        ops.dequant_matmul(q, torch.ones(shape), torch.ones(8, 2))


# ---------------------------------------------------------------------------
# gradients: autograd through the plain version against jax.grad
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["row", "col1d", "full", "scalar"])
def test_grads_match_jax_grad(layout):
    """d/d(scale, w) of a linear probe of the output against ``jax.grad``
    through the reference's custom_vjp; the scale's gradient in the
    caller's shape of the scale."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    M, K, N = 20, 28, 12
    q, s_row = _quantized(_rand(51, (M, K), 2.0))
    scale = {"row": s_row, "col1d": np.abs(_rand(54, (K,))) + 0.1,
             "full": np.abs(_rand(55, (M, K))) + 0.1,
             "scalar": np.float32(0.7).reshape(())}[layout]
    w = _rand(52, (K, N))
    probe = _rand(53, (M, N))

    def f_ref(s_, w_):
        return jnp.sum(jnp.asarray(probe) * jops.dequant_matmul(
            jnp.asarray(q), s_, w_, block_m=16, block_n=16, block_k=16))

    gs_j, gw_j = jax.grad(f_ref, argnums=(0, 1))(jnp.asarray(scale),
                                                 jnp.asarray(w))
    ts = torch.as_tensor(scale).requires_grad_()
    tw = torch.as_tensor(w).requires_grad_()
    (torch.as_tensor(probe) * ops.dequant_matmul(torch.as_tensor(q), ts,
                                                 tw)).sum().backward()
    assert ts.grad.shape == ts.shape
    _close(ts.grad.numpy(), np.asarray(gs_j))
    _close(tw.grad.numpy(), np.asarray(gw_j))


def test_1d_row_scale_gradient_lands_in_its_shape():
    """A 1-D scale of length M (M != K) is a row scale. The reference's
    Pallas forward takes it, but its custom_vjp backward broadcasts the
    scale by numpy rules against [M, K] and raises; the port's plain
    version reshapes it by ``normalize_scale`` first, so its gradient is
    the [M, 1] scale's (held against ``jax.grad``), in the shape [M]."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    M, K, N = 6, 10, 3
    q, s = _quantized(_rand(81, (M, K), 2.0))
    w, probe = _rand(82, (K, N)), _rand(83, (M, N))
    gs_j = jax.grad(lambda s_: jnp.sum(jnp.asarray(probe) * jops.dequant_matmul(
        jnp.asarray(q), s_, jnp.asarray(w), block_m=8, block_n=8,
        block_k=8)))(jnp.asarray(s))
    ts = torch.as_tensor(s.reshape(M)).requires_grad_()
    (torch.as_tensor(probe) * ops.dequant_matmul(
        torch.as_tensor(q), ts, torch.as_tensor(w))).sum().backward()
    assert ts.grad.shape == (M,)
    _close(ts.grad.numpy(), np.asarray(gs_j).reshape(M))


def test_q_gets_no_gradient_and_scale_none_is_a_0d_one():
    """``tiered_matmul`` with ``x_scale=None`` multiplies by a 0-d f32 one;
    a float q that asks for a gradient gets none (it is cache data)."""
    x = torch.as_tensor(_rand(61, (6, 5))).requires_grad_()
    w = torch.as_tensor(_rand(62, (5, 3))).requires_grad_()
    out = tq.tiered_matmul(x, None, w)
    torch.testing.assert_close(out, x.detach() @ w.detach(), rtol=1e-6,
                               atol=1e-6)
    out.sum().backward()
    assert x.grad is None and w.grad is not None


def test_tiered_matmul_matches_reference_xla_path():
    import jax.numpy as jnp
    from repro.fl import quant as jq
    x = _rand(91, (18, 26), 2.0)
    q, s = _quantized(x)
    w = _rand(92, (26, 10))
    for a, sc in ((q, s), (x, None)):
        want = jq.tiered_matmul(jnp.asarray(a), None if sc is None else
                                jnp.asarray(sc), jnp.asarray(w))
        got = tq.tiered_matmul(torch.as_tensor(a), None if sc is None else
                               torch.as_tensor(sc), torch.as_tensor(w))
        _close(got, np.asarray(want))


def test_cpu_dispatch_never_launches_the_kernel():
    q, s = _quantized(_rand(71, (8, 8)))
    before = dqmm.launches
    _port(q, s, _rand(72, (8, 4)))
    assert dqmm.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    q, s = _quantized(_rand(73, (8, 8)))
    with pytest.raises(ValueError, match="CUDA"):
        dqmm.dequant_matmul(torch.as_tensor(q), torch.as_tensor(s),
                            torch.as_tensor(_rand(74, (8, 4))))


@pytest.mark.parametrize("M,N,K,sms", [(32, 512, 16384, 132),
                                       (32, 512, 32768, 132),
                                       (4096, 512, 16384, 132),
                                       (1, 1, 1, 132), (257, 65, 129, 132),
                                       (5, 2, 3, 8)])
def test_split_k_plan_covers_k(M, N, K, sms):
    """Slices of whole k steps of M's tile class that cover K, none empty,
    and a grid of about one block an SM where K allows it. At the slice's
    main shape (M 32, K 16,384, N 512) on 132 SMs: 16 slices of 1,024 over
    8 tiles; at M 4,096 one slice (128 tiles of 128 x 128)."""
    splits, per = dqmm.plan(M, N, K, sms)
    assert per % dqmm.TILES[dqmm.block_m(M, K)][1] == 0 and splits >= 1
    assert splits * per >= K > (splits - 1) * per
    assert dqmm.plan(M, N, K, sms) == (splits, per)
    if (M, N, K) == (32, 512, 16384):
        assert (splits, per) == (16, 1024)
    if (M, N) == (4096, 512):
        assert splits == 1 and dqmm.block_m(M, K) == 128


# ---------------------------------------------------------------------------
# the kernel's arithmetic, emulated on the CPU
# ---------------------------------------------------------------------------


def _top16(x):
    """The upper half of each f32's bits: x truncated to a bf16 value."""
    return (np.asarray(x, np.float32).view(np.uint32)
            & np.uint32(0xFFFF0000)).view(np.float32)


def _split3(x):
    """The kernel's ``split3``: x as hi + mid + lo, each a bf16 value held
    in f32, by truncation (a +-inf keeps all of itself in hi)."""
    x = np.asarray(x, np.float32)
    hi = _top16(x)
    with np.errstate(invalid="ignore"):
        r = np.where(hi == x, np.float32(0), x - hi).astype(np.float32)
    mid = _top16(r)
    return hi, mid, _top16(r - mid)


# the kernel's products of (w term, q term) besides hi x hi, smallest first,
# by (w terms, q terms); the 3 x 3 case keeps the six of weight >= 2^-16
_REST = {(1, 1): [], (2, 1): [(1, 0)], (3, 1): [(2, 0), (1, 0)],
         (1, 3): [(0, 2), (0, 1)],
         (3, 3): [(2, 0), (0, 2), (1, 1), (1, 0), (0, 1)]}


def _emulate(q, scale, w, w_terms=3, sms=132):
    """The kernel's sums (its 32- and 64-row classes) in numpy f32: per
    slice of ``plan`` and per k, the kept products of bf16 terms (each
    exact in f32) added in f32, hi x hi in one sum and the smaller ones
    (smallest first) in another; the two added, the slices added in order;
    then the row scale of a one-term q (int8 or bf16 q under a row or 0-d
    scale) in the epilogue. A row whose scale is not finite is summed per
    element, sum_k (q s) w, and left unscaled. ``w_terms`` keeps the first
    1, 2 or 3 of w's terms (a bf16 w is its own hi)."""
    q, w = np.asarray(q), np.asarray(w, np.float32)
    scale = np.asarray(scale, np.float32)
    M, K = q.shape
    N = w.shape[1]
    kind, sv = ref.normalize_scale(torch.as_tensor(scale), M, K)
    sv = sv.numpy()
    qf = q.astype(np.float32)
    one_term = ((scale.size == 1 or kind == "row")
                and q.dtype != np.float32)
    if one_term:
        srow = np.broadcast_to(scale.reshape(-1, 1), (M, 1))
        a_terms = [qf]
    else:
        a_terms = list(_split3((qf * sv).astype(np.float32)))
    w_t = _split3(w)[:w_terms]
    pairs = _REST[len(w_t), len(a_terms)]
    splits, per = dqmm.plan(M, N, K, sms)
    total = np.zeros((M, N), np.float32)
    for z in range(splits):
        hi = np.zeros((M, N), np.float32)
        rest = np.zeros((M, N), np.float32)
        for k in range(z * per, min(K, (z + 1) * per)):
            for i, t in pairs:
                rest += a_terms[t][:, k:k + 1] * w_t[i][k]
            hi += a_terms[0][:, k:k + 1] * w_t[0][k]
        total += hi + rest
    if not one_term:
        return total
    out = total.copy()
    with np.errstate(invalid="ignore", over="ignore"):
        fin = np.isfinite(srow[:, 0])
        out[fin] = srow[fin] * total[fin]
        for r in np.flatnonzero(~fin):
            v = np.zeros(N, np.float32)
            for k in range(K):
                v += (qf[r, k] * srow[r, 0]) * w[k]
            out[r] = v
    return out


def _jax_ref(q, scale, w):
    """The JAX package's ``dequant_matmul_ref`` on numpy inputs."""
    import jax.numpy as jnp
    from repro.kernels.ref import dequant_matmul_ref
    return np.asarray(dequant_matmul_ref(jnp.asarray(q), jnp.asarray(scale),
                                         jnp.asarray(w)))


def _bound_np(q, scale, w):
    return f32_sum_bound(torch.as_tensor(q), torch.as_tensor(scale),
                         torch.as_tensor(w)).numpy()


def test_split3_is_exact_down_to_2_pow_minus_110():
    """hi + mid + lo == x bit for bit, each term a bf16 value, for finite f32
    x from 2^-110 up (10^6 normals scaled over 2^-110 .. 2^20, and f32's
    extremes); below, lo is a bf16 subnormal and drops bits: 2^-111 (1 +
    2^-23) is the first power-of-two binade where the split is not exact."""
    rng = np.random.RandomState(0)
    x = rng.randn(10 ** 6) * np.exp2(rng.randint(-110, 21, 10 ** 6))
    x = np.concatenate([x, [np.finfo(np.float32).max, -np.finfo(
        np.float32).max, 2.0 ** -110 * (1 + 2.0 ** -23), 1 + 2.0 ** -23]])
    x = x.astype(np.float32)
    x = x[np.abs(x) >= 2.0 ** -110]
    terms = _split3(x)
    for t in terms:
        assert (t.view(np.uint32) & 0xFFFF).max() == 0  # bf16 values
    total = terms[0].astype(np.float64) + terms[1] + terms[2]
    np.testing.assert_array_equal(total, x.astype(np.float64))
    edge = np.float32(2.0 ** -111 * (1 + 2.0 ** -23))
    assert sum(float(t) for t in _split3(edge)) != float(edge)
    hi, mid, lo = _split3(np.float32([np.inf, -np.inf]))
    assert np.array_equal(hi, [np.inf, -np.inf]) and not mid.any() \
        and not lo.any()


def test_int8_is_exact_in_bf16():
    """Every int8 value, and so every int8 q, is one exact bf16 term."""
    v = torch.arange(-128, 128, dtype=torch.int8)
    assert torch.equal(v.to(torch.bfloat16).float(), v.float())
    assert np.array_equal(_top16(v.numpy().astype(np.float32)),
                          v.numpy().astype(np.float32))


def _emu_case(name, K=2048):
    """numpy inputs of the main shape (M 32, N 512) cut to ``K``, from a
    seed: int8 rows of the quantizer with row scales, w ~ N(0, 1 / K)."""
    rng = np.random.RandomState(7)
    M, N = 32, 512
    x = rng.randn(M, K).astype(np.float32)
    if name == "zero rows":
        x[[3, 11]] = 0
    q, s = _quantized(x)
    w = (rng.randn(K, N) / np.sqrt(K)).astype(np.float32)
    if name == "denormal s":
        s = np.full_like(s, 1e-40)
    elif name == "near overflow":
        s = np.full_like(s, 1e36)
        w = ((rng.rand(K, N) * 2 - 1) / K).astype(np.float32)
    elif name == "bf16 w":
        w = torch.as_tensor(w).to(torch.bfloat16).float().numpy()
    elif name == "f32 q":
        q = x
    elif name == "col scale":
        s = (rng.rand(K) * 0.05 + 0.001).astype(np.float32)
    elif name == "full scale":
        s = (rng.rand(M, K) * 0.05 + 0.001).astype(np.float32)
    elif name == "0-d scale":
        s = np.float32(0.02).reshape(())
    return q, s, w


@pytest.mark.parametrize("name", ["main cut", "zero rows", "denormal s",
                                  "near overflow", "bf16 w", "0-d scale",
                                  "col scale", "full scale", "f32 q"])
def test_emulated_kernel_sums_hold_the_bound(name):
    """The emulated kernel against the JAX package's ``dequant_matmul_ref``
    by ``f32_sum_bound`` at the main shape cut to K 2,048 (8 slices of 256
    by ``plan``): one-term q with three-term w (the main path), bf16 w (one
    term), and the three-term q cases (col and full scales, f32 q) with
    the six products of 3 x 3 that the kernel keeps. XLA on the CPU flushes
    subnormal products to zero, so the denormal case is held against the
    port's plain version, which keeps them, as the card does."""
    q, s, w = _emu_case(name)
    assert dqmm.plan(32, 512, 2048, 132) == (8, 256)
    got = _emulate(q, s, w)
    if name == "denormal s":
        want = ref.dequant_matmul_ref(torch.as_tensor(q), torch.as_tensor(s),
                                      torch.as_tensor(w)).double().numpy()
        assert np.abs(want).max() > 0
    else:
        want = _jax_ref(q, s, w)
    err = np.abs(got.astype(np.float64) - want)
    assert np.isfinite(got).all()
    assert (err <= _bound_np(q, s, w)).all(), float(
        (err / _bound_np(q, s, w)).max())
    if name == "zero rows":
        assert (got[[3, 11]] == 0).all()


@pytest.mark.parametrize("K,w_terms,holds", [(32, 3, True), (32, 2, False),
                                             (2048, 2, True),
                                             (2048, 1, False)])
def test_term_count_against_the_bound(K, w_terms, holds):
    """Why f32 w takes three terms. The bound allows 2 K 2^-24 of |q s| @
    |w|, so a term count shows at small K: cut to K 32, two terms (16 bits
    of w) break it where three hold it; at K 2,048 two still hold it and
    one (w truncated to bf16) breaks it. Three terms make every product
    exact, so the kernel differs from the plain version only in the order
    of its sums, at every K."""
    q, s, w = _emu_case("main cut", K)
    err = np.abs(_emulate(q, s, w, w_terms).astype(np.float64)
                 - _jax_ref(q, s, w))
    assert bool((err <= _bound_np(q, s, w)).all()) == holds


def test_emulated_nonfinite_row_scales_give_the_plain_pattern():
    """Rows whose scale is inf or NaN take the per-element route: the plain
    version's NaN (inf over q with zeros, NaN) and +-inf (inf over q of one
    sign, w >= 0); the scale applied in the epilogue would give +-inf for
    the first and lose the pattern."""
    q, s, w = _emu_case("main cut", 256)
    w = np.abs(w)
    q[7], q[8] = 3, -2
    s[1], s[5], s[7], s[8] = np.inf, np.nan, np.inf, np.inf
    got, want = _emulate(q, s, w), _jax_ref(q, s, w)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.isinf(got), np.isinf(want))
    assert np.isnan(got[[1, 5]]).all()
    assert (got[7] == np.inf).all() and (got[8] == -np.inf).all()
    assert np.array_equal(got[np.isinf(want)], want[np.isinf(want)])
    with np.errstate(invalid="ignore", over="ignore"):
        factored = s[1] * (q[1].astype(np.float32) @ w)
    assert not np.isnan(factored).all()


# ---------------------------------------------------------------------------
# the kernel on the card against its plain version
# ---------------------------------------------------------------------------


def f32_sum_bound(q, scale, w):
    """Per output, ``2 K 2^-24 (|q s| @ |w|) + K 2^-149``, in f64."""
    K = q.shape[1]
    _, s = ref.normalize_scale(scale, q.shape[0], K)
    mag = (q.double() * s.double()).abs() @ w.double().abs()
    return 2 * K * 2.0 ** -24 * mag + K * 2.0 ** -149


def _bf16_ulp(x):
    """One bf16 ulp of |x| (the spacing at its binade; the least normal's
    below it)."""
    e = torch.floor(torch.log2(x.abs().double().clamp_min(2.0 ** -126)))
    return torch.pow(2.0, e - 7)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


def _card_case(name, dev):
    g = torch.Generator(device=dev).manual_seed(0)
    if name.startswith("main"):
        M, K, N = 32, 16384, 512
    elif name == "M4096":
        M, K, N = 4096, 2048, 512
    else:
        M, K, N = (int(v) for v in name.split("x"))
    x = torch.randn(M, K, generator=g, device=dev)
    q, s = tq.quantize_int8(x)
    w = torch.randn(K, N, generator=g, device=dev) / K ** 0.5
    if name == "main_bf16w":
        w = w.to(torch.bfloat16)
    return q, s, w


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["main", "main_bf16w", "M4096", "1x1x1",
                                  "5x3x2", "257x129x65"])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_holds_the_summation_bound(cuda_device, name, out_dtype):
    q, s, w = _card_case(name, cuda_device)
    before = dqmm.launches
    got = dqmm.dequant_matmul(q, s, w, out_dtype)
    again = dqmm.dequant_matmul(q, s, w, out_dtype)
    torch.cuda.synchronize()
    assert dqmm.launches == before + 2
    assert got.dtype == out_dtype and got.shape == (q.shape[0], w.shape[1])
    assert torch.equal(got, again)
    want = ref.dequant_matmul_ref(q, s, w, out_dtype)
    bound = f32_sum_bound(q, s, w)
    if out_dtype == torch.bfloat16:
        bound = bound + _bf16_ulp(want.double())
    err = (got.double() - want.double()).abs()
    assert bool((err <= bound).all()), float((err - bound).max())


@pytest.mark.cuda
def test_bound_sees_a_missing_split_k_slice(cuda_device):
    q, s, w = _card_case("main", cuda_device)
    splits, per = dqmm.plan(q.shape[0], w.shape[1], q.shape[1],
                            torch.cuda.get_device_properties(
                                cuda_device).multi_processor_count)
    cut = (splits - 1) * per
    short = ref.dequant_matmul_ref(q[:, :cut], s, w[:cut])
    got = dqmm.dequant_matmul(q, s, w)
    assert bool(((got.double() - short.double()).abs()
                 > f32_sum_bound(q, s, w)).any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["col", "full", "scalar"])
def test_kernel_scale_layouts_and_float_q(cuda_device, kind):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    M, K, N = 19, 333, 70
    scale = {"col": torch.rand(K, generator=g, device=cuda_device) + 0.1,
             "full": torch.rand(M, K, generator=g, device=cuda_device) + 0.1,
             "scalar": torch.tensor(0.3, device=cuda_device)}[kind]
    w = torch.randn(K, N, generator=g, device=cuda_device)
    for q in (torch.randint(-127, 128, (M, K), generator=g,
                            device=cuda_device).to(torch.int8),
              torch.randn(M, K, generator=g, device=cuda_device),
              torch.randn(M, K, generator=g,
                          device=cuda_device).to(torch.bfloat16)):
        got = dqmm.dequant_matmul(q, scale, w)
        want = ref.dequant_matmul_ref(q, scale, w)
        err = (got.double() - want.double()).abs()
        assert bool((err <= f32_sum_bound(q, scale, w)).all())


@pytest.mark.cuda
def test_kernel_rejects_bad_dtypes(cuda_device):
    q = torch.zeros(4, 8, dtype=torch.int16, device=cuda_device)
    s = torch.ones(4, 1, device=cuda_device)
    w = torch.ones(8, 2, device=cuda_device)
    with pytest.raises(TypeError):
        dqmm.dequant_matmul(q, s, w)
    with pytest.raises(TypeError):
        dqmm.dequant_matmul(q.to(torch.int8), s.double(), w)
    with pytest.raises(ValueError):
        dqmm.dequant_matmul(q.to(torch.int8), torch.ones(3, device=cuda_device),
                            w)


# (q dtype, scale layout, w dtype): the term counts (one-term q under a row
# or 0-d scale, else three; one-term bf16 w, three-term f32 w) of every
# instantiation
_TERM_CASES = [(qd, kind, wd) for qd in ("int8", "bfloat16", "float32")
               for kind in ("row", "scalar", "col", "full")
               for wd in ("float32", "bfloat16")]


@pytest.mark.cuda
@pytest.mark.parametrize("M,K", [(20, 333), (50, 333), (300, 333),
                                 (50, 16384), (300, 100)])
@pytest.mark.parametrize("qd,kind,wd", _TERM_CASES)
def test_kernel_term_instantiations(cuda_device, M, K, qd, kind, wd):
    """Every (q, scale, w) instantiation in each tile class (M 20: 32 rows,
    M 50: 64, M 300: 128, and 64 below ``CHAIN_MIN_K``), at widths whose
    rows are not whole 16-byte vectors (K 333, N 70: the narrow-copy and
    element paths) and split K at K 16,384: the bound, equal bits on a
    rerun."""
    g = torch.Generator(device=cuda_device).manual_seed(M + K)
    N = 70
    x = torch.randn(M, K, generator=g, device=cuda_device)
    if qd == "int8":
        q = torch.randint(-127, 128, (M, K), generator=g,
                          device=cuda_device).to(torch.int8)
    else:
        q = x.to(getattr(torch, qd))
    scale = {"row": torch.rand(M, 1, generator=g, device=cuda_device) + 0.1,
             "scalar": torch.tensor(0.3, device=cuda_device),
             "col": torch.rand(K, generator=g, device=cuda_device) + 0.1,
             "full": torch.rand(M, K, generator=g, device=cuda_device)
             + 0.1}[kind]
    w = (torch.randn(K, N, generator=g, device=cuda_device)
         / K ** 0.5).to(getattr(torch, wd))
    got = dqmm.dequant_matmul(q, scale, w)
    again = dqmm.dequant_matmul(q, scale, w)
    want = ref.dequant_matmul_ref(q, scale, w)
    err = (got.double() - want.double()).abs()
    assert torch.equal(got, again)
    assert bool((err <= f32_sum_bound(q, scale, w)).all()), float(
        (err / f32_sum_bound(q, scale, w)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("qd", ["int8", "float32"])
def test_kernel_nonfinite_row_scales_give_the_plain_pattern(cuda_device,
                                                           qd):
    """Rows whose scale is inf or NaN: the plain version's NaN and +-inf
    (one-term int8 q: the per-element route for those rows; three-term f32
    q: for the blocks that meet them), the other rows within the bound."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    M, K, N = 32, 4096, 512
    q, s = tq.quantize_int8(torch.randn(M, K, generator=g,
                                        device=cuda_device))
    q[7], q[8] = 3, -2
    if qd == "float32":
        q = q.float()
    w = (torch.rand(K, N, generator=g, device=cuda_device) + 0.5) / K ** 0.5
    s[1], s[5], s[7], s[8] = float("inf"), float("nan"), float("inf"), \
        float("inf")
    got = dqmm.dequant_matmul(q, s, w)
    want = ref.dequant_matmul_ref(q, s, w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.isinf(got), torch.isinf(want))
    assert bool(torch.isnan(got[[1, 5]]).all())
    assert bool((got[7] == float("inf")).all())
    assert bool((got[8] == -float("inf")).all())
    fin = torch.isfinite(s[:, 0])
    err = (got[fin].double() - want[fin].double()).abs()
    assert bool((err <= f32_sum_bound(q[fin], s[fin], w)).all())
