"""The SSD scan of the port (kernel B5) against the JAX package.

The sequential plain version, ``repro_torch.kernels.ref.ssd_scan_ref``, is
held against the reference's ``repro.kernels.ref.ssd_scan_ref`` and against
the reference's Pallas kernel itself, run in interpret mode on the CPU as
the reference's own sweep (``tests/test_kernels.py``) runs it; the chunked
plain form, which the model runs on the CPU and the kernel's backward
differentiates, against the reference model's ``_ssd_chunked`` and its
``jax.grad``.

Inputs are numpy draws from a seed: x, B and C standard normal; the sweep's
dt = 0.3 |n| and log_a = -0.2 |n|; the model's own distributions where a
test says so (dt = softplus(n), as from a zero dt_bias, and log_a = -dt,
as from A_log = 0, so the log decay runs to about -45 within 64 rows).

Tolerances:
  * float32 plain versions against each other and the reference: rtol
    1e-5, atol 1e-5 (the same f32 function summed in another order; the
    chunked and the sequential forms differ by more than one einsum's
    order, so 1e-5 and not 1e-6);
  * against the Pallas kernel: rtol 2e-4, atol 2e-4, the reference's own
    tolerance for that kernel;
  * bfloat16 inputs (x, B, C): |err| <= 1e-4 + 2^-7 |want|, one or two
    bf16 ulps of each output (both sides compute in f32 and round once);
    the floor covers outputs near zero, where terms of up to about 150
    (|C.B| ~ 24 at N = 64, times x and dt) cancel and their f32 sums in
    two orders differ by about 1e-5;
  * gradients through the chunked form: rtol 1e-4, atol 1e-4 against
    jax.grad; the card's against the CPU's: rtol 1e-4 and a floor of 1e-5
    of the largest gradient in f32 (see the test), 2e-2 in bf16;
  * on the card the kernel is held against the sequential plain version as
    ``chip_smoke.py`` holds it: 2e-4 in f32, 1e-4 + 2^-7 |plain| in bf16;
  * the CPU emulation of the bf16 kernel's arithmetic (every f32 operand
    of a tensor-core product split into three bf16 terms, f32 sums)
    against the Pallas kernel: the Pallas tolerance, 2e-4.

The JAX package is imported inside the parity tests only, so that the
kernel tests collect on a machine with the card and without JAX:
``python -m pytest -q -m cuda tests/test_torch_ssm_scan.py``."""
import numpy as np
import pytest
import torch

from repro_torch.convert import leaf_to_torch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import ssm_scan as scan
from repro_torch.models import ssm

F32_TOL = dict(rtol=1e-5, atol=1e-5)
PALLAS_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = (2 ** -7, 1e-4)  # (rtol, atol)

# (head dim, state size) pairs the kernel's first version was built for:
# Zamba2-7B's 64/64, the reduced configs' 16/16, the reference's kernel
# sweep's (8|16, 4|16); every one stays accepted in both dtypes
FIRST_WIDTHS = ((64, 64), (16, 16), (16, 4), (8, 16), (8, 4))
# (B, S, H, hd, N, chunk): the reference's sweep widths, two chunk lengths
SWEEP = [(1, 64, 1, 8, 4, 32), (2, 64, 3, 16, 16, 64), (1, 256, 3, 8, 16, 64),
         (2, 256, 1, 16, 4, 32)]


def _inputs(B, S, H, hd, N, seed=0, real=False):
    """(x, dt, log_a, Bm, Cm) as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, S, H, hd).astype(np.float32)
    if real:
        dt = np.log1p(np.exp(rng.randn(B, S, H))).astype(np.float32)
        la = -dt
    else:
        dt = (np.abs(rng.randn(B, S, H)) * 0.3).astype(np.float32)
        la = (-np.abs(rng.randn(B, S, H)) * 0.2).astype(np.float32)
    Bm = rng.randn(B, S, N).astype(np.float32)
    Cm = rng.randn(B, S, N).astype(np.float32)
    return x, dt, la, Bm, Cm


def _torch(arrays, dtype=torch.float32, device="cpu"):
    """x, Bm and Cm in ``dtype``; dt and log_a stay float32."""
    x, dt, la, Bm, Cm = (torch.as_tensor(a, device=device) for a in arrays)
    return x.to(dtype), dt, la, Bm.to(dtype), Cm.to(dtype)


def _jax(arrays, dtype="float32"):
    import jax.numpy as jnp
    jdt = jnp.dtype(dtype)
    x, dt, la, Bm, Cm = (jnp.asarray(a) for a in arrays)
    return x.astype(jdt), dt, la, Bm.astype(jdt), Cm.astype(jdt)


def _close_bf16(got: torch.Tensor, want: torch.Tensor) -> None:
    assert got.dtype == want.dtype == torch.bfloat16
    rtol, atol = BF16_TOL
    err = (got.float() - want.float()).abs()
    assert bool((err <= atol + rtol * want.float().abs()).all()), \
        float(err.max())


# --------------------------------------------------------------------------
# plain versions against the JAX package
# --------------------------------------------------------------------------


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("case", SWEEP[:2])
def test_plain_version_matches_reference_oracle(case, real):
    from repro.kernels import ref as jref

    arrays = _inputs(*case[:5], seed=1, real=real)
    want = jref.ssd_scan_ref(*_jax(arrays))
    got = ref.ssd_scan_ref(*_torch(arrays))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)


@pytest.mark.parametrize("case", SWEEP)
def test_plain_version_matches_pallas_kernel(case):
    from repro.kernels.ssm_scan import ssd_scan

    *shape, chunk = case
    arrays = _inputs(*shape, seed=2)
    want = ssd_scan(*_jax(arrays), chunk=chunk, interpret=True)
    got = ops.ssd_scan(*_torch(arrays), chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **PALLAS_TOL)


def test_segsum_matches_reference():
    from repro.models import ssm as jssm

    la = -np.abs(np.random.RandomState(3).randn(2, 3, 9)).astype(np.float32)
    want = np.asarray(jssm._segsum(la))
    got = ref.segsum(torch.as_tensor(la)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    finite = np.isfinite(want)
    np.testing.assert_allclose(got[finite], want[finite], **F32_TOL)


@pytest.mark.parametrize("real", [False, True])
@pytest.mark.parametrize("case", [(2, 64, 3, 16, 16, 32),
                                  (1, 128, 2, 8, 4, 128)])
def test_chunked_form_matches_reference_f32(case, real):
    from repro.models import ssm as jssm

    *shape, chunk = case
    arrays = _inputs(*shape, seed=4, real=real)
    x, dt, la, Bm, Cm = _jax(arrays)
    want = jssm._ssd_chunked(x, Bm, Cm, dt, la, chunk=chunk)
    tx, tdt, tla, tB, tC = _torch(arrays)
    got = ssm._ssd_chunked(tx, tB, tC, tdt, tla, chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32_TOL)
    # and the chunked form is the sequential function
    np.testing.assert_allclose(got.numpy(), ref.ssd_scan_ref(
        tx, tdt, tla, tB, tC).numpy(), **F32_TOL)


def test_chunked_form_matches_reference_bf16():
    from repro.models import ssm as jssm

    arrays = _inputs(2, 64, 3, 16, 16, seed=5, real=True)
    x, dt, la, Bm, Cm = _jax(arrays, "bfloat16")
    want = jssm._ssd_chunked(x, Bm, Cm, dt, la, chunk=32)
    tx, tdt, tla, tB, tC = _torch(arrays, torch.bfloat16)
    got = ssm._ssd_chunked(tx, tB, tC, tdt, tla, chunk=32)
    _close_bf16(got, leaf_to_torch(want, "cpu"))


def test_chunked_form_asserts_whole_chunks():
    tx, tdt, tla, tB, tC = _torch(_inputs(1, 48, 1, 8, 4))
    with pytest.raises(AssertionError):
        ssm._ssd_chunked(tx, tB, tC, tdt, tla, chunk=32)


@pytest.mark.parametrize("real", [False, True])
def test_ops_forward_and_gradients_match_reference(real):
    """The forward is the sequential plain version; the gradients are
    autograd through the chunked form, held against jax.grad through the
    reference model's _ssd_chunked, for every input."""
    import jax
    import jax.numpy as jnp
    from repro.models import ssm as jssm

    arrays = _inputs(2, 64, 3, 16, 16, seed=6, real=real)
    cot = np.random.RandomState(7).randn(2, 64, 3, 16).astype(np.float32)

    def jloss(x, dt, la, Bm, Cm):
        y = jssm._ssd_chunked(x, Bm, Cm, dt, la, chunk=32)
        return jnp.sum(y * cot)

    want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*_jax(arrays))
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    got = ops.ssd_scan(*inputs, chunk=32)
    np.testing.assert_allclose(got.detach().numpy(),
                               ref.ssd_scan_ref(*_torch(arrays)).numpy(),
                               rtol=0, atol=0)
    grads = torch.autograd.grad(got, inputs, torch.as_tensor(cot))
    for g, w in zip(grads, want):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_cpu_dispatch_never_launches_the_kernel():
    arrays = _inputs(1, 64, 2, 8, 4)
    inputs = [t.requires_grad_() for t in _torch(arrays)]
    before = scan.launches
    ops.ssd_scan(*inputs, chunk=64).sum().backward()
    tx, tdt, tla, tB, tC = _torch(arrays)
    ssm._ssd_chunked(tx, tB, tC, tdt, tla, chunk=64)
    assert scan.launches == before


def test_kernel_wrapper_rejects_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        scan.ssd_scan(*_torch(_inputs(1, 64, 2, 8, 4)))


# --------------------------------------------------------------------------
# the kernel's widths and plan (pure Python)
# --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("widths", FIRST_WIDTHS + (
    (32, 16), (64, 128), (1, 1), (7, 5), (128, 128), (128, 1)))
def test_check_widths_accepts_run_time_widths(widths, dtype):
    scan.check_widths(*widths, dtype)


@pytest.mark.parametrize("hd,N,name", [
    (129, 64, "head dim 129"), (64, 129, "state size 129"),
    (0, 64, "head dim 0"), (64, 0, "state size 0")])
def test_check_widths_names_the_width_it_rejects(hd, N, name):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=name):
            scan.check_widths(hd, N, dtype)


def test_check_widths_rejects_other_dtypes():
    with pytest.raises(TypeError, match="float16"):
        scan.check_widths(64, 64, torch.float16)


@pytest.mark.parametrize("widths,want", [
    # (hd, N): (classes, warps, plane buffers, shared memory bytes)
    ((64, 64), ((64, 64), 4, 2, 113664)),
    ((8, 4), ((64, 64), 4, 2, 113664)),
    ((32, 16), ((64, 64), 4, 2, 113664)),
    ((64, 128), ((64, 128), 8, 2, 203776)),
    ((112, 64), ((128, 64), 8, 2, 181248)),
    ((128, 128), ((128, 128), 8, 1, 214016))])
def test_plan_of_the_bf16_kernel(widths, want):
    p = scan.plan(*widths, 2)
    assert ((p.hd_class, p.n_class), p.warps, p.plane_buffers, p.smem) == want
    assert p.smem <= scan.SMEM_PER_BLOCK
    # two blocks a multiprocessor at Zamba2-7B's widths (228 KB an SM,
    # 1 KB of it reserved per block)
    if widths == (64, 64):
        assert 2 * (p.smem + 1024) <= 228 * 1024


@pytest.mark.parametrize("widths,classes", [
    ((64, 64), (64, 64)), ((16, 4), (16, 16)), ((8, 16), (16, 16)),
    ((32, 16), (64, 16)), ((64, 128), (64, 128)), ((128, 128), (128, 128))])
def test_plan_of_the_f32_kernel(widths, classes):
    """The f32 kernel adds a 16-column class: the reference sweep's widths
    are not padded to 64."""
    p = scan.plan(*widths, 4)
    assert (p.hd_class, p.n_class) == classes
    assert p.warps == 8 and p.smem <= scan.SMEM_PER_BLOCK


# --------------------------------------------------------------------------
# the bf16 kernel's arithmetic, emulated on the CPU
# --------------------------------------------------------------------------


def _split(v: torch.Tensor, terms: int):
    """f32 ``v`` as ``terms`` bf16-valued f32 tensors that sum to it, each
    the bf16 rounding of what the ones before it miss (the kernel's
    ``split3`` at terms = 3)."""
    parts = []
    for _ in range(terms):
        t = v.bfloat16().float()
        parts.append(t)
        v = v - t
    return parts


def _emulate(x, dt, la, Bm, Cm, terms=3, chunk=scan.CHUNK):
    """The bf16 kernel's arithmetic in f32 on the CPU: x, B and C rounded
    to bf16 (exact tensor-core operands); per chunk of ``chunk`` rows the
    decayed scores S, the state h^T and w_j B_j (the f32 operands) each
    split into ``terms`` bf16 terms, one product per term, summed in f32.
    Returns y in f32."""
    Bsz, S, H, hd = x.shape
    x, Bm, Cm = (t.bfloat16().float() for t in (x, Bm, Cm))
    hT = torch.zeros(Bsz, H, Bm.shape[-1], hd)
    ys = []
    for s0 in range(0, S, chunk):
        xc, Bc, Cc = x[:, s0:s0 + chunk], Bm[:, s0:s0 + chunk], Cm[:, s0:s0 + chunk]
        dtc, lac = dt[:, s0:s0 + chunk], la[:, s0:s0 + chunk]
        L = xc.shape[1]
        cum = torch.cumsum(lac, dim=1)                 # [B, L, H]
        total = cum[:, -1]                             # [B, H]
        mask = torch.ones(L, L, dtype=torch.bool).tril()[None, :, :, None]
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # [B, i, j, H]
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)[..., None]
        # the mask before the exp, as the kernel
        scores = torch.where(mask, cb * torch.exp(torch.where(mask, diff, 0.))
                             * dtc[:, None], 0.)      # [B, i, j, H]
        inter = sum(torch.einsum("bin,bhnd->bihd", Cc, t)
                    for t in _split(hT, terms))
        intra = sum(torch.einsum("bijh,bjhd->bihd", t, xc)
                    for t in _split(scores, terms))
        ys.append(torch.exp(cum)[..., None] * inter + intra)
        w = torch.exp(total[:, None] - cum) * dtc      # [B, L, H]
        wB = w[..., None] * Bc[:, :, None, :]           # [B, L, H, N]
        hT = torch.exp(total)[..., None, None] * hT + sum(
            torch.einsum("bjhn,bjhd->bhnd", t, xc) for t in _split(wB, terms))
    return torch.cat(ys, dim=1)


def _bf16_valued(arrays):
    """x, B and C rounded to bf16 values (the kernel's bf16 inputs), kept
    as f32 numpy so both sides compute in f32 on the same inputs."""
    x, dt, la, Bm, Cm = arrays
    r = [torch.as_tensor(a).bfloat16().float().numpy() for a in (x, Bm, Cm)]
    return r[0], dt, la, r[1], r[2]


@pytest.mark.parametrize("case", SWEEP + [(1, 200, 2, 32, 16, 40),
                                          (1, 128, 2, 64, 64, 64)])
def test_kernel_arithmetic_matches_pallas_kernel(case):
    """Three terms: the emulated kernel within the Pallas kernel's own
    tolerance of the Pallas kernel (interpret mode), on bf16-valued
    inputs, at the sweep's widths, (32, 16) ragged against the emulation's
    64-row chunk, and Zamba2's 64/64 with the model's decay."""
    from repro.kernels.ssm_scan import ssd_scan

    *shape, chunk = case
    real = shape[3] == 64
    arrays = _bf16_valued(_inputs(*shape, seed=11, real=real))
    want = np.asarray(ssd_scan(*_jax(arrays), chunk=chunk, interpret=True))
    got = _emulate(*(torch.as_tensor(a) for a in arrays)).numpy()
    np.testing.assert_allclose(got, want, **PALLAS_TOL)
    # and it is the f32 chunked form, all in f32, within the f32 plain
    # versions' tolerance
    f32 = ref.ssd_chunked_ref(*(torch.as_tensor(a) for a in arrays),
                              chunk=chunk).numpy()
    np.testing.assert_allclose(got, f32, **F32_TOL)


def test_third_term_buys_the_margin():
    """Zamba2's widths and decay, where outputs are sums of terms of up to
    about 150 that cancel. Measured as the share of the bf16 bound (1e-4 +
    2^-7 |plain|, before the output's own bf16 rounding) that the error
    against the sequential form takes: three terms take what the f32
    chunked form itself takes (f32 summation order, about 0.09 here); two
    terms take over three times as much (0.27), and stray from the f32
    chunked form by over ten times the three-term distance."""
    arrays = _bf16_valued(_inputs(1, 256, 4, 64, 64, seed=12, real=True))
    t = [torch.as_tensor(a) for a in arrays]
    want = ref.ssd_scan_ref(*t).numpy()
    f32 = ref.ssd_chunked_ref(*t, chunk=scan.CHUNK).numpy()
    bound = BF16_TOL[1] + BF16_TOL[0] * np.abs(want)
    three, two = (_emulate(*t, terms=n).numpy() for n in (3, 2))
    share = {name: float((np.abs(y - want) / bound).max())
             for name, y in (("f32", f32), ("three", three), ("two", two))}
    assert share["three"] <= 1.25 * share["f32"], share
    assert share["two"] >= 2.5 * share["three"], share
    assert np.abs(two - f32).max() >= 10 * np.abs(three - f32).max()


# --------------------------------------------------------------------------
# the kernel, on the card
# --------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


def _kernel_vs_plain(arrays, dtype, device):
    inputs = _torch(arrays, dtype, device)
    before = scan.launches
    got = scan.ssd_scan(*inputs)
    torch.cuda.synchronize()
    assert scan.launches == before + 1
    want = ref.ssd_scan_ref(*inputs)
    assert got.dtype == want.dtype and got.shape == want.shape
    if dtype == torch.bfloat16:
        _close_bf16(got.cpu(), want.cpu())
    else:
        torch.testing.assert_close(got, want, **PALLAS_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", [c[:5] for c in SWEEP] + [
    (2, 256, 8, 64, 64),       # Zamba2-7B's widths
    (2, 256, 4, 64, 128),      # Mamba2's published d_state 128
    (1, 200, 4, 32, 16),       # run-time widths, ragged S
    (1, 130, 3, 7, 5),         # widths off 16-byte vectors: element loads
    (1, 100, 2, 128, 128),     # the ceiling
    (1, 200, 4, 16, 16),       # the reduced configs' widths, ragged S
    (2, 1000, 4, 64, 64),      # ragged: 15 whole chunks and 40 rows
    (1, 7, 2, 64, 64)])        # shorter than one chunk
@pytest.mark.parametrize("real", [False, True])
def test_kernel_matches_plain_version(cuda_device, case, dtype, real):
    _kernel_vs_plain(_inputs(*case, real=real), dtype, cuda_device)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda_device):
    x, dt, la, Bm, Cm = _torch(_inputs(1, 64, 2, 129, 16), device=cuda_device)
    with pytest.raises(ValueError, match="head dim 129"):
        scan.ssd_scan(x, dt, la, Bm, Cm)
    x, dt, la, Bm, Cm = _torch(_inputs(1, 64, 2, 16, 16), device=cuda_device)
    with pytest.raises(TypeError, match="float32"):
        scan.ssd_scan(x, dt.bfloat16(), la, Bm, Cm)
    with pytest.raises(TypeError, match="bfloat16"):
        scan.ssd_scan(x, dt, la, Bm.bfloat16(), Cm)
    with pytest.raises(ValueError, match="contiguous"):
        scan.ssd_scan(x.transpose(1, 2).contiguous().transpose(1, 2), dt, la,
                      Bm, Cm)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_card_backward_matches_cpu_backward(cuda_device, dtype):
    """ops.ssd_scan on the card (kernel forward, autograd through the
    chunked form) against the same call on the CPU, Zamba2's widths and
    the model's distributions."""
    arrays = _inputs(1, 128, 4, 64, 64, seed=9, real=True)
    cot = np.random.RandomState(10).randn(1, 128, 4, 64).astype(np.float32)
    grads = {}
    for device in ("cpu", cuda_device):
        inputs = [t.requires_grad_() for t in _torch(arrays, dtype, device)]
        before = scan.launches
        y = ops.ssd_scan(*inputs, chunk=64)
        assert scan.launches == before + (device != "cpu")
        grads[str(device)] = [g.float().cpu() for g in torch.autograd.grad(
            y, inputs, torch.as_tensor(cot, device=device).to(dtype))]
    for a, b in zip(grads["cpu"], grads[str(cuda_device)]):
        # f32: entries that are zero in exact arithmetic (log_a's gradient
        # at the first position: the state before it is 0) come out of the
        # chunked backward as rounding noise of about 4e-7 of the largest
        # gradient on either device, so the floor is 1e-5 of that largest
        # entry; bf16: the gradients of x, B and C round to bf16
        tol = (dict(rtol=1e-4, atol=1e-5 * float(a.abs().max()))
               if dtype == torch.float32 else dict(rtol=2e-2, atol=2e-2))
        torch.testing.assert_close(b, a, **tol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reruns_give_equal_bits(cuda_device, dtype):
    """Zamba2-7B's training shape: a second call gives the same bits (one
    block walks a (b, h) in a fixed order; no atomics)."""
    x, dt, la, Bm, Cm = _torch(_inputs(4, 1024, 112, 64, 64, real=True),
                               dtype, cuda_device)
    first = scan.ssd_scan(x, dt, la, Bm, Cm)
    again = scan.ssd_scan(x, dt, la, Bm, Cm)
    torch.cuda.synchronize()
    assert torch.equal(first, again)


@pytest.mark.cuda
@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("widths", [(64, 64), (64, 128), (112, 64),
                                    (128, 128), (8, 16), (16, 100)])
def test_library_shared_memory_matches_plan(cuda_device, widths, itemsize):
    assert scan.library_smem_bytes(*widths, itemsize) == \
        scan.plan(*widths, itemsize).smem
