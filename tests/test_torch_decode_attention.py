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

# (B, S, Hq, Hkv, d, lengths[, dv]): g in {1, 4}, S not a multiple of the
# blocks, rows with length 0, a row with the whole cache; dv defaults to d
CASES = [(2, 64, 4, 4, 16, (64, 0)),
         (3, 100, 8, 2, 32, (1, 57, 100)),
         (2, 40, 4, 1, 16, (0, 0)),
         (4, 130, 16, 4, 64, (130, 65, 0, 7)),
         (2, 50, 4, 4, 112, (50, 17)),  # Zamba2-7B's head dim
         (2, 70, 4, 2, 80, (70, 33)),   # hubert-xlarge's
         # the MLA widths of the reference's configs, nope + rope: 16 + 8
         # reduced, 64 + 32 and 128 + 64 (deepseek-v2); dv below dk
         (2, 60, 4, 2, 24, (60, 13)),
         (2, 70, 8, 2, 96, (70, 0)),
         (2, 40, 4, 4, 192, (40, 21)),
         (2, 50, 8, 2, 96, (50, 33), 64)]


def _inputs(B, S, Hq, Hkv, d, lengths, dv=None, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, Hq, d).astype(np.float32),
            rng.randn(B, S, Hkv, d).astype(np.float32),
            rng.randn(B, S, Hkv, dv or d).astype(np.float32),
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


PLAN_SHAPES = [(8, 1024, 32, 8), (8, 32768, 32, 8), (8, 1024, 32, 32),
               (8, 1000, 32, 8), (1, 17, 56, 8), (2, 64, 32, 2),
               (1, 524288, 32, 8), (8, 256, 32, 32), (4, 1000, 16, 4),
               (128, 32768, 32, 8), (1, 1, 8, 8)]
# (dk, dv, itemsize): the serving widths, the MLA widths, both ceilings
PLAN_WIDTHS = [(128, 128, 2), (112, 112, 2), (80, 80, 4), (16, 16, 4),
               (192, 128, 2), (96, 64, 2), (256, 256, 4), (8, 8, 2)]


@pytest.mark.parametrize("width", PLAN_WIDTHS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("sms", [132, 1])
def test_split_plan_covers_the_cache(shape, width, sms):
    """Every allocated row lies in exactly one split, no split is empty,
    every q head of a group lies in exactly one head chunk, the splits of
    a group fit one cluster (so grid x, which is the split count, divides
    by the cluster's x), a split's rows are whole ``SPLIT_ALIGN``s, and a
    grid of more than one wave of ``BLOCKS_PER_SM`` blocks an SM is split
    only so far that no split covers more than ``SPLIT_ROWS`` rows."""
    B, S, Hq, Hkv = shape
    p = dec.plan(B, S, Hq, Hkv, *width, sms)
    g = Hq // Hkv
    assert p.gc in (1, 2, 4, 8)
    assert p.gc * (p.n_chunks - 1) < g <= p.gc * p.n_chunks
    assert p.chunk_rows % dec.SPLIT_ALIGN == 0
    assert (p.splits - 1) * p.chunk_rows < S <= p.splits * p.chunk_rows
    assert 1 <= p.splits <= dec.MAX_CLUSTER
    groups = B * Hkv * p.n_chunks
    if p.splits > 1 and groups * p.splits > dec.BLOCKS_PER_SM * sms:
        assert (p.splits - 1) * dec.SPLIT_ROWS < S


@pytest.mark.parametrize("width", PLAN_WIDTHS)
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_ring_plan_fits_the_card(shape, width):
    """A stage holds 16 to 256 rows, whole TMA boxes of 16 (bf16: whole
    16-row steps of the four consumer warps), the ring holds 1 to 8
    stages and no more than one split's tiles, a block's shared memory
    fits, a ring deeper than two
    stages leaves room for the blocks the grid puts on an SM (at most
    ``BLOCKS_PER_SM``), and the blocks that fit on one SM keep at least
    64 KB of K and V requested unless the whole split is already in
    flight."""
    B, S, Hq, Hkv = shape
    dk, dv, itemsize = width
    p = dec.plan(B, S, Hq, Hkv, dk, dv, itemsize, 132)
    unit = (dec.MMA_ROWS * dec.CONSUMER_WARPS if itemsize == 2
            else dec.BOX_ROWS)
    assert unit <= p.rows <= dec.MAX_ROWS and p.rows % unit == 0
    tiles = -(-p.chunk_rows // p.rows)
    assert 1 <= p.stages <= min(dec.MAX_STAGES, tiles)
    assert p.smem == dec.smem_bytes(dk, dv, itemsize, p.gc, p.rows, p.stages,
                                    p.splits)
    assert p.smem <= dec.SMEM_PER_BLOCK
    # the ring holds the tiles, and after the stream the warps' partials;
    # the inbox one (m, l) per split and head and a slice of the outputs
    # from every split
    row = dec.pitch_bytes(dk, itemsize) + dec.pitch_bytes(dv, itemsize)
    assert p.smem >= (max(p.stages * p.rows * row,
                          dec.CONSUMER_WARPS * p.gc * (dv + 2) * 4)
                      + (p.gc * dv + 2 * p.splits * p.gc) * 4)
    blocks = B * Hkv * p.n_chunks * p.splits
    resident = min(dec.BLOCKS_PER_SM, -(-blocks // 132))
    fit = dec.SMEM_PER_SM // (p.smem + dec.SMEM_RESERVED)
    if p.stages > 2:
        assert fit >= resident
    resident = min(resident, fit)
    # bytes a stage's boxes request, each row with the bytes past it
    stage = p.rows * (dec.pitch_bytes(dk, itemsize)
                      + dec.pitch_bytes(dv, itemsize))
    if p.stages < tiles:
        assert resident * p.stages * stage >= 64 * 1024


@pytest.mark.parametrize("d", [8, 16, 24, 64, 80, 96, 112, 128, 192, 200,
                               256])
def test_row_pitch_holds_a_row_without_bank_conflicts(d):
    """A stage row holds every column. bf16: 128 bytes for each 64
    columns (swizzled by the TMA, nothing read past them) and the rest
    padded to an odd number of 16-byte units, at most 32 bytes past it,
    so that 8 consecutive rows start in 8 bank groups; f32: dense."""
    assert dec.pitch_bytes(d, 4) == 4 * d
    rem = d % dec.SWIZZLE_COLS
    pad = dec.pitch_bytes(d, 2) - d // dec.SWIZZLE_COLS * 128
    if rem:
        assert pad % 32 == 16 and 2 * rem + 16 <= pad <= 2 * rem + 32
    else:
        assert pad == 0


@pytest.mark.parametrize("dk,dv,itemsize", [
    (24, 24, 2), (96, 96, 2), (192, 192, 2), (96, 64, 2), (256, 256, 2),
    (256, 256, 4), (8, 8, 2), (4, 4, 4), (112, 80, 2), (12, 200, 4)])
def test_head_dims_at_run_time_are_accepted(dk, dv, itemsize):
    dec.check_head_dims(dk, dv, itemsize)


@pytest.mark.parametrize("dk,dv,itemsize,bad", [
    (20, 20, 2, 20), (96, 60, 2, 60), (264, 264, 2, 264), (6, 8, 4, 6),
    (0, 8, 2, 0), (128, 260, 4, 260), (4, 4, 2, 4)])
def test_head_dims_off_the_16_byte_rule_are_refused(dk, dv, itemsize, bad):
    with pytest.raises(ValueError, match=f"head dim {bad} "):
        dec.check_head_dims(dk, dv, itemsize)


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
    (2, 300, 16, 4, 80, (300, 129)),
    (2, 300, 32, 8, 96, (300, 129)),       # run-time widths
    (2, 300, 16, 16, 192, (300, 7)),
    (2, 300, 32, 8, 96, (300, 129), 64),   # dv below dk
    (2, 130, 8, 2, 256, (130, 1)),         # f32: two vectors a lane
    (1, 2000, 8, 1, 200, (1999,), 136),
    (2, 5000, 16, 2, 128, (5000, 2500))])  # a 16-block cluster
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
    q, k, v, length = _torch(_inputs(1, 32, 4, 2, 22, (3,)), torch.float32,
                             cuda_device)
    with pytest.raises(ValueError, match="head dim 22 "):
        dec.decode_attention(q, k, v, length)
    q, k, v, length = _torch(_inputs(1, 32, 4, 2, 24, (3,), 20),
                             torch.bfloat16, cuda_device)
    with pytest.raises(ValueError, match="head dim 20 "):
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
@pytest.mark.parametrize("shape", PLAN_SHAPES[:4])
def test_card_plan_fits_one_wave(cuda_device, shape):
    """A card plan meant for one wave keeps every cluster of its grid
    resident at once."""
    B, S, Hq, Hkv = shape
    p = dec.card_plan(B, S, Hq, Hkv, 128, 128, torch.bfloat16, 0)
    groups = B * Hkv * p.n_chunks
    slots = dec.BLOCKS_PER_SM * dec._sm_count(0)
    if 1 < p.splits and groups * p.splits <= slots:
        assert dec.resident_clusters(p, B, S, Hq, Hkv, 128, 128,
                                     torch.bfloat16) >= B * Hkv * p.n_chunks


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_rerun_gives_equal_bits(cuda_device, dtype):
    """The splits are merged in a fixed order: a rerun on the same inputs
    gives the same bits."""
    q, k, v, length = _torch(_inputs(
        8, 1024, 32, 8, 128, (1024, 1, 700, 0, 1023, 64, 65, 512)),
        getattr(torch, dtype), cuda_device)
    first = dec.decode_attention(q, k, v, length)
    again = dec.decode_attention(q, k, v, length)
    torch.cuda.synchronize()
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert torch.equal(first.view(bits), again.view(bits))


@pytest.mark.cuda
@pytest.mark.parametrize("width", PLAN_WIDTHS)
def test_kernel_shared_memory_matches_the_plan(cuda_device, width):
    from repro_torch.kernels import _build

    lib = _build.load("decode_attention")
    for shape in PLAN_SHAPES:
        p = dec.plan(*shape, *width, 132)
        assert lib.decode_attention_smem_bytes(
            width[0], width[1], width[2], p.gc, p.rows, p.stages,
            p.splits) == p.smem
        # every plan fits: at least one cluster of it is resident at once
        dtype = torch.bfloat16 if width[2] == 2 else torch.float32
        assert dec.resident_clusters(p, *shape, width[0], width[1], dtype) >= 1


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
