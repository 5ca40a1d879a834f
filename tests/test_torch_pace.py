"""The port's pace controller with its window on a device (the tensor window,
which takes the Eq. 2 norms through kernel B3 on the card) against the JAX
package's numpy controller.

On the CPU the tensor window's norms go through ``ops.diff_sqnorm``'s f64
plain version, the arithmetic the kernel does on the card: the difference
in f32, the square and the sum in f64, as numpy does. Only the summation
order differs, so perturbations agree within 1e-12 relative and the
freeze decisions are equal at every round. The numpy window
(``tests/test_torch_control.py``) stays bit-equal to the reference.

The tests that need the card run with
``python -m pytest -q -m cuda tests/test_torch_pace.py``; the JAX package
is imported inside the parity tests only."""
import numpy as np
import pytest
import torch

from repro_torch.core import pace
from repro_torch.kernels import block_perturb

PERTURB_RTOL = 1e-12
KW = dict(min_rounds=6, slope_lambda=2e-2, mu=2, fit_window=4)


def _series(rounds=24, seed=0, nan_round=9):
    """A converging series of blocks: two f32 leaves and a bf16 leaf (as
    an LM block mixes them) whose updates shrink as 1 / (1 + r), with one
    non-finite round."""
    rng = np.random.RandomState(seed)
    base = {"w": rng.randn(6, 5), "a": {"b": rng.randn(11)},
            "h": rng.randn(3, 4)}
    out = []
    for r in range(rounds):
        s = 1.0 / (1 + r)
        blk = {"w": (base["w"] + s * rng.randn(6, 5)).astype(np.float32),
               "a": {"b": (base["a"]["b"] + s * rng.randn(11)
                           ).astype(np.float32)},
               "h": (base["h"] + s * rng.randn(3, 4)).astype(np.float32)}
        if r == nan_round:
            blk["w"][2, 3] = np.nan
        out.append(blk)
    return out


def _to_torch(blk, device="cpu"):
    return {"w": torch.as_tensor(blk["w"], device=device),
            "a": {"b": torch.as_tensor(blk["a"]["b"], device=device)},
            "h": torch.as_tensor(blk["h"], device=device).bfloat16()}


def _to_jax(blk):
    import jax.numpy as jnp
    return {"w": jnp.asarray(blk["w"]), "a": {"b": jnp.asarray(blk["a"]["b"])},
            "h": jnp.asarray(blk["h"], jnp.bfloat16)}


@pytest.fixture
def tensor_window(monkeypatch):
    """Every controller picks the tensor window, whatever the device."""
    monkeypatch.setattr(
        pace, "_new_window",
        lambda leaves, q, low: pace._TensorWindow(q, low, leaves[0].device))


def _assert_series_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               rtol=PERTURB_RTOL, atol=0)


@pytest.mark.parametrize("low_memory", [False, True])
def test_tensor_window_matches_reference(tensor_window, low_memory):
    from repro.core.pace import PaceController as JPace
    kw = dict(KW, low_memory=low_memory)
    jp, tp = JPace(**kw), pace.PaceController(**kw)
    freezes_j, freezes_t = [], []
    for r, blk in enumerate(_series()):
        out_j = jp.observe(_to_jax(blk))
        out_t = tp.observe(_to_torch(blk))
        assert (out_t is None) == (out_j is None), r
        if out_j is not None:
            np.testing.assert_allclose(out_t, out_j, rtol=PERTURB_RTOL)
        fj, ft = jp.should_freeze(), tp.should_freeze()
        assert ft == fj, r
        freezes_j.append(fj)
        freezes_t.append(ft)
    assert isinstance(tp._win, pace._TensorWindow)
    assert any(freezes_j), "the series never freezes: it tests nothing"
    assert freezes_t == freezes_j
    hj, ht = jp.history, tp.history
    assert ht["rounds"] == hj["rounds"] and ht["skipped"] == hj["skipped"] == 1
    _assert_series_close(ht["perturbation"], hj["perturbation"])
    _assert_series_close(ht["smoothed"], hj["smoothed"])


@pytest.mark.parametrize("low_memory", [False, True])
def test_tensor_window_holds_only_its_copies(tensor_window, low_memory):
    """Exact: at most Q+1 snapshots, the dropped slot reused; anchored: two,
    the replaced ``prev`` reused."""
    tp = pace.PaceController(window_q=3, low_memory=low_memory)
    seen = set()
    for blk in _series(rounds=12, nan_round=-1):
        tp.observe(_to_torch(blk))
        win = tp._win
        bufs = (list(win.ring) if not low_memory
                else [t for t in (win.anchor, win.prev) if t is not None])
        assert len({t.data_ptr() for t in bufs}) <= (2 if low_memory else 4)
        seen |= {t.data_ptr() for t in bufs}
    # every snapshot after the window filled went into a dropped buffer
    assert len(seen) == (2 if low_memory else 4)


@pytest.mark.parametrize("low_memory", [False, True])
def test_state_dict_matches_numpy_path_and_round_trips(tensor_window,
                                                       low_memory):
    from repro.core.pace import PaceController as JPace
    kw = dict(KW, low_memory=low_memory)
    blocks = _series()
    jp, tp = JPace(**kw), pace.PaceController(**kw)
    for blk in blocks[:13]:
        jp.observe(_to_jax(blk))
        tp.observe(_to_torch(blk))
        jp.should_freeze()
        tp.should_freeze()
    sj, st = jp.state_dict(), tp.state_dict()
    assert sorted(st) == sorted(sj)
    for k in ("window", "anchor", "prev", "counters"):
        assert st[k].dtype == sj[k].dtype and st[k].shape == sj[k].shape, k
        np.testing.assert_array_equal(st[k], sj[k])
    for k in ("update_norms", "perturbations", "smoothed"):
        assert st[k].dtype == np.float64
        np.testing.assert_allclose(st[k], sj[k], rtol=PERTURB_RTOL, atol=0)
    # resume both from the same (reference) state and go on observing
    jr = JPace(**kw).load_state_dict(sj)
    tr = pace.PaceController(**kw).load_state_dict(sj)
    assert tr._win is None  # placed with the next block
    for k, v in tr.state_dict().items():
        np.testing.assert_array_equal(v, sj[k])
    for blk in blocks[13:]:
        out_j = jr.observe(_to_jax(blk))
        out_t = tr.observe(_to_torch(blk))
        np.testing.assert_allclose(out_t, out_j, rtol=PERTURB_RTOL)
        assert tr.should_freeze() == jr.should_freeze()
    assert isinstance(tr._win, pace._TensorWindow)
    assert all(t.device.type == "cpu" for t in tr._win.ring)


def test_cpu_blocks_take_the_numpy_window():
    tp = pace.PaceController()
    tp.observe(_to_torch(_series(rounds=1)[0]))
    assert isinstance(tp._win, pace._HostWindow)


def test_tensor_window_on_the_cpu_never_launches_the_kernel(tensor_window):
    before = block_perturb.launches
    tp = pace.PaceController(window_q=2)
    for blk in _series(rounds=5, nan_round=-1):
        tp.observe(_to_torch(blk))
    assert block_perturb.launches == before
    assert len(tp.history["perturbation"]) == 4


def test_tensor_window_rejects_a_block_that_changed_shape(tensor_window):
    tp = pace.PaceController()
    tp.observe({"w": torch.zeros(4), "b": torch.zeros(3)})
    with pytest.raises(ValueError, match="leaf sizes changed"):
        tp.observe({"w": torch.zeros(3), "b": torch.zeros(4)})


def _fake_card(monkeypatch, free, held, reserved, peak):
    monkeypatch.setattr(torch.cuda, "mem_get_info",
                        lambda device=None: (free, 80 * 10 ** 9))
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device=None: held)
    monkeypatch.setattr(torch.cuda, "memory_reserved",
                        lambda device=None: reserved)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda device=None: peak)


def test_exact_window_that_cannot_fit_raises(monkeypatch):
    """Llama-3-8B's stage-0 block (1.745e9 elements) after a round: 17 GB
    held, a 48 GB peak, 31 GB free beside 31 GB the allocator holds unused.
    Six f32 copies (42 GB) and the round's 31 GB of transients do not fit;
    the anchored window's two (14 GB) do."""
    _fake_card(monkeypatch, free=31 * 10 ** 9, held=17 * 10 ** 9,
               reserved=48 * 10 ** 9, peak=48 * 10 ** 9)
    n = 1_745_000_000
    dev = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="low_memory=True"):
        pace.check_window_fits(n, 6, False, dev)
    pace.check_window_fits(n, 2, True, dev)
    win = pace._TensorWindow(5, False, dev)
    with pytest.raises(ValueError, match="6 float32 copies"):
        win._fit(n)


@pytest.mark.parametrize("total,blocks", [(40, 4), (7, 3), (12, 1), (3, 5)])
def test_ablation_schedules_match_reference(total, blocks):
    from repro.core import pace as jpace
    assert (pace.naive_equal_schedule(total, blocks)
            == jpace.naive_equal_schedule(total, blocks))
    if blocks > 1:
        assert (pace.front_loaded_schedule(total, blocks)
                == jpace.front_loaded_schedule(total, blocks))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("low_memory", [False, True])
def test_card_window_matches_numpy_path(cuda_device, low_memory):
    """Card blocks pick the card window; its series is the CPU blocks'
    numpy series within 1e-12 relative, with equal decisions, and B3
    launches twice per leaf in every observe that has a previous
    snapshot."""
    kw = dict(KW, low_memory=low_memory)
    card, host = pace.PaceController(**kw), pace.PaceController(**kw)
    before = block_perturb.launches
    with_prev = 0
    for blk in _series():
        tb = _to_torch(blk, cuda_device)
        had = bool(card._win is not None and (card._win.ring
                                              or card._win.prev is not None))
        finite = all(bool(torch.isfinite(v).all())
                     for v in (tb["w"], tb["a"]["b"], tb["h"]))
        with_prev += had and finite
        out_c = card.observe(tb)
        out_h = host.observe(_to_torch(blk))
        assert (out_c is None) == (out_h is None)
        if out_h is not None:
            np.testing.assert_allclose(out_c, out_h, rtol=PERTURB_RTOL)
        assert card.should_freeze() == host.should_freeze()
    assert isinstance(card._win, pace._TensorWindow)
    assert isinstance(host._win, pace._HostWindow)
    assert block_perturb.launches - before == 2 * 3 * with_prev
    sc, sh = card.state_dict(), host.state_dict()
    for k in ("window", "anchor", "prev", "counters"):
        np.testing.assert_array_equal(sc[k], sh[k])
    for k in ("update_norms", "perturbations", "smoothed"):
        np.testing.assert_allclose(sc[k], sh[k], rtol=PERTURB_RTOL, atol=0)
    # a restored controller places its window on the next block's card
    again = pace.PaceController(**kw).load_state_dict(sc)
    again.observe(_to_torch(_series()[0], cuda_device))
    assert all(t.device.type == "cuda" for t in again._win.ring) and \
        (again._win.prev is None or again._win.prev.device.type == "cuda")
