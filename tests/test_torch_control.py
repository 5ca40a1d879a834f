"""The port's control plane (pace controller, selector, memory and time
models, sync loop) against the JAX package's. These are numpy on both
sides, so the comparisons are exact unless stated."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import memory_model as jmem
from repro.core.pace import PaceController as JPace
from repro.core.selector import ParticipantSelector as JSel
from repro.core.selector.rlcd import rlcd_communities as j_rlcd
from repro.core.selector.selection import ClientInfo as JInfo
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.sim import FederatedLoop as JLoop, FleetTimeModel as JTime
from repro.models.cnn import CNN as JCNN, RESNET18 as J18, VGG11 as JV11

from repro_torch.core import memory_model as tmem
from repro_torch.core.pace import PaceController as TPace
from repro_torch.core.selector import ParticipantSelector as TSel
from repro_torch.core.selector.rlcd import rlcd_communities as t_rlcd
from repro_torch.core.selector.selection import ClientInfo as TInfo
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.sim import FederatedLoop as TLoop, FleetTimeModel as TTime
from repro_torch.models.cnn import CNN as TCNN, RESNET18 as T18, VGG11 as TV11


@pytest.mark.parametrize("low_memory", [False, True])
def test_pace_controller_matches_reference(low_memory):
    rng = np.random.RandomState(0)
    kw = dict(min_rounds=4, slope_lambda=5e-2, low_memory=low_memory)
    jp, tp = JPace(**kw), TPace(**kw)
    base = {"w": rng.randn(5, 3).astype(np.float32),
            "a": {"b": rng.randn(7).astype(np.float32)}}
    for r in range(14):
        scale = 1.0 / (1 + r)
        cur = {"w": base["w"] + scale * rng.randn(5, 3).astype(np.float32),
               "a": {"b": base["a"]["b"] + scale * rng.randn(7).astype(np.float32)}}
        if r == 6:  # a non-finite round is rejected, not ingested
            cur["w"][0, 0] = np.nan
        out_j = jp.observe({"w": jnp.asarray(cur["w"]),
                            "a": {"b": jnp.asarray(cur["a"]["b"])}})
        out_t = tp.observe({"w": torch.as_tensor(cur["w"]),
                            "a": {"b": torch.as_tensor(cur["a"]["b"])}})
        assert out_t == out_j
        assert tp.should_freeze() == jp.should_freeze()
    assert tp.history == jp.history
    sj, st = jp.state_dict(), tp.state_dict()
    assert sorted(sj) == sorted(st)
    for k in sj:
        np.testing.assert_array_equal(st[k], sj[k])
    again = TPace(**kw).load_state_dict(st)
    assert again.history == tp.history


def test_selector_picks_match_reference():
    rng = np.random.RandomState(1)
    n = 12
    G = rng.randn(n, 6)
    sim = (G @ G.T) / np.outer(np.linalg.norm(G, axis=1),
                               np.linalg.norm(G, axis=1))
    assert t_rlcd(sim, seed=3) == j_rlcd(sim, seed=3)
    js, ts = JSel(seed=5), TSel(seed=5)
    assert ts.fit_communities(sim) == js.fit_communities(sim)
    mem = rng.choice([1.0, 2.0, 4.0], n) * 2 ** 30
    for r in range(6):
        loss = rng.rand(n) * 1e3
        args = [(i, mem[i], 1e9 * (1 + i % 3), 20 + i, loss[i] * (20 + i))
                for i in range(n)]
        jsel = js.select({a[0]: JInfo(*a) for a in args}, 5,
                         mem_required=1.5 * 2 ** 30,
                         stage_time_fn=lambda c: c.num_samples / c.capability)
        tsel = ts.select({a[0]: TInfo(*a) for a in args}, 5,
                         mem_required=1.5 * 2 ** 30,
                         stage_time_fn=lambda c: c.num_samples / c.capability)
        assert tsel == jsel


@pytest.mark.parametrize("which", ["resnet18", "vgg11"])
def test_memory_model_matches_reference(which):
    jm = JCNN(J18 if which == "resnet18" else JV11)
    tm = TCNN(T18 if which == "resnet18" else TV11, device="cpu")
    for stage in range(len(jm.cfg.stage_sizes)):
        for dtype in ("float32", "float16", "int8"):
            assert (tmem.cnn_feature_cache_bytes(tm, stage, 37, 32, dtype)
                    == jmem.cnn_feature_cache_bytes(jm, stage, 37, 32, dtype))
        assert (tmem.cnn_stage_memory_bytes(tm, stage, 32, 32, cache_samples=500)
                == jmem.cnn_stage_memory_bytes(jm, stage, 32, 32,
                                               cache_samples=500))
        need = lambda t, m: m.cnn_stage_memory_bytes(
            jm, stage, 32, 32, cache_samples=500,
            cache_dtype=m.CACHE_TIER_DTYPES[t])
        for mem in (1e6, 1e8, 3e9):
            assert (tmem.cache_tier_ladder(mem, lambda t: need(t, tmem))
                    == jmem.cache_tier_ladder(mem, lambda t: need(t, jmem)))


def _fleets():
    out = []
    for vision, dirichlet, fleet in ((JVision, j_dirichlet, j_fleet),
                                     (TVision, t_dirichlet, t_fleet)):
        train = vision(num_classes=4, image_size=8, seed=0).sample(120, seed=1)
        parts = dirichlet(train["y"], 6, alpha=1.0, seed=0)
        out.append(fleet(train, parts, scenario="high", seed=2,
                         link_rate_pool=[1e5, 1e6, float("inf")]))
    return out


def test_time_model_and_sync_loop_match_reference():
    jc, tc = _fleets()
    kw = dict(flops_per_sample=3e6, rho=1.3, jitter=0.2, seed=4)
    jt, tt = JTime.from_clients(jc, **kw), TTime.from_clients(tc, **kw)
    np.testing.assert_array_equal(tt.compute_s, np.asarray(jt.compute_s))
    jt.payload_bytes = tt.payload_bytes = 12345.0
    jt = jt.with_compute_scale({1: 0.5, 4: 0.75})
    tt = tt.with_compute_scale({1: 0.5, 4: 0.75})
    for r in range(3):
        want = jt.cohort_times([5, 1, 2, 4], r)
        got = tt.cohort_times([5, 1, 2, 4], r)
        assert sorted(got) == sorted(want)
        np.testing.assert_allclose([got[c] for c in want],
                                   [want[c] for c in want], rtol=1e-6)

    def loop(cls, tm):
        return cls(select_fn=lambda r, avail: avail[r % 3: r % 3 + 2],
                   train_fn=lambda cohort, r, **_: {c: 0.1 * c for c in cohort},
                   client_ids=list(range(6)), time_model=tm)

    lj, lt = loop(JLoop, jt), loop(TLoop, tt)
    rj, rt = lj.run(4, start_round=2), lt.run(4, start_round=2)
    assert [(r.round_idx, r.selected, r.losses) for r in rt] == \
        [(r.round_idx, r.selected, r.losses) for r in rj]
    np.testing.assert_allclose(lt.clock, lj.clock, rtol=1e-6)
