"""The port's six baselines (``repro_torch.fl.baselines``) against the JAX
package's runners, on the CPU at Table 1's configuration
(``benchmarks/run.py:tab1_fl_accuracy``: 16 clients over 8 classes of
16x16 images, a (1, 1)-stage ResNet of widths (12, 24), 5 clients a round,
batch 32, ``fused=False``, each client's memory ``full_model_memory`` x
one of {0.35, 0.5, 0.7, 0.9}), cut to 800 samples (one to three local
steps for most clients) and 2 rounds.

Under that memory rule no client holds the full model, so ExclusiveFL,
TiFL and Oort are inoperative; they also run on a fleet whose multipliers
come from {0.7, 1.2, 1.5}, where about half the clients hold it, so that
TiFL's tiers and Oort's bandit picks are held too. The fused path and
the engine's unused leaves are held in ``test_torch_baselines_fused.py``.

Initial values cannot be drawn alike, so the port's ``CNN.init`` and the
``cnn_fc_only_init`` that ``repro_torch.fl.baselines`` imports are patched
to return the reference's own init for the same config and seed.

Held: selections, drops, participation, scales and per-round virtual
durations and clock exactly; losses, params and BN state rtol 1e-3, atol
1e-5 (``tests/test_torch_server.py``'s tolerance)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.output_module import cnn_fc_only_init as j_fc_only_init
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl import baselines as JB
from repro.fl.client import make_client_fleet as j_fleet
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
from repro.models.module import PFac

import repro_torch.fl.baselines as TB
from repro_torch.convert import to_torch
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves

CFG = dict(name="rn", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(12, 24), num_classes=8)
TABLE1 = ([0.35, 0.5, 0.7, 0.9], [0.3, 0.3, 0.25, 0.15])
OPERATIVE = ([0.7, 1.2, 1.5], [0.4, 0.3, 0.3])
RUN = dict(rounds=2, batch_size=32, clients_per_round=5, fused=False)
TOL = dict(rtol=1e-3, atol=1e-5)
RUNNERS = ["allsmall", "exclusivefl", "depthfl", "heterofl", "tifl", "oort"]


@pytest.fixture(autouse=True)
def one_thread():
    """The port's CPU convolutions sum in an order that follows torch's
    thread count, and a free f32 trajectory can amplify a ReLU input within
    that rounding of zero past the tolerance
    (``tests/test_torch_policies_drift.py``); one thread makes the
    trajectories the same on every machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet(vision, dirichlet, fleet, mults, n=800):
    train = vision(num_classes=8, image_size=16).sample(n, seed=1)
    clients = fleet(train, dirichlet(train["y"], 16, alpha=1.0, seed=0),
                    scenario="high", seed=0)
    full_mem = JB.full_model_memory(JCNN(JCfg(**CFG)), 32)
    rng = np.random.RandomState(7)
    for c in clients:
        c.memory_bytes = full_mem * rng.choice(mults[0], p=mults[1])
    return clients


def _fleets(mults):
    return (_fleet(JVision, j_dirichlet, j_fleet, mults),
            _fleet(TVision, t_dirichlet, t_fleet, mults))


@pytest.fixture
def reference_init(monkeypatch):
    """The port's model and DepthFL head inits return the reference's."""

    def cnn_init(self, generator):
        jcfg = JCfg(**dataclasses.asdict(self.cfg))
        p, s = JCNN(jcfg).init(jax.random.PRNGKey(generator.initial_seed()))
        return to_torch(p, self.device), to_torch(s, self.device)

    def fc_only_init(fac, cfg, d):
        jfac = PFac(jax.random.PRNGKey(fac.generator.initial_seed()),
                    dtype=jnp.float32)
        return to_torch(j_fc_only_init(jfac.sub(f"aux{d}"),
                                       JCfg(**dataclasses.asdict(cfg)), d),
                        fac.device)

    monkeypatch.setattr(TCNN, "init", cnn_init)
    monkeypatch.setattr(TB, "cnn_fc_only_init", fc_only_init)


def _hold(j_out, t_out):
    assert set(t_out) == set(j_out), (sorted(t_out), sorted(j_out))
    for key in ("inoperative", "participation", "scale"):
        if key in j_out:
            assert t_out[key] == j_out[key], key
    assert len(t_out["history"]) == len(j_out["history"])
    for jr, tr in zip(j_out["history"], t_out["history"]):
        assert (tr.round_idx, tr.stage, tr.selected, tr.dropped,
                tr.duration, tr.virtual_time) == \
            (jr.round_idx, jr.stage, [int(c) for c in jr.selected],
             jr.dropped, jr.duration, jr.virtual_time)
        np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
    if "params" not in j_out:
        return
    assert t_out["model"].cfg == TCfg(**dataclasses.asdict(j_out["model"].cfg))
    for key in ("params", "state"):
        lj = jax.tree.leaves(j_out[key])
        lt = tree_leaves(t_out[key])
        assert len(lj) == len(lt)
        for a, b in zip(lj, lt):
            assert b.dtype == torch.float32 and b.shape == a.shape
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _run_pair(name, mults, **kw):
    jc, tc = _fleets(mults)
    cfg = dict(RUN, **kw)
    j_out = getattr(JB, f"run_{name}")(JCfg(**CFG), jc, **cfg)
    t_out = getattr(TB, f"run_{name}")(TCfg(**CFG), tc, device="cpu", **cfg)
    _hold(j_out, t_out)
    return j_out, t_out


@pytest.mark.parametrize("name", RUNNERS)
def test_runner_matches_reference_at_table1(reference_init, name):
    _, out = _run_pair(name, TABLE1)
    if name in ("exclusivefl", "tifl", "oort"):
        assert out["inoperative"] and out["history"] == []
    else:
        assert len(out["history"]) == 2 and "inoperative" not in out
        assert all(r.selected for r in out["history"])
    if name == "allsmall":
        assert out["scale"] < 1
    if name == "depthfl":
        assert out["participation"] == 0.0  # nobody holds every stage


@pytest.mark.parametrize("name", ["exclusivefl", "tifl", "oort"])
def test_full_model_runner_matches_reference_where_operative(reference_init,
                                                             name):
    _, out = _run_pair(name, OPERATIVE)
    assert 0 < out["participation"] < 1 and "inoperative" not in out
    if name == "tifl":
        # each round samples one tier, round-robin
        tc = _fleets(OPERATIVE)[1]
        times = {c.client_id: c.num_samples / c.capability for c in tc}
        picked = [sorted(times[c] for c in r.selected)
                  for r in out["history"]]
        assert max(picked[0]) <= min(picked[1])


def test_heterofl_groups_and_depthfl_depths_match_reference_rules():
    """The port's helpers give the reference's per-client assignment."""
    jc, tc = _fleets(TABLE1)
    tcfg = TCfg(**CFG)
    depths = TB.depthfl_depths(TCNN(tcfg, device="cpu"), tc, 32)
    scales = TB.heterofl_scales(tcfg, tc, 32)
    jm = JCNN(JCfg(**CFG))
    for c in jc:
        need = [sum(JB.cnn_stage_memory_bytes(jm, t, 32) for t in range(s + 1))
                for s in range(2)]
        d = max([s for s in range(2) if c.memory_bytes >= need[s]],
                default=0)
        assert depths[c.client_id] == d
        fits = [s for s in JB._HFL_SCALES if JB.full_model_memory(
            JCNN(JB.scaled_config(JCfg(**CFG), s)), 32) <= c.memory_bytes]
        assert scales[c.client_id] == (fits[0] if fits
                                       else JB._HFL_SCALES[-1])
    assert len(set(scales.values())) > 1 and len(set(depths.values())) == 1


@pytest.mark.parametrize("name", RUNNERS)
@pytest.mark.parametrize("kw", [dict(faults=None), dict(screen_updates=True),
                                dict(aggregator="mean")],
                         ids=["faults", "screen_updates", "aggregator"])
def test_unported_runner_arguments_raise(reference_init, name, kw):
    """Once rejected, now ported: each runner accepts ``faults``,
    ``screen_updates`` and ``aggregator``, and a one-round run with it at
    Table 1's configuration matches the reference's."""
    _run_pair(name, TABLE1, **dict(kw, rounds=1))


def test_tifl_rejects_unknown_arguments():
    tc = _fleets(OPERATIVE)[1]
    with pytest.raises(TypeError, match="unknown kwargs"):
        TB.run_tifl(TCfg(**CFG), tc, rounds=1, device="cpu", bogus=1)
