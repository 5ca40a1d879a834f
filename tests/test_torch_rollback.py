"""The port's defended servers (``repro_torch.fl.server``) against the JAX
package's, end to end on the CPU: screening, the robust aggregators, fault
injection and freeze rollback.

  * ``tests/test_faults.py``'s ``test_server_zero_fault_defended_bit_
    identity`` scenario (a (1, 1)-stage ResNet of widths (8, 16), six
    clients over 400 16x16 samples, four a round, ``schedule=[2, 2]``):
    the port's run with every defense armed and a zero-rate injector is
    bitwise its undefended run, and matches the reference's defended run;
  * two-stage trajectories under faults (nan, amplify, signflip, crash at
    rate 0.3) with screening, each aggregator and freeze rollback: the
    pace controller freezes stage 0 after its fourth round (``min_rounds``
    3, ``mu`` 1, a slope threshold no slope reaches), the guard band is
    below any loss so the first round of stage 1 rolls the freeze back,
    and stage 0 restarts from its freeze-time snapshot;
  * ``FedAvgServer`` and HeteroFL (whose scale groups each get their own
    clients' faults) under faults.

As in ``tests/test_torch_server.py``, the Eq. 8 similarity and each
stage's output module come from the reference, and the runners' initial
values too. Held: records (selected, dropped, screened, rolled_back,
frozen, stages) exactly; losses, params and BN state rtol 1e-3, atol
1e-5. The trajectories run the sequential path (``fused=False``), whose
reference compiles once a stage; torch on one thread."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import freezing_cnn as jfz
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl import baselines as JB
from repro.fl import faults as jfaults
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.server import FedAvgServer as JFedAvg
from repro.fl.server import SmartFreezeServer as JServer
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
from repro.optim import sgd as j_sgd

import repro_torch.core.freezing_cnn as tfz
import repro_torch.fl.baselines as TB
from repro_torch.convert import to_torch
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl import faults as tfaults
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.server import FedAvgServer as TFedAvg
from repro_torch.fl.server import SmartFreezeServer as TServer
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves
from repro_torch.optim import sgd as t_sgd

CFG = dict(name="tiny_resnet", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
TOL = dict(rtol=1e-3, atol=1e-5)
DECISIVE_PACE = dict(min_rounds=3, mu=1, slope_lambda=10.0)
ROLLBACK = dict(freeze_rollback=True, rollback_guard=-100.0,
                rollback_patience=1)
FAULTS = dict(p_fault=0.3, kinds=("nan", "amplify", "signflip", "crash"),
              seed=5)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: the CPU convolutions' summation order follows the
    thread count (``tests/test_torch_policies_drift.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleets(n_samples, n_clients):
    out = []
    for vision, dirichlet, fleet in ((JVision, j_dirichlet, j_fleet),
                                     (TVision, t_dirichlet, t_fleet)):
        train = vision(num_classes=4, image_size=16, seed=0).sample(
            n_samples, seed=1)
        out.append(fleet(train, dirichlet(train["y"], n_clients, alpha=1.0,
                                          seed=0), scenario="low", seed=0))
    return out


def _servers(monkeypatch, fleets, **kw):
    """(reference server, port server, initial params and state): the port
    takes the reference's Eq. 8 similarity and output modules."""
    jm = JCNN(JCfg(**CFG))
    params, state = jm.init(jax.random.PRNGKey(0))
    jkw, tkw = dict(kw), dict(kw)
    if "faults" in kw:
        jkw["faults"] = jfaults.FaultInjector(**kw["faults"])
        tkw["faults"] = tfaults.FaultInjector(**kw["faults"])
    if "optimizer_fn" in kw:
        jkw["optimizer_fn"] = kw["optimizer_fn"]["j"]
        tkw["optimizer_fn"] = kw["optimizer_fn"]["t"]
    jsrv = JServer(jm, fleets[0], use_pallas=False, **jkw)
    tsrv = TServer(TCNN(TCfg(**CFG), device="cpu"), fleets[1], device="cpu",
                   **tkw)
    j_sim = jsrv.bootstrap_similarity(params, state)
    monkeypatch.setattr(tsrv, "bootstrap_similarity", lambda p, s: j_sim)
    seed = kw.get("seed", 0)
    j_ops = {s: jfz.init_cnn_stage_active(jm, params, s,
                                          jax.random.PRNGKey(seed + s)
                                          )[1].get("op") for s in range(2)}
    port_init = tfz.init_cnn_stage_active

    def init_with_reference_op(model, p, stage, generator, **k):
        frozen, active = port_init(model, p, stage, generator, **k)
        if "op" in active:
            active["op"] = to_torch(j_ops[stage])
        return frozen, active

    monkeypatch.setattr(tfz, "init_cnn_stage_active", init_with_reference_op)
    return jsrv, tsrv, params, state


def _hold(j_out, t_out):
    assert len(t_out["history"]) == len(j_out["history"])
    for jr, tr in zip(j_out["history"], t_out["history"]):
        assert (tr.round_idx, tr.stage, tr.selected, tr.dropped, tr.screened,
                tr.rolled_back, tr.frozen) == \
            (jr.round_idx, jr.stage, [int(c) for c in jr.selected],
             [int(c) for c in jr.dropped], jr.screened, jr.rolled_back,
             jr.frozen)
        np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
    for key in ("params", "state"):
        for a, b in zip(jax.tree.leaves(j_out[key]),
                        tree_leaves(t_out[key])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def _bytes(tree):
    return b"".join(t.numpy().tobytes() for t in tree_leaves(tree))


def test_server_zero_fault_defended_bit_identity(monkeypatch):
    """Every defense armed and a zero-rate injector: the port's trajectory
    is its undefended one bit for bit, and the reference's."""
    fleets = _fleets(400, 6)
    run = dict(clients_per_round=4, batch_size=32, rounds_per_stage=2,
               seed=0, pace_kwargs=dict(min_rounds=99))
    defended = dict(run, screen_updates=True, freeze_rollback=True,
                    faults=dict(p_fault=0.0))
    jsrv, tsrv, params, state = _servers(monkeypatch, fleets, **defended)
    j_out = jsrv.run(params, state, schedule=[2, 2])
    t_out = tsrv.run(to_torch(params), to_torch(state), schedule=[2, 2])
    _hold(j_out, t_out)
    plain = TServer(TCNN(TCfg(**CFG), device="cpu"), fleets[1],
                    device="cpu", **run)
    monkeypatch.setattr(plain, "bootstrap_similarity",
                        tsrv.bootstrap_similarity)
    p_out = plain.run(to_torch(params), to_torch(state), schedule=[2, 2])
    assert _bytes(p_out["params"]) == _bytes(t_out["params"])
    assert _bytes(p_out["state"]) == _bytes(t_out["state"])
    assert [r.loss for r in p_out["history"]] == \
        [r.loss for r in t_out["history"]]
    assert [r.selected for r in p_out["history"]] == \
        [r.selected for r in t_out["history"]]
    assert all(not r.screened and not r.rolled_back
               for r in t_out["history"])


@pytest.mark.parametrize("aggregator", ["mean", "trimmed_mean",
                                        "coord_median"])
def test_defended_rollback_trajectory_matches_reference(monkeypatch,
                                                        aggregator):
    """Eight rounds under the mean: stage 0 freezes after round 3, round 4
    rolls it back, stage 0 restarts from its snapshot for two rounds and
    stage 1 takes the last. Under a robust combine the two packages'
    params part faster: at SGD 0.05 by about 3x a round from round 4
    (0.03, 0.8 and 2.7 of the tolerance after 4, 6 and 8 rounds under
    ``coord_median``, where the mean stays at 0.001; the reference's own
    XLA sums move with the core count), at SGD 0.01 to 0.003 and 0.03
    after six rounds under ``coord_median`` and ``trimmed_mean``. So the
    trajectories train at 0.01, and the robust aggregators are held over
    the first six rounds: the freeze, the rollback and one round from the
    restored snapshot."""
    total = 8 if aggregator == "mean" else 6
    fleets = _fleets(256, 4)
    jsrv, tsrv, params, state = _servers(
        monkeypatch, fleets, clients_per_round=3, batch_size=16, seed=0,
        optimizer_fn={"j": lambda: j_sgd(0.01), "t": lambda: t_sgd(0.01)},
        fused=False, screen_updates=True, aggregator=aggregator,
        faults=FAULTS, pace_kwargs=DECISIVE_PACE, **ROLLBACK)
    merges = []
    merge = tfz.merge_cnn_params
    monkeypatch.setattr(tfz, "merge_cnn_params", lambda *a: merges.append(
        merge(*a)) or merges[-1])
    starts = []
    init = tfz.init_cnn_stage_active
    monkeypatch.setattr(tfz, "init_cnn_stage_active",
                        lambda model, p, stage, *a, **k: starts.append(
                            (stage, p)) or init(model, p, stage, *a, **k))
    j_out = jsrv.run(params, state, total_rounds=total)
    t_out = tsrv.run(to_torch(params), to_torch(state), total_rounds=total)
    _hold(j_out, t_out)
    hist = t_out["history"]
    assert [r.stage for r in hist] == [0, 0, 0, 0, 1, 0, 0, 1][:total]
    assert [r.rolled_back for r in hist] == [False] * 4 + [True] + \
        [False] * (total - 5)
    assert hist[3].frozen and tsrv.rollbacks == jsrv.rollbacks == 1
    assert any(r.dropped for r in hist) and any(r.screened for r in hist)
    # stage 0 restarted from the very tree merged at its freeze
    assert [s for s, _ in starts] == [0, 1, 0, 1]
    frozen_at = next(m for m in merges if m is starts[1][1])
    assert starts[2][1] is frozen_at
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(t_out["params"]))


def test_fedavg_and_heterofl_with_faults_match_reference(monkeypatch):
    fleets = _fleets(256, 4)
    params, state = JCNN(JCfg(**CFG)).init(jax.random.PRNGKey(0))
    kw = dict(clients_per_round=3, batch_size=16, seed=0, fused=False,
              screen_updates=True, aggregator="trimmed_mean")
    j_out = JFedAvg(JCNN(JCfg(**CFG)), fleets[0], use_pallas=False,
                    faults=jfaults.FaultInjector(**FAULTS), **kw).run(
        params, state, rounds=3)
    t_out = TFedAvg(TCNN(TCfg(**CFG), device="cpu"), fleets[1],
                    device="cpu", faults=tfaults.FaultInjector(**FAULTS),
                    **kw).run(to_torch(params), to_torch(state), rounds=3)
    _hold(j_out, t_out)
    assert any(r.dropped for r in t_out["history"])

    # HeteroFL at Table 1's memory rule: its scale groups each get their
    # own clients' corruption faults
    def cnn_init(self, generator):
        jcfg = JCfg(**dataclasses.asdict(self.cfg))
        p, s = JCNN(jcfg).init(jax.random.PRNGKey(generator.initial_seed()))
        return to_torch(p, self.device), to_torch(s, self.device)

    monkeypatch.setattr(TCNN, "init", cnn_init)
    full = JB.full_model_memory(JCNN(JCfg(**CFG)), 32)
    for fleet in fleets:
        rng = np.random.RandomState(7)
        for c in fleet:
            c.memory_bytes = full * rng.choice([0.35, 0.5, 0.7, 0.9],
                                               p=[0.3, 0.3, 0.25, 0.15])
    run = dict(rounds=2, batch_size=16, clients_per_round=4, fused=False,
               aggregator="coord_median", screen_updates=True)
    faults = dict(FAULTS, p_fault=0.5, seed=2)
    j_out = JB.run_heterofl(JCfg(**CFG), fleets[0],
                            faults=jfaults.FaultInjector(**faults), **run)
    t_out = TB.run_heterofl(TCfg(**CFG), fleets[1], device="cpu",
                            faults=tfaults.FaultInjector(**faults), **run)
    _hold(j_out, t_out)
