"""The port's vectorized selector on the SmartFreeze server path, on the
CPU: the server against the JAX package's with each package's
``VectorizedSelector`` (the reference's
``test_vectorized_selector_drives_smartfreeze_server``, at the default
``epsilon = 0.2``, so the Gumbel stream is drawn every round), the
engine's ``residual_norms`` against the reference's, and a crash and
resume that continues the selector's streams.

The server cases reuse ``tests/test_torch_server.py``'s setup: a (1, 1)
-stage ResNet of widths (8, 16) on 16x16 images, the reference's params,
Eq. 8 similarity and output modules carried across. Tolerances are that
file's: losses and final params rtol 1e-3, atol 1e-5; cohorts and stages
equal. Residual norms rtol 1e-6."""
import jax
import numpy as np
import pytest
import torch

from repro.core.selector import VectorizedSelector as JSelector
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.server import SmartFreezeServer as JServer
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg

from repro_torch.checkpoint import CheckpointManager
from repro_torch.convert import to_numpy, to_torch
from repro_torch.core.selector import ParticipantSelector, VectorizedSelector
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.server import SmartFreezeServer as TServer
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves

from test_torch_engine import _engines, _worlds
from test_torch_resume import Crash, crash_after
from test_torch_server import CFG, TOL, _patch_to_reference


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the other trajectory files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(vision, dirichlet, n_clients=8):
    train = vision(num_classes=4, image_size=16, seed=0).sample(256, seed=1)
    return train, dirichlet(train["y"], n_clients, alpha=1.0, seed=0)


@pytest.mark.parametrize("ratio,fused", [(None, False), (0.1, True)])
def test_vectorized_selector_drives_server_like_reference(monkeypatch, ratio,
                                                          fused):
    jt, jp = _data(JVision, j_dirichlet)
    tt, tp = _data(TVision, t_dirichlet)
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    kw = dict(clients_per_round=4, batch_size=16, seed=0, fused=fused,
              compress_ratio=ratio, pace_kwargs=dict(min_rounds=999))
    jsrv = JServer(jm, j_fleet(jt, jp, scenario="low", seed=0),
                   selector=JSelector(seed=0, phi=1), use_pallas=False, **kw)
    tsrv = TServer(tm, t_fleet(tt, tp, scenario="low", seed=0),
                   selector=VectorizedSelector(seed=0, phi=1, device="cpu"),
                   device="cpu", **kw)
    _patch_to_reference(monkeypatch, jsrv, tsrv, jm, params, state, 0)
    j_out = jsrv.run(params, state, schedule=[2, 1])
    t_out = tsrv.run(to_torch(params), to_torch(state), schedule=[2, 1])
    assert tsrv.selector._communities == jsrv.selector._communities
    assert tsrv.selector._round == jsrv.selector._round == 3
    assert t_out["rounds"] == j_out["rounds"] == 3
    for jr, tr in zip(j_out["history"], t_out["history"]):
        assert (tr.round_idx, tr.stage, tr.selected, tr.uplink_bytes) == \
            (jr.round_idx, jr.stage, jr.selected, jr.uplink_bytes)
        assert len(tr.selected) == 4
        np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
    for a, b in zip(jax.tree.leaves(j_out["params"]),
                    jax.tree.leaves(to_numpy(t_out["params"]))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


def test_residual_norms_match_reference():
    """The reference engine's residual pools after a round at ratio 0.1,
    loaded into the port's engine: the per-client norms agree within
    rtol 1e-6; a port round's norms equal an f64 norm of its own rows."""
    jclients, tclients = _worlds()
    je, te, (ja, js), (ta, ts) = _engines(0, 0.1, jclients)
    assert te.residual_norms() == {}
    je.run_round({c.client_id: c for c in jclients}, [2, 0, 3], ja, js, 0)
    te.load_ef_state({k: np.array(v) for k, v in je.ef_state().items()})
    want, got = je.residual_norms(), te.residual_norms()
    assert sorted(got) == sorted(want) == [0, 2, 3]
    for c in want:
        assert want[c] > 0
        np.testing.assert_allclose(got[c], want[c], rtol=1e-6)
    te.run_round({c.client_id: c for c in tclients}, [1, 3], ta, ts, 1)
    got = te.residual_norms()
    assert sorted(got) == [0, 1, 2, 3]
    for c in got:
        rows = np.concatenate([r.double().numpy()
                               for r in te.client_residuals(c)])
        np.testing.assert_allclose(got[c], np.linalg.norm(rows), rtol=1e-6)


def test_resume_continues_vectorized_selection(tmp_path):
    """A run with the vectorized selector at epsilon 0.2, checkpointed
    every round and crashed mid-stage, resumed by a fresh server and a
    fresh selector: the cohorts equal an uninterrupted run's, and the
    list selector's checkpoint keys are not needed."""
    tt, tp = _data(TVision, t_dirichlet)
    clients = t_fleet(tt, tp, scenario="low", seed=0)
    model = TCNN(TCfg(**CFG), device="cpu")
    params, state = model.init(torch.Generator().manual_seed(0))

    def make():
        return TServer(model, clients, clients_per_round=3, batch_size=32,
                       seed=0, compress_ratio=0.5,
                       selector=VectorizedSelector(seed=0, phi=1,
                                                   device="cpu"),
                       pace_kwargs=dict(min_rounds=999), device="cpu")
    out_a = make().run(params, state, schedule=[3, 2])
    srv_b = make()
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    with pytest.raises(Crash):
        srv_b.run(params, state, schedule=[3, 2], ckpt_manager=mgr,
                  ckpt_every=1, eval_fn=crash_after(2), eval_every=1)
    assert len(srv_b.history) == 2          # crashed inside stage 0
    srv_c = make()
    out_c = srv_c.run(params, state, schedule=[3, 2], ckpt_manager=mgr,
                      ckpt_every=1, resume=True)
    combined = srv_b.history + out_c["history"]
    assert [r.selected for r in combined] == \
        [r.selected for r in out_a["history"]]
    assert [r.stage for r in combined] == [0, 0, 0, 1, 1]
    assert srv_c.selector._round == 5
    saved = mgr.restore()["tree"]["selector"]
    assert sorted(saved) == ["comm_flat", "comm_offsets", "round"]
    for a, b in zip(tree_leaves(out_a["params"]),
                    tree_leaves(out_c["params"])):
        assert torch.equal(a, b)


def test_list_and_vectorized_selectors_pick_alike_on_the_server():
    """At epsilon 0 the vectorized selector is the list selector's
    drop-in: one port server run each, the same cohorts."""
    tt, tp = _data(TVision, t_dirichlet)
    clients = t_fleet(tt, tp, scenario="low", seed=0)
    model = TCNN(TCfg(**CFG), device="cpu")
    params, state = model.init(torch.Generator().manual_seed(0))
    cohorts = []
    for selector in (ParticipantSelector(epsilon=0.0, seed=0, phi=1),
                     VectorizedSelector(epsilon=0.0, seed=0, phi=1,
                                        device="cpu")):
        srv = TServer(model, clients, clients_per_round=3, batch_size=32,
                      seed=0, selector=selector,
                      pace_kwargs=dict(min_rounds=999), device="cpu")
        out = srv.run(params, state, schedule=[2, 1])
        cohorts.append([r.selected for r in out["history"]])
    assert cohorts[0] == cohorts[1]
