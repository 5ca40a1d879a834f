"""Crash and resume of the port's servers on the CPU, as the JAX package's
own tests hold its servers (``tests/test_sim.py``, ``tests/test_quant.py``),
and a continuation of a reference run from the reference's checkpoint.

Port only, bitwise: a (1, 1)-stage ResNet of widths (8, 16) over eight
clients of 16x16 images, four a round, batch 32. ``SmartFreezeServer``
with a pace controller loose enough that stage 0 freezes (``min_rounds=3,
mu=2, slope_lambda=0.5``), checkpointing every round, crashes in its
``eval_fn``; a fresh server resumes, and the two halves' records and the
final params and BN state equal the uninterrupted run's. Two cases run
compressed uplinks at ratio 0.5 (error-feedback pools carried) under the
async manager, so a snapshot that aliased live memory would fail them;
one of them under the deadline policy (factor 1.5), whose straggler
rounds take the sequential path. The
same across a cache-tier decision (int8 / fp16 / f32 / declined clients
under the reference test's memory rule, plus a client whose memory holds
the stage but no cache).

Across packages: the reference runs ``schedule=[3, 2]`` at ratio 1.0 with
a crash in round 2 and a checkpoint every round; the port resumes from
the reference's checkpoint (finishing stage 0, then all of stage 1) and
holds the reference's uninterrupted run: selections and stages equal,
losses, final params and BN state rtol 1e-3, atol 1e-5, perturbations
rtol 1e-2 (``tests/test_torch_server.py``'s tolerances)."""
import dataclasses
import time

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JManager
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.server import SmartFreezeServer as JServer
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg

from repro_torch.checkpoint import CheckpointManager, ckpt
from repro_torch.convert import to_torch
from repro_torch.core.memory_model import cnn_stage_memory_bytes
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.server import SmartFreezeServer
from repro_torch.models.cnn import CNN, CNNConfig
from repro_torch.models.module import tree_leaves

from test_torch_server import CFG, SRV, TOL, _data, _patch_to_reference

LOOSE_PACE = dict(min_rounds=3, mu=2, slope_lambda=0.5)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the other trajectory files run
    (``tests/test_torch_fedavg.py``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Crash(Exception):
    pass


def crash_after(n):
    """An ``eval_fn`` that raises on its (n + 1)-th call."""
    calls = {"n": 0}

    def eval_fn(p, s, stage):
        calls["n"] += 1
        if calls["n"] > n:
            raise Crash()
        return 0.0
    return eval_fn


def _world(n_samples=720, n_clients=8):
    sv = TVision(num_classes=4, image_size=16, seed=0)
    train = sv.sample(n_samples, seed=1)
    parts = t_dirichlet(train["y"], n_clients, alpha=1.0, seed=0)
    clients = t_fleet(train, parts, scenario="low", seed=0)
    model = CNN(CNNConfig("tiny", "resnet", stage_sizes=(1, 1),
                          stage_channels=(8, 16), num_classes=4),
                device="cpu")
    params, state = model.init(torch.Generator().manual_seed(0))
    return clients, model, params, state


def _equal_trees(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def _crash_and_resume(make, params, state, mgr, n_ok, **run_kw):
    """(uninterrupted run, crashed server, resumed run)."""
    out_a = make().run(params, state, **run_kw)
    srv_b = make()
    with pytest.raises(Crash):
        srv_b.run(params, state, ckpt_manager=mgr, ckpt_every=1,
                  eval_fn=crash_after(n_ok), eval_every=1, **run_kw)
    assert 0 < len(srv_b.history) < len(out_a["history"])
    out_c = make().run(params, state, ckpt_manager=mgr, ckpt_every=1,
                       resume=True, **run_kw)
    return out_a, srv_b, out_c


def _same_records(ref, combined):
    assert len(combined) == len(ref)
    for a, b in zip(ref, combined):
        assert (a.round_idx, a.stage, a.selected, a.frozen) == \
            (b.round_idx, b.stage, b.selected, b.frozen)
        assert a.loss == b.loss, (a.round_idx, a.loss, b.loss)
        assert a.perturbation == b.perturbation
        assert a.virtual_time == b.virtual_time
        assert a.uplink_bytes == b.uplink_bytes


@pytest.mark.parametrize("ratio,async_save,deadline", [
    (None, False, 0.0), (0.5, True, 0.0), (0.5, True, 1.5)])
def test_smartfreeze_resume_bit_identical_across_freeze(
        tmp_path, monkeypatch, ratio, async_save, deadline):
    clients, model, params, state = _world()

    def make():
        return SmartFreezeServer(model, clients, clients_per_round=4,
                                 batch_size=32, rounds_per_stage=5, seed=0,
                                 pace_kwargs=dict(LOOSE_PACE),
                                 compress_ratio=ratio,
                                 deadline_factor=deadline, device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=async_save)
    if async_save:
        # each write lands after the next round has trained (and updated
        # the residual pools in place)
        write = ckpt._write
        monkeypatch.setattr(ckpt, "_write",
                            lambda *a: (time.sleep(0.5), write(*a))[1])
    out_a, srv_b, out_c = _crash_and_resume(make, params, state, mgr, 2)
    assert any(r.frozen for r in out_a["history"]), "no pace freeze"
    _same_records(out_a["history"], srv_b.history + out_c["history"])
    assert {r.stage for r in out_c["history"]} >= {1}
    _equal_trees(out_a["params"], out_c["params"])
    _equal_trees(out_a["state"], out_c["state"])
    if ratio is not None:
        step = mgr.restore()
        assert "ef" in step["tree"]
    if deadline:
        assert any(r.dropped for r in out_a["history"]), "no straggler cut"


def test_resume_across_tier_decision_bit_identical(tmp_path):
    """Crash and resume in stage 1 with a mixed-tier fleet (int8, fp16,
    f32 and declined clients, ``cache_time_scale``) on the sequential
    path: the resumed run consumes the checkpoint's cached bytes."""
    clients, model, params, state = _world(600, 6)
    clients = [dataclasses.replace(c) for c in clients]
    need = lambda c, dt: cnn_stage_memory_bytes(  # noqa: E731
        model, 1, 32, 16, cache_samples=c.num_samples, cache_dtype=dt)
    clients[0].memory_bytes = need(clients[0], "int8") + 1.0
    clients[1].memory_bytes = need(clients[1], "float16") + 1.0
    clients[2].memory_bytes = need(clients[2], "float32") + 1.0
    clients[3].memory_bytes = cnn_stage_memory_bytes(model, 1, 32, 16) + 1.0

    def make():
        return SmartFreezeServer(model, clients, clients_per_round=4,
                                 batch_size=32, rounds_per_stage=3, seed=0,
                                 fused=False, cache_tiers="all",
                                 cache_time_scale=True,
                                 pace_kwargs=dict(min_rounds=99),
                                 device="cpu")
    mgr = CheckpointManager(str(tmp_path / "ck"), async_save=False)
    out_a, srv_b, out_c = _crash_and_resume(make, params, state, mgr, 3,
                                            schedule=[2, 3])
    assert set(srv_b.cache_tier_plan.values()) >= {"int8", "fp16", "f32",
                                                   None}
    _same_records(out_a["history"], srv_b.history + out_c["history"])
    _equal_trees(out_a["params"], out_c["params"])
    _equal_trees(out_a["state"], out_c["state"])
    # the step resumed from is stage 1's first round, which filled the
    # cache: it carries the encoded features
    step = mgr.restore(step=len(srv_b.history) - 1)
    assert (step["step"], step["metadata"]["stage"]) == (2, 1)
    cached = step["tree"]["cache"]["ids"].tolist()
    assert cached == sorted(c for c in srv_b.history[2].selected
                            if srv_b.cache_tier_plan[c])


def test_port_continues_a_reference_checkpoint(tmp_path, monkeypatch):
    jt, jp = _data(JVision, j_dirichlet)
    tt, tp = _data(TVision, t_dirichlet)
    jm, tm = JCNN(JCfg(**CFG)), CNN(CNNConfig(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    srv = dict(SRV, compress_ratio=1.0)
    j_ref = JServer(jm, j_fleet(jt, jp, scenario="low", seed=0),
                    use_pallas=False, **srv).run(params, state,
                                                 schedule=[3, 2])
    mgr = JManager(str(tmp_path / "ck"), async_save=False)
    j_crash = JServer(jm, j_fleet(jt, jp, scenario="low", seed=0),
                      use_pallas=False, **srv)
    with pytest.raises(Crash):
        j_crash.run(params, state, schedule=[3, 2], ckpt_manager=mgr,
                    ckpt_every=1, eval_fn=crash_after(2), eval_every=1)
    assert len(j_crash.history) == 2
    tsrv = SmartFreezeServer(tm, t_fleet(tt, tp, scenario="low", seed=0),
                             device="cpu", **srv)
    # stage 1 starts in the port: its output module is the reference's
    _patch_to_reference(monkeypatch, j_crash, tsrv, jm, params, state,
                        SRV["seed"])
    t_mgr = CheckpointManager(str(tmp_path / "ck"))
    t_out = tsrv.run(to_torch(params), to_torch(state), schedule=[3, 2],
                     ckpt_manager=t_mgr, ckpt_every=1, resume=True)
    t_mgr.wait()
    ref = j_ref["history"][2:]
    got = t_out["history"]
    assert [r.stage for r in got] == [0, 1, 1] == [r.stage for r in ref]
    for jr, tr in zip(ref, got):
        assert (tr.round_idx, tr.selected, tr.uplink_bytes) == \
            (jr.round_idx, [int(c) for c in jr.selected], jr.uplink_bytes)
        np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
        np.testing.assert_allclose(tr.perturbation or 0.0,
                                   jr.perturbation or 0.0, rtol=1e-2)
        np.testing.assert_allclose(tr.virtual_time, jr.virtual_time,
                                   rtol=1e-6)
    for a, b in zip(jax.tree.leaves((j_ref["params"], j_ref["state"])),
                    tree_leaves(t_out["params"])
                    + tree_leaves(t_out["state"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
    # the port's own last checkpoint restores in the reference
    back = JManager(str(tmp_path / "ck")).restore()
    assert back["metadata"]["round_idx"] == 4
    for a, b in zip(jax.tree.leaves(back["tree"]["state"]),
                    tree_leaves(t_out["state"])):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
