"""The baselines' fused path and the engine's unused leaves, against the
JAX package on the CPU (``test_torch_baselines.py``'s configuration and
tolerance).

  * DepthFL fused, with every depth group's cohort through the compressed
    fold at ratio 1.0 (top-k keeps every entry, so no near-tie can flip),
    on the fleet where both depths occur, so that the per-stage average
    over groups, the deepest group's ``fc`` and each group's ``aux`` head
    are held; the reference runs without Pallas, as its runners build
    their engines.
  * The engine with a loss that never reads ``stages/stage1``, as for a
    depth-0 DepthFL client: those leaves get zero gradients, as under
    ``jax.grad``. A client trained alone, and a cohort whose uplinks go
    through the compressed fold (which adds zeros), return them bit for
    bit; a dense cohort returns their weighted average. Sequential and
    fused, against the reference's ``RoundEngine``."""
import jax
import numpy as np
import pytest
import torch

from repro.core.output_module import cnn_fc_only_init as j_fc_only_init
from repro.fl.engine import RoundEngine as JEngine
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
from repro.models.cnn import softmax_xent as j_xent
from repro.models.module import PFac
from repro.optim import sgd as j_sgd

from repro_torch.convert import to_torch
from repro_torch.fl.engine import RoundEngine as TEngine
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.cnn import softmax_xent as t_xent
from repro_torch.models.module import tree_leaves
from repro_torch.optim import sgd as t_sgd
from test_torch_baselines import (CFG, OPERATIVE, TOL, _fleets, _run_pair,
                                  reference_init)  # noqa: F401


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


def test_depthfl_fused_compressed_groups_match_reference(reference_init):
    _, out = _run_pair("depthfl", OPERATIVE, fused=True, compress_ratio=1.0)
    assert len(out["history"]) == 2
    assert 0 < out["participation"] < 1  # both depths occur


def _shallow_loss(cnn, xent):
    def loss_fn(p, frozen_unused, st, batch):
        h, st = cnn.stem(p, st, batch["x"], train=True)
        h, st = cnn.run_stages(p, st, h, 0, 1, train=True)
        return xent(cnn.head({"fc": p["aux"]["fc"]}, h), batch["y"]), st
    return loss_fn


@pytest.mark.parametrize("sequential,ratio", [(True, None), (False, 1.0)],
                         ids=["sequential", "fused compressed"])
def test_unused_leaves_get_zero_update_as_in_reference(sequential, ratio):
    jc, tc = _fleets(OPERATIVE)
    jby = {c.client_id: c for c in jc}
    tby = {c.client_id: c for c in tc}
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    aux = j_fc_only_init(PFac(jax.random.PRNGKey(1)).sub("aux0"),
                         JCfg(**CFG), 0)
    sub = {"stem": params["stem"], "stages": params["stages"], "aux": aux}
    kw = dict(batch_size=32, compress_ratio=ratio)
    je = JEngine(loss_fn=_shallow_loss(jm, j_xent), optimizer=j_sgd(0.05),
                 **kw)
    te = TEngine(loss_fn=_shallow_loss(tm, t_xent), optimizer=t_sgd(0.05),
                 device="cpu", **kw)
    t_in = to_torch(sub)
    unused = tree_leaves(t_in["stages"]["stage1"])
    for r, sel in enumerate(([14], [14, 1, 3])):  # 3, 2 and 2 local steps
        jp, js, jl = je.run_round(jby, sel, sub, state, r,
                                  sequential=sequential)
        tp, ts, tl = te.run_round(tby, sel, t_in, to_torch(state), r,
                                  sequential=sequential)
        assert not torch.equal(tp["stages"]["stage0"]["b0"]["conv1"]["w"],
                               t_in["stages"]["stage0"]["b0"]["conv1"]["w"])
        for a, b in zip(tree_leaves(tp["stages"]["stage1"]), unused):
            if len(sel) == 1 or ratio is not None:
                assert torch.equal(a, b)
            else:  # the f32 weighted average of equal rows
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6)
        np.testing.assert_allclose([tl[c] for c in jl], [jl[c] for c in jl],
                                   **TOL)
        for a, b in zip(jax.tree.leaves((jp, js)),
                        tree_leaves(tp) + tree_leaves(ts)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)
        for a, b in zip(jax.tree.leaves(jp["stages"]["stage1"]),
                        tree_leaves(tp["stages"]["stage1"])):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=0)
