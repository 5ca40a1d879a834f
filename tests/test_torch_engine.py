"""The port's round engine against the JAX package's, on the CPU, at a small
size: a (1, 1)-stage ResNet with channels (8, 16) on 16x16 images and four
clients. Both engines start from the reference's params (carried across
with ``repro_torch.convert``) and train on the same numpy shards and batch
plans.

Tolerances: params, BN state and per-client losses rtol 1e-4, atol 1e-5
(f32 convolutions and reductions summed in another order over a few SGD
steps); uplink bytes exactly. At ratio 1.0 top-k keeps every entry, so no
near-tie at the top-k boundary can flip between the packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freezing_cnn as jfz
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.engine import RoundEngine as JEngine
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
from repro.optim import sgd as j_sgd

from repro_torch.convert import to_torch
from repro_torch.core import freezing_cnn as tfz
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.engine import RoundEngine as TEngine, weighted_avg
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves
from repro_torch.optim import sgd as t_sgd

CFG = dict(name="tiny", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
TOL = dict(rtol=1e-4, atol=1e-5)


def _worlds():
    out = []
    for vision, dirichlet, fleet in ((JVision, j_dirichlet, j_fleet),
                                     (TVision, t_dirichlet, t_fleet)):
        train = vision(num_classes=4, image_size=16, seed=0).sample(200, seed=1)
        parts = dirichlet(train["y"], 4, alpha=1.0, seed=0)
        out.append(fleet(train, parts, scenario="low", seed=0))
    return out


def _close_trees(j_tree, t_tree):
    lj, lt = jax.tree.leaves(j_tree), tree_leaves(t_tree)
    assert len(lj) == len(lt)
    for a, b in zip(lj, lt):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), **TOL)


def _engines(stage, ratio, jclients):
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    frozen, active = jfz.init_cnn_stage_active(jm, params, stage,
                                               jax.random.PRNGKey(1))
    kw = dict(batch_size=16, local_epochs=1, compress_ratio=ratio)
    cached = {}
    if stage > 0:
        cached = dict(cached_loss_fn=jfz.cnn_cached_stage_loss_fn(jm, stage),
                      feature_fn=lambda x: jfz.cnn_prefix_features(
                          jm, frozen, state, x, stage))
    je = JEngine(loss_fn=jfz.cnn_stage_loss_fn(jm, stage), optimizer=j_sgd(0.05),
                 frozen=frozen, use_pallas=False, **cached, **kw)
    t_frozen, t_state = to_torch(frozen), to_torch(state)
    cached = {}
    if stage > 0:
        cached = dict(cached_loss_fn=tfz.cnn_cached_stage_loss_fn(tm, stage),
                      feature_fn=lambda x: tfz.cnn_prefix_features(
                          tm, t_frozen, t_state, x, stage))
    te = TEngine(loss_fn=tfz.cnn_stage_loss_fn(tm, stage), optimizer=t_sgd(0.05),
                 frozen=t_frozen, device="cpu", **cached, **kw)
    return je, te, (active, state), (to_torch(active), t_state)


@pytest.mark.parametrize("stage,ratio", [(0, None), (0, 1.0), (1, 1.0)])
def test_round_matches_reference(stage, ratio):
    """Stage 1 mixes a cached and a recompute group, so the two fused
    rounds and their weighted combination are covered too."""
    jclients, tclients = _worlds()
    je, te, (ja, js), (ta, ts) = _engines(stage, ratio, jclients)
    selected = [2, 0, 3, 1]
    use_cache = {0: "f32", 1: None, 2: "f32", 3: None} if stage else {}
    for r in range(2):  # the second round starts from the first's aggregate
        ja, js, jl = je.run_round({c.client_id: c for c in jclients},
                                  selected, ja, js, r, use_cache=use_cache)
        ta, ts, tl = te.run_round({c.client_id: c for c in tclients},
                                  selected, ta, ts, r, use_cache=use_cache)
        assert sorted(tl) == sorted(jl)
        np.testing.assert_allclose([tl[c] for c in selected],
                                   [jl[c] for c in selected], **TOL)
        _close_trees(ja, ta)
        _close_trees(js, ts)
        assert te.last_uplink_bytes == je.last_uplink_bytes
    if stage:
        assert te.cache_nbytes() == je.cache_nbytes()


@pytest.mark.parametrize("ratio", [None, 0.1, 0.37, 1.0])
def test_uplink_bytes_equal_reference(ratio):
    jclients, _ = _worlds()
    je, te, (ja, _), (ta, _) = _engines(1, ratio, jclients)
    assert te.per_client_uplink_bytes(ta) == je.per_client_uplink_bytes(ja)
    assert te._uplink_bytes(ta, 6) == je._uplink_bytes(ja, 6)


def test_cached_logits_equal_recompute_logits():
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    frozen, active = jfz.init_cnn_stage_active(jm, params, 1,
                                               jax.random.PRNGKey(1))
    x = np.random.RandomState(3).randn(8, 16, 16, 3).astype(np.float32)
    tf, ta, ts = to_torch(frozen), to_torch(active), to_torch(state)
    full, _ = tfz.cnn_stage_forward(tm, tf, ta, ts, torch.as_tensor(x), 1)
    feats = tfz.cnn_prefix_features(tm, tf, ts, torch.as_tensor(x), 1)
    cached, _ = tfz.cnn_stage_forward_from_features(tm, ta, ts, feats, 1)
    np.testing.assert_array_equal(cached.detach().numpy(),
                                  full.detach().numpy())
    want, _ = jfz.cnn_stage_forward(jm, frozen, active, state,
                                    jnp.asarray(x), 1)
    np.testing.assert_allclose(cached.detach().numpy(), np.asarray(want),
                               **TOL)


def test_residual_pools_carry_error_feedback():
    """At ratio 0.1 each client keeps 90% of its delta as residual: after
    a round every selected client has a nonzero pool row, and the rows of
    clients not selected stay untouched."""
    _, tclients = _worlds()
    tm = TCNN(TCfg(**CFG), device="cpu")
    params, state = tm.init(torch.Generator().manual_seed(0))
    _, active = tfz.init_cnn_stage_active(tm, params, 0,
                                          torch.Generator().manual_seed(1))
    te = TEngine(loss_fn=tfz.cnn_stage_loss_fn(tm, 0), optimizer=t_sgd(0.05),
                 batch_size=16, compress_ratio=0.1, device="cpu")
    clients = {c.client_id: c for c in tclients}
    te.run_round(clients, [0, 1], active, state, 0)
    te.run_round(clients, [2], active, state, 1)
    for cid in (0, 1, 2):
        rows = te.client_residuals(cid)
        assert len(rows) == len(tree_leaves(active))
        assert any(float(r.abs().sum()) > 0 for r in rows)
    assert te._res_pool[0].shape[0] >= 3


def test_weighted_avg_is_the_eq1_fold():
    rng = np.random.RandomState(0)
    trees = [{"a": torch.as_tensor(rng.randn(3).astype(np.float32)),
              "b": {"c": torch.as_tensor(rng.randn(2, 2).astype(np.float32))}}
             for _ in range(3)]
    w = np.asarray([0.2, 0.3, 0.5])
    out = weighted_avg(trees, w)
    want = sum(wi * t["b"]["c"].numpy() for wi, t in zip(w, trees))
    np.testing.assert_allclose(out["b"]["c"].numpy(), want, rtol=1e-6)
