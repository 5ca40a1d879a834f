"""The CNN path's smaller public functions in the port against the JAX
package, on the CPU at the sizes of the reference's own tests: the
one-batch stage step (``make_cnn_stage_step``, as the reference's
``tests/test_system.py::test_cnn_stage_frozen_prefix_is_fixed`` drives it:
a (1, 1)-stage ResNet with channels (8, 16), 4 classes, 16x16 images),
``SimClient.batches`` / ``local_train``, Louvain's ``modularity`` (on
``tests/test_selector.py``'s clustered graph), the selector's data
diversity Div(S, t), ``CNN.stage_output_channels``, ``param_bytes``,
``cast_tree``, ``tree_sub``, ``tree_norm`` and the CNN config modules.

Params come from ``jax.random`` in the reference and are carried across
with ``repro_torch.convert``; data, shards and batch plans are numpy in
both packages.

Tolerances: one step's loss, params and BN state rtol 1e-4, atol 1e-5 (f32
convolutions and reductions summed in another order, as
``tests/test_torch_engine.py``); host data, batch plans, modularity, byte
counts and casts exactly; the f32 differences and norms of a tree rtol
1e-6."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import freezing_cnn as jfz
from repro.core import pace as jpace
from repro.core.selector import ParticipantSelector as JSelector
from repro.core.selector.louvain import louvain as j_louvain
from repro.core.selector.louvain import modularity as j_modularity
from repro.core.selector.similarity import similarity_matrix
from repro.data.partition import dirichlet_partition
from repro.data.synthetic import SyntheticVision
from repro.fl.client import make_client_fleet as j_fleet
from repro.models import cnn as jcnn
from repro.models import module as jmodule
from repro.models import transformer as jtr
from repro.optim import sgd as j_sgd

from repro_torch.convert import to_torch
from repro_torch.core import freezing_cnn as tfz
from repro_torch.core import pace as tpace
from repro_torch.core.selector import ParticipantSelector as TSelector
from repro_torch.core.selector.louvain import louvain as t_louvain
from repro_torch.core.selector.louvain import modularity as t_modularity
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.models import cnn as tcnn
from repro_torch.models import module as tmodule
from repro_torch.models.module import tree_leaves
from repro_torch.optim import sgd as t_sgd


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: this file's CPU work is small ops, and in a
    parallel run of the suite every pytest worker's torch pool spinning
    over all the cores oversubscribes them (``tests/test_torch_quant.py``).
    The results do not depend on it beyond the stated tolerances."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CFG = dict(name="tiny_resnet", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def world():
    """``tests/test_system.py``'s fl_world: 800 samples of 4 classes over
    10 clients, as numpy, and each package's fleet of them."""
    train = SyntheticVision(num_classes=4, image_size=16, seed=0).sample(
        800, seed=1)
    parts = dirichlet_partition(train["y"], 10, alpha=1.0, seed=0)
    return (train, j_fleet(train, parts, scenario="low", seed=0),
            t_fleet(train, parts, scenario="low", seed=0))


def _models():
    jm = jcnn.CNN(jcnn.CNNConfig(**CFG))
    tm = tcnn.CNN(tcnn.CNNConfig(**CFG), device="cpu")
    return jm, tm


def _close(t_tree, j_tree, tol=TOL):
    lt, lj = tree_leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(lt) == len(lj)
    for a, b in zip(lt, lj):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **tol)


# --------------------------------------------------------------------------
# the stage step and the client's local loop
# --------------------------------------------------------------------------


def test_cnn_stage_step_matches_reference_with_a_fixed_prefix(world):
    """Stage 1 of the two-stage ResNet, one SGD(0.1) step on 16 samples:
    the loss, the new active params and BN state as the reference's; the
    frozen prefix bit for bit unchanged and absent from the active tree."""
    train, _, _ = world
    jm, tm = _models()
    params, state = jm.init(jax.random.PRNGKey(0))
    frozen, active = jfz.init_cnn_stage_active(jm, params, 1,
                                               jax.random.PRNGKey(1))
    jstep = jfz.make_cnn_stage_step(jm, 1, j_sgd(0.1))
    ja, js, _, jloss = jstep(active, frozen, state, j_sgd(0.1).init(active),
                             {"x": jnp.asarray(train["x"][:16]),
                              "y": jnp.asarray(train["y"][:16])})
    t_frozen, t_active, t_state = (to_torch(frozen), to_torch(active),
                                   to_torch(state))
    before = [leaf.clone() for leaf in tree_leaves(t_frozen)]
    tstep = tfz.make_cnn_stage_step(tm, 1, t_sgd(0.1))
    ta, ts, opt_state, tloss = tstep(
        t_active, t_frozen, t_state, t_sgd(0.1).init(t_active),
        {"x": torch.as_tensor(train["x"][:16]),
         "y": torch.as_tensor(train["y"][:16])})
    assert opt_state == {"step": 1}
    np.testing.assert_allclose(float(tloss), float(jloss), **TOL)
    _close(ta, ja)
    _close(ts, js)
    for a, b in zip(before, tree_leaves(t_frozen)):
        assert torch.equal(a, b)
    moved = [float((a - b).abs().max()) for a, b in
             zip(tree_leaves(ta["stages"]), tree_leaves(t_active["stages"]))]
    assert max(moved) > 0
    assert "stage0" in t_frozen["stages"] and "stage0" not in ta["stages"]
    assert all(not leaf.requires_grad for leaf in tree_leaves(ta))


@pytest.mark.parametrize("epochs,seed", [(1, 0), (2, 7)])
def test_client_batches_are_bitwise_equal(world, epochs, seed):
    _, jclients, tclients = world
    for jc, tc in zip(jclients[:3], tclients[:3]):
        jb = list(jc.batches(16, epochs, seed))
        tb = list(tc.batches(16, epochs, seed))
        assert len(jb) == len(tb) == epochs * (jc.num_samples // 16)
        for a, b in zip(jb, tb):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])


def test_client_local_train_matches_reference(world):
    """Client 0's local epoch of stage-0 steps (batch 16, round 3's batch
    plan): the batch count, the mean loss and the trained active params."""
    _, jclients, tclients = world
    jm, tm = _models()
    params, state = jm.init(jax.random.PRNGKey(0))
    frozen, active = jfz.init_cnn_stage_active(jm, params, 0,
                                               jax.random.PRNGKey(1))
    kw = dict(batch_size=16, epochs=1, round_idx=3)
    ja, js, jloss, jn = jclients[0].local_train(
        jfz.make_cnn_stage_step(jm, 0, j_sgd(0.05)), active, frozen, state,
        j_sgd(0.05).init(active), **kw)
    t_active = to_torch(active)
    ta, ts, tloss, tn = tclients[0].local_train(
        tfz.make_cnn_stage_step(tm, 0, t_sgd(0.05)), t_active,
        to_torch(frozen), to_torch(state), t_sgd(0.05).init(t_active), **kw)
    assert tn == jn == tclients[0].num_samples // 16 > 1
    assert isinstance(tloss, float)
    np.testing.assert_allclose(tloss, jloss, **TOL)
    _close(ta, ja)
    _close(ts, js)


# --------------------------------------------------------------------------
# selector
# --------------------------------------------------------------------------


def _clustered_sim(n_groups=3, per=4, noise=0.05, seed=0):
    """``tests/test_selector.py``'s planted groups."""
    rng = np.random.RandomState(seed)
    vecs = {}
    for g in range(n_groups):
        proto = np.zeros(48)
        proto[g * 16:(g + 1) * 16] = 1.0
        for i in range(per):
            vecs[g * per + i] = proto + rng.randn(48) * noise
    return similarity_matrix(vecs)


def test_modularity_matches_reference():
    """The reference selector test's graph (noise 0.15, seed 3) under
    Louvain's partition from each package, every node alone, one
    community, and a resolution of 0.5; an empty graph scores 0."""
    W = _clustered_sim(noise=0.15, seed=3)
    Wp = np.maximum(W, 0)
    np.fill_diagonal(Wp, 0)
    parts = [j_louvain(Wp), t_louvain(Wp), [[i] for i in range(len(W))],
             [list(range(len(W)))], [[0, 5, 9], [1, 2, 3, 4], [6, 7, 8, 10, 11]]]
    assert parts[0] == parts[1]
    for comms in parts:
        for res in (1.0, 0.5):
            want = j_modularity(Wp, comms, res)
            got = t_modularity(Wp, comms, res)
            assert isinstance(got, float) and got == want
    # the raw similarity (diagonal and negative weights in it) too
    assert t_modularity(W, parts[0]) == j_modularity(W, parts[0])
    assert t_modularity(np.zeros((3, 3)), [[0, 1, 2]]) == 0.0


@pytest.mark.parametrize("selected", [[0, 1, 2, 3], [0, 4, 8], [5, 11],
                                      [7], []])
def test_data_diversity_matches_reference(selected):
    """Div(S, t) = 1 / sum over pairs i != j of S; inf below two clients."""
    W = _clustered_sim()
    want = JSelector().data_diversity(selected, W)
    got = TSelector().data_diversity(selected, W)
    assert isinstance(got, float) and got == want
    if len(selected) < 2:
        assert got == float("inf")


# --------------------------------------------------------------------------
# models, trees, configs
# --------------------------------------------------------------------------


def test_stage_output_channels_match_reference():
    for name in ("resnet10", "resnet18", "vgg11_bn", "vgg16_bn"):
        jm = jcnn.build_cnn(name)
        tm = tcnn.build_cnn(name, device="cpu")
        n = len(jm.cfg.stage_sizes)
        assert [tm.stage_output_channels(s) for s in range(n)] == \
            [jm.stage_output_channels(s) for s in range(n)]


def _mixed_tree():
    """A bf16 model's params (its MoE router float32) and an int leaf."""
    from repro import configs as jconfigs
    cfg = jconfigs.get("grok-1-314b").reduced(num_layers=2)
    tree = jtr.build(cfg).init(jax.random.PRNGKey(0))
    tree["count"] = jnp.arange(5, dtype=jnp.int32)
    return tree


def test_param_bytes_and_cast_tree_match_reference():
    jtree = _mixed_tree()
    ttree = to_torch(jtree)
    assert tmodule.param_bytes(ttree) == jmodule.param_bytes(jtree)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = jax.tree.leaves(jmodule.cast_tree(jtree, jdt))
        got = tree_leaves(tmodule.cast_tree(ttree, tdt))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == getattr(torch, jnp.dtype(b.dtype).name)
            np.testing.assert_array_equal(a.float().numpy(),
                                          np.asarray(b, np.float32))
        assert tmodule.cast_tree(ttree, tdt)["count"].dtype == torch.int32
    assert tmodule.param_bytes(tmodule.cast_tree(ttree, torch.float32)) == \
        jmodule.param_bytes(jmodule.cast_tree(jtree, jnp.float32))


def test_tree_sub_and_tree_norm_match_reference():
    def tree(seed):
        r = np.random.RandomState(seed)
        return {"a": jnp.asarray(r.randn(3, 4), jnp.bfloat16),
                "b": {"c": jnp.asarray(r.randn(7), jnp.float32),
                      "d": jnp.asarray(r.randn(2, 2, 2), jnp.bfloat16)}}

    ja, jb = tree(1), tree(2)
    ta, tb = to_torch(ja), to_torch(jb)
    want = jpace.tree_sub(ja, jb)
    got = tpace.tree_sub(ta, tb)
    for a, b in zip(tree_leaves(got), jax.tree.leaves(want)):
        assert a.dtype == torch.float32
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n = tpace.tree_norm(got)
    assert isinstance(n, float)
    np.testing.assert_allclose(n, jpace.tree_norm(want), rtol=1e-6)
    np.testing.assert_allclose(tpace.tree_norm(ta), jpace.tree_norm(ja),
                               rtol=1e-6)


def test_cnn_config_modules_reexport_the_reference_configs():
    from repro.configs import resnet_cifar as jres, vgg_cifar as jvgg
    from repro_torch.configs import resnet_cifar as tres, vgg_cifar as tvgg
    for jmod, tmod, names in ((jres, tres, ("RESNET10", "RESNET18")),
                              (jvgg, tvgg, ("VGG11", "VGG16"))):
        for name in names:
            assert getattr(tmod, name) is getattr(tcnn, name)
            assert dataclasses.asdict(getattr(tmod, name)) == \
                dataclasses.asdict(getattr(jmod, name))
