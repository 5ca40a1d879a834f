"""Parity of the port's CNN layers and models with the JAX package, on the
CPU. Inputs come from numpy seeds; weights are the reference's, carried
across with ``repro_torch.convert``. Tolerance: rtol = atol = 1e-5 (f32
convolutions summed in another order)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as jl
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg

from repro_torch.convert import to_numpy, to_torch
from repro_torch.models import layers as tl
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import ParamFactory, param_count, tree_leaves

TOL = dict(rtol=1e-5, atol=1e-5)


def _np_tree_close(a, b):
    la = jax.tree.leaves(a)
    lb = tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_allclose(np.asarray(y.detach()), np.asarray(x), **TOL)


@pytest.mark.parametrize("stride,k,size", [(1, 3, 8), (2, 3, 8), (2, 1, 8),
                                           (2, 3, 7), (1, 3, 5)])
def test_conv2d_same_padding_matches_reference(stride, k, size):
    rng = np.random.RandomState(0)
    x = rng.randn(2, size, size, 4).astype(np.float32)
    w = rng.randn(k, k, 4, 6).astype(np.float32)
    b = rng.randn(6).astype(np.float32)
    for p in ({"w": w}, {"w": w, "b": b}):
        want = jl.conv2d({n: jnp.asarray(v) for n, v in p.items()},
                         jnp.asarray(x), stride=stride)
        got = tl.conv2d(to_torch(p), torch.as_tensor(x), stride=stride)
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_reference(train):
    rng = np.random.RandomState(1)
    x = (rng.randn(4, 5, 5, 3) * 2 + 1).astype(np.float32)
    p = {"scale": rng.rand(3).astype(np.float32) + 0.5,
         "bias": rng.randn(3).astype(np.float32)}
    s = {"mean": rng.randn(3).astype(np.float32),
         "var": rng.rand(3).astype(np.float32) + 0.5}
    y_j, s_j = jl.batchnorm(jax.tree.map(jnp.asarray, p),
                            jax.tree.map(jnp.asarray, s), jnp.asarray(x),
                            train=train, momentum=0.6)
    y_t, s_t = tl.batchnorm(to_torch(p), to_torch(s), torch.as_tensor(x),
                            train=train, momentum=0.6)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    for key in ("mean", "var"):  # running update, biased batch variance
        np.testing.assert_allclose(s_t[key].numpy(), np.asarray(s_j[key]),
                                   **TOL)


CFGS = {
    "resnet": dict(name="rn", kind="resnet", stage_sizes=(1, 1),
                   stage_channels=(8, 16), num_classes=5),
    "vgg": dict(name="vg", kind="vgg", stage_sizes=(1, 1),
                stage_channels=(8, 16), num_classes=5),
}


@pytest.mark.parametrize("kind", sorted(CFGS))
@pytest.mark.parametrize("train", [True, False])
def test_cnn_apply_matches_reference(kind, train):
    jm = JCNN(JCfg(**CFGS[kind]))
    tm = TCNN(TCfg(**CFGS[kind]), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    x = np.random.RandomState(2).randn(3, 16, 16, 3).astype(np.float32)
    logits_j, st_j = jm.apply(params, state, jnp.asarray(x), train=train)
    logits_t, st_t = tm.apply(to_torch(params), to_torch(state),
                              torch.as_tensor(x), train=train)
    np.testing.assert_allclose(logits_t.numpy(), np.asarray(logits_j), **TOL)
    _np_tree_close(st_j, st_t)


@pytest.mark.parametrize("kind", sorted(CFGS))
def test_cnn_init_layout_matches_reference(kind):
    """Same tree, same shapes and leaf order (HWIO conv weights), and the
    conv init's scale: std 1.414 / sqrt(k * k * c_in)."""
    jp, js = JCNN(JCfg(**CFGS[kind])).init(jax.random.PRNGKey(0))
    tp, ts = TCNN(TCfg(**CFGS[kind]), device="cpu").init(
        torch.Generator().manual_seed(0))
    for a, b in ((jp, tp), (js, ts)):
        assert ([np.shape(x) for x in jax.tree.leaves(a)]
                == [tuple(x.shape) for x in tree_leaves(b)])
        assert jax.tree.structure(a) == jax.tree.structure(to_numpy(b))
    assert param_count(tp) == sum(np.size(x) for x in jax.tree.leaves(jp))
    w = ParamFactory(torch.Generator().manual_seed(3)).param(
        (3, 3, 64, 64), fan_in=3 * 3 * 64, scale=1.414)
    np.testing.assert_allclose(float(w.std()), 1.414 / np.sqrt(576), rtol=0.02)


def test_convert_round_trip_is_exact():
    params, state = JCNN(JCfg(**CFGS["resnet"])).init(jax.random.PRNGKey(4))
    back = to_numpy(to_torch(params))
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the refusal is for machines without it")
    with pytest.raises(RuntimeError, match="cuda"):
        TCNN(TCfg(**CFGS["resnet"]))


def test_dense_matches_reference():
    rng = np.random.RandomState(5)
    x = rng.randn(4, 6).astype(np.float32)
    p = {"w": rng.randn(6, 3).astype(np.float32),
         "b": rng.randn(3).astype(np.float32)}
    want = jl.dense(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tl.dense(to_torch(p), torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", ["sgd", "momentum"])
def test_optimizers_match_reference(name):
    """Three clipped steps of each optimizer on the same gradients: the
    clip's global norm and the updated params agree to f32 rounding."""
    from repro import optim as jopt
    from repro_torch import optim as topt

    rng = np.random.RandomState(6)
    params = {"a": rng.randn(5).astype(np.float32),
              "b": {"c": rng.randn(3, 2).astype(np.float32)}}
    jo, to = getattr(jopt, name)(0.1), getattr(topt, name)(0.1)
    jp, tp = jax.tree.map(jnp.asarray, params), to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    for step in range(3):
        g = jax.tree.map(lambda x: (4 * rng.randn(*x.shape)).astype(np.float32),
                         params)
        jg, jn = jopt.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 1.0)
        tg, tn = topt.clip_by_global_norm(to_torch(g), 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        ju, js = jo.update(jg, js, jp)
        tu, ts = to.update(tg, ts, tp)
        jp, tp = jopt.apply_updates(jp, ju), topt.apply_updates(tp, tu)
        _np_tree_close(jp, tp)
    assert ts["step"] == int(js["step"]) == 3
