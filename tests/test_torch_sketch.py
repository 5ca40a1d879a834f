"""The port's population-scale community path (``core/selector/
similarity.py`` sketches and top-m neighbors, ``core/selector/rlcd.py``
label propagation and centroid merge) against the JAX package's, on the
CPU, with the reference's planted cases (``tests/test_vectorized_selector
.py``).

Tolerances: projections equal; sketches rtol 1e-6 (atol 1e-7 for entries
that cancel to near zero: f32 products summed in another order);
neighbor indices equal and weights rtol 1e-6 (atol 1e-7 for cosines
near zero, the same f32 rounding); labels equal;
output-layer gradients within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.selector import label_propagation as j_lpa
from repro.core.selector import louvain as j_louvain
from repro.core.selector import output_layer_gradient as j_olg
from repro.core.selector import sketch_communities as j_communities
from repro.core.selector import similarity_matrix as j_similarity
from repro.core.selector import topm_neighbors as j_topm
from repro.core.selector.similarity import label_sketches as j_sketches
from repro.core.selector.similarity import sketch_projection as j_projection

from repro_torch.core.selector import (label_propagation, label_sketches,
                                       output_layer_gradient,
                                       sketch_communities, sketch_projection,
                                       topm_neighbors)

CPU = "cpu"
W_TOL = dict(rtol=1e-6, atol=1e-7)


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the other parity files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planted_histograms(n_groups=4, per=5, num_classes=16, seed=0):
    rng = np.random.RandomState(seed)
    hist = np.zeros((n_groups * per, num_classes))
    for i in range(n_groups * per):
        g = i // per
        hist[i, g * 2] = 50 + rng.randint(0, 10)
        hist[i, g * 2 + 1] = 30
    hist += rng.rand(*hist.shape)
    return hist


def _separation_histograms():
    rng = np.random.RandomState(3)
    n = 60
    hist = np.zeros((n, 8))
    grp = np.arange(n) // 30
    for i in range(n):
        hist[i, 0] = 30
        hist[i, 1 + grp[i] * 2] = 60 + rng.randint(0, 10)
    return hist, grp


@pytest.mark.parametrize("classes,dim,seed", [(16, 128, 0), (100, 64, 3),
                                              (10, 8, 1)])
def test_sketch_projection_and_sketches_match(classes, dim, seed):
    proj = sketch_projection(classes, dim, seed)
    np.testing.assert_array_equal(proj, j_projection(classes, dim, seed))
    rng = np.random.RandomState(seed)
    hist = rng.randint(0, 50, size=(300, classes)).astype(np.float64)
    hist[7] = 0                                  # an empty client
    got = label_sketches(hist, proj, device=CPU)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), np.asarray(j_sketches(hist, proj)),
                               **W_TOL)


@pytest.mark.parametrize("n,d,m,block", [(50, 16, 5, 7), (200, 32, 8, 64),
                                         (31, 4, 30, 5)])
def test_topm_neighbors_match_and_tile(n, d, m, block):
    vecs = np.random.RandomState(n).randn(n, d).astype(np.float32)
    nb, w = topm_neighbors(vecs, m, block_rows=block, device=CPU)
    jnb, jw = j_topm(vecs, m, block_rows=block)
    assert nb.dtype == torch.int32 and w.dtype == torch.float32
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **W_TOL)
    nb1, w1 = topm_neighbors(vecs, m, block_rows=n, device=CPU)
    np.testing.assert_array_equal(nb.numpy(), nb1.numpy())
    np.testing.assert_allclose(w.numpy(), w1.numpy(), **W_TOL)
    # the tile ceiling shrinks the block, with the same result
    nb2, w2 = topm_neighbors(vecs, m, max_tile_bytes=4 * n * 3, device=CPU)
    np.testing.assert_array_equal(nb.numpy(), nb2.numpy())
    np.testing.assert_allclose(w.numpy(), w2.numpy(), **W_TOL)


def test_topm_ties_resolve_to_the_lowest_index():
    """Duplicate rows give equal cosines: like ``lax.top_k``, the top-m
    keeps the lowest-indexed of equal columns, within the kept set and at
    the boundary, and lists them in ascending order."""
    rng = np.random.RandomState(0)
    protos = rng.randn(3, 8).astype(np.float32)
    vecs = protos[np.asarray([0, 1, 0, 2, 0, 1, 0, 0, 2, 0, 1, 0])]
    for m in (2, 3, 5, 7):
        for block in (12, 5):
            nb, w = topm_neighbors(vecs, m, block_rows=block, device=CPU)
            jnb, jw = j_topm(vecs, m, block_rows=block)
            np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
            np.testing.assert_allclose(w.numpy(), np.asarray(jw),
                                       **W_TOL)
    nb, _ = topm_neighbors(vecs, 3, device=CPU)
    # row 0's duplicates are rows 2, 4, 6, 7, 9, 11: the lowest three win
    assert nb[0].tolist() == [2, 4, 6]
    assert nb[4].tolist() == [0, 2, 6]


def test_topm_accepts_device_tensors():
    vecs = torch.from_numpy(np.random.RandomState(1).randn(40, 6)
                            .astype(np.float32))
    nb, w = topm_neighbors(vecs, 4, block_rows=9)
    jnb, jw = j_topm(vecs.numpy(), 4, block_rows=9)
    assert nb.device == vecs.device
    np.testing.assert_array_equal(nb.numpy(), np.asarray(jnb))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), **W_TOL)


@pytest.mark.parametrize("case", ["planted", "separation"])
def test_label_propagation_matches_reference(case):
    if case == "planted":
        hist, dim, m = _planted_histograms(), 128, 4
    else:
        hist, dim, m = _separation_histograms()[0], 64, 6
    proj = j_projection(hist.shape[1], dim, 0)
    jnb, jw = j_topm(j_sketches(hist, proj), m)
    want = j_lpa(jnb, jw)
    # the reference's own neighbor graph, so only the sweeps are compared
    got = label_propagation(torch.from_numpy(np.array(jnb)),
                            torch.from_numpy(np.array(jw)))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and got.min() == 0
    # n_iter and tol reach the sweeps
    np.testing.assert_array_equal(
        label_propagation(np.asarray(jnb), np.asarray(jw), n_iter=2,
                          tol=0.2, device=CPU),
        j_lpa(jnb, jw, n_iter=2, tol=0.2))


def test_sketch_communities_planted_and_separation():
    hist = _planted_histograms()
    labels, n_comm = sketch_communities(hist, sketch_dim=128,
                                        num_neighbors=4, seed=0, device=CPU)
    j_labels, j_n = j_communities(hist, sketch_dim=128, num_neighbors=4,
                                  seed=0)
    assert n_comm == j_n == 4
    np.testing.assert_array_equal(labels, j_labels)
    W = j_similarity({i: hist[i] for i in range(len(hist))})
    oracle = j_louvain(np.maximum(W, 0))
    got = [sorted(np.flatnonzero(labels == c).tolist()) for c in range(n_comm)]
    assert sorted(got) == sorted(sorted(c) for c in oracle)
    hist, grp = _separation_histograms()
    labels, n_comm = sketch_communities(hist, sketch_dim=64, num_neighbors=6,
                                        seed=0, device=CPU)
    np.testing.assert_array_equal(
        labels, j_communities(hist, sketch_dim=64, num_neighbors=6,
                              seed=0)[0])
    assert n_comm == 2
    for g in (0, 1):
        assert len(set(labels[grp == g])) == 1


def test_vectorized_selector_fits_sketch_communities():
    from repro.core.selector import VectorizedSelector as JSelector
    from repro_torch.core.selector import VectorizedSelector
    hist = _planted_histograms(n_groups=3, per=6)
    got = VectorizedSelector(seed=2, device=CPU).fit_communities_sketch(
        hist, sketch_dim=32, num_neighbors=3)
    js = JSelector(seed=2)
    np.testing.assert_array_equal(
        got, js.fit_communities_sketch(hist, sketch_dim=32, num_neighbors=3))


def test_output_layer_gradient_matches_reference():
    """A small softmax head [12 -> 5] on a batch of 16: the loss's gradient
    over the head's leaves (bias, then weight: sorted keys), flattened."""
    rng = np.random.RandomState(0)
    w = rng.randn(12, 5).astype(np.float32) * 0.3
    b = rng.randn(5).astype(np.float32) * 0.1
    x = rng.randn(16, 12).astype(np.float32)
    y = rng.randint(0, 5, 16)

    def j_loss(p, data):
        xs, ys = data
        logp = jax.nn.log_softmax(xs @ p["w"] + p["b"])
        return -jnp.mean(jnp.take_along_axis(logp, ys[:, None], 1))

    def t_loss(p, data):
        xs, ys = data
        return torch.nn.functional.cross_entropy(xs @ p["w"] + p["b"], ys)

    want = j_olg(j_loss, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                 (jnp.asarray(x), jnp.asarray(y)))
    got = output_layer_gradient(
        t_loss, {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
        (torch.from_numpy(x), torch.from_numpy(y).long()))
    assert got.dtype == np.float32 and got.shape == (5 + 60,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # a leaf the loss never reads gives zeros, as jax.grad does
    got = output_layer_gradient(
        lambda p, d: t_loss(p, d),
        {"w": torch.from_numpy(w), "b": torch.from_numpy(b),
         "z": torch.ones(3)},
        (torch.from_numpy(x), torch.from_numpy(y).long()))
    np.testing.assert_array_equal(got[-3:], 0.0)
