"""The port's population-scale selector (``core/selector/vectorized.py``)
against the JAX package's ``VectorizedSelector`` and the port's list
selector, on the CPU, over the reference's own selection cases
(``tests/test_vectorized_selector.py``).

At ``epsilon = 0`` every case's picks equal the reference's and the list
selector's exactly. At ``epsilon > 0`` the port draws ``jax.random.gumbel``'s
stream (bits equal, noise within 2e-6 absolute, the two ``log``s'
rounding), so its picks equal the reference's on the reference's
200-client, 5-community fleet. The vectorized time kernels equal the
reference's bit for bit, and a selector's state crosses packages both
ways."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.selector import ClientInfo as JInfo
from repro.core.selector import ClientPopulation as JPopulation
from repro.core.selector import VectorizedSelector as JSelector
from repro.core.selector.similarity import similarity_matrix as j_similarity
from repro.core import time_model as jtm
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.client import fleet_population as j_fleet_population

from repro_torch.core import time_model as ttm
from repro_torch.core.selector import (ClientInfo, ClientPopulation,
                                       InfeasibleStageError,
                                       ParticipantSelector,
                                       VectorizedSelector,
                                       population_from_selector)
from repro_torch.core.selector import _threefry
from repro_torch.core.selector.vectorized import assign_cache_tiers
from repro_torch.fl.client import fleet_population, make_client_fleet

CPU = "cpu"


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread, as the other parity files run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fleet(n=40, seed=0):
    rng = np.random.RandomState(seed)
    return {i: ClientInfo(i, memory_bytes=float(rng.choice([1, 2, 4, 8])) * 2**30,
                          capability=float(rng.choice([1e9, 2.5e9])),
                          num_samples=int(rng.randint(10, 200)),
                          loss_sum=float(rng.rand())) for i in range(n)}


def _j(clients):
    """The same infos as the reference's ``ClientInfo``s, in the same
    dict order."""
    return {c: JInfo(i.client_id, i.memory_bytes, i.capability,
                     i.num_samples, i.loss_sum) for c, i in clients.items()}


def _clustered_sim(n_groups=3, per=6, seed=0):
    rng = np.random.RandomState(seed)
    vecs = {}
    for g in range(n_groups):
        proto = np.zeros(48)
        proto[g * 16:(g + 1) * 16] = 1.0
        for i in range(per):
            vecs[g * per + i] = proto + rng.randn(48) * 0.05
    return j_similarity(vecs), n_groups, per


def _time_fn(c):
    return c.num_samples / c.capability


def _trio(seed, phi=2, eps=0.0, W=None, communities=None):
    """(port vectorized, reference vectorized, port list) selectors."""
    out = (VectorizedSelector(epsilon=eps, seed=seed, phi=phi, device=CPU),
           JSelector(epsilon=eps, seed=seed, phi=phi),
           ParticipantSelector(epsilon=eps, seed=seed, phi=phi))
    for s in out:
        if W is not None:
            s.fit_communities(W)
        if communities is not None:
            s._communities = communities
    return out


def _select_all(trio, clients, k, mem_required):
    tv, jv, ls = trio
    kw = dict(mem_required=mem_required, stage_time_fn=_time_fn)
    return (tv.select(clients, k, **kw), jv.select(_j(clients), k, **kw),
            ls.select(clients, k, **kw))


def _assert_same(picks):
    tv, jv, ls = picks
    assert tv == jv == ls, picks


# ---------------------------------------------------------------------------
# epsilon = 0: port == reference == list selector
# ---------------------------------------------------------------------------


def test_matches_no_communities():
    clients = _fleet()
    trio = _trio(3)
    for _ in range(4):
        for k in (3, 7, 15):
            _assert_same(_select_all(trio, clients, k, 1.5 * 2**30))


def test_matches_when_k_exceeds_eligible():
    clients = {0: ClientInfo(0, 2**33, 1e9, 10, loss_sum=1.0),
               1: ClientInfo(1, 2**33, 1e9, 10, loss_sum=2.0),
               2: ClientInfo(2, 2**33, 1e9, 10, loss_sum=9.0)}
    for k in (3, 5):
        picks = _select_all(_trio(0), clients, k, 0)
        _assert_same(picks)
        assert picks[0] == [0, 1, 2]


def test_matches_with_shuffled_dict_order():
    base = _fleet(20, seed=4)
    order = np.random.RandomState(0).permutation(20)
    clients = {int(i): base[int(i)] for i in order}
    for k in (5, 50):
        _assert_same(_select_all(_trio(2), clients, k, 1.5 * 2**30))


def test_matches_with_communities():
    W, ng, per = _clustered_sim()
    rng = np.random.RandomState(1)
    clients = {i: ClientInfo(i, memory_bytes=2**33, capability=1e9,
                             num_samples=10 + i, loss_sum=float(rng.rand()))
               for i in range(ng * per)}
    trio = _trio(5, phi=1, W=W)
    assert trio[0]._communities == trio[1]._communities == trio[2]._communities
    for _ in range(5):
        for k in (ng, ng + 2, 2 * ng + 1):
            _assert_same(_select_all(trio, clients, k, 0))


def test_matches_under_memory_filter():
    W, ng, per = _clustered_sim(per=5)
    clients = {i: ClientInfo(i, memory_bytes=(2.0 if i % 3 else 0.5) * 2**30,
                             capability=1e9, num_samples=20 + i,
                             loss_sum=float(i % 7))
               for i in range(ng * per)}
    trio = _trio(11, phi=1, W=W)
    for _ in range(4):
        picks = _select_all(trio, clients, 8, 2**30)
        _assert_same(picks)
        assert all(clients[c].memory_bytes >= 2**30 for c in picks[0])


def test_infeasible_raises():
    clients = _fleet()
    with pytest.raises(InfeasibleStageError):
        VectorizedSelector(phi=3, device=CPU).select(
            clients, 4, mem_required=64 * 2**30, stage_time_fn=_time_fn)


def test_single_community_excludes_unassigned_clients():
    clients = {0: ClientInfo(0, 2**33, 1e9, 10, loss_sum=1.0),
               1: ClientInfo(1, 2**33, 1e9, 10, loss_sum=2.0),
               2: ClientInfo(2, 2**33, 1e9, 10, loss_sum=9.0)}
    for k in (1, 2, 3):
        picks = _select_all(_trio(0, phi=1, communities=[[0, 1]]), clients,
                            k, 0)
        _assert_same(picks)
        assert 2 not in picks[0]


def test_infeasible_round_does_not_desync_rng_streams():
    W, ng, per = _clustered_sim(n_groups=4, per=6)
    clients = {i: ClientInfo(i, 2**30, 1e9, 10 + i, loss_sum=float(i % 5))
               for i in range(ng * per)}
    trio = _trio(9, phi=2, W=W)
    for r in range(6):
        if r == 2:
            for s in trio:
                with pytest.raises(Exception) as e:
                    s.select(_j(clients) if s is trio[1] else clients, 4,
                             mem_required=2**40, stage_time_fn=_time_fn)
                assert type(e.value).__name__ == "InfeasibleStageError"
            assert trio[0]._round == trio[1]._round
            continue
        _assert_same(_select_all(trio, clients, 4, 0))


def test_equal_utilities_pick_the_lowest_index():
    """Ties: eight clients of equal utility, with and without communities,
    pick the lowest indices, as ``lax.top_k`` and the list bandit's stable
    sort do. The server's round 0 (every unseen client at 1e3 x |D_i|,
    capabilities in tiers) ties in f32 wherever |D_i| is equal: there the
    port and the reference both pick the lowest-indexed clients of the
    largest shard, where the list selector's f64 utilities still order
    them by capability (the reference's documented f32 resolution)."""
    clients = {i: ClientInfo(i, 2**33, 1e9, 50, loss_sum=3.0)
               for i in range(8)}
    for comms in (None, [[0, 2, 4, 6], [1, 3, 5, 7]]):
        trio = _trio(4, phi=1, communities=comms)
        for k in (1, 3, 5):
            _assert_same(_select_all(trio, clients, k, 0))
    assert VectorizedSelector(epsilon=0.0, device=CPU).select(
        clients, 3, mem_required=0, stage_time_fn=_time_fn) == [0, 1, 2]
    rng = np.random.RandomState(2)
    round0 = {}
    for i in range(30):
        ns = int(rng.choice([40, 80]))
        round0[i] = ClientInfo(i, 2**33, float(rng.choice([1e9, 2.5e9, 5e9])),
                               ns, loss_sum=1e3 * ns)
    largest = [i for i in range(30) if round0[i].num_samples == 80]
    W, _, _ = _clustered_sim(n_groups=3, per=10)
    for comms_w in (None, W):
        tv, jv, _ = _trio(0, phi=1, W=comms_w)
        for _ in range(3):
            kw = dict(mem_required=0, stage_time_fn=_time_fn)
            got = tv.select(round0, 7, **kw)
            assert got == jv.select(_j(round0), 7, **kw)
            if comms_w is None:
                assert got == largest[:7]


def test_population_roundtrip_and_snapshot():
    clients = _fleet(17)
    pop = ClientPopulation.from_infos(clients, device=CPU)
    jpop = JPopulation.from_infos(_j(clients))
    assert pop.n == 17 and list(pop.client_ids) == sorted(clients)
    assert pop.memory_bytes.dtype == torch.float32
    assert pop.num_samples.dtype == pop.community_id.dtype == torch.int32
    assert pop.last_seen.dtype == torch.int32
    for name in ("memory_bytes", "capability", "num_samples", "loss_sum",
                 "community_id", "last_seen", "ef_residual_norm"):
        np.testing.assert_array_equal(getattr(pop, name).numpy(),
                                      np.asarray(getattr(jpop, name)))
    np.testing.assert_array_equal(pop.stage_time().numpy(),
                                  np.asarray(jpop.stage_time()))
    np.testing.assert_array_equal(pop.stage_time(3.5, 1.25).numpy(),
                                  np.asarray(jpop.stage_time(3.5, 1.25)))
    sel = ParticipantSelector()
    pop2 = population_from_selector(sel, clients, device=CPU)
    assert pop2.n_communities == 1
    before = pop2.loss_sum
    pop2.update_loss_sums([0, 3], [5.0, 7.0])
    assert float(pop2.loss_sum[3]) == 7.0 and float(before[3]) != 7.0
    sel._communities = [[0, 1, 2], [5, 6]]
    pop3 = population_from_selector(sel, clients, device=CPU)
    assert pop3.n_communities == 2
    assert pop3.community_id.tolist()[:8] == [0, 0, 0, 2, 2, 1, 1, 2]
    with pytest.raises(TypeError, match="A14"):
        pop.shard(None)


def test_fleet_population_matches_reference():
    rng = np.random.RandomState(0)
    data = {"x": rng.rand(60, 2).astype(np.float32),
            "y": rng.randint(0, 3, 60)}
    parts = [np.arange(i * 10, (i + 1) * 10 - i) for i in range(6)]
    pop = fleet_population(make_client_fleet(data, parts, seed=3),
                           community_id=[0, 1, 0, 1, 2, 2], n_communities=2,
                           device=CPU)
    jpop = j_fleet_population(j_fleet(data, parts, seed=3),
                              community_id=[0, 1, 0, 1, 2, 2],
                              n_communities=2)
    assert pop.n_communities == jpop.n_communities == 2
    np.testing.assert_array_equal(pop.client_ids, jpop.client_ids)
    for name in ("memory_bytes", "capability", "num_samples", "community_id"):
        np.testing.assert_array_equal(getattr(pop, name).numpy(),
                                      np.asarray(getattr(jpop, name)))


def _resident(n=500, n_comm=8, seed=0):
    rng = np.random.RandomState(seed)
    comm = rng.randint(0, n_comm, n)
    infos = {i: ClientInfo(i, 2**33, 1e9, int(rng.randint(16, 64)),
                           float(rng.rand())) for i in range(n)}
    return infos, comm


@pytest.mark.parametrize("eps", [0.0, 0.2])
def test_select_arrays_resident_population(eps):
    infos, comm = _resident()
    n_comm = 8
    pop = ClientPopulation.from_infos(infos, community_id=comm,
                                      n_communities=n_comm, device=CPU)
    jpop = JPopulation.from_infos(_j(infos), community_id=comm,
                                  n_communities=n_comm)
    vs = VectorizedSelector(epsilon=eps, seed=1, device=CPU)
    js = JSelector(epsilon=eps, seed=1)
    for r in range(3):
        sel = vs.select_arrays(pop, n_comm * 2, mem_required=0, round_idx=r)
        jsel = js.select_arrays(jpop, n_comm * 2, mem_required=0, round_idx=r)
        np.testing.assert_array_equal(sel, jsel)
        assert len(sel) == n_comm * 2
        assert len(set(comm[sel])) == n_comm
        assert len(set(sel.tolist())) == len(sel)
    assert vs._round == 0                      # explicit rounds never commit
    np.testing.assert_array_equal(pop.last_seen.numpy(),
                                  np.asarray(jpop.last_seen))
    # implicit rounds commit, and the single-community fast path
    one = ClientPopulation.from_infos(infos, device=CPU)
    jone = JPopulation.from_infos(_j(infos))
    for k in (5, 600):
        np.testing.assert_array_equal(
            vs.select_arrays(one, k, mem_required=0),
            js.select_arrays(jone, k, mem_required=0))
    assert vs._round == js._round == 2


def test_selector_seed_divergence_regression():
    W, ng, per = _clustered_sim(n_groups=4, per=6)
    clients = {i: ClientInfo(i, 2**33, 1e9, 10, loss_sum=1.0)
               for i in range(ng * per)}

    def picks(seed, rounds=6):
        s = VectorizedSelector(epsilon=0.0, seed=seed, phi=1, device=CPU)
        s.fit_communities(W)
        return [s.select(clients, 3, mem_required=0, stage_time_fn=_time_fn)
                for _ in range(rounds)]

    assert picks(0) == picks(0)
    assert picks(0) != picks(1)


def test_gumbel_exploration_matches_reference_and_covers():
    """epsilon > 0 on the reference's 200-client, 5-community fleet: the
    port's picks equal the reference's round for round at 0.2 and 0.5,
    seeds diverge, and every round covers every community."""
    rng = np.random.RandomState(0)
    n, n_comm = 200, 5
    comm = rng.randint(0, n_comm, n)
    infos = {i: ClientInfo(i, 2**33, 1e9, 10, float(rng.rand()))
             for i in range(n)}

    def run(seed, eps, port):
        if port:
            pop = ClientPopulation.from_infos(infos, community_id=comm,
                                              n_communities=n_comm,
                                              device=CPU)
            vs = VectorizedSelector(epsilon=eps, seed=seed, device=CPU)
        else:
            pop = JPopulation.from_infos(_j(infos), community_id=comm,
                                         n_communities=n_comm)
            vs = JSelector(epsilon=eps, seed=seed)
        return [tuple(int(i) for i in vs.select_arrays(
            pop, n_comm, mem_required=0, round_idx=r)) for r in range(4)]

    for eps in (0.2, 0.5):
        a, b = run(0, eps, True), run(1, eps, True)
        assert a == run(0, eps, False) and b == run(1, eps, False)
        assert a != b
        for picks in a + b:
            assert len({comm[i] for i in picks}) == n_comm


@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**32 - 1])
def test_gumbel_stream_equals_jax(seed):
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(
        _threefry.random_bits(seed, 1000),
        np.asarray(jax.random.bits(key, (1000,), jnp.uint32)))
    np.testing.assert_allclose(
        _threefry.gumbel(seed, 1000, CPU).numpy(),
        np.asarray(jax.random.gumbel(key, (1000,), jnp.float32)),
        rtol=0, atol=2e-6)


def test_cache_admission_matches_reference():
    """``tests/test_quant.py:test_vectorized_tier_admission_matches_host``'s
    scenario: the tiny ResNet's stage-1 requirement, six clients whose
    memories scatter over every admission outcome; the port's tiers equal
    the reference's and the port server's host ladder."""
    import dataclasses
    from repro.core.memory_model import (
        cnn_feature_cache_bytes as j_cache_bytes)
    from repro.core.selector.vectorized import assign_cache_tiers as j_assign
    from repro.data.partition import dirichlet_partition as j_dirichlet
    from repro.data.synthetic import SyntheticVision as JVision
    from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg
    from repro_torch.core.memory_model import (CACHE_TIER_DTYPES, CACHE_TIERS,
                                               cnn_feature_cache_bytes,
                                               cnn_stage_memory_bytes)
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import SyntheticVision
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.models.cnn import CNN, CNNConfig
    cfg = dict(name="tiny_resnet", kind="resnet", stage_sizes=(1, 1),
               stage_channels=(8, 16), num_classes=4)

    def fleet(vision, dirichlet, make):
        train = vision(num_classes=4, image_size=16, seed=0).sample(600,
                                                                    seed=1)
        parts = dirichlet(train["y"], 6, alpha=1.0, seed=0)
        return [dataclasses.replace(c) for c in
                make(train, parts, scenario="low", seed=0)]

    model, jmodel = CNN(CNNConfig(**cfg), device=CPU), JCNN(JCfg(**cfg))
    clients = fleet(SyntheticVision, dirichlet_partition, make_client_fleet)
    jclients = fleet(JVision, j_dirichlet, j_fleet)
    rng = np.random.RandomState(3)
    base = cnn_stage_memory_bytes(model, 1, 32, 16)
    for c, jc in zip(clients, jclients):
        c.memory_bytes = jc.memory_bytes = (
            base + float(rng.rand()) * 2.5
            * cnn_feature_cache_bytes(model, 1, c.num_samples, 16, "float32")
            - float(rng.rand() < 0.25) * base)
    rates = [cnn_feature_cache_bytes(model, 1, 1, 16, CACHE_TIER_DTYPES[t])
             for t in CACHE_TIERS]
    assert rates == [j_cache_bytes(jmodel, 1, 1, 16, CACHE_TIER_DTYPES[t])
                     for t in CACHE_TIERS]
    pop = fleet_population(clients, device=CPU)
    jpop = j_fleet_population(jclients)
    idx = assign_cache_tiers(pop, base, rates)
    np.testing.assert_array_equal(idx, j_assign(jpop, base, rates))
    plan = VectorizedSelector(device=CPU).cache_admission(
        pop, stage_bytes=base, per_sample_bytes=rates, tiers=CACHE_TIERS)
    assert plan == JSelector().cache_admission(
        jpop, stage_bytes=base, per_sample_bytes=rates, tiers=CACHE_TIERS)
    host = SmartFreezeServer(model, clients, cache_tiers="all",
                             device=CPU)._cache_plan(1)
    assert plan == host
    assert set(host.values()) >= {"f32", None}


def test_time_kernels_equal_reference_bitwise():
    rng = np.random.RandomState(0)
    n = 20_000
    ns = rng.randint(32, 512, n).astype(np.int32)
    cap = rng.choice([0.3e9, 1e9, 2.5e9, 5e9, 10e9], n).astype(np.float32)
    fps = (rng.rand(n) * 1e6).astype(np.float32)
    for f, r in ((1.0, 1.0), (3.7, 1.3)):
        np.testing.assert_array_equal(
            ttm.stage_times_vec(f, torch.from_numpy(ns),
                                torch.from_numpy(cap), r).numpy(),
            np.asarray(jtm.stage_times_vec(f, ns, cap, r)))
        np.testing.assert_array_equal(
            ttm.stage_times(f, ns, cap, r),
            np.asarray(jtm.stage_times_vec(f, ns, cap, r)))
    np.testing.assert_array_equal(
        ttm.stage_times_vec(torch.from_numpy(fps), torch.from_numpy(ns),
                            torch.from_numpy(cap)).numpy(),
        np.asarray(jtm.stage_times_vec(fps, ns, cap)))
    rate = rng.choice([1e6, 2.5e6, 8e6, np.inf], n).astype(np.float32)
    up = ttm.uplink_times_vec(123_457, torch.from_numpy(rate)).numpy()
    np.testing.assert_array_equal(
        up, np.asarray(jtm.uplink_times_vec(jnp.float32(123_457), rate)))
    np.testing.assert_array_equal(ttm.uplink_times(123_457, rate), up)
    comp = rng.rand(n).astype(np.float32)
    jit = jtm.completion_jitter(n, 3, 2, 0.3)
    want = np.asarray(jtm.completion_times_vec(comp, up, jit))
    np.testing.assert_array_equal(
        ttm.completion_times_vec(torch.from_numpy(comp), torch.from_numpy(up),
                                 torch.from_numpy(jit)).numpy(), want)
    np.testing.assert_array_equal(ttm.completion_times(comp, up, jit), want)


def test_state_dict_crosses_packages_both_ways():
    """A selector saved by either package restores in the other and
    continues with equal picks (``fl/sim.py`` serializes through
    ``state_dict``)."""
    from repro.fl.sim import selector_state_tree as j_tree
    from repro_torch.fl.sim import load_selector_state, selector_state_tree
    W, ng, per = _clustered_sim(n_groups=4, per=6)
    rng = np.random.RandomState(3)
    clients = {i: ClientInfo(i, 2**33, 1e9, 10 + i, float(rng.rand()))
               for i in range(ng * per)}
    kw = dict(mem_required=0, stage_time_fn=_time_fn)
    tv, jv, _ = _trio(6, phi=1, eps=0.2, W=W)
    for _ in range(3):
        assert tv.select(clients, 5, **kw) == jv.select(_j(clients), 5, **kw)
    t_state, j_state = selector_state_tree(tv), j_tree(jv)
    assert sorted(t_state) == sorted(j_state) == ["comm_flat",
                                                   "comm_offsets", "round"]
    for key in t_state:
        np.testing.assert_array_equal(t_state[key], j_state[key])
    t_from_j = VectorizedSelector(epsilon=0.2, seed=6, phi=1, device=CPU)
    load_selector_state(t_from_j, {k: np.asarray(v)
                                   for k, v in j_state.items()})
    j_from_t = JSelector(epsilon=0.2, seed=6, phi=1)
    j_from_t.load_state_dict(t_state)
    assert t_from_j._communities == jv._communities
    for _ in range(3):
        want = jv.select(_j(clients), 5, **kw)
        assert t_from_j.select(clients, 5, **kw) == want
        assert j_from_t.select(_j(clients), 5, **kw) == want
        assert tv.select(clients, 5, **kw) == want
