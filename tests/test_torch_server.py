"""The port's SmartFreeze server against the JAX package's, end to end on
the CPU at a small size: a (1, 1)-stage ResNet, channels (8, 16), 16x16
images, four clients, ``schedule=[2, 2]`` with compressed uplinks at ratio
1.0 (the reference without Pallas).

What cannot be carried bit for bit is carried across explicitly:
  * initial params come from the reference (``repro_torch.convert``);
  * each stage's output module is drawn from ``jax.random`` in the
    reference, so the port's ``init_cnn_stage_active`` is patched here to
    return the reference's output-module params;
  * the Eq. 8 similarity is held allclose, then communities are fitted
    from the reference's matrix, since float noise can flip a community.

Tolerances: per-round losses and final params rtol 1e-3, atol 1e-5 (four
rounds of f32 SGD with convolutions summed in another order); selection,
stages and uplink bytes exactly; host data bitwise."""
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro.core import freezing_cnn as jfz
from repro.data.partition import dirichlet_partition as j_dirichlet
from repro.data.synthetic import SyntheticVision as JVision
from repro.fl.client import batch_index_plan as j_plan
from repro.fl.client import make_client_fleet as j_fleet
from repro.fl.server import SmartFreezeServer as JServer
from repro.models.cnn import CNN as JCNN, CNNConfig as JCfg

import repro_torch.core.freezing_cnn as tfz
from repro_torch.convert import to_numpy, to_torch
from repro_torch.data.partition import dirichlet_partition as t_dirichlet
from repro_torch.data.synthetic import SyntheticVision as TVision
from repro_torch.fl.client import batch_index_plan as t_plan
from repro_torch.fl.client import make_client_fleet as t_fleet
from repro_torch.fl.server import SmartFreezeServer as TServer
from repro_torch.models.cnn import CNN as TCNN, CNNConfig as TCfg
from repro_torch.models.module import tree_leaves

ROOT = os.path.join(os.path.dirname(__file__), "..")
CFG = dict(name="tiny", kind="resnet", stage_sizes=(1, 1),
           stage_channels=(8, 16), num_classes=4)
SRV = dict(clients_per_round=3, batch_size=16, compress_ratio=1.0, seed=0)
TOL = dict(rtol=1e-3, atol=1e-5)


def _data(vision, dirichlet):
    train = vision(num_classes=4, image_size=16, seed=0).sample(256, seed=1)
    return train, dirichlet(train["y"], 4, alpha=1.0, seed=0)


def test_host_data_is_bitwise_equal():
    (jt, jp), (tt, tp) = _data(JVision, j_dirichlet), _data(TVision, t_dirichlet)
    for k in ("x", "y"):
        np.testing.assert_array_equal(jt[k], tt[k])
    assert len(jp) == len(tp)
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(a, b)
    jc = j_fleet(jt, jp, scenario="low", seed=0)
    tc = t_fleet(tt, tp, scenario="low", seed=0)
    for a, b in zip(jc, tc):
        assert (a.client_id, a.memory_bytes, a.capability, a.seed,
                a.link_rate) == (b.client_id, b.memory_bytes, b.capability,
                                 b.seed, b.link_rate)
        np.testing.assert_array_equal(a.data["x"], b.data["x"])
        np.testing.assert_array_equal(a.data["y"], b.data["y"])
        for r in (0, 3):
            for pa, pb in zip(j_plan(a.num_samples, 16, 2, a.round_seed(r)),
                              t_plan(b.num_samples, 16, 2, b.round_seed(r))):
                np.testing.assert_array_equal(pa, pb)


def test_two_stage_trajectory_matches_reference(monkeypatch):
    jt, jp = _data(JVision, j_dirichlet)
    tt, tp = _data(TVision, t_dirichlet)
    jm, tm = JCNN(JCfg(**CFG)), TCNN(TCfg(**CFG), device="cpu")
    params, state = jm.init(jax.random.PRNGKey(0))
    jsrv = JServer(jm, j_fleet(jt, jp, scenario="low", seed=0),
                   use_pallas=False, **SRV)
    tsrv = TServer(tm, t_fleet(tt, tp, scenario="low", seed=0),
                   device="cpu", **SRV)
    tparams, tstate = to_torch(params), to_torch(state)

    np.testing.assert_allclose(tsrv.bootstrap_similarity(tparams, tstate),
                               jsrv.bootstrap_similarity(params, state),
                               rtol=1e-4, atol=1e-5)
    _patch_to_reference(monkeypatch, jsrv, tsrv, jm, params, state,
                        SRV["seed"])

    j_out = jsrv.run(params, state, schedule=[2, 2])
    t_out = tsrv.run(tparams, tstate, schedule=[2, 2])

    assert t_out["rounds"] == j_out["rounds"] == 4
    assert [r.stage for r in t_out["history"]] == [0, 0, 1, 1]
    for jr, tr in zip(j_out["history"], t_out["history"]):
        assert (tr.round_idx, tr.stage, tr.selected, tr.uplink_bytes) == \
            (jr.round_idx, jr.stage, jr.selected, jr.uplink_bytes)
        np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
        np.testing.assert_allclose(tr.perturbation or 0.0,
                                   jr.perturbation or 0.0, rtol=1e-2)
        assert tr.cache_bytes == jr.cache_bytes
        np.testing.assert_allclose(tr.virtual_time, jr.virtual_time,
                                   rtol=1e-6)
    for a, b in zip(jax.tree.leaves(j_out["params"]),
                    jax.tree.leaves(to_numpy(t_out["params"]))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)
    for a, b in zip(jax.tree.leaves(j_out["state"]),
                    jax.tree.leaves(to_numpy(t_out["state"]))):
        np.testing.assert_allclose(b, np.asarray(a), **TOL)


def _patch_to_reference(monkeypatch, jsrv, tsrv, jm, params, state, seed):
    """The port's server takes the reference's Eq. 8 similarity and each
    stage's output module (``test_two_stage_trajectory_matches_reference``)."""
    j_sim = jsrv.bootstrap_similarity(params, state)
    monkeypatch.setattr(tsrv, "bootstrap_similarity", lambda p, s: j_sim)
    j_ops = {s: jfz.init_cnn_stage_active(jm, params, s,
                                          jax.random.PRNGKey(seed + s)
                                          )[1].get("op") for s in range(2)}
    port_init = tfz.init_cnn_stage_active

    def init_with_reference_op(model, p, stage, generator, **kw):
        frozen, active = port_init(model, p, stage, generator, **kw)
        if "op" in active:
            active["op"] = to_torch(j_ops[stage])
        return frozen, active

    monkeypatch.setattr(tfz, "init_cnn_stage_active", init_with_reference_op)


@pytest.mark.parametrize("kwargs", [dict(mesh=None), dict(faults=None),
                                    dict(screen_updates=True),
                                    dict(aggregator="mean"),
                                    dict(freeze_rollback=True),
                                    dict(rollback_guard=0.5),
                                    dict(use_pallas=True)])
def test_unported_server_arguments_raise(monkeypatch, kwargs):
    """``mesh`` and ``use_pallas`` are not ported and raise. The defenses'
    arguments are ported: each is accepted, and a one-round run with it
    (sequential, uncompressed: the defenses do not compose with
    ``compress_ratio``) matches the reference's."""
    jt, jp = _data(JVision, j_dirichlet)
    tt, tp = _data(TVision, t_dirichlet)
    if "mesh" in kwargs or "use_pallas" in kwargs:
        with pytest.raises(TypeError):
            TServer(TCNN(TCfg(**CFG), device="cpu"),
                    t_fleet(tt, tp, scenario="low", seed=0), device="cpu",
                    **kwargs)
        return
    srv = dict(SRV, compress_ratio=None, fused=False, **kwargs)
    jm = JCNN(JCfg(**CFG))
    params, state = jm.init(jax.random.PRNGKey(0))
    jsrv = JServer(jm, j_fleet(jt, jp, scenario="low", seed=0),
                   use_pallas=False, **srv)
    tsrv = TServer(TCNN(TCfg(**CFG), device="cpu"),
                   t_fleet(tt, tp, scenario="low", seed=0), device="cpu",
                   **srv)
    _patch_to_reference(monkeypatch, jsrv, tsrv, jm, params, state,
                        SRV["seed"])
    j_out = jsrv.run(params, state, schedule=[1, 0])
    t_out = tsrv.run(to_torch(params), to_torch(state), schedule=[1, 0])
    (jr,), (tr,) = j_out["history"], t_out["history"]
    assert (tr.round_idx, tr.stage, tr.selected, tr.screened,
            tr.rolled_back) == (jr.round_idx, jr.stage, jr.selected,
                                jr.screened, jr.rolled_back)
    np.testing.assert_allclose(tr.loss, jr.loss, **TOL)
    for a, b in zip(jax.tree.leaves((j_out["params"], j_out["state"])),
                    tree_leaves(t_out["params"])
                    + tree_leaves(t_out["state"])):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), **TOL)


def test_unported_policies_and_run_arguments_raise():
    tt, tp = _data(TVision, t_dirichlet)
    fleet = t_fleet(tt, tp, scenario="low", seed=0)
    model = TCNN(TCfg(**CFG), device="cpu")
    with pytest.raises(ValueError, match="choose from .*'async-buffered'.*"
                       "'deadline'.*'sync'"):
        TServer(model, fleet, device="cpu", aggregation="fedbuff")


def test_port_imports_without_jax_or_reference():
    """Every module of the port imports with JAX, the JAX package and
    ml_dtypes blocked, the LM, serving, hybrid, B3, tier, policy, baseline,
    fault, checkpoint, population, MoE and frontend slices' modules among
    them (the schedules, the LM memory model and the VLM and audio
    configs), and
    registering the ported configs pulls in nothing of them; chip_smoke.py
    imports none of them."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
            "sys.modules['ml_dtypes'] = None\n"
            "import pkgutil, importlib, repro_torch\n"
            "names = [m.name for m in pkgutil.walk_packages("
            "repro_torch.__path__, 'repro_torch.')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "for n in ('repro_torch.configs.llama3_8b', "
            "'repro_torch.models.attention', 'repro_torch.models.transformer', "
            "'repro_torch.core.freezing', 'repro_torch.kernels.flash_attention', "
            "'repro_torch.launch.train', 'repro_torch.kernels.decode_attention', "
            "'repro_torch.launch.serve', 'repro_torch.configs.zamba2_7b', "
            "'repro_torch.models.ssm', 'repro_torch.kernels.ssm_scan', "
            "'repro_torch.kernels.block_perturb', 'repro_torch.core.pace', "
            "'repro_torch.fl.quant', 'repro_torch.kernels.dequant_matmul', "
            "'repro_torch.fl.sim', 'repro_torch.fl.engine', "
            "'repro_torch.fl.baselines', 'repro_torch.fl.faults', "
            "'repro_torch.checkpoint', 'repro_torch.checkpoint.ckpt', "
            "'repro_torch.core.selector.vectorized', "
            "'repro_torch.core.selector._threefry', "
            "'repro_torch.core.selector.similarity', "
            "'repro_torch.core.selector.rlcd', 'repro_torch.core.time_model', "
            "'repro_torch.fl.client', 'repro_torch.configs.xlstm_350m', "
            "'repro_torch.configs.minicpm3_4b', 'repro_torch.models.moe', "
            "'repro_torch.configs.grok1_314b', "
            "'repro_torch.configs.deepseek_v2_236b', "
            "'repro_torch.configs.resnet_cifar', "
            "'repro_torch.configs.vgg_cifar', "
            "'repro_torch.configs.internvl2_2b', "
            "'repro_torch.configs.hubert_xlarge', "
            "'repro_torch.optim.schedules', "
            "'repro_torch.core.memory_model'):\n"
            "    assert n in names, n\n"
            "from repro_torch import configs\n"
            "assert configs.names() == ['deepseek-coder-33b', "
            "'deepseek-v2-236b', 'grok-1-314b', 'hubert-xlarge', "
            "'internvl2-2b', 'llama3-8b', 'minicpm3-4b', 'qwen2-72b', "
            "'xlstm-350m', 'zamba2-7b']\n"
            "assert not any(k == 'jax' or k.startswith('jax.') or k == 'repro' "
            "or k.startswith('repro.') for k, v in sys.modules.items() "
            "if v is not None)\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    import ast
    tree = ast.parse(open(os.path.join(ROOT, "chip_smoke.py")).read())
    imported = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                for a in n.names}
    imported |= {n.module for n in ast.walk(tree)
                 if isinstance(n, ast.ImportFrom) and n.module}
    assert not any(m.split(".")[0] in ("jax", "repro", "ml_dtypes")
                   for m in imported)
