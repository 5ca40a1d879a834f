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

    j_sim = jsrv.bootstrap_similarity(params, state)
    np.testing.assert_allclose(tsrv.bootstrap_similarity(tparams, tstate),
                               j_sim, rtol=1e-4, atol=1e-5)
    monkeypatch.setattr(tsrv, "bootstrap_similarity", lambda p, s: j_sim)

    j_ops = {s: jfz.init_cnn_stage_active(jm, params, s,
                                          jax.random.PRNGKey(SRV["seed"] + s)
                                          )[1].get("op") for s in range(2)}
    port_init = tfz.init_cnn_stage_active

    def init_with_reference_op(model, p, stage, generator, **kw):
        frozen, active = port_init(model, p, stage, generator, **kw)
        if "op" in active:
            active["op"] = to_torch(j_ops[stage])
        return frozen, active

    monkeypatch.setattr(tfz, "init_cnn_stage_active", init_with_reference_op)

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


@pytest.mark.parametrize("kwargs", [dict(mesh=None), dict(faults=None),
                                    dict(screen_updates=True),
                                    dict(aggregator="mean"),
                                    dict(freeze_rollback=True),
                                    dict(compute_dtype="bfloat16"),
                                    dict(cache_tiers="all"),
                                    dict(deadline_factor=2.0),
                                    dict(availability=None),
                                    dict(use_pallas=True)])
def test_unported_server_arguments_raise(kwargs):
    tt, tp = _data(TVision, t_dirichlet)
    with pytest.raises(TypeError):
        TServer(TCNN(TCfg(**CFG), device="cpu"),
                t_fleet(tt, tp, scenario="low", seed=0), device="cpu",
                **kwargs)


def test_unported_policies_and_run_arguments_raise():
    tt, tp = _data(TVision, t_dirichlet)
    fleet = t_fleet(tt, tp, scenario="low", seed=0)
    model = TCNN(TCfg(**CFG), device="cpu")
    for policy in ("deadline", "async"):
        with pytest.raises(ValueError, match="not ported"):
            TServer(model, fleet, device="cpu", aggregation=policy)
    srv = TServer(model, fleet, device="cpu")
    for kw in (dict(ckpt_manager=None), dict(resume=True)):
        with pytest.raises(TypeError):
            srv.run({}, {}, **kw)


def test_port_imports_without_jax_or_reference():
    """Every module of the port imports with JAX and the JAX package
    blocked, the LM, serving, hybrid and B3 slices' modules among them, and
    registering the ported configs pulls in nothing of either;
    chip_smoke.py imports neither."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['repro'] = None\n"
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
            "'repro_torch.kernels.block_perturb', 'repro_torch.core.pace'):\n"
            "    assert n in names, n\n"
            "from repro_torch import configs\n"
            "assert configs.names() == ['deepseek-coder-33b', 'llama3-8b', "
            "'qwen2-72b', 'zamba2-7b']\n"
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
    assert not any(m.split(".")[0] in ("jax", "repro") for m in imported)
