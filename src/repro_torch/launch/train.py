"""End-to-end progressive federated LM training (counterpart of
``repro/launch/train.py``).

Runs SmartFreeze on a dense GQA or hybrid (Zamba2) ``--arch``: per stage,
build the (frozen, active) split and output module, run federated rounds
(pods are the cross-silo clients) through ``fl/sim.py``'s
``FederatedLoop``, feed the pace controller the aggregated active block
each round, freeze on convergence, merge, grow, repeat.

On the card every full-sequence attention runs the flash kernel
(``kernels/csrc/flash_attention.cu``) and every Mamba2 layer's SSD scan
the scan kernel (``kernels/csrc/ssm_scan.cu``); ``use_pallas`` picks the
CPU attention path the reference's ``--use-pallas`` picks (the hybrid
family's shared attention is GQA too). Checkpoints (``ckpt_dir``,
``resume``; ROADMAP A11) and the client mesh (``mesh_clients > 1``;
ROADMAP A14) are not ported and raise ``TypeError``.

Examples (one H100, full width):
  PYTHONPATH=src python -m repro_torch.launch.train --arch llama3-8b \\
      --full --steps 8 --batch 4 --seq 1024 --use-pallas
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --full --steps 6 --batch 4 --seq 1024 --use-pallas
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.core import freezing
from repro_torch.core.pace import PaceController
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.fl.sim import FederatedLoop
from repro_torch.models.transformer import build
from repro_torch.optim import sgd


def train(arch: str, *, reduced: bool = True, steps: int = 40, batch: int = 8,
          seq: int = 128, local_steps: int = 1, num_pods: int = 1,
          lr: float = 3e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 20, resume: bool = False, remat: bool = False,
          d_model: int = 0, num_layers: int = 0, log_every: int = 5,
          pace_kwargs: Optional[dict] = None, seed: int = 0,
          compute_dtype: Optional[str] = None, mesh_clients: int = 0,
          use_pallas: bool = False, device="cuda") -> dict:
    """The reference's ``train`` plus ``device``. Returns {"params",
    "history", "config"}; each history entry carries the reference's
    (stage, round, loss, perturbation) and the round's host-clock
    ``seconds`` (training, aggregation and the pace controller)."""
    if ckpt_dir is not None or resume:
        raise TypeError("checkpoints (ckpt_dir, resume) are not ported "
                        "(ROADMAP A11)")
    if mesh_clients and mesh_clients > 1:
        raise TypeError("mesh_clients > 1 is not ported (ROADMAP A14)")
    dev = resolve_device(device)
    cfg = configs.get(arch)
    if reduced:
        over = {}
        if d_model:
            over["d_model"] = d_model
        if num_layers:
            over["num_layers"] = num_layers
        cfg = cfg.reduced(**over)
    if compute_dtype:
        cfg = dataclasses.replace(cfg, compute_dtype=compute_dtype)
    if use_pallas:
        if cfg.attention != "gqa":
            raise SystemExit("--use-pallas: only the GQA attention flavour "
                             f"has a kernel (arch uses {cfg.attention!r})")
        cfg = dataclasses.replace(cfg, attention_impl="pallas")
    model = build(cfg, dev)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    T = cfg.num_freeze_blocks
    rng = np.random.RandomState(seed)
    history = []
    rounds_per_stage = max(steps // T, 1)
    global_round = 0

    for stage in range(T):
        plan = freezing.make_stage_plan(cfg, stage)
        frozen, active = freezing.init_stage_active(
            model, params, plan,
            torch.Generator(device=dev).manual_seed(seed + 100 + stage))
        step_fn = freezing.make_fed_round_step(
            model, plan, sgd(lr), num_pods=num_pods, local_steps=local_steps,
            remat=remat)
        pace = PaceController(**(pace_kwargs or dict(
            min_rounds=max(rounds_per_stage // 2, 3), mu=2,
            slope_lambda=5e-3)))
        t_stage = time.time()
        box = {"active": active, "stage_round": 0, "t0": 0.0}

        def train_fn(cohort, r, _box=box, _step=step_fn, _frozen=frozen):
            _box["t0"] = time.perf_counter()
            data = make_lm_batch(cfg, num_pods * local_steps * batch, seq,
                                 seed=rng.randint(1 << 30))
            fed = {k: torch.as_tensor(v, device=dev).reshape(
                (num_pods, local_steps, batch) + v.shape[1:])
                for k, v in data.items()}
            w = torch.ones((num_pods,), dtype=torch.float32, device=dev)
            _box["active"], metrics = _step(_box["active"], _frozen, fed, w)
            loss = float(metrics["loss"])
            return {pod: loss for pod in cohort}

        def on_round(rec, _box=box, _pace=pace, _stage=stage):
            r = _box["stage_round"]
            loss = next(iter(rec.losses.values())) if rec.losses else float("nan")
            p = _pace.observe(_box["active"]["runs"])
            freeze = _pace.should_freeze()
            history.append({"stage": _stage, "round": r, "loss": loss,
                            "perturbation": p,
                            "seconds": time.perf_counter() - _box["t0"]})
            if r % log_every == 0:
                print(f"stage {_stage} round {r:3d} loss {loss:.4f} "
                      f"P={p if p is None else round(p, 4)}")
            _box["stage_round"] = r + 1
            if freeze:
                print(f"stage {_stage} frozen by pace controller at round {r}")
            return freeze

        loop = FederatedLoop(select_fn=lambda r, avail: avail,
                             train_fn=train_fn,
                             client_ids=list(range(num_pods)),
                             on_round=on_round)
        done = loop.run(rounds_per_stage, start_round=global_round)
        global_round += len(done)
        params = freezing.merge_stage_params(model, params, plan, box["active"])
        # drop the stage's trees before the next one is drawn
        del frozen, active, box, step_fn, loop, train_fn, on_round
        print(f"stage {stage} done in {time.time() - t_stage:.0f}s")
    return {"params": params, "history": history, "config": cfg}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=0)
    ap.add_argument("--num-layers", type=int, default=0)
    ap.add_argument("--local-steps", type=int, default=1)
    ap.add_argument("--pods", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported (ROADMAP A11): raises")
    ap.add_argument("--resume", action="store_true",
                    help="not ported (ROADMAP A11): raises")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--compute-dtype", default=None,
                    help="override the arch's compute dtype "
                         "(bfloat16 / float32)")
    ap.add_argument("--mesh-clients", type=int, default=0,
                    help="not ported above 1 (ROADMAP A14): raises")
    ap.add_argument("--use-pallas", action="store_true",
                    help="on the CPU, run attention through the flash "
                         "kernel's plain version (the card always runs the "
                         "kernel)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    out = train(a.arch, reduced=a.reduced, steps=a.steps, batch=a.batch,
                seq=a.seq, local_steps=a.local_steps, num_pods=a.pods,
                lr=a.lr, ckpt_dir=a.ckpt_dir, resume=a.resume,
                remat=a.remat, d_model=a.d_model, num_layers=a.num_layers,
                compute_dtype=a.compute_dtype, mesh_clients=a.mesh_clients,
                use_pallas=a.use_pallas, device=a.device)
    losses = [h["loss"] for h in out["history"]]
    print(f"finished: {len(losses)} rounds, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")


if __name__ == "__main__":
    main()
