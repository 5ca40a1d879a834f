"""End-to-end progressive federated LM training (counterpart of
``repro/launch/train.py``).

Runs SmartFreeze on a dense (GQA or MLA: MiniCPM3), MoE (grok-1 with GQA,
deepseek-v2 with MLA; the MoE FFN's load-balancing aux loss enters every
stage loss at 0.01), hybrid (Zamba2), xLSTM, VLM (InternVL2-2B: ``seq``
counts its 256 patch positions, the loss reads the text after them) or
audio (HuBERT-XLarge, an encoder with full attention over its frames)
``--arch``, with ``make_lm_batch``'s batches: per stage,
build the (frozen, active) split and output module, run federated rounds
(pods are the cross-silo clients) through ``fl/sim.py``'s
``FederatedLoop``, feed the pace controller the aggregated active block
each round, freeze on convergence, merge, grow, repeat.

On the card every full-sequence GQA attention runs the flash kernel
(``kernels/csrc/flash_attention.cu``): the dense and MoE GQA layers, the
hybrid family's shared attention, and the output module's proxy layers,
which are GQA with the arch's head geometry for every family (xLSTM's 4
heads of 256, MiniCPM3's 40 of 64; InternVL2's 16 over 8 kv heads of 128,
causal; HuBERT's 16 heads of 80, non-causal). Every Mamba2 layer's SSD
scan runs the scan kernel (``kernels/csrc/ssm_scan.cu``). MLA, mLSTM and
sLSTM layers and the MoE FFN call no kernel, as in the reference.
``use_pallas`` picks the CPU attention path the reference's
``--use-pallas`` picks, and raises ``SystemExit`` for an MLA arch, as the
reference does. The client mesh (``mesh_clients > 1``; ROADMAP A14) is not
ported and raises ``TypeError``.

Checkpoints (``checkpoint/ckpt.py``, the reference's on-disk format):
with ``ckpt_dir``, every ``ckpt_every`` rounds the merged params, the
active tree with its output module, the pace controller's state and the
data rng stream are saved (and the final params at the end);
``resume=True`` continues mid-stage from the newest committed step, or
with the next stage when that step froze or finished its stage.

On the card the pace controller keeps its window there and takes its
Eq. 2 norms with the block-perturbation kernel
(``kernels/csrc/block_perturb.cu``). The default exact window holds Q+1 =
6 f32 copies of the active block: for full-width Llama-3-8B (a 1.745 B
element block, 42 GB) that does not fit beside a round's transients, and
the first observe raises and asks for ``low_memory=True``, the anchored
window's two copies, which only ``pace_kwargs`` reaches.

Examples (one H100, full width):
  PYTHONPATH=src python -c "from repro_torch.launch.train import train; \\
      train('llama3-8b', reduced=False, steps=8, batch=4, seq=1024, \\
            use_pallas=True, pace_kwargs=dict(low_memory=True))"
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --full --steps 6 --batch 4 --seq 1024 --use-pallas
  PYTHONPATH=src python -m repro_torch.launch.train --arch xlstm-350m \\
      --full --steps 8 --batch 4 --seq 1024 --use-pallas
  PYTHONPATH=src python -c "from repro_torch.launch.train import train; \\
      train('minicpm3-4b', reduced=False, steps=12, batch=4, seq=1024, \\
            pace_kwargs=dict(low_memory=True))"
  PYTHONPATH=src python -m repro_torch.launch.train --arch internvl2-2b \\
      --full --steps 8 --batch 4 --seq 1024 --use-pallas
  PYTHONPATH=src python -m repro_torch.launch.train --arch hubert-xlarge \\
      --full --steps 8 --batch 4 --seq 1024 --use-pallas
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
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import freezing
from repro_torch.core.pace import PaceController
from repro_torch.data.synthetic import make_lm_batch
from repro_torch.fl.sim import (FederatedLoop, pack_rng_state, tree_like,
                                unpack_rng_state)
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
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    rng = np.random.RandomState(seed)
    start_stage, start_in_stage = 0, 0
    restored_pace = restored_active = restored_global = None
    if resume and mgr is not None:
        try:
            ck = mgr.restore()
        except FileNotFoundError:
            ck = None
        if ck is not None:
            meta, tree = ck["metadata"], ck["tree"]
            # legacy checkpoints stored bare params, and no rng state
            params = tree_like(params, tree.get("params", tree))
            if "rng" in tree:
                rng = unpack_rng_state(tree["rng"])
            restored_pace = tree.get("pace")
            restored_active = tree.get("active")  # with the output module
            restored_global = meta.get("global_round")
            start_stage, start_in_stage = meta["stage"], meta["round"] + 1
            if meta.get("frozen"):
                # saved on a pace-freeze round: params carry that stage's
                # merge, so the next stage starts
                start_stage, start_in_stage = start_stage + 1, 0
                restored_pace = restored_active = None
            print(f"resumed from stage {start_stage} round {start_in_stage}")
    history = []
    rounds_per_stage = max(steps // T, 1)
    if start_in_stage >= rounds_per_stage:
        # saved on a stage's last round: the next stage starts
        start_stage, start_in_stage = start_stage + 1, 0
    # the saved global index: stages frozen early ran fewer than
    # rounds_per_stage rounds
    global_round = (restored_global + 1 if restored_global is not None
                    else start_stage * rounds_per_stage + start_in_stage)

    for stage in range(start_stage, T):
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
        r0 = start_in_stage if stage == start_stage else 0
        if r0 and restored_pace is not None:
            pace.load_state_dict(restored_pace)
        if r0 and restored_active is not None:
            # the merged params lack the output module: the whole active
            # tree comes back
            active = tree_like(active, restored_active)
        restored_pace = restored_active = None
        t_stage = time.time()
        box = {"active": active, "stage_round": r0, "t0": 0.0}

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
            if mgr and (rec.round_idx + 1) % ckpt_every == 0:
                merged = freezing.merge_stage_params(model, params, plan,
                                                     _box["active"])
                mgr.save(rec.round_idx,
                         {"params": merged, "active": _box["active"],
                          "pace": _pace.state_dict(),
                          "rng": pack_rng_state(rng)},
                         metadata={"stage": _stage, "round": r,
                                   "global_round": rec.round_idx,
                                   "frozen": bool(freeze),
                                   "compute_dtype": cfg.compute_dtype})
                del merged
            _box["stage_round"] = r + 1
            if freeze:
                print(f"stage {_stage} frozen by pace controller at round {r}")
            return freeze

        loop = FederatedLoop(select_fn=lambda r, avail: avail,
                             train_fn=train_fn,
                             client_ids=list(range(num_pods)),
                             on_round=on_round)
        done = loop.run(rounds_per_stage - r0, start_round=global_round)
        global_round += len(done)
        params = freezing.merge_stage_params(model, params, plan, box["active"])
        # drop the stage's trees before the next one is drawn
        del frozen, active, box, step_fn, loop, train_fn, on_round
        print(f"stage {stage} done in {time.time() - t_stage:.0f}s")
    if mgr:
        mgr.save(global_round, {"params": params,
                                "rng": pack_rng_state(rng)},
                 metadata={"stage": T - 1, "round": rounds_per_stage,
                           "global_round": global_round,
                           "compute_dtype": cfg.compute_dtype})
        mgr.wait()
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
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true")
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
    if losses:
        print(f"finished: {len(losses)} rounds, "
              f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print("finished: nothing left to run (checkpoint already complete)")


if __name__ == "__main__":
    main()
