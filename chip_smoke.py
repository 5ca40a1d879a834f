"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. versions, and the card's name and power limit from nvidia-smi;
  2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
     (all nvcc processes started together);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and time kernel, plain version, the
     one-call PyTorch yardstick, and the memory bound;
 3b. hold the block-perturbation reduction (B3), the pace controller's
     Eq. 2 norms, against its plain version: f32, bf16 and mixed operands,
     n from 3 to the Llama-3-8B stage-0 pace block and past 2^31,
     misaligned views, extreme magnitudes, a NaN; equal bits on a rerun;
  4. drive the main path: ``SmartFreezeServer.run`` on full-width ResNet-18
     (4 stages x 2 rounds, 20 clients over 10,000 32x32 SyntheticVision
     samples, 6 clients a round, top-k uplinks at ratio 0.1), with every
     kernel's launch count set to 0 just before and read just after (B1
     and B3: the pace controller's window on the card);
  5. profile one stage-0 and one stage-3 round of that path: device time by
     kernel class and the device's idle share;
  6. check the card's result against the port's CPU path on a small model,
     and the card's pace controller against the CPU path's on the same
     blocks over a pace-decided run;
  7. hold the flash attention kernel (B4) against its plain version at the
     Llama-3-8B training shape and its variants (Zamba2-7B's head dim 112
     and hubert-xlarge's 80 among them), with its times;
  8. drive the LM main path: ``launch/train.py:train`` on full-width
     Llama-3-8B (32 layers, 4 stages x 2 rounds, batch 4 x 1024 tokens),
     with every kernel's launch count set to 0 just before and read just
     after (B4, and B3 in the pace observe);
  9. profile one stage-0 and one stage-3 LM round, the round step and the
     pace observe: device time by kernel class and the idle share;
 10. check the card's LM result against the port's CPU path on a small
     model, and the card's pace controller against the CPU path's;
 11. free the training phases' memory, then hold the flash-decode kernel
     (B6) against its plain version at the Llama-3-8B serving shape, the
     decode_32k cut and its variants (Zamba2-7B's head dim 112 and
     hubert-xlarge's 80 among them), with its times;
 12. drive the serving path: ``launch/serve.py:serve`` on full-width
     Llama-3-8B (batch 8, 960 prompt + 64 generated tokens: 1,024 decode
     steps), with every kernel's launch count set to 0 just before and read
     just after;
 13. time and profile one full-width decode step at length 1,024 and one
     at the decode_32k cut (batch 8 x 32,768 cached tokens): device time
     by kernel class and the device's idle share;
 14. check the card's serving result against the port's CPU path on a
     small model;
 15. hold the SSD scan kernel (B5) against its plain version (the
     sequential recurrence) at Zamba2-7B's training shape, at 4,096 tokens,
     at a ragged length and at the reference sweep's f32 widths, with the
     model's dt and decay distributions; time kernel, plain version and the
     chunked plain form;
 16. drive the hybrid main path: ``launch/train.py:train`` on full-width
     Zamba2-7B (81 layers: 68 Mamba2, 13 shared attention over 2 tied
     sets; 6 stages x 1 round, batch 4 x 1024 tokens), with every kernel's
     launch count set to 0 just before and read just after;
 17. profile one stage-0 and one stage-5 hybrid round;
 18. check the card's hybrid training against the port's CPU path on a
     small model, and the card's anchored pace window against the CPU
     path's;
 19. drive hybrid serving: ``launch/serve.py:serve`` on full-width
     Zamba2-7B (batch 8, 192 prompt + 64 generated tokens: 256 decode
     steps), counts set to 0 before and read after; then time and profile
     one decode step;
 20. check the card's hybrid serving against the port's CPU path on a
     small model.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Without CUDA, or without the
repository beside this file, it fails before printing either.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# the LM phases free and reallocate tens of GB of differently sized trees
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

# H100 SXM published peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 34e12
BF16_FLOPS = 989e12
RATIO = 0.1
COHORT = 6


def _time_ms(fn, reps=20):
    """Device milliseconds per call of ``fn``: CUDA events around ``reps``
    calls, with the card held busy by a sleep kernel while the host
    enqueues them, so host-side wrapper overhead does not count. The
    inputs are warm in L2 (they fit in its 50 MB), as they are when the
    fold follows the top-k that produced them."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _call_ms(fn, reps=20):
    """Host-clock milliseconds per synchronized call, wrapper included."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / reps


def phase_versions():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    return card


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS)
    secs = time.perf_counter() - t0
    for name, log in logs.items():
        print(f"built {name}: {_build.library_path(name).name}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
    print(f"build seconds: {secs:.2f}")


def resnet18_leaf_lengths():
    """Every distinct leaf length the ResNet-18 main path folds: all stages'
    active params, output modules included."""
    import torch
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    model = CNN(RESNET18, device="cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    lengths = set()
    for stage in range(len(RESNET18.stage_sizes)):
        _, active = fz.init_cnn_stage_active(model, params, stage,
                                             torch.Generator().manual_seed(0))
        lengths.update(int(l.numel()) for l in tree_leaves(active))
    return sorted(lengths)


def phase_sparse_agg():
    """Kernel against its plain version at every ResNet-18 leaf length
    (K=6 clients, k = topk_keep(L, 0.1) distinct sorted indices per row, as
    top-k sends them), plus an all-duplicates case and a k=1 case.

    Tolerance: atomics sum in an order that varies run to run, so each
    output may differ from the plain version by a few f32 ulps of the sum
    of |contributions| landing on it: |err| <= 1e-6 * (1 + that sum)."""
    import torch
    from repro_torch.fl.compression import topk_keep
    from repro_torch.kernels import ref, sparse_agg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(f"L={L}", COHORT, topk_keep(L, RATIO), L, False)
             for L in resnet18_leaf_lengths()]
    cases += [("all_duplicates", COHORT, 256, 1000, True),
              ("k=1", COHORT, 1, 10, False)]
    rows, worst = [], 0.0
    for name, K, k, L, dup in cases:
        if dup:
            idx = torch.full((K, k), 7, dtype=torch.int32, device=dev)
        else:
            idx = torch.stack([torch.sort(torch.randperm(
                L, generator=gen, device=dev)[:k]).values
                for _ in range(K)]).to(torch.int32)
        vals = torch.randn(K, k, generator=gen, device=dev)
        w = torch.rand(K, generator=gen, device=dev)
        w = w / w.sum()
        got = sparse_agg.sparse_cohort_add(idx, vals, w, L)
        want = ref.sparse_cohort_add_ref(idx, vals, w, L)
        mag = ref.sparse_cohort_add_ref(idx, vals.abs(), w, L)
        err = (got - want).abs()
        bad = bool((err > 1e-6 * (1.0 + mag)).any())
        max_err = float(err.max())
        worst = max(worst, max_err)
        flat = idx.reshape(-1).long()
        contrib = (w[:, None] * vals).reshape(-1)
        ms = _time_ms(lambda: sparse_agg.sparse_cohort_add(idx, vals, w, L))
        call_ms = _call_ms(lambda: sparse_agg.sparse_cohort_add(idx, vals, w, L))
        plain_ms = _time_ms(lambda: ref.sparse_cohort_add_ref(idx, vals, w, L))
        library_ms = _time_ms(lambda: torch.zeros(L, device=dev).index_add_(
            0, flat, contrib))
        nbytes = K * k * 8 + K * 4 + L * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * K * k / F32_FLOPS) * 1e3
        print(f"sparse_cohort_add {name:>16} K={K} k={k:<7d} max_abs_err="
              f"{max_err:.3e} ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
              f"call_ms={call_ms:.4f}")
        if bad:
            raise AssertionError(f"sparse_cohort_add disagrees with its plain "
                                 f"version at {name}: max_abs_err {max_err}")
        rows.append(dict(L=L, K=K, k=k, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, bound_ms=bound_ms,
                         call_ms=call_ms))
    # the JSON line reports the largest leaf, the stage-3 3x3 512->512 conv
    top = max(rows, key=lambda r: r["L"])
    return {"name": "sparse_cohort_add", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_agg.cu",
            "replaces": "src/repro/kernels/sparse_agg.py:53",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": "bytes", "library_ms": top["library_ms"],
            "call_ms": top["call_ms"],
            "shape": {"K": top["K"], "k": top["k"], "L": top["L"]}}


def _layer_leaves(cfg, kind):
    """One layer of ``kind`` as meta tensors: the shapes ``layer_init``
    gives, with no memory behind them."""
    import torch
    from repro_torch.models.module import ParamFactory, tree_leaves
    from repro_torch.models.transformer import layer_init

    class Meta(ParamFactory):
        def param(self, shape, *, init="normal", scale=1.0, fan_in=None,
                  dtype=None):
            full = ((self.stack,) if self.stack else ()) + tuple(shape)
            return torch.empty(full, dtype=dtype or self.dtype, device="meta")
    return tree_leaves(layer_init(Meta(None, "meta", torch.bfloat16), cfg,
                                  kind))


def _pace_block(cfg, stage):
    """(leaves, elements) of the block the LM path's pace controller
    observes at ``stage``: the active runs' stacked layers (the shared
    attention sets and the output module are not in it)."""
    from repro_torch.core import freezing
    leaves = n = 0
    for region, kind, _, a, b in freezing.make_stage_plan(cfg, stage).runs:
        if region == "active" and kind != "shared_attn":
            layer = _layer_leaves(cfg, kind)
            leaves += len(layer)
            n += (b - a) * sum(l.numel() for l in layer)
    return leaves, n


def _plain_sqnorm(a, b, chunk=1 << 26):
    """The plain version of B3 over chunks of 2^26 elements, summed in f64,
    so that its f32 and f64 temporaries stay under 1 GB at any n."""
    import torch
    from repro_torch.kernels import ref
    parts = [ref.diff_sqnorm_ref(a[i:i + chunk], b[i:i + chunk])
             for i in range(0, a.numel(), chunk)]
    return torch.stack(parts).sum()


# |kernel - plain| <= B3_RTOL |plain|: both square and sum in f64 (the
# differences are the same f32 values), in other orders
B3_RTOL = 1e-12


def phase_block_perturb():
    """Kernel B3 against its plain version (chunked, f64) on the card:
    f32/f32, bf16/bf16 and bf16/f32 operands (the pace controller diffs
    bf16 leaves against f32 snapshots), n from 3 up to the Llama-3-8B
    stage-0 block's length, one bf16 pair past 2^31 elements, views at
    element offsets that are not 16-byte aligned (some never align in
    both), magnitudes 1e-20 and 1e15, and a NaN, which must give NaN. Two
    runs must give equal bits. Times the kernel, the plain version and,
    on f32 pairs, ``torch.dist`` (squared) as the one-call yardstick.
    Bound: each operand read once over 3.35 TB/s, against n f32 subtracts
    at 67 TFLOP/s and 2n f64 operations (the fused multiply-add) at 34."""
    import torch
    from repro_torch import configs
    from repro_torch.kernels import block_perturb as bp
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    _, n0 = _pace_block(configs.get("llama3-8b"), 0)
    print(f"block_perturb: Llama-3-8B stage-0 pace block n={n0}")

    def pair(n, da, db, off_a=0, off_b=0, magnitude=1.0):
        out = []
        for dt, off in ((da, off_a), (db, off_b)):
            t = torch.randn(n + off, generator=gen, device=dev,
                            dtype=getattr(torch, dt))
            out.append(t.mul_(magnitude)[off:])
        return out

    f32, bf16 = "float32", "bfloat16"
    # (name, n, a dtype, b dtype, a offset, b offset, magnitude, timed)
    cases = [("n=3", 3, f32, f32, 0, 0, 1.0, False),
             ("n=4097 bf16", 4097, bf16, bf16, 0, 0, 1.0, False),
             ("n=1e6+3 mixed", 10 ** 6 + 3, bf16, f32, 0, 0, 1.0, False),
             ("1e-20", 10_001, f32, f32, 0, 0, 1e-20, False),
             ("1e15", 10_001, f32, f32, 0, 0, 1e15, False),
             ("1e15 mixed", 4097, bf16, f32, 0, 0, 1e15, False),
             ("views +1/+3", 10 ** 7 + 5, f32, f32, 1, 3, 1.0, False),
             ("views +3/+1 mixed", 10 ** 7 + 5, bf16, f32, 3, 1, 1.0, False),
             ("views +1/+2 mixed", 10 ** 7 + 5, bf16, f32, 1, 2, 1.0, False),
             ("views +1/+0 bf16", 10 ** 7 + 5, bf16, bf16, 1, 0, 1.0, False),
             ("block f32", n0, f32, f32, 0, 0, 1.0, True),
             ("block mixed", n0, bf16, f32, 0, 0, 1.0, True),
             ("block bf16", n0, bf16, bf16, 0, 0, 1.0, True),
             ("n>2^31 bf16", 2 ** 31 + 4099, bf16, bf16, 0, 0, 1.0, True)]
    rows, worst_abs, worst_rel = {}, 0.0, 0.0
    for name, n, da, db, off_a, off_b, mag, timed in cases:
        a, b = pair(n, da, db, off_a, off_b, mag)
        got = bp.diff_sqnorm_f64(a, b)
        again = bp.diff_sqnorm_f64(a, b)
        want = _plain_sqnorm(a, b)
        got, again, want = got.item(), again.item(), want.item()
        err = abs(got - want)
        rel = err / abs(want)
        worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
        aligned = all(t.data_ptr() % 16 == 0 for t in (a, b))
        line = (f"diff_sqnorm {name:>18} n={n} {da}/{db} aligned={aligned} "
                f"sum={got!r} plain={want!r} rel_err={rel:.3e}")
        if timed:
            ms = _time_ms(lambda: bp.diff_sqnorm_f64(a, b), reps=10)
            call_ms = _call_ms(lambda: bp.diff_sqnorm_f64(a, b), reps=5)
            plain_ms = _time_ms(lambda: _plain_sqnorm(a, b), reps=2)
            library_ms = None
            if da == db == f32:
                dist = torch.dist(a, b).item() ** 2
                library_ms = _time_ms(lambda: torch.dist(a, b), reps=5)
                line += f" torch.dist^2={dist!r}"
            nbytes = n * (a.element_size() + b.element_size())
            t_bytes = nbytes / HBM_BYTES_PER_S
            t_ops = n / F32_FLOPS + 2 * n / F64_FLOPS
            bound_ms = max(t_bytes, t_ops) * 1e3
            bound_by = "bytes" if t_bytes >= t_ops else "operations"
            line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
                     f"{library_ms} bound_ms={bound_ms:.4f} ({bound_by}) "
                     f"bound_share={bound_ms / ms:.3f} call_ms={call_ms:.4f}")
            rows[name] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                              bound_ms=bound_ms, bound_by=bound_by,
                              call_ms=call_ms, shape=dict(n=n, a=da, b=db))
        print(line)
        if got != again:
            raise AssertionError(f"diff_sqnorm at {name}: two runs differ "
                                 f"({got!r}, {again!r})")
        if not math.isfinite(want) or not rel <= B3_RTOL:
            raise AssertionError(f"diff_sqnorm disagrees with its plain "
                                 f"version at {name}: {got!r} vs {want!r}")
        del a, b
        torch.cuda.empty_cache()
    a, b = pair(100_003, f32, f32)
    a[54_321] = float("nan")
    got, want = bp.diff_sqnorm_f64(a, b).item(), _plain_sqnorm(a, b).item()
    print(f"diff_sqnorm with a NaN: {got!r} (plain {want!r})")
    if not (math.isnan(got) and math.isnan(want)):
        raise AssertionError("diff_sqnorm does not propagate a NaN")
    top = rows["block f32"]
    return {"name": "diff_sqnorm", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/block_perturb.cu",
            "replaces": "src/repro/kernels/block_perturb.py:39",
            "launches": None, "max_abs_err": worst_abs,
            "max_rel_err": worst_rel, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "call_ms": top["call_ms"], "shape": top["shape"],
            "mixed": rows["block mixed"], "bf16": rows["block bf16"],
            "past_2_31": rows["n>2^31 bf16"]}


def _fleet(n_samples, n_clients, image_size, num_classes, seed=0):
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import SyntheticVision
    from repro_torch.fl.client import make_client_fleet
    sv = SyntheticVision(num_classes=num_classes, image_size=image_size,
                         seed=seed)
    train = sv.sample(n_samples, seed=1)
    parts = dirichlet_partition(train["y"], n_clients, alpha=1.0, seed=0)
    return (make_client_fleet(train, parts, scenario="low", seed=0),
            sv.sample(1000, seed=2))


class _timed_observes:
    """Records the wall ms of every ``PaceController.observe`` inside the
    ``with`` (each ends in the observe's own device sync: the finiteness
    check, and the norms' read-back when it takes them)."""

    def __enter__(self):
        from repro_torch.core import pace
        self.cls = pace.PaceController
        self.observe = observe = self.cls.observe
        ms = []

        def timed(ctl, block):
            t0 = time.perf_counter()
            out = observe(ctl, block)
            ms.append((time.perf_counter() - t0) * 1e3)
            return out
        self.cls.observe = timed
        return ms

    def __exit__(self, *exc):
        self.cls.observe = self.observe


def phase_main_path(card):
    """Full-width ResNet-18 through SmartFreezeServer.run on the card.
    CIFAR-10's 50,000 training images are cut to 10,000 SyntheticVision
    samples; widths, image size and class count are untouched."""
    import torch
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import block_perturb, sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    dev = torch.device("cuda")
    clients, test = _fleet(10_000, 20, 32, 10)
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    srv = SmartFreezeServer(model, clients, clients_per_round=COHORT,
                            batch_size=32, local_epochs=1,
                            compress_ratio=RATIO, seed=0, device="cuda")
    tx = torch.as_tensor(test["x"], device=dev)
    ty = torch.as_tensor(test["y"], device=dev).long()
    marks = []

    def eval_fn(p, s, stage):
        torch.cuda.synchronize()
        t_in = time.perf_counter()
        with torch.no_grad():
            logits = torch.cat([model.apply(p, s, tx[i:i + 500], train=False)[0]
                                for i in range(0, len(tx), 500)])
            acc = float((logits.argmax(-1) == ty).float().mean())
        torch.cuda.synchronize()
        marks.append((t_in, time.perf_counter()))
        return acc

    torch.cuda.reset_peak_memory_stats()
    with _timed_observes() as observe_ms:
        sparse_agg.launches = block_perturb.launches = 0
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = srv.run(params, state, eval_fn=eval_fn, eval_every=1,
                      schedule=[2, 2, 2, 2])
        torch.cuda.synchronize()
        launches = sparse_agg.launches
        b3_launches = block_perturb.launches
    total_s = time.perf_counter() - t_start
    prev_end = t_start
    for rr, (t_in, t_out), o_ms in zip(out["history"], marks, observe_ms):
        wall_ms = (t_in - prev_end) * 1e3
        prev_end = t_out
        print(f"round {rr.round_idx} stage {rr.stage} loss {rr.loss:.4f} "
              f"wall_ms {wall_ms:.1f} pace_observe_ms {o_ms:.2f} "
              f"perturbation {rr.perturbation} uplink_bytes "
              f"{rr.uplink_bytes} test_acc {rr.test_acc:.3f} cohort "
              f"{rr.selected}")
    print("(round 0's wall time includes the Eq. 8 similarity bootstrap; "
          "each stage's first round includes its feature-cache fill)")
    print(f"main path seconds {total_s:.2f} on {card}")
    print(f"torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated()}")

    hist = out["history"]
    assert len(hist) == 8 and [r.stage for r in hist] == [0, 0, 1, 1, 2, 2, 3, 3]
    assert all(math.isfinite(r.loss) for r in hist), [r.loss for r in hist]
    leaves = [l for l in tree_leaves(out["params"]) + tree_leaves(out["state"])]
    assert all(l.device.type == "cuda" for l in leaves)
    assert all(bool(torch.isfinite(l).all()) for l in leaves)
    expected = expected_b3 = 0
    for i, rr in enumerate(hist):
        _, active = fz.init_cnn_stage_active(model, out["params"], rr.stage,
                                             torch.Generator().manual_seed(0))
        plan = srv._cache_plan(rr.stage)
        groups = len({plan.get(c) is not None for c in rr.selected})
        expected += len(tree_leaves(active)) * groups
        # the pace controller's observe of the stage's block: two B3
        # launches a leaf once it holds a previous snapshot
        if i and hist[i - 1].stage == rr.stage:
            expected_b3 += 2 * len(tree_leaves(active.get("stages", active)))
    print(f"sparse_cohort_add launches {launches} (expected {expected}); "
          f"diff_sqnorm launches {b3_launches} (expected {expected_b3})")
    assert launches == expected > 0, (launches, expected)
    assert b3_launches == expected_b3 > 0, (b3_launches, expected_b3)
    return launches, b3_launches


def _kernel_class(name):
    low = name.lower()
    if "sparse_cohort_add" in low:
        return "sparse_cohort_add"
    if "flash_fwd" in low:
        return "flash_attention (B4)"
    if "decode_split" in low or "decode_merge" in low:
        return "decode_attention (B6)"
    if "ssd_scan" in low:
        return "ssd_scan (B5)"
    if "diff_sqnorm" in low:
        return "diff_sqnorm (B3)"
    if "softmax" in low:
        return "softmax"
    if "nvjet" in low or "cublas" in low or "cutlass" in low:
        return "conv / gemm"
    if any(t in low for t in ("index", "gather", "scatter", "embedding")):
        return "indexing"
    if "sort" in low or "radix" in low:
        return "top-k sort"
    if any(t in low for t in ("conv", "cudnn", "gemm", "xmma", "sm90_",
                              "implicit", "winograd", "fft")):
        return "conv / gemm"
    if any(t in low for t in ("reduce", "norm", "welford")):
        return "reductions"
    if "memcpy" in low or "memset" in low:
        return "copies / memset"
    if "direct_copy" in low:
        return "dtype casts"
    return "elementwise / other"


def phase_profile(card):
    """Where a main-path round's time goes, at stage 0 (the most compute)
    and stage 3 (the largest leaves): one warm-up round (cache fill,
    cuDNN algorithm choice), one round timed on the host clock, and one
    under torch.profiler, whose CUDA kernel rows give device time by kernel
    class. The device's idle share is 1 - device time / round wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.models.cnn import CNN, RESNET18
    clients, _ = _fleet(10_000, 20, 32, 10)
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    srv = SmartFreezeServer(model, clients, clients_per_round=COHORT,
                            batch_size=32, compress_ratio=RATIO,
                            device="cuda")
    cohort = list(range(COHORT))
    steps = sum(c.num_samples // 32 for c in clients[:COHORT])
    for stage in (0, 3):
        frozen, active = fz.init_cnn_stage_active(
            model, params, stage, torch.Generator().manual_seed(stage))
        engine = srv._stage_engine(stage, frozen, state)
        use_cache = {c: "f32" for c in cohort} if stage else {}

        def one_round(r):
            engine.run_round(srv.clients, cohort, active, state, r,
                             use_cache=use_cache)
            torch.cuda.synchronize()

        one_round(0)
        t0 = time.perf_counter()
        one_round(1)
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            one_round(2)
        by_class = {}
        for row in prof.key_averages():
            if row.device_type == torch.autograd.DeviceType.CUDA:
                cls = _kernel_class(row.key)
                by_class[cls] = by_class.get(cls, 0.0) + row.self_device_time_total
        busy_ms = sum(by_class.values()) / 1e3
        print(f"profile stage {stage}: {steps} local steps, round wall_ms "
              f"{wall_ms:.1f} on {card}")
        if not by_class:
            print("  torch.profiler recorded no device time: not measured")
            continue
        print(f"  device busy ms {busy_ms:.1f}, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"  {cls:>20}: {us / 1e3:9.2f} ms")


PACE_FIELDS = ("window_q", "smooth_h", "slope_lambda", "mu", "fit_window",
               "min_rounds", "low_memory")
# the card's perturbations against the CPU path's on the same blocks: both
# take the f32 differences, square and sum them in f64, in other orders
PACE_RTOL = 1e-9


class _pace_shadowed:
    """Inside the ``with``, every pace controller that observes a card block
    has a shadow: a controller of the same settings fed the same block
    copied to the host, which takes the CPU path (the numpy window, bit for
    bit the reference). ``should_freeze`` is asked of both. Yields the list
    of (card controller, shadow, [(card flag, shadow flag), ...])."""

    def __enter__(self):
        from repro_torch.core import pace
        from repro_torch.models.module import tree_map
        self.cls = pace.PaceController
        self.saved = (self.cls.observe, self.cls.should_freeze)
        observe, should = self.saved
        pairs, by_id = [], {}

        def shadowed_observe(ctl, block):
            out = observe(ctl, block)
            if id(ctl) not in by_id:
                shadow = self.cls(**{f: getattr(ctl, f) for f in PACE_FIELDS})
                by_id[id(ctl)] = (ctl, shadow, [])
                pairs.append(by_id[id(ctl)])
            observe(by_id[id(ctl)][1],
                    tree_map(lambda leaf: leaf.detach().cpu(), block))
            return out

        def shadowed_should(ctl):
            got = should(ctl)
            if id(ctl) in by_id:
                _, shadow, flags = by_id[id(ctl)]
                flags.append((got, should(shadow)))
            return got

        self.cls.observe = shadowed_observe
        self.cls.should_freeze = shadowed_should
        return pairs

    def __exit__(self, *exc):
        self.cls.observe, self.cls.should_freeze = self.saved


def _check_pace_shadows(pairs, what):
    """Every card controller's window lived on the card, its perturbation
    series is its shadow's (the CPU path's) within PACE_RTOL, and the two
    gave the same freeze flag at every round. Returns the card
    controllers' freeze flags."""
    import numpy as np
    from repro_torch.core import pace
    flags, norms = [], 0
    for card, shadow, pair_flags in pairs:
        assert isinstance(card._win, pace._TensorWindow), type(card._win)
        assert isinstance(shadow._win, pace._HostWindow), type(shadow._win)
        hc, hs = card.history, shadow.history
        assert (hc["rounds"], hc["skipped"]) == (hs["rounds"], hs["skipped"])
        np.testing.assert_allclose(hc["perturbation"], hs["perturbation"],
                                   rtol=PACE_RTOL, atol=0)
        np.testing.assert_allclose(hc["smoothed"], hs["smoothed"],
                                   rtol=PACE_RTOL, atol=0)
        assert all(a == b for a, b in pair_flags), pair_flags
        flags += [a for a, _ in pair_flags]
        norms += len(hc["perturbation"])
        worst = max((abs(a - b) / abs(b) for a, b in zip(
            hc["perturbation"], hs["perturbation"]) if b), default=0.0)
        print(f"  {what}: card pace == CPU pace on {len(pair_flags)} rounds, "
              f"perturbations {['%.6g' % p for p in hc['perturbation']]} "
              f"(max rel diff {worst:.2e}), freeze flags "
              f"{[a for a, _ in pair_flags]}")
    assert norms > 0, "no observe took the Eq. 2 norms"
    return flags


def phase_small_reference():
    """The port on the card against the port on the CPU (itself held
    against the JAX package by tests/test_torch_server.py), on a small
    model: 2 stages x 1 round, ratio 1.0 so top-k keeps every entry and no
    near-tie can flip between devices. Tolerance rtol 1e-3, atol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import sparse_agg
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.models.module import tree_leaves
    cfg = CNNConfig("small", "resnet", stage_sizes=(1, 1),
                    stage_channels=(8, 16), num_classes=4)
    clients, _ = _fleet(256, 4, 16, 4)
    cpu_model = CNN(cfg, device="cpu")
    params, state = cpu_model.init(torch.Generator().manual_seed(0))
    results = {}
    for device in ("cpu", "cuda"):
        model = CNN(cfg, device=device)
        srv = SmartFreezeServer(model, clients, clients_per_round=3,
                                batch_size=16, compress_ratio=1.0, seed=0,
                                device=device)
        before = sparse_agg.launches
        out = srv.run(to_torch(to_numpy(params), device),
                      to_torch(to_numpy(state), device), schedule=[1, 1])
        if device == "cuda":
            assert sparse_agg.launches > before
        results[device] = out
    for a, b in zip(results["cpu"]["history"], results["cuda"]["history"]):
        assert a.selected == b.selected and a.stage == b.stage
        np.testing.assert_allclose(b.loss, a.loss, rtol=1e-3, atol=1e-5)
    for a, b in zip(tree_leaves(results["cpu"]["params"]),
                    tree_leaves(results["cuda"]["params"])):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-5)
    print("small model: card == CPU path (rtol 1e-3, atol 1e-5)")
    # the pace controller deciding: 10 rounds over the 2 stages, the exact
    # window of the default Q = 5, freezes allowed from round 3
    from repro_torch.kernels import block_perturb
    model = CNN(cfg, device="cuda")
    srv = SmartFreezeServer(model, clients, clients_per_round=3,
                            batch_size=16, compress_ratio=1.0, seed=0,
                            device="cuda", pace_kwargs=dict(
                                min_rounds=3, mu=1, slope_lambda=5e-2,
                                fit_window=3))
    before = block_perturb.launches
    with _pace_shadowed() as pairs:
        out = srv.run(to_torch(to_numpy(params), "cuda"),
                      to_torch(to_numpy(state), "cuda"), total_rounds=10)
    assert block_perturb.launches > before
    flags = _check_pace_shadows(pairs, "small CNN")
    stages = [r.stage for r in out["history"]]
    assert [r.frozen for r in out["history"]] == flags
    print(f"small model: pace-decided stages {stages} (card pace == CPU "
          f"pace, rtol {PACE_RTOL})")

# (name, B, S, Hq, Hkv, d, dtype, causal): the first is the LM main path's
# shape (Llama-3-8B, batch 4 x 1024 tokens)
FLASH_CASES = [("main", 4, 1024, 32, 8, 128, "bfloat16", True),
               ("ragged S=1000", 4, 1000, 32, 8, 128, "bfloat16", True),
               ("S=4096 B=1", 1, 4096, 32, 8, 128, "bfloat16", True),
               ("non-causal", 4, 1024, 32, 8, 128, "bfloat16", False),
               ("g=1", 4, 1024, 32, 32, 128, "bfloat16", True),
               ("d=16 f32", 4, 1024, 4, 2, 16, "float32", True),
               # Zamba2-7B's shared attention and proxy layers
               ("d=112 g=1", 4, 1024, 32, 32, 112, "bfloat16", True),
               # hubert-xlarge's encoder: 16 heads of 80, full attention
               ("d=80 hubert", 4, 1024, 16, 16, 80, "bfloat16", False),
               ("d=80 f32", 2, 1000, 16, 4, 80, "float32", True)]
# (rtol, atol) of |err| <= atol + rtol |plain|. bf16: rtol 2^-7, PR 13's,
# is one or two ulps of the output's own magnitude (the kernel carries p as
# two bf16 terms, so both versions compute in f32 and round once to bf16);
# atol 1e-5 covers outputs near zero, where q k^T's f32 sums on the tensor
# cores leave about 1e-6 of every output (B6, on the CUDA cores, takes
# 1e-6). f32: summation order only.
FLASH_TOL = {"bfloat16": (2 ** -7, 1e-5), "float32": (1e-5, 1e-5)}


def _sdpa(q, k, v, causal, scale):
    """The one-call PyTorch yardstick: scaled_dot_product_attention on
    [B, H, S, d] views, kv heads grouped (enable_gqa)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, scale=scale,
        enable_gqa=q.shape[2] != k.shape[2]).transpose(1, 2)


def phase_flash_attention():
    """Kernel B4 against its plain version (f32 scores and softmax, output
    in the input dtype) at the main path's shape and its variants: ragged S,
    a long sequence, full attention, g = 1, f32 at head_dim 16, Zamba2-7B's
    head dim 112 and hubert-xlarge's 80 (its encoder's full attention, bf16
    and f32). Without the causal mask, the plain version one key short must
    break the bound somewhere, so that an off-by-one kernel could not pass
    it. Bound:
    the larger of (q, k, v, o bytes once) / 3.35 TB/s and the flops these
    inputs need (4 B Hq d per (query, key) pair: S (S + 1) / 2 pairs when
    causal, S^2 when not) / the peak of the dtype's unit (989 TFLOP/s bf16
    tensor cores, 67 TFLOP/s f32)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    for name, B, S, Hq, Hkv, d, dtype, causal in FLASH_CASES:
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, Hq, d, generator=gen, device=dev).to(dt)
        k = torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(dt)
        v = torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(dt)
        scale = d ** -0.5
        got = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        want = ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        rtol, atol = FLASH_TOL[dtype]
        err = (got.float() - want.float()).abs()
        bad = bool((err > atol + rtol * want.float().abs()).any())
        max_err = float(err.max())
        worst = max(worst, max_err)
        ms = _time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                     scale=scale))
        call_ms = _call_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, scale=scale))
        plain_ms = _time_ms(lambda: ref.flash_attention_ref(
            q, k, v, causal=causal, scale=scale), reps=5)
        library_ms = _time_ms(lambda: _sdpa(q, k, v, causal, scale))
        pairs = S * (S + 1) // 2 if causal else S * S
        flops = 4 * B * Hq * d * pairs
        nbytes = (2 * B * S * Hq * d + 2 * B * S * Hkv * d) * q.element_size()
        peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S > flops / peak
                    else "operations")
        # ulps where the relative term of the bound dominates (|plain| >=
        # atol / rtol); nearer zero a sign flip is many ulps and the floor
        # holds it
        big = want.float().abs() >= atol / rtol
        ulps = (_bf16_ulps(got[big], want[big])
                if dtype == "bfloat16" and bool(big.any()) else None)
        # the least atol that this case's errors need beside rtol |plain|
        need_atol = float((err - rtol * want.float().abs()).max())
        # without the causal mask, the plain version one key short must
        # break the bound somewhere
        sees_off = causal
        if not causal:
            off = ref.flash_attention_ref(q, k[:, :-1], v[:, :-1],
                                          causal=False, scale=scale)
            sees_off = bool(((off.float() - want.float()).abs()
                             > atol + rtol * want.float().abs()).any())
            del off
        print(f"flash_attention {name:>14} B={B} S={S} Hq={Hq} Hkv={Hkv} "
              f"d={d} {dtype} causal={causal} max_abs_err={max_err:.3e} "
              f"max_ulps_off_floor={ulps} needed_atol={need_atol:.2e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"bound_share={bound_ms / ms:.3f} call_ms={call_ms:.4f}")
        if bad:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {name}: max_abs_err {max_err}")
        if not sees_off:
            raise AssertionError(f"the tolerance at {name} does not tell the "
                                 "plain version from itself one key off")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_ulps=ulps,
                         bound_ms=bound_ms, bound_by=bound_by,
                         call_ms=call_ms, shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv,
                                                     d=d, dtype=dtype,
                                                     causal=causal)))
        del q, k, v, got, want, err
    top = rows[0]  # the main path's shape
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:88",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "call_ms": top["call_ms"], "shape": top["shape"],
            # Zamba2-7B's and hubert-xlarge's shapes
            "d112": next(r for r in rows if r["name"] == "d=112 g=1"),
            "d80": next(r for r in rows if r["name"] == "d=80 hubert")}


LM_PACE = dict(min_rounds=3, mu=2, slope_lambda=5e-3, low_memory=True)


def _expected_lm_launches(cfg, history):
    """(flash attention, SSD scan, block perturbation) launches of the
    rounds in ``history``: one per attention layer and one per Mamba2 layer
    that a round's forward runs. Stage t runs layers [0, b_{t+1}) (frozen
    prefix and active block) and T - t - 1 proxy attention layers of its
    output module; neither backward launches a kernel (both are autograd
    through plain forms). The pace controller's observe launches B3 twice
    per leaf of the stage's block once it holds a previous snapshot: in
    every round of a stage but the first."""
    from repro_torch.core import freezing
    kinds = cfg.layer_kinds()
    flash = ssd = b3 = 0
    for i, h in enumerate(history):
        hi = freezing.make_stage_plan(cfg, h["stage"]).hi
        mamba = sum(k == "mamba2" for k in kinds[:hi])
        ssd += mamba
        flash += hi - mamba + (cfg.num_freeze_blocks - h["stage"] - 1)
        if i and history[i - 1]["stage"] == h["stage"]:
            b3 += 2 * _pace_block(cfg, h["stage"])[0]
    return flash, ssd, b3


F32_PARAMS = ("A_log", "D", "dt_bias")


def _named_leaves(tree, key=None):
    """(last key, leaf) for every leaf of a nested dict."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, k)
    else:
        yield key, tree


def _peak_rss_bytes():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024


def phase_lm_main_path(card, arch="llama3-8b", steps=8, expect=(172, 0, 72)):
    """Full width ``arch`` through launch/train.py:train on the card, bf16,
    random params from a seed, ``steps`` rounds of batch 4 x 1024 tokens
    spread evenly over the stages, one pod. Llama-3-8B: 32 layers, d_model
    4096, 32 q / 8 kv heads, vocab 128256, 4 stages x 2 rounds. Zamba2-7B:
    81 layers (68 Mamba2, 13 shared attention over 2 tied sets), d_model
    3584, 6 stages x 1 round. The pace controller's anchored window
    (low_memory) keeps two f32 copies of the active block on the card
    instead of six (the exact window does not fit beside the round's
    transients) and takes its norms with B3. ``expect`` is (flash
    attention, SSD scan, B3) launches, as ``_expected_lm_launches`` counts
    them. Returns the launches, the trained params and the config."""
    import torch
    from repro_torch.kernels import block_perturb
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_agg, ssm_scan
    from repro_torch.launch.train import train
    from repro_torch.models.module import tree_leaves
    with _timed_observes() as observe_ms:
        torch.cuda.reset_peak_memory_stats()
        fa.launches = sparse_agg.launches = ssm_scan.launches = 0
        block_perturb.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = train(arch, reduced=False, steps=steps, batch=4, seq=1024,
                    num_pods=1, use_pallas=True, pace_kwargs=dict(LM_PACE),
                    log_every=1, device="cuda")
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = (fa.launches, ssm_scan.launches, block_perturb.launches)
    hist, cfg = out["history"], out["config"]
    for h, o_ms in zip(hist, observe_ms):
        leaves, n = _pace_block(cfg, h["stage"])
        print(f"{arch} stage {h['stage']} round {h['round']} loss "
              f"{h['loss']:.4f} round_wall_ms {h['seconds'] * 1e3:.1f} "
              f"pace_observe_ms {o_ms:.2f} (block n={n}, {leaves} leaves) "
              f"perturbation {h['perturbation']}")
    print(f"{arch} main path seconds {total_s:.2f} (model init included) on "
          f"{card}")
    print(f"{arch} torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()}")
    print(f"{arch} host peak rss bytes {_peak_rss_bytes()}")
    per_stage = steps // cfg.num_freeze_blocks
    assert [h["stage"] for h in hist] == [
        t for t in range(cfg.num_freeze_blocks) for _ in range(per_stage)], hist
    assert all(math.isfinite(h["loss"]) for h in hist), [h["loss"] for h in hist]
    leaves = tree_leaves(out["params"])
    assert all(l.device.type == "cuda" for l in leaves)
    assert all(bool(torch.isfinite(l).all()) for l in leaves)
    # bf16 params, but for Mamba2's A_log, D and dt_bias, kept in f32
    for key, leaf in _named_leaves(out["params"]):
        want = torch.float32 if key in F32_PARAMS else torch.bfloat16
        assert leaf.dtype == want, (key, leaf.dtype)
    expected = _expected_lm_launches(cfg, hist)
    print(f"{arch} flash_attention, ssd_scan, diff_sqnorm launches "
          f"{launches} (expected {expected})")
    assert launches == expected == expect, (launches, expected)
    assert sparse_agg.launches == 0
    return launches, out["params"], cfg


def _device_ms_by_class(prof):
    import torch
    by_class = {}
    for row in prof.key_averages():
        if row.device_type == torch.autograd.DeviceType.CUDA:
            cls = _kernel_class(row.key)
            by_class[cls] = by_class.get(cls, 0.0) + row.self_device_time_total
    return {cls: us / 1e3 for cls, us in by_class.items()}


def phase_lm_profile(card, params, cfg, stages=(0, 3), exact_raises=False):
    """Where an LM round's time goes, at the first of ``stages`` (the
    embedding stage, with the most proxy layers; Llama-3-8B: 8 trained
    layers and 3 proxies) and the last (the deepest frozen prefix and the
    real head; Llama-3-8B: 24 frozen layers; Zamba2-7B: 68). A round is
    what train() runs per round: the federated round
    step, then the pace controller's observe of the active block. The step:
    one warm-up, one timed on the host clock, one under torch.profiler. The
    observe: the warm-up's (a first snapshot) is not counted; of the next
    two, which take the two Eq. 2 norms, one is timed on the host clock
    (ending in a synchronize, since the snapshot's write is still queued
    when observe returns) and one profiled. ``exact_raises``: after the warm-up step, an exact window
    (the default Q+1 = 6 copies) must refuse the block before allocating
    anything, and name ``low_memory=True``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import freezing
    from repro_torch.core.pace import PaceController
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.models.transformer import build
    from repro_torch.optim import sgd
    dev = torch.device("cuda")
    model = build(cfg, dev)
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for stage in stages:
        plan = freezing.make_stage_plan(cfg, stage)
        frozen, active = freezing.init_stage_active(
            model, params, plan, torch.Generator(device=dev).manual_seed(stage))
        step = freezing.make_fed_round_step(model, plan, sgd(3e-3),
                                            num_pods=1, local_steps=1,
                                            remat=False)
        ctl = PaceController(**LM_PACE)
        w = torch.ones(1, device=dev)
        box = {"active": active}

        def one_step(r):
            data = make_lm_batch(cfg, 4, 1024, seed=r)
            fed = {k: torch.as_tensor(v, device=dev).reshape(1, 1, 4, 1024)
                   for k, v in data.items()}
            box["active"], met = step(box["active"], frozen, fed, w)
            float(met["loss"])
            torch.cuda.synchronize()

        one_step(0)
        if exact_raises:
            held = torch.cuda.memory_allocated()
            try:
                PaceController().observe(box["active"]["runs"])
            except ValueError as e:
                assert "low_memory=True" in str(e), e
                assert torch.cuda.memory_allocated() == held
                print(f"  exact pace window refused: {e}")
            else:
                raise AssertionError("an exact pace window of the full-width "
                                     "block was accepted")
        ctl.observe(box["active"]["runs"])
        t0 = time.perf_counter()
        one_step(1)
        step_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=acts) as prof:
            one_step(2)
        step_dev = _device_ms_by_class(prof)
        t0 = time.perf_counter()
        ctl.observe(box["active"]["runs"])
        torch.cuda.synchronize()  # the snapshot's write runs after the norms
        obs_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=acts) as prof:
            ctl.observe(box["active"]["runs"])
            torch.cuda.synchronize()
        obs_dev = _device_ms_by_class(prof)
        print(f"{cfg.name} profile stage {stage} on {card}: round step wall_ms "
              f"{step_ms:.1f}, pace observe wall_ms {obs_ms:.2f}")
        if not step_dev:
            print("  torch.profiler recorded no device time: not measured")
        else:
            busy, obs_busy = sum(step_dev.values()), sum(obs_dev.values())
            print(f"  step: device busy ms {busy:.1f}, idle share "
                  f"{1 - busy / step_ms:.3f}")
            for cls, ms in sorted(step_dev.items(), key=lambda kv: -kv[1]):
                print(f"  {cls:>20}: {ms:9.2f} ms")
            print(f"  observe: device busy ms {obs_busy:.2f}, idle share "
                  f"{1 - obs_busy / obs_ms:.3f} ("
                  + ", ".join(f"{c} {m:.2f}" for c, m in sorted(
                      obs_dev.items(), key=lambda kv: -kv[1])) + ")")
            print(f"  round (step + observe): idle share "
                  f"{1 - (busy + obs_busy) / (step_ms + obs_ms):.3f}")
        print(f"  chunked CE loss, forward + backward alone: "
              f"{_ce_ms(box['active'], plan, cfg):.2f} ms (its GEMMs and "
              f"reductions are inside the classes above)")
        del frozen, active, box, step, ctl
    del model


def _ce_ms(active, plan, cfg):
    """Device ms of the chunked CE loss, forward and backward, at the LM
    round's shape: hidden [4, 1024, d_model] bf16 against the stage's head,
    CUDA events around 3 calls after a warm-up."""
    import torch
    from repro_torch.models.transformer import chunked_ce_loss
    dev = torch.device("cuda")
    head = (active["head"] if plan.final else active["op"]["head"])["w"]
    head = head.detach().requires_grad_()
    h = torch.randn(4, 1024, cfg.d_model, device=dev).to(torch.bfloat16)
    h.requires_grad_()
    labels = torch.randint(0, cfg.vocab_size, (4, 1024), device=dev)

    def run():
        loss = chunked_ce_loss(h, head, {"labels": labels}, cfg)
        torch.autograd.grad(loss, (h, head))

    run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 3


def phase_small_lm_reference(arch="llama3-8b"):
    """The LM path on the card against the port's CPU path (itself held
    against the JAX package by tests/test_torch_lm.py and, for the hybrid,
    tests/test_torch_hybrid.py), on the reduced ``arch`` in float32
    (Llama-3-8B: 4 layers, d_model 64, 4 q / 4 kv heads; Zamba2-7B: 4
    layers alternating Mamba2 and shared attention, d_model 64; 2 stages
    x 1 round, batch 2 x 64 tokens). Both runs draw their params and
    output modules from CPU generators of the same seeds, so they start
    equal. Tolerance rtol 1e-3, atol 1e-5 on losses and final params (f32
    on both devices, summed in other orders; the bf16 output modules can
    flip a rounding). Every kernel of the path launches on the card and
    never on the CPU."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.core import freezing
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssm_scan
    from repro_torch.launch.train import train
    from repro_torch.models import transformer
    from repro_torch.models.module import tree_leaves
    name = f"{arch}-f32"
    configs.register(dataclasses.replace(configs.get(arch), name=name,
                                         param_dtype="float32",
                                         compute_dtype="float32"))
    kernels = [fa] + ([ssm_scan] if configs.get(arch).family == "hybrid"
                      else [])
    lm_init, stage_init = transformer.LM.init, freezing.init_stage_active

    def cpu_lm_init(self, generator):
        return lm_init(self, torch.Generator().manual_seed(
            generator.initial_seed()))

    def cpu_stage_init(model, params, plan, generator):
        return stage_init(model, params, plan, torch.Generator().manual_seed(
            generator.initial_seed()))

    transformer.LM.init = cpu_lm_init
    freezing.init_stage_active = cpu_stage_init
    try:
        results = {}
        for device in ("cpu", "cuda"):
            before = [k.launches for k in kernels]
            results[device] = train(name, reduced=True, steps=2, batch=2,
                                    seq=64, use_pallas=True, log_every=100,
                                    device=device)
            for k, n in zip(kernels, before):
                assert (k.launches > n) == (device == "cuda"), k.__name__
    finally:
        transformer.LM.init, freezing.init_stage_active = lm_init, stage_init
    a, b = results["cpu"], results["cuda"]
    assert len(a["history"]) == len(b["history"]) == 2
    for x, y in zip(a["history"], b["history"]):
        assert (x["stage"], x["round"]) == (y["stage"], y["round"])
        np.testing.assert_allclose(y["loss"], x["loss"], rtol=1e-3, atol=1e-5)
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(b["params"])):
        assert y.device.type == "cuda"
        np.testing.assert_allclose(y.float().cpu().numpy(), x.float().numpy(),
                                   rtol=1e-3, atol=1e-5)
    print(f"small {arch}: card == CPU path (rtol 1e-3, atol 1e-5)")
    # the pace controller deciding: 6 rounds a stage at most, freezes
    # allowed from round 3; Llama with the exact window, Zamba2 anchored
    from repro_torch.kernels import block_perturb
    low_memory = configs.get(arch).family == "hybrid"
    before = block_perturb.launches
    with _pace_shadowed() as pairs:
        out = train(name, reduced=True, steps=12, batch=2, seq=64,
                    use_pallas=True, log_every=100, device="cuda",
                    pace_kwargs=dict(min_rounds=3, mu=1, slope_lambda=5e-2,
                                     fit_window=3, low_memory=low_memory))
    assert block_perturb.launches > before
    _check_pace_shadows(pairs, f"small {arch}")
    stages = [h["stage"] for h in out["history"]]
    print(f"small {arch}: pace-decided stages {stages} (low_memory="
          f"{low_memory}; card pace == CPU pace, rtol {PACE_RTOL})")


# (name, B, S, Hq, Hkv, d, dtype, lengths): the first three are the serving
# path's shape (Llama-3-8B, batch 8, a 1,024-token cache) at three lengths;
# the fourth the decode_32k cut (DECODE_32K.seq_len, batch 128 cut to 8)
def _decode_cases():
    from repro_torch.configs import DECODE_32K
    S32 = DECODE_32K.seq_len
    return [("serve len=1", 8, 1024, 32, 8, 128, "bfloat16", [1] * 8),
            ("serve len=512", 8, 1024, 32, 8, 128, "bfloat16", [512] * 8),
            ("serve len=1024", 8, 1024, 32, 8, 128, "bfloat16", [1024] * 8),
            ("decode_32k cut", 8, S32, 32, 8, 128, "bfloat16",
             [0, S32, 1, 4097, 12345, 20000, 31999, 32767]),
            ("g=1", 8, 1024, 32, 32, 128, "bfloat16", [1024] * 8),
            ("ragged S=1000", 8, 1000, 32, 8, 128, "bfloat16",
             [1000, 999, 1, 500, 0, 64, 65, 1000]),
            ("d=16 f32", 8, 1024, 32, 8, 16, "float32", [1024] * 8),
            ("d=64 f32", 8, 1024, 32, 8, 64, "float32",
             [1024, 0, 7, 513, 1024, 100, 1023, 2]),
            # Zamba2-7B's serving shape: 192 + 64 tokens, head dim 112
            ("d=112 g=1", 8, 256, 32, 32, 112, "bfloat16",
             [256, 1, 255, 128, 0, 64, 200, 17]),
            # hubert-xlarge's width, 16 heads of 80, at ragged lengths
            ("d=80 hubert", 8, 1024, 16, 16, 80, "bfloat16",
             [1024, 1, 1023, 517, 0, 64, 800, 33]),
            ("d=80 f32", 4, 1000, 16, 4, 80, "float32", [1000, 0, 999, 2])]


# (rtol, atol) of |err| <= atol + rtol |plain|. bf16: rtol 2^-7 is one or
# two ulps of the output's own magnitude (both versions sum in f32 in
# another order and round once to bf16), atol 1e-6 only covers outputs near
# zero. f32: summation order only. Every case also checks that the plain
# version one row short (length - 1) breaks the bound in every row it
# changes, so that an off-by-one kernel could not pass it.
DECODE_TOL = {"bfloat16": (2 ** -7, 1e-6), "float32": (1e-5, 1e-5)}


def _bf16_ulps(got, want) -> int:
    """Largest distance, in bf16 ulps, between two bf16 tensors: sign and
    magnitude bit patterns mapped onto one ordered integer line."""
    import torch

    def ordered(t):
        bits = t.contiguous().view(torch.int16).int()
        return torch.where(bits < 0, -(bits & 0x7FFF), bits)
    return int((ordered(got) - ordered(want)).abs().max())
L2_BYTES = 50 * 2 ** 20


def _time_cold_ms(fns, reps=24):
    """Device milliseconds per call, cycling through ``fns`` (one per copy
    of the inputs, enough copies that a copy's cache rows have left the
    50 MB L2 before its next turn, as the serving path finds them after a
    step's other layers), CUDA events around ``reps`` calls behind a sleep
    kernel as ``_time_ms``."""
    import torch
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    start.record()
    for i in range(reps):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_decode_attention():
    """Kernel B6 against its plain version at the serving shape and its
    variants: the kernel, the plain version and the one-call PyTorch
    yardstick (``scaled_dot_product_attention`` on a [B, Hq, 1, d] query
    with kv pre-transposed to [B, Hkv, S, d] outside the timed region, a
    boolean length mask and ``enable_gqa``; it is compared on rows with
    length > 0 only, since it has no answer for an empty row). Bound: the
    bytes the function must move (K and V rows below each row's length, q
    and the output once) over 3.35 TB/s, against the flops these rows need
    (4 d per (q head, cached row)) at the peak of the input dtype."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    for name, B, S, Hq, Hkv, d, dtype, lengths in _decode_cases():
        dt = getattr(torch, dtype)
        elt = torch.tensor([], dtype=dt).element_size()
        kv_bytes = 2 * B * S * Hkv * d * elt
        copies = max(1, -(-3 * L2_BYTES // kv_bytes) + 1)
        sets = []
        for _ in range(copies):
            q = torch.randn(B, Hq, d, generator=gen, device=dev).to(dt)
            k = torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(dt)
            v = torch.randn(B, S, Hkv, d, generator=gen, device=dev).to(dt)
            sets.append((q, k, v))
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q, k, v = sets[0]
        got = dec.decode_attention(q, k, v, length)
        want = ref.decode_attention_ref(q, k, v, length)
        torch.cuda.synchronize()
        err = (got.float() - want.float()).abs()
        rtol, atol = DECODE_TOL[dtype]
        bad = bool((err > atol + rtol * want.float().abs()).any())
        max_err = float(err.max())
        ulps = _bf16_ulps(got, want) if dtype == "bfloat16" else None
        short = ref.decode_attention_ref(q, k, v, (length - 1).clamp(min=0))
        short_err = (short.float() - want.float()).abs()
        # every row the shortening changes must break the bound somewhere
        changed = (length >= 1) & (length <= S)
        sees_off_by_one = bool(
            (short_err > atol + rtol * want.float().abs()).flatten(1).any(1)
            [changed].all())
        del short, short_err
        worst = max(worst, max_err)
        empty_ok = bool((got[length == 0] == 0).all())
        ms = _time_cold_ms([lambda s=s: dec.decode_attention(*s, length)
                            for s in sets])
        call_ms = _call_ms(lambda: dec.decode_attention(q, k, v, length))
        plain_ms = _time_cold_ms([lambda s=s: ref.decode_attention_ref(
            *s, length) for s in sets], reps=max(3, len(sets)))
        mask = (torch.arange(S, device=dev)[None, :] < length[:, None]
                )[:, None, None, :]
        tsets = [(s[0][:, :, None], s[1].transpose(1, 2).contiguous(),
                  s[2].transpose(1, 2).contiguous()) for s in sets]

        def sdpa(t):
            return F.scaled_dot_product_attention(t[0], t[1], t[2],
                                                  attn_mask=mask,
                                                  enable_gqa=Hq != Hkv)
        library_ms = _time_cold_ms([lambda t=t: sdpa(t) for t in tsets])
        live = length > 0
        lib_err = float((sdpa(tsets[0])[:, :, 0].float() - want.float())
                        .abs()[live].max())
        del tsets
        valid = sum(min(max(n, 0), S) for n in lengths)
        nbytes = (2 * valid * Hkv * d + 2 * B * Hq * d) * elt + 4 * B
        flops = 4 * valid * Hq * d
        peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
                    else "operations")
        gc, n_chunks, chunk_rows, splits = dec.plan(
            B, S, Hq, Hkv, dec._sm_count(0))
        print(f"decode_attention {name:>15} B={B} S={S} Hq={Hq} Hkv={Hkv} "
              f"d={d} {dtype} splits={splits}x{chunk_rows} copies={copies} "
              f"max_abs_err={max_err:.3e} max_ulps={ulps} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (err {lib_err:.3e}) "
              f"bound_ms={bound_ms:.4f} ({bound_by}) "
              f"bound_share={bound_ms / ms:.3f} call_ms={call_ms:.4f}")
        if bad or not empty_ok:
            raise AssertionError(f"decode_attention disagrees with its plain "
                                 f"version at {name}: max_abs_err {max_err}, "
                                 f"empty rows zero: {empty_ok}")
        if not sees_off_by_one:
            raise AssertionError(f"the tolerance at {name} does not tell the "
                                 "plain version from itself one row short")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_ulps=ulps,
                         bound_ms=bound_ms, bound_by=bound_by,
                         call_ms=call_ms, shape=dict(
                             B=B, S=S, Hq=Hq, Hkv=Hkv, d=d, dtype=dtype,
                             length=max(lengths))))
        del sets, q, k, v, got, want, err
        torch.cuda.empty_cache()
    top = rows[2]  # the serving path's shape with a full cache
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:25",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "call_ms": top["call_ms"], "shape": top["shape"],
            # Zamba2-7B's serving shape and hubert-xlarge's width
            "d112": next(r for r in rows if r["name"] == "d=112 g=1"),
            "d80": next(r for r in rows if r["name"] == "d=80 hubert")}


SERVE = dict(batch=8, prompt_len=960, gen_len=64)
HYBRID_SERVE = dict(batch=8, prompt_len=192, gen_len=64)


def phase_serve(card, arch="llama3-8b", shape=None, expect=32_768):
    """Full-width ``arch`` through launch/serve.py:serve on the card, bf16,
    random params from a seed, a batch of prompts stepped one token at a
    time, then greedy tokens. Llama-3-8B (32 layers, d_model 4096, 32 q /
    8 kv heads, vocab 128256): batch 8, 960 prompt + 64 generated tokens,
    1,024 decode steps over a 1,024-row cache. Zamba2-7B (13 shared attention
    layers over 2 tied sets, 68 Mamba2 layers stepping their O(1)
    recurrence): batch 8, 192 + 64 tokens, 256 steps. ``expect`` is B6's
    launches, one per attention layer and step; the path launches no other
    kernel. The last step's logits are kept (by a wrapper that only
    records them) to check that they are finite. Returns B6's launches."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_agg, ssm_scan
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    shape = shape or SERVE
    cfg = configs.get(arch)
    steps = shape["prompt_len"] + shape["gen_len"]
    n_attn = sum(k != "mamba2" for k in cfg.layer_kinds())
    step, last = transformer.LM.decode_step, {}

    def recording_step(self, *args, **kwargs):
        last["logits"], cache = step(self, *args, **kwargs)
        return last["logits"], cache

    transformer.LM.decode_step = recording_step
    try:
        torch.cuda.reset_peak_memory_stats()
        dec.launches = fa.launches = sparse_agg.launches = 0
        ssm_scan.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = serve(arch, reduced=False, device="cuda", **shape)
        total_s = time.perf_counter() - t0
        launches = dec.launches
    finally:
        transformer.LM.decode_step = step
    gen = out["generated"]
    loop_s = shape["batch"] * shape["gen_len"] / out["tokens_per_s"]
    print(f"{arch} serve tokens_per_s {out['tokens_per_s']:.2f} (generated "
          f"tokens over the whole {steps}-step loop), ms_per_decode_step "
          f"{loop_s * 1e3 / steps:.3f}, loop seconds {loop_s:.3f}, with "
          f"model init {total_s:.2f} on {card}")
    print(f"{arch} serve torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()}")
    print(f"{arch} serve generated[0, :16] {gen[0, :16].tolist()}")
    print(f"{arch} decode_attention launches {launches} (expected "
          f"{n_attn * steps}), ssd_scan launches {ssm_scan.launches}")
    assert launches == n_attn * steps == expect, launches
    assert fa.launches == sparse_agg.launches == ssm_scan.launches == 0
    assert gen.shape == (shape["batch"], shape["gen_len"])
    assert gen.dtype == np.int32 and gen.min() >= 0
    assert gen.max() < cfg.vocab_size
    logits = last.pop("logits")
    assert logits.shape == (shape["batch"], 1, cfg.vocab_size)
    assert bool(torch.isfinite(logits.float()).all())
    return launches


def phase_decode_profile(card, arch="llama3-8b", cuts=None):
    """One full-width Llama-3-8B decode step (batch 8) at length 1,024 (a
    1,024-row cache) and at the decode_32k
    cut (a DECODE_32K.seq_len = 32,768-row cache, batch 128 cut to 8: 34.4
    GB of bf16 cache filled with random values), at pos = S - 1, so every
    row's length is S. Per cut: one warm-up step, 5 steps timed on the
    host clock (each ending in a synchronize), one under torch.profiler.
    ``arch`` and ``cuts`` ((name, S) pairs) pick another model and cache
    lengths; a hybrid model's Mamba2 states are filled at random too."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.configs import DECODE_32K
    from repro_torch.models.transformer import build
    dev = torch.device("cuda")
    cfg = configs.get(arch)
    model = build(cfg, dev)
    B = SERVE["batch"]
    cuts = cuts or (("length 1024", 1024),
                    ("decode_32k cut", DECODE_32K.seq_len))
    with torch.inference_mode():
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        gen = torch.Generator(device=dev).manual_seed(1)
        tok = {"tokens": torch.randint(0, cfg.vocab_size, (B, 1), device=dev,
                                       generator=gen, dtype=torch.int32)}
        for name, S in cuts:
            cache = model.init_cache(B, S)
            for c in cache.values():
                for t in c.values():
                    t.normal_(generator=gen)
            torch.cuda.synchronize()
            model.decode_step(params, tok, cache, S - 1)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(5):
                logits, _ = model.decode_step(params, tok, cache, S - 1)
                torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / 5
            assert bool(torch.isfinite(logits.float()).all())
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                model.decode_step(params, tok, cache, S - 1)
                torch.cuda.synchronize()
            by_class = _device_ms_by_class(prof)
            cache_gb = sum(t.numel() * t.element_size() for c in cache.values()
                           for t in c.values()) / 1e9
            print(f"{arch} decode step {name}: B={B} S={S} cache "
                  f"{cache_gb:.2f} GB, "
                  f"step_ms {step_ms:.3f}, tokens_per_s "
                  f"{B * 1e3 / step_ms:.1f} on {card}; "
                  f"torch.cuda.max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()}")
            if not by_class:
                print("  torch.profiler recorded no device time: not measured")
            else:
                busy = sum(by_class.values())
                print(f"  device busy ms {busy:.3f}, idle share "
                      f"{1 - busy / step_ms:.3f}")
                for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
                    print(f"  {cls:>22}: {ms:9.3f} ms")
            del cache, logits
            torch.cuda.empty_cache()
        del params
    del model
    torch.cuda.empty_cache()


def phase_small_serve_reference(arch="llama3-8b"):
    """Serving on the card against the port's CPU path (itself held against
    the JAX package by tests/test_torch_serve.py and, for the hybrid,
    tests/test_torch_hybrid.py), on the reduced ``arch`` in float32 with 2
    kv heads (4 layers, d_model 64, 4 q / 2 kv heads; Zamba2-7B's half of
    them Mamba2; batch 4, 8 prompt + 8 generated tokens). Both runs draw their params
    from a CPU generator of the same seed, so they start equal. The
    generated tokens must be equal; the logits of every step agree to rtol
    1e-3, atol 1e-5 (f32 on both devices: the kernel's online softmax
    against the CPU's masked einsum)."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    name = f"{arch}-f32-kv2"
    configs.register(dataclasses.replace(
        configs.get(arch), name=name, num_kv_heads=2,
        param_dtype="float32", compute_dtype="float32"))
    n_attn = sum(k != "mamba2" for k in configs.get(name).reduced()
                 .layer_kinds())
    lm_init, step = transformer.LM.init, transformer.LM.decode_step
    logits = []

    def cpu_lm_init(self, generator):
        return lm_init(self, torch.Generator().manual_seed(
            generator.initial_seed()))

    def recording_step(self, *args, **kwargs):
        out, cache = step(self, *args, **kwargs)
        logits.append(out.float().cpu().numpy())
        return out, cache

    transformer.LM.init = cpu_lm_init
    transformer.LM.decode_step = recording_step
    try:
        results = {}
        for device in ("cpu", "cuda"):
            logits.clear()
            before = dec.launches
            out = serve(name, reduced=True, batch=4, prompt_len=8, gen_len=8,
                        device=device)
            expected = n_attn * 16 if device == "cuda" else 0
            assert dec.launches - before == expected, dec.launches - before
            results[device] = (out["generated"], list(logits))
    finally:
        transformer.LM.init, transformer.LM.decode_step = lm_init, step
    (gen_cpu, log_cpu), (gen_card, log_card) = results["cpu"], results["cuda"]
    np.testing.assert_array_equal(gen_card, gen_cpu)
    assert len(log_cpu) == len(log_card) == 16
    for a, b in zip(log_cpu, log_card):
        np.testing.assert_allclose(b, a, rtol=1e-3, atol=1e-5)
    print(f"small {arch} serve: card == CPU path (tokens equal; logits "
          "rtol 1e-3, atol 1e-5)")


# (name, B, S, H, hd, N, dtype, dt and decay): the first is the hybrid
# main path's shape (Zamba2-7B, batch 4 x 1024 tokens); "model" draws dt =
# softplus(n) (dt_bias 0) and log_a = -dt (A_log 0), "sweep" the reference
# kernel sweep's dt = 0.3 |n| and log_a = -0.2 |n|; x, B, C standard normal
SSD_CASES = [("main", 4, 1024, 112, 64, 64, "bfloat16", "model"),
             ("S=4096 B=1", 1, 4096, 112, 64, 64, "bfloat16", "model"),
             ("ragged S=1000", 4, 1000, 112, 64, 64, "bfloat16", "model"),
             ("main f32", 4, 1024, 112, 64, 64, "float32", "model"),
             ("reduced f32", 2, 64, 8, 16, 16, "float32", "model"),
             ("sweep 1", 1, 64, 1, 8, 4, "float32", "sweep"),
             ("sweep 2", 2, 64, 3, 16, 16, "float32", "sweep"),
             ("sweep 3", 1, 256, 3, 8, 16, "float32", "sweep"),
             ("sweep 4", 2, 256, 1, 16, 4, "float32", "sweep")]
# (rtol, atol) of |err| <= atol + rtol |plain|. f32: the reference's own
# tolerance for its Pallas kernel. bf16: rtol 2^-7 is one or two ulps of
# the output's own magnitude (both versions compute in f32 and round once);
# atol 1e-4 covers outputs near zero, where terms of up to about 150 cancel
# and f32 sums in two orders differ by about 1e-5. Every case also checks
# that the plain version with its decay shifted by one position breaks the
# bound, so that an off-by-one kernel could not pass it.
SSD_TOL = {"bfloat16": (2 ** -7, 1e-4), "float32": (2e-4, 2e-4)}
def _ssd_flops(S, H, hd, N, r):
    """(C B^T flops, f32 flops) of one batch row of the chunked form at
    chunk length r, two per multiply-add: C B^T below the diagonal once per
    chunk (it is the same for every head), and per head and chunk the
    decayed S x below the diagonal, C h^T, the state update's outer
    products and its decay h * exp(total)."""
    shared = f32 = 0
    for n, rr in ((S // r, r), (1, S % r)):
        shared += n * rr * (rr + 1) * N
        f32 += n * H * (rr * (rr + 1) * hd + 4 * rr * N * hd + N * hd * (rr > 0))
    return shared, f32


def _ssd_bound(B, S, H, hd, N, elt):
    """(bound ms, bound_by): the bytes the function moves (x and y once,
    dt and log_a in f32, B and C once) over 3.35 TB/s against its
    operations: the chunked form's at the chunk length that needs the
    fewest (any chunk length gives the same y; the kernel's is 64), C B^T
    at the tensor cores' peak of its operand type (989 TFLOP/s bf16, the
    67 TFLOP/s f32 rate for f32), the decayed terms in f32 at 67 TFLOP/s."""
    nbytes = 2 * B * S * H * hd * elt + 2 * B * S * H * 4 + 2 * B * S * N * elt
    shared_rate = BF16_FLOPS if elt == 2 else F32_FLOPS
    t_ops = B * min(shared / shared_rate + f32 / F32_FLOPS
                    for shared, f32 in (_ssd_flops(S, H, hd, N, r)
                                        for r in range(1, S + 1)))
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def phase_ssd_scan():
    """Kernel B5 against its plain version (the sequential recurrence, f32
    state) at the hybrid main path's shape and its variants: a 4,096-token
    sequence, a ragged length, f32 at full width and at the reduced
    widths, and the reference sweep's f32 widths. Times the kernel, the
    plain version and the chunked plain form (the model's CPU path and the
    kernel's backward, at the model's chunk). No single PyTorch call
    computes this function: library_ms is None."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssm_scan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    for name, B, S, H, hd, N, dtype, dist in SSD_CASES:
        dt_ = getattr(torch, dtype)
        x = torch.randn(B, S, H, hd, generator=gen, device=dev).to(dt_)
        n = torch.randn(B, S, H, generator=gen, device=dev)
        if dist == "model":
            dt, la = F.softplus(n), -F.softplus(n)
        else:
            dt = n.abs() * 0.3
            la = -torch.randn(B, S, H, generator=gen, device=dev).abs() * 0.2
        Bm = torch.randn(B, S, N, generator=gen, device=dev).to(dt_)
        Cm = torch.randn(B, S, N, generator=gen, device=dev).to(dt_)
        got = ssm_scan.ssd_scan(x, dt, la, Bm, Cm)
        want = ref.ssd_scan_ref(x, dt, la, Bm, Cm)
        torch.cuda.synchronize()
        rtol, atol = SSD_TOL[dtype]
        err = (got.float() - want.float()).abs()
        bad = bool((err > atol + rtol * want.float().abs()).any())
        finite = bool(torch.isfinite(got.float()).all())
        max_err = float(err.max())
        # ulps where the relative term of the bound dominates (|plain| >=
        # atol / rtol); nearer zero a sign flip is many ulps and the floor
        # holds it
        big = want.float().abs() >= atol / rtol
        ulps = (_bf16_ulps(got[big], want[big])
                if dtype == "bfloat16" and bool(big.any()) else None)
        la_shift = torch.cat([la[:, :1], la[:, :-1]], dim=1)
        shifted = ref.ssd_scan_ref(x, dt, la_shift, Bm, Cm)
        sees_shift = bool(((shifted.float() - want.float()).abs()
                           > atol + rtol * want.float().abs()).any())
        del shifted
        worst = max(worst, max_err)
        chunk = min(256, S)
        while S % chunk:
            chunk -= 1
        ms = _time_ms(lambda: ssm_scan.ssd_scan(x, dt, la, Bm, Cm))
        call_ms = _call_ms(lambda: ssm_scan.ssd_scan(x, dt, la, Bm, Cm))
        plain_ms = _time_ms(lambda: ref.ssd_scan_ref(x, dt, la, Bm, Cm),
                            reps=2)
        chunked_ms = _time_ms(lambda: ref.ssd_chunked_ref(
            x, dt, la, Bm, Cm, chunk=chunk), reps=3)
        bound_ms, bound_by = _ssd_bound(B, S, H, hd, N, x.element_size())
        print(f"ssd_scan {name:>13} B={B} S={S} H={H} hd={hd} N={N} {dtype} "
              f"{dist} max_abs_err={max_err:.3e} max_ulps_off_floor={ulps} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} chunked_plain_ms="
              f"{chunked_ms:.4f} (chunk {chunk}) library_ms=None "
              f"bound_ms={bound_ms:.4f} ({bound_by}) bound_share="
              f"{bound_ms / ms:.3f} call_ms={call_ms:.4f}")
        if bad or not finite:
            raise AssertionError(f"ssd_scan disagrees with its plain version "
                                 f"at {name}: max_abs_err {max_err}, finite "
                                 f"{finite}")
        if not sees_shift:
            raise AssertionError(f"the tolerance at {name} does not tell the "
                                 "plain version from one with its decay "
                                 "shifted by a position")
        rows.append(dict(ms=ms, plain_ms=plain_ms, chunked_plain_ms=chunked_ms,
                         library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                         call_ms=call_ms, shape=dict(B=B, S=S, H=H, hd=hd, N=N,
                                                     dtype=dtype)))
        del x, dt, la, la_shift, Bm, Cm, got, want, err
        torch.cuda.empty_cache()
    top = rows[0]  # the hybrid main path's shape
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:68",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "chunked_plain_ms": top["chunked_plain_ms"],
            "call_ms": top["call_ms"], "shape": top["shape"]}


def main():
    import torch
    card = phase_versions()
    phase_build()
    entry = phase_sparse_agg()
    perturb = phase_block_perturb()
    entry["launches"], cnn_b3 = phase_main_path(card)
    phase_profile(card)
    phase_small_reference()
    flash = phase_flash_attention()
    (llama_flash, _, llama_b3), params, cfg = phase_lm_main_path(card)
    phase_lm_profile(card, params, cfg, exact_raises=True)
    del params
    phase_small_lm_reference()
    torch.cuda.empty_cache()  # the training phases' trees are gone
    decode = phase_decode_attention()
    llama_decode = phase_serve(card)
    phase_decode_profile(card)
    phase_small_serve_reference()
    torch.cuda.empty_cache()
    scan = phase_ssd_scan()
    (hybrid_flash, scan["launches"], hybrid_b3), params, cfg = \
        phase_lm_main_path(card, "zamba2-7b", steps=6, expect=(61, 242, 0))
    phase_lm_profile(card, params, cfg, stages=(0, 5))
    del params
    phase_small_lm_reference("zamba2-7b")
    torch.cuda.empty_cache()
    hybrid_decode = phase_serve(card, "zamba2-7b", HYBRID_SERVE, expect=3_328)
    phase_decode_profile(card, "zamba2-7b", (("length 256", 256),))
    phase_small_serve_reference("zamba2-7b")
    # launches: the sum over the main paths that run the kernel
    flash["launches"] = llama_flash + hybrid_flash
    flash["launches_by_path"] = {"llama3-8b train": llama_flash,
                                 "zamba2-7b train": hybrid_flash}
    decode["launches"] = llama_decode + hybrid_decode
    decode["launches_by_path"] = {"llama3-8b serve": llama_decode,
                                  "zamba2-7b serve": hybrid_decode}
    perturb["launches_by_path"] = {"resnet18 sync": cnn_b3,
                                   "llama3-8b train": llama_b3,
                                   "zamba2-7b train": hybrid_b3}
    perturb["launches"] = cnn_b3 + llama_b3 + hybrid_b3
    print(json.dumps({"kernels": [entry, flash, decode, scan, perturb]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:  # report and fail; never print a result
        traceback.print_exc()
        sys.exit(1)
