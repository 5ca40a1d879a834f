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
  4. drive the main path: ``SmartFreezeServer.run`` on full-width ResNet-18
     (4 stages x 2 rounds, 20 clients over 10,000 32x32 SyntheticVision
     samples, 6 clients a round, top-k uplinks at ratio 0.1), with every
     kernel's launch count set to 0 just before and read just after;
  5. profile one stage-0 and one stage-3 round of that path: device time by
     kernel class and the device's idle share;
  6. check the card's result against the port's CPU path on a small model.

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

# H100 SXM published peaks (NVIDIA data sheet) for the bound: HBM3 bytes/s
# and float32 FLOP/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
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


def phase_main_path(card):
    """Full-width ResNet-18 through SmartFreezeServer.run on the card.
    CIFAR-10's 50,000 training images are cut to 10,000 SyntheticVision
    samples; widths, image size and class count are untouched."""
    import torch
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import sparse_agg
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
    sparse_agg.launches = 0
    torch.cuda.synchronize()
    t_start = time.perf_counter()
    out = srv.run(params, state, eval_fn=eval_fn, eval_every=1,
                  schedule=[2, 2, 2, 2])
    torch.cuda.synchronize()
    launches = sparse_agg.launches
    total_s = time.perf_counter() - t_start
    prev_end = t_start
    for rr, (t_in, t_out) in zip(out["history"], marks):
        wall_ms = (t_in - prev_end) * 1e3
        prev_end = t_out
        print(f"round {rr.round_idx} stage {rr.stage} loss {rr.loss:.4f} "
              f"wall_ms {wall_ms:.1f} uplink_bytes {rr.uplink_bytes} "
              f"test_acc {rr.test_acc:.3f} cohort {rr.selected}")
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
    expected = 0
    for rr in hist:
        _, active = fz.init_cnn_stage_active(model, out["params"], rr.stage,
                                             torch.Generator().manual_seed(0))
        plan = srv._cache_plan(rr.stage)
        groups = len({plan.get(c) is not None for c in rr.selected})
        expected += len(tree_leaves(active)) * groups
    print(f"sparse_cohort_add launches {launches} (expected {expected})")
    assert launches == expected > 0, (launches, expected)
    return launches


def _kernel_class(name):
    low = name.lower()
    if "sparse_cohort_add" in low:
        return "sparse_cohort_add"
    if "sort" in low or "radix" in low:
        return "top-k sort"
    if any(t in low for t in ("conv", "cudnn", "gemm", "xmma", "sm90_",
                              "implicit", "winograd", "fft")):
        return "conv / gemm"
    if any(t in low for t in ("reduce", "norm", "welford")):
        return "reductions"
    if "memcpy" in low or "memset" in low:
        return "copies / memset"
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


def main():
    import torch
    card = phase_versions()
    phase_build()
    entry = phase_sparse_agg()
    entry["launches"] = phase_main_path(card)
    phase_profile(card)
    phase_small_reference()
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:  # report and fail; never print a result
        traceback.print_exc()
        sys.exit(1)
