"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which exits non-zero on failure:
  1. versions, and the card's name and power limit from nvidia-smi;
  2. build every CUDA kernel of the port from ``src/repro_torch/kernels/csrc``
     (all nvcc processes started together);
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, and time kernel, plain version, the
     one-call PyTorch yardstick, and the memory bound (B1, the cohort
     fold: ``torch.equal`` to its plain version run on the CPU at every
     ResNet-18 leaf, with duplicates and unsorted rows, equal bits on a
     rerun, one kernel and no memset a call, a broken ``sorted_rows``
     promise failing the launch);
 3a. hold the flash-decode kernel (B6) against its plain version at the
     Llama-3-8B serving shape, the decode_32k cut and its variants
     (Zamba2-7B's head dim 112, hubert-xlarge's 80, the MLA widths 96 and
     192, dk 96 with dv 64, f32 at 256, grok-1-314b's g = 6,
     internvl2-2b's g = 2), with its times; each case checks that one call
     runs exactly one device kernel and that a rerun gives equal bits; bf16
     cases are held within a floor derived from both versions' f32 sums,
     and the d 112 case is run over 20 draws against its own floor;
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
 5b. run one fused compressed stage-0 round of phase 4's setup twice from
     the same state: equal bits under deterministic cuDNN;
 6b. drive the aggregation policies on full-width ResNet-18 (phase 4's
     fleet, cohort, batch, ratio and SGD): ``SmartFreezeServer.run`` under
     the deadline policy (factor 1.5, a quarter of the fleet 20x slower,
     availability 0.9 with dropout 0.1), under the async-buffered policy
     (buffer 4, concurrency 8, a virtual-clock watchdog) and with
     ``fused=False``; counts set to 0 before each run and read after, B1's
     held against the ticks (a sequential round or an async completion
     folds each client alone); a trimmed round, a dropout, a watchdog retry
     and staleness asserted; one K = 1 fold of the path equal to its plain
     version bit for bit; a stage-0 round fused and sequential in turns,
     the sequential one profiled;
 6c. check the card's deadline and async runs against the port's CPU path
     on the small model: the loop's records equal, losses and params
     allclose;
 6d. drive the paper's baselines on full-width ResNet-18 (phase 4's fleet,
     cohort, batch, ratio and SGD, two rounds a run): AllSmall, HeteroFL
     and DepthFL under Table 1's memory rule, where ExclusiveFL, TiFL and
     Oort must be inoperative; ExclusiveFL, TiFL, Oort and
     ``FedAvgServer`` on the fleet's own memory, ``FedAvgServer`` also with
     ``fused=False`` and under the deadline policy; B1's count held against
     each run's rounds, one K = 1 fold of the path equal to its plain
     version bit for bit, one cohort fold equal to it on the CPU; a
     profiled ExclusiveFL round;
 6e. check the six baselines on the card against the port's CPU path at
     Table 1's configuration, then run Table 1's 12 rounds on the card and
     print its accuracy row;
 6f. drive the defenses on full-width ResNet-18 (phase 6b's straggler
     fleet and deadline policy, ``COHORT`` clients a round): screening
     under NaN, Inf and amplified updates (a client screened, every param
     finite after every round, B3 counted), a sign-flipped round under
     ``trimmed_mean`` and ``coord_median`` fused and sequential (the two
     routes agree), the undefended and defended round in turns, a freeze
     rollback restoring params equal to the freeze-time snapshot, and
     crash and hang faults with top-k 0.1 uplinks under sync and async (B1
     counted over the rounds' survivors, a K > 1 survivor fold equal to
     its plain version on the CPU bit for bit, a watchdog retry);
 6g. check the defenses on the card against the port's CPU path on the
     small model: records equal, params allclose;
 6h. checkpoint and resume (``phase_resume``): full-width ResNet-18
     crashed and resumed across a stage-0 freeze, fused with top-k 0.1
     under deterministic cuDNN (every restored tensor equal to the saved
     one, the records and final params ``torch.equal`` to an unbroken
     run's, and a second unbroken run's to the first, B1 and B3 counted)
     and sequential (the resumed trajectory equal bit for bit); round walls with async saves and without, in turns,
     checkpoint bytes and synchronous save and restore walls; a resume
     across a cache-tier decision (the restored cache equal to the saved
     one); ``FedAvgServer``'s selection stream restored; the LM trainer at
     Llama-3-8B width, depth cut to 4 layers in 2 freeze blocks, resumed
     mid-stage (B4 and B3 counted); a small CNN checkpoint crossing between
     the card and the CPU;
  7. hold the flash attention kernel (B4) against its plain version at the
     Llama-3-8B training shape and its variants (Zamba2-7B's head dim 112,
     hubert-xlarge's 80, the run-time widths 96, 256 and dk 192 with dv
     128, the xLSTM-350M and MiniCPM3-4B proxies' d 256 and d 64 at g = 1,
     grok-1-314b's g = 6 and deepseek-v2-236b's 128-head proxies,
     internvl2-2b's g = 2, sequences of 1 and 17 among them), with its
     times, its plan and
     the registers and spills of each instantiation; a rerun must give
     equal bits;
  8. drive the LM main path: ``launch/train.py:train`` on full-width
     Llama-3-8B (32 layers, 4 stages x 2 rounds, batch 4 x 1024 tokens),
     with every kernel's launch count set to 0 just before and read just
     after (B4, and B3 in the pace observe);
  9. profile one stage-0 and one stage-3 LM round, the round step and the
     pace observe: device time by kernel class and the idle share;
 10. check the card's LM result against the port's CPU path on a small
     model, and the card's pace controller against the CPU path's;
 11. free the training phases' memory (phase 3's B6 check, below, ran
     early: one-call profiles late in a long process record nothing);
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
     at a ragged length, at Mamba2's published state size 128, at the
     run-time widths (32, 16) and at the reference sweep's f32 widths, with
     the model's dt and decay distributions; print each case's plan,
     registers and spills, assert equal bits on a rerun; time kernel,
     plain version and the chunked plain form against the bound (restated
     for tensor-core products, the first bound beside it);
 16. drive the hybrid main path: ``launch/train.py:train`` on full-width
     Zamba2-7B (81 layers: 68 Mamba2, 13 shared attention over 2 tied
     sets; 6 stages x 1 round, batch 4 x 1024 tokens), with every kernel's
     launch count set to 0 just before and read just after;
 17. profile one stage-0 and one stage-5 hybrid round;
 18. check the card's hybrid training against the port's CPU path on a
     small model, and the card's anchored pace window against the CPU
     path's;
 19. drive hybrid serving: ``launch/serve.py:serve`` on full-width
     Zamba2-7B (batch 8, 64 prompt + 64 generated tokens: 128 decode
     steps), counts set to 0 before and read after; then time and profile
     one decode step;
 20. check the card's hybrid serving against the port's CPU path on a
     small model;
 20b. drive xLSTM-350M (24 layers: 21 mLSTM, 3 sLSTM; d_model 1024) through
     ``launch/train.py:train`` at full width and depth (4 stages x 2
     rounds, batch 4 x 1024 tokens), counts set to 0 before and read after
     (B4 in the output module's GQA proxies, 4 heads of 256; B3 in the pace
     observe); profile a stage-0 and a stage-3 round; time one sLSTM
     layer's host loop of 1,024 cells, forward and backward, with its idle
     share; the small xLSTM card against the CPU path; serve full width
     (batch 8, 192 + 64 tokens, no B6), profile a decode step, and the
     small serve card against the CPU;
 20c. the same for MiniCPM3-4B (62 MLA layers, d_model 2560, 40 heads; 6
     stages x 2 rounds, without ``use_pallas``; B4 in the proxies, 40 heads
     of 64): train, profile stages 0 and 5, the small card-vs-CPU check
     with one ``mla_forward`` at S = 2,048 (the blockwise branch) on both,
     serve at 64 + 64 tokens (no B6), a profiled decode step, the small
     serve check;
 20d. the MoE family at full width with depth cut (``MOE_CUTS``): one
     grok-1-314b ``attn_moe`` layer forward and backward (one B4 launch at
     g = 6, finite gradients, device ms by class, capacity drops);
     deepseek-v2-236b at depth 2 through ``train`` (2 stages x 2 rounds,
     B4 in the proxy, B3 in the observes, peak memory); the small grok-1
     and deepseek-v2 card-vs-CPU training checks; grok-1 served at depth 4
     and deepseek-v2 at depth 7 (batch 8, 192 + 64 tokens: grok-1 1,024 B6
     launches at g = 6, deepseek-v2 none), each with a profiled decode step and the small
     serve card-vs-CPU check;
 20e. the modality frontends at full width and depth: internvl2-2b (24
     layers, d_model 2048, 16 q / 8 kv heads of 128, 256 patch positions
     of 1,024 features) and hubert-xlarge (48 layers, d_model 1280, 16
     heads of 80, non-causal, 512-feature frames) through
     ``launch/train.py:train`` (4 stages x 2 rounds, batch 4 x 1024
     positions, ``use_pallas``), counts set to 0 before and read after (B4,
     B3); a profile of stages 0 and 3 each; internvl2-2b's cached round
     (stages 1-3, features stored at the f32, fp16 and int8 tiers, held
     against the recompute round; B4 counted); the small card-vs-CPU
     checks; internvl2-2b served (batch 8, 192 + 64 tokens, B6 at g = 2),
     a profiled decode step and the small serve check;
 21. hold the dequantizing GEMM (B2) against its plain version at the
     quant-aware path's shape (M 32, K 16,384, N 512, int8 q with row
     scales) and its variants (bf16 w, K 32,768, M 4,096, col, full and
     0-d scales, f32 and bf16 q, ragged shapes, zero rows, denormal
     scales, near-overflow magnitudes, bf16 out, a bad scale shape) by the
     f32 summation bound, which a plain version missing the last split-K
     slice must break; equal bits on a rerun; its times;
 22. drive the memory tiers: ``SmartFreezeServer.run`` on full-width
     ResNet-18 with ``cache_tiers="all"`` and ``compute_dtype="bfloat16"``
     (10 clients over CIFAR-10's 50,000 samples, the high-contention memory
     pool, schedule [0, 1, 1, 1]: stage 0 holds no cache), counts set to 0
     before and read after;
     the ladder's plan per stage and every tier group on the card
     asserted; then profile a stage-2 round with one client per tier;
 23. drive the quant-aware int8 path, which launches B2:
     ``RoundEngine.run_round`` at ResNet-18's stage 3 over the fleet, the
     flattened prefix features int8 with row scales, the reference test's
     MLP consumer at w1 [16,384, 512]; one round in f32, one in bf16, one
     B2 launch per local step; a profiled round;
 24. check the card's tiered bf16 run and a quant-aware int8 round against
     the port's CPU path on a small model;
 25. the resident population (``phase_population``): 100,000 clients in
     64 communities, k 64, 5 rounds of ``select_arrays`` at epsilon 0 and
     5 at 0.2 held against the port's CPU path (equal; at 0.2 near ties
     counted), community coverage, the Gumbel draw timed, cache admission
     at three tiers equal to the CPU's, and ``sketch_communities``' steps
     on 100,000 planted CIFAR-100 label histograms (50 communities back;
     2,048 rows' top-8 weights against a CPU top-8 over all columns);
 26. drive ``SmartFreezeServer.run`` with ``VectorizedSelector`` on
     full-width ResNet-18 (phase 4's setup, schedule [2, 1, 1, 1]), counts
     set to 0 before and read after (B1, B3); each cohort equal to the list
     selector's on the CPU; the engine's residual norms against f64 CPU
     norms; then its twin with the list selector, under deterministic
     cuDNN as the first: cohorts and losses equal round for round;
 27. check the small CNN with ``VectorizedSelector(epsilon=0.2)`` on the
     card against the port's CPU path.

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
    return logs


def _ptxas_by_kernel(log):
    """{(mangled-name fragment, template values...): (registers, spill
    store bytes, spill load bytes)} of the B4, B5 and B2 instantiations in
    an ``nvcc -Xptxas -v`` log (``flash_fwd_bf16<CEIL>``,
    ``flash_fwd_f32<CEIL>``, ``ssd_scan_bf16<HD class, N class>``,
    ``ssd_scan_f32<HD class, N class, FULL>``, a bool as 0 or 1;
    ``dequant_matmul_kernel<BM, q type, scale kind, w type>``, the types
    as "int8", "f32" or "bf16")."""
    import re
    types = {"a": "int8", "f": "f32", "13__nv_bfloat16": "bf16",
             "S1_": "bf16"}
    out, key, spills = {}, None, (None, None)
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '.*?(flash_fwd_(?:bf16|f32)"
                      r"|ssd_scan_(?:bf16|f32))I((?:L[ib]\d+E)+)", line)
        if m:
            key = (m.group(1), *map(int, re.findall(r"L[ib](\d+)E",
                                                    m.group(2))))
            continue
        m = re.search(r"Compiling entry function '.*?(dequant_matmul_kernel)"
                      r"ILi(\d+)E(a|f|13__nv_bfloat16)Li(\d)E"
                      r"(f|13__nv_bfloat16|S1_)EEv", line)
        if m:
            key = (m.group(1), int(m.group(2)), types[m.group(3)],
                   int(m.group(4)), types[m.group(5)])
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and key:
            spills = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and key:
            out[key] = (int(m.group(1)),) + spills
            key = None
    return out


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


def _fold_cpu(idx, vals, w, L):
    """B1's plain version run on the CPU: the yardstick for the kernel's
    bits (``index_add_`` on a CUDA tensor sums with atomics itself)."""
    from repro_torch.kernels import ref
    return ref.sparse_cohort_add_ref(idx.cpu(), vals.cpu(), w.cpu(), L)


def _broken_promise_fails():
    """Whether an unsorted row under ``sorted_rows=True`` fails B1's launch:
    a process of its own (the device-side assert loses the CUDA context)
    that must exit non-zero with the assert in its output. Returns (failed
    as it should, the output's last line)."""
    code = ("import sys\nsys.path.insert(0, %r)\nimport torch\n"
            "from repro_torch.kernels import sparse_agg\n"
            "idx = torch.tensor([[5, 2, 9], [1, 3, 4]], dtype=torch.int32, "
            "device='cuda')\nvals = torch.ones(2, 3, device='cuda')\n"
            "w = torch.full((2,), 0.5, device='cuda')\n"
            "sparse_agg.sparse_cohort_add(idx, vals, w, 16, sorted_rows=True)"
            "\ntorch.cuda.synchronize()\nprint('no error')\n"
            % os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    text = (r.stdout + r.stderr).strip()
    last = text.splitlines()[-1] if text else ""
    return r.returncode != 0 and "assert" in text.lower(), last


def phase_sparse_agg():
    """Kernel B1 against its plain version run on the CPU, bit for bit
    (``torch.equal``), and a rerun against the first call (equal bits):
    at every ResNet-18 leaf length (K = 6 clients, k = topk_keep(L, 0.1)
    distinct indices a row, ascending as top-k sends them, through
    ``sorted_rows=True``, the main path's route), all duplicates, k = 1,
    ascending rows mixing runs of equal indices with distinct ones (one of
    them with more entries a tile than the kernel stages at once), and
    unsorted rows through the default route (the wrapper's stable sort).
    An unsorted row under ``sorted_rows=True`` must fail the launch. One
    call of the main path's route must run one kernel and no memset: one
    node in a CUDA graph of the call, one profiled device activity.
    Times (``_time_ms``): the kernel, the default route on sorted rows,
    the plain version on the card, ``index_add_`` into a zeroed vector,
    and the byte bound."""
    import torch
    from repro_torch.fl.compression import topk_keep
    from repro_torch.kernels import ref, sparse_agg
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def distinct(K, k, L):
        return torch.stack([torch.sort(torch.randperm(
            L, generator=gen, device=dev)[:k]).values
            for _ in range(K)]).to(torch.int32)

    def runs(K, k, L):
        return torch.sort(torch.randint(0, L, (K, k), generator=gen,
                                        device=dev), dim=1).values.to(
                                            torch.int32)

    cases = [(f"L={L}", COHORT, topk_keep(L, RATIO), L, "distinct", True)
             for L in resnet18_leaf_lengths()]
    cases += [("all_duplicates", COHORT, 256, 1000, "same", True),
              ("k=1", COHORT, 1, 10, "distinct", True),
              ("runs", COHORT, 4096, 20_000, "runs", True),
              ("runs default route", COHORT, 4096, 20_000, "runs", False),
              ("dense runs", COHORT, 200_000, 8_192, "runs", True),
              ("unsorted", COHORT, 5000, 30_000, "unsorted", False)]
    rows, worst = [], 0.0
    for name, K, k, L, kind, sorted_rows in cases:
        if kind == "same":
            idx = torch.full((K, k), 7, dtype=torch.int32, device=dev)
        elif kind == "distinct":
            idx = distinct(K, k, L)
        elif kind == "runs":
            idx = runs(K, k, L)
        else:
            idx = torch.randint(0, L, (K, k), generator=gen, device=dev,
                                dtype=torch.int32)
        vals = torch.randn(K, k, generator=gen, device=dev)
        w = torch.rand(K, generator=gen, device=dev)
        w = w / w.sum()

        def fold():
            return sparse_agg.sparse_cohort_add(idx, vals, w, L,
                                                sorted_rows=sorted_rows)
        got = fold()
        again = fold()
        want = _fold_cpu(idx, vals, w, L)
        equal = torch.equal(got.cpu(), want)
        equal_bits = torch.equal(again, got)
        max_err = float((got.cpu() - want).abs().max())
        worst = max(worst, max_err)
        flat = idx.reshape(-1).long()
        contrib = (w[:, None] * vals).reshape(-1)
        ms = _time_ms(fold)
        call_ms = _call_ms(fold)
        plain_ms = _time_ms(lambda: ref.sparse_cohort_add_ref(idx, vals, w, L))
        library_ms = _time_ms(lambda: torch.zeros(L, device=dev).index_add_(
            0, flat, contrib))
        nbytes = K * k * 8 + K * 4 + L * 4
        bound_ms = max(nbytes / HBM_BYTES_PER_S, 2 * K * k / F32_FLOPS) * 1e3
        print(f"sparse_cohort_add {name:>18} K={K} k={k:<7d} L={L:<8d} "
              f"sorted_rows={sorted_rows} equal_to_cpu_plain={equal} "
              f"equal_bits={equal_bits} max_abs_err={max_err:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} bound_ms={bound_ms:.4f} "
              f"bound_share={bound_ms / ms:.3f} call_ms={call_ms:.4f}")
        if not equal:
            raise AssertionError(f"sparse_cohort_add at {name} differs from "
                                 f"its plain version on the CPU: max_abs_err "
                                 f"{max_err}")
        if not equal_bits:
            raise AssertionError(f"sparse_cohort_add at {name} gave other "
                                 "bits on a rerun")
        if name.startswith("L="):
            rows.append(dict(L=L, K=K, k=k, ms=ms, plain_ms=plain_ms,
                             library_ms=library_ms, bound_ms=bound_ms,
                             call_ms=call_ms, idx=idx, vals=vals, w=w))
    # the JSON line reports the largest leaf, the stage-3 3x3 512->512 conv
    top = max(rows, key=lambda r: r["L"])
    idx, vals, w, L = top.pop("idx"), top.pop("vals"), top.pop("w"), top["L"]
    sort_ms = _time_ms(lambda: sparse_agg.sparse_cohort_add(idx, vals, w, L))
    main_route = lambda: sparse_agg.sparse_cohort_add(  # noqa: E731
        idx, vals, w, L, sorted_rows=True)
    nodes = _graph_nodes(main_route)
    one_call = _device_kernels(main_route)
    print(f"sparse_cohort_add L={L}: graph_nodes_a_call={nodes} "
          f"profiled_a_call={one_call}; the default route (stable row sort "
          f"first) ms={sort_ms:.4f}")
    if nodes != [0] or len(one_call) != 1 or any(
            "sparse_cohort_add" not in n or "memset" in n.lower()
            for n in one_call):
        raise AssertionError(f"one sparse_cohort_add call ran graph nodes "
                             f"{nodes}, profiled {one_call} on the card, not "
                             "one kernel")
    failed, last = _broken_promise_fails()
    print(f"sparse_cohort_add: unsorted rows under sorted_rows=True fail the "
          f"launch: {failed} ({last})")
    if not failed:
        raise AssertionError("unsorted rows under sorted_rows=True did not "
                             "fail sparse_cohort_add's launch")
    for r in rows:
        for key in ("idx", "vals", "w"):
            r.pop(key, None)
    return {"name": "sparse_cohort_add", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/sparse_agg.cu",
            "replaces": "src/repro/kernels/sparse_agg.py:53",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": "bytes", "library_ms": top["library_ms"],
            "call_ms": top["call_ms"], "sort_route_ms": sort_ms,
            "shape": {"K": top["K"], "k": top["k"], "L": top["L"]}}


def _layer_leaves(cfg, kind):
    """One layer of ``kind`` as meta tensors: the shapes ``layer_init``
    gives, with no memory behind them."""
    import torch
    from repro_torch.models.module import ParamFactory, tree_leaves
    from repro_torch.models.transformer import layer_init
    return tree_leaves(layer_init(ParamFactory(None, "meta", torch.bfloat16),
                                  cfg, kind))


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
    if "decode_attention_cluster" in low:
        return "decode_attention (B6)"
    if "ssd_scan" in low:
        return "ssd_scan (B5)"
    if "diff_sqnorm" in low:
        return "diff_sqnorm (B3)"
    if "dequant_matmul" in low or "splitk_reduce" in low:
        return "dequant_matmul (B2)"
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


def _device_us_by_class(prof):
    """Device microseconds of a ``torch.profiler`` window by kernel class:
    the sum of its device events' durations, read from the profiler's raw
    results. ``prof.events()`` and ``key_averages()`` first build a Python
    event, and a tree, for every host and device event, which took longer
    than the rounds profiled in windows of many launches, such as an
    xLSTM round with sLSTM's host loop (the sums are the same)."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    by_class, class_of = {}, {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == cuda:
            name = ev.name()
            cls = class_of.get(name)
            if cls is None:
                cls = class_of[name] = _kernel_class(name)
            by_class[cls] = (by_class.get(cls, 0.0)
                             + (ev.end_ns() - ev.start_ns()) / 1e3)
    return by_class


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
        by_class = _device_us_by_class(prof)
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


def _same_bits(a, b):
    """Whether two trees of tensors hold the same bits, leaf for leaf."""
    import torch
    from repro_torch.models.module import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y)
        for x, y in zip(la, lb))


def phase_fused_repeat(card):
    """One fused compressed stage-0 round of phase 4's setup (full-width
    ResNet-18, 6 clients, batch 32, top-k 0.1 with error feedback), run
    twice from the same params, BN state and fresh residual pools: the
    new params, BN state and per-client losses compared bit for bit.
    First with cuDNN's default algorithms (its convolution backward sums
    with atomics), then with deterministic cuDNN, where the two runs must
    agree (B1 sums in a fixed order). A third round runs under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, and the
    ops it names as without a deterministic implementation are printed."""
    import warnings
    import torch
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    clients, _ = _fleet(10_000, 20, 32, 10)
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    srv = SmartFreezeServer(model, clients, clients_per_round=COHORT,
                            batch_size=32, compress_ratio=RATIO,
                            device="cuda")
    cohort = list(range(COHORT))
    frozen, active = fz.init_cnn_stage_active(
        model, params, 0, torch.Generator().manual_seed(0))

    def one_round():
        engine = srv._stage_engine(0, frozen, state)
        sparse_agg.launches = 0
        p, s, losses = engine.run_round(srv.clients, cohort, active, state, 0)
        torch.cuda.synchronize()
        assert sparse_agg.launches > 0
        return p, s, losses

    def twice():
        (p1, s1, l1), (p2, s2, l2) = one_round(), one_round()
        return _same_bits(p1, p2) and _same_bits(s1, s2) and l1 == l2

    default = twice()
    torch.backends.cudnn.deterministic = True
    try:
        equal_bits = twice()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                one_round()
            finally:
                torch.use_deterministic_algorithms(False)
    finally:
        torch.backends.cudnn.deterministic = False
    flagged = sorted({str(w.message).split(" does not have")[0][:100]
                      for w in caught if "deterministic" in str(w.message)})
    print(f"fused compressed stage-0 round run twice on {card}: "
          f"equal_bits={equal_bits} with deterministic cuDNN, "
          f"equal_bits={default} with cuDNN's default algorithms; ops "
          f"without a deterministic implementation: {flagged or 'none'}")
    if not equal_bits:
        raise AssertionError("two runs of one fused compressed round under "
                             "deterministic cuDNN gave other bits")
    return equal_bits


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

class _ticks:
    """Records every aggregation tick inside the ``with``: the loop's
    ``RoundRecord``, the tick's wall ms (the tick ends in the round's loss
    read-back; a synchronize on each side keeps queued work out) and the
    loop."""

    def __enter__(self):
        import torch
        from repro_torch.fl import sim
        self.classes = (sim.SyncAggregation, sim.DeadlineAggregation,
                        sim.AsyncBufferedAggregation)
        self.saved = [c.tick for c in self.classes]
        log = []

        def wrap(tick):
            def timed(policy, loop, r):
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                rec = tick(policy, loop, r)
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
                log.append((rec, (time.perf_counter() - t0) * 1e3, loop))
                return rec
            return timed
        for c, tick in zip(self.classes, self.saved):
            c.tick = wrap(tick)
        return log

    def __exit__(self, *exc):
        for c, tick in zip(self.classes, self.saved):
            c.tick = tick


class _first_single_fold:
    """Inside the ``with``, keeps a copy of the inputs and the output of
    the B1 launch that folds one client (K = 1; with ``cohort=True``, more
    than one) at the largest leaf length seen, the first such; the launch
    itself is the path's own and counts once."""

    def __init__(self, cohort=False):
        self.cohort = cohort

    def __enter__(self):
        from repro_torch.kernels import sparse_agg
        self.mod, self.fn = sparse_agg, sparse_agg.sparse_cohort_add
        kept = {}

        def keep(idx, vals, weights, length, **kw):
            out = self.fn(idx, vals, weights, length, **kw)
            if ((idx.shape[0] > 1) == self.cohort
                    and length > kept.get("L", 0)):
                kept.update(L=length, idx=idx.clone(), vals=vals.clone(),
                            w=weights.clone(), out=out.clone())
            return out
        sparse_agg.sparse_cohort_add = keep
        return kept

    def __exit__(self, *exc):
        self.mod.sparse_cohort_add = self.fn


def _expected_fold_launches(model, params, srv, ticks, stages):
    """B1 launches a run's ticks imply: a sequential round (every round of
    a ``fused=False`` server), or an async completion, folds each client
    alone (one launch a leaf for each client trained); a fused round folds
    once a leaf for each cache group (one a tier, and one of the clients
    that recompute)."""
    from repro_torch.core import freezing_cnn as fz
    import torch
    from repro_torch.models.module import tree_leaves
    n, leaf_count = 0, {}
    for (rec, _, _), stage in zip(ticks, stages):
        if stage not in leaf_count:
            leaf_count[stage] = len(tree_leaves(fz.init_cnn_stage_active(
                model, params, stage, torch.Generator().manual_seed(0))[1]))
        leaves = leaf_count[stage]
        if rec.sequential or rec.policy == "async" or not srv.fused:
            n += leaves * len(rec.selected)
        else:
            plan = srv._cache_plan(stage)
            n += leaves * len({plan.get(c) for c in rec.selected})
    return n


def _expected_b3(model, params, stages):
    """phase_main_path's rule: two B3 launches a leaf of the stage block at
    every round after a stage's first."""
    from repro_torch.core import freezing_cnn as fz
    import torch
    from repro_torch.models.module import tree_leaves
    n = 0
    for i, stage in enumerate(stages):
        if i and stages[i - 1] == stage:
            _, active = fz.init_cnn_stage_active(
                model, params, stage, torch.Generator().manual_seed(0))
            n += 2 * len(tree_leaves(active.get("stages", active)))
    return n


def phase_policies(card):
    """The deadline and async-buffered policies and the engine's sequential
    escape hatch on full-width ResNet-18: ``phase_main_path``'s fleet,
    cohort, batch, top-k ratio and SGD, three ``SmartFreezeServer.run``s:

      1. deadline: ``DeadlineAggregation(factor=1.5)`` over
         ``AvailabilityTrace(0.9, 0.1, seed=0)`` with a quarter of the fleet
         20x slower (``benchmarks/run.py:sim_scale``'s straggler fleet and
         its Eq. 6 time model at 5e7 FLOPs a sample), schedule [2, 2, 2, 2];
      2. async: ``AsyncBufferedAggregation(buffer_size=4, concurrency=8)``
         with a watchdog at the fleet's median completion time and 3
         retries at backoff 2 (windows 1 to 8 x the median: the faster
         half never times out, so a client still in flight at a merge
         completes stale; the slowest, 6.2 x the median, finishes inside
         the last window, so nobody is dropped for good and every buffer
         fills), schedule [3, 3, 3, 3] (each stage's loop starts a fresh
         in-flight heap at version 0, so staleness needs a later tick in a
         stage);
      3. ``fused=False`` sync, schedule [1, 1, 1, 1].

    Counts set to 0 before each run and read after; B1's against the ticks
    (a sequential round or an async completion folds each client alone),
    B3's by ``phase_main_path``'s rule. One K = 1 fold of the path is held
    against its plain version for equal bits. Then a stage-0 round of the
    cohort runs fused and sequential in turns, and the sequential round
    is profiled for the device's idle share."""
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.fl.sim import (AsyncBufferedAggregation,
                                    AvailabilityTrace, DeadlineAggregation,
                                    FleetTimeModel)
    from repro_torch.kernels import block_perturb, ref, sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    clients, _ = _fleet(10_000, 20, 32, 10)
    stragglers = [dataclasses.replace(
        c, capability=0.05e9 if c.client_id % 4 == 0 else 1e9)
        for c in clients]
    times = [c.num_samples / c.capability for c in clients]
    timeout_s = float(np.median(times))
    print(f"policies: async watchdog timeout_s {timeout_s!r} (the fleet's "
          f"median |D_i| / c_i), max_retries 3, backoff 2")
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    runs = [
        ("deadline", stragglers, [2, 2, 2, 2], dict(
            aggregation=DeadlineAggregation(factor=1.5),
            availability=AvailabilityTrace(p_available=0.9, p_dropout=0.1,
                                           seed=0),
            time_model=FleetTimeModel.from_clients(stragglers,
                                                   flops_per_sample=5e7))),
        ("async", clients, [3, 3, 3, 3], dict(
            aggregation=AsyncBufferedAggregation(
                buffer_size=4, concurrency=8, timeout_s=timeout_s,
                max_retries=3))),
        ("sequential (fused=False)", clients, [1, 1, 1, 1],
         dict(fused=False))]
    out, fold = {}, None
    t_runs = time.perf_counter()
    for name, fleet, schedule, kw in runs:
        srv = SmartFreezeServer(model, fleet, clients_per_round=COHORT,
                                batch_size=32, local_epochs=1,
                                compress_ratio=RATIO, seed=0, device="cuda",
                                **kw)
        torch.cuda.reset_peak_memory_stats()
        with _timed_observes() as observe_ms, _ticks() as ticks, \
                _first_single_fold() as kept:
            sparse_agg.launches = block_perturb.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = srv.run(params, state, schedule=schedule)
            torch.cuda.synchronize()
            b1, b3 = sparse_agg.launches, block_perturb.launches
        secs = time.perf_counter() - t0
        hist = res["history"]
        stages = [r.stage for r in hist]
        for (rec, tick_ms, _), o_ms, rr in zip(ticks, observe_ms, hist):
            print(f"{name} round {rec.round_idx} stage {rr.stage} loss "
                  f"{rr.loss:.4f} wall_ms {tick_ms + o_ms:.1f} "
                  f"pace_observe_ms {o_ms:.2f} selected {rec.selected} "
                  f"dropped {rec.dropped} staleness {rec.staleness} retries "
                  f"{rec.retries} sequential {rec.sequential} duration "
                  f"{rec.duration!r} virtual_time {rec.t_end!r}")
        want_b1 = _expected_fold_launches(model, res["params"], srv, ticks,
                                          stages)
        want_b3 = _expected_b3(model, res["params"], stages)
        print(f"{name}: {secs:.2f} s, torch.cuda.max_memory_allocated "
              f"{torch.cuda.max_memory_allocated()} on {card}; "
              f"sparse_cohort_add launches {b1} (expected {want_b1}), "
              f"diff_sqnorm launches {b3} (expected {want_b3})")
        assert stages == [s for s, n in enumerate(schedule)
                          for _ in range(n)], stages
        assert len(ticks) == len(hist)
        assert all(math.isfinite(r.loss) for r in hist), [r.loss for r in hist]
        leaves = tree_leaves(res["params"]) + tree_leaves(res["state"])
        assert all(l.device.type == "cuda" for l in leaves)
        assert all(bool(torch.isfinite(l).all()) for l in leaves)
        assert b1 == want_b1 > 0, (b1, want_b1)
        assert b3 == want_b3, (b3, want_b3)
        recs = [rec for rec, _, _ in ticks]
        if name == "deadline":
            # late for certain: its dropout draw spares it; a dropout for
            # certain: it finished by the 1.5 x median deadline
            late = dropouts = 0
            for rec, _, loop in ticks:
                sel = rec.selected + rec.dropped
                t = loop.times(sel, rec.round_idx)
                cut = 1.5 * float(np.median([t[c] for c in sel] or [0.0]))
                late += sum(not loop.dropouts([c], rec.round_idx)
                            for c in rec.dropped)
                dropouts += sum(t[c] <= cut for c in rec.dropped)
            print(f"deadline: {late} clients trimmed late, {dropouts} "
                  f"dropped out")
            assert late > 0, "no deadline round trimmed a client"
            assert dropouts > 0, "no client dropped out"
            assert any(r.sequential for r in recs)
        if name == "async":
            assert any(r.retries for r in recs), "no watchdog retry fired"
            assert any(v > 0 for r in recs for v in r.staleness.values())
            assert all(len(r.selected) == 4 for r in recs)
        if name.startswith("sequential"):
            assert all(r.sequential is False and r.selected for r in recs)
        if fold is None and kept:
            fold = kept
        out[name] = (b1, b3)
    # one K = 1 fold of the path against its plain version: one addend an
    # output (top-k indices are unique, the weight is 1), so equal bits
    want = ref.sparse_cohort_add_ref(fold["idx"], fold["vals"], fold["w"],
                                     fold["L"])
    assert torch.equal(fold["out"], want)
    print(f"K = 1 fold of the path (L {fold['L']}, k {fold['idx'].shape[1]}) "
          f"== plain version, bit for bit")
    # where a sequential round's time goes: stage 0, COHORT clients, timed
    # against the fused round of the same cohort in turns (fused,
    # sequential, sequential, fused), then profiled (phase_profile
    # profiles the fused round of this cohort)
    t_prof = time.perf_counter()
    srv = SmartFreezeServer(model, clients, clients_per_round=COHORT,
                            batch_size=32, compress_ratio=RATIO,
                            device="cuda")
    frozen, active = fz.init_cnn_stage_active(
        model, params, 0, torch.Generator().manual_seed(0))
    engine = srv._stage_engine(0, frozen, state)
    cohort = list(range(COHORT))

    def one_round(r, seq):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_round(srv.clients, cohort, active, state, r,
                         sequential=seq)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    one_round(0, True)
    walls = {False: [], True: []}
    for r, seq in enumerate((False, True, True, False), start=1):
        walls[seq].append(one_round(r, seq))
    steps = sum(c.num_samples // 32 for c in clients[:COHORT])
    print(f"stage 0, {steps} local steps, in turns: fused round wall_ms "
          f"{walls[False][0]:.1f}, {walls[False][1]:.1f}; sequential "
          f"{walls[True][0]:.1f}, {walls[True][1]:.1f} on {card}")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round(9, True)
    by_class = _device_us_by_class(prof)
    if by_class:
        busy_ms = sum(by_class.values()) / 1e3
        print(f"profile sequential stage 0: device busy ms {busy_ms:.1f}, "
              f"idle share {1 - busy_ms / np.mean(walls[True]):.3f} (of "
              f"its mean wall)")
        for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"  {cls:>20}: {us / 1e3:9.2f} ms")
    else:
        print("profile sequential stage 0: torch.profiler recorded no "
              "device time: not measured")
    print(f"policies phase seconds: runs {t_prof - t_runs:.1f}, fused and "
          f"sequential rounds {time.perf_counter() - t_prof:.1f}")
    return out


POLICY_TOL = dict(rtol=1e-3, atol=1e-5)


def phase_small_policies_reference():
    """The policies on the card against the port's CPU path (itself held
    against the JAX package by tests/test_torch_policies.py), on
    ``phase_small_reference``'s small model with client 0 20x slower:
    deadline (factor 1.5) over ``AvailabilityTrace(0.9, 0.25, seed=0)``,
    and async (buffer 2, concurrency 3, a watchdog at the fleet's second
    fastest time), schedule [2, 1], ratio 1.0. The loop's records
    (selected, dropped, staleness, retries, sequential) equal; losses,
    params and BN state rtol 1e-3, atol 1e-5; the virtual clock rtol
    1e-6."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.fl.sim import (AsyncBufferedAggregation,
                                    AvailabilityTrace, DeadlineAggregation)
    from repro_torch.kernels import sparse_agg
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.models.module import tree_leaves
    cfg = CNNConfig("small", "resnet", stage_sizes=(1, 1),
                    stage_channels=(8, 16), num_classes=4)
    clients, _ = _fleet(256, 4, 16, 4)
    clients = [dataclasses.replace(c, capability=c.capability / 20.0)
               if c.client_id == 0 else c for c in clients]
    times = sorted(c.num_samples / c.capability for c in clients)
    params, state = CNN(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    policies = {
        "deadline": lambda: dict(
            aggregation=DeadlineAggregation(factor=1.5),
            availability=AvailabilityTrace(0.9, 0.25, seed=0)),
        "async": lambda: dict(aggregation=AsyncBufferedAggregation(
            buffer_size=2, concurrency=3, timeout_s=times[1],
            max_retries=1))}
    for name, kw in policies.items():
        results = {}
        for device in ("cpu", "cuda"):
            srv = SmartFreezeServer(CNN(cfg, device=device), clients,
                                    clients_per_round=3, batch_size=16,
                                    compress_ratio=1.0, seed=0,
                                    device=device, **kw())
            before = sparse_agg.launches
            with _ticks() as ticks:
                out = srv.run(to_torch(to_numpy(params), device),
                              to_torch(to_numpy(state), device),
                              schedule=[2, 1])
            if device == "cuda":
                assert sparse_agg.launches > before
            results[device] = (out, [rec for rec, _, _ in ticks])
        (c_out, c_recs), (g_out, g_recs) = results["cpu"], results["cuda"]
        assert len(c_recs) == len(g_recs) == 3
        for a, b in zip(c_recs, g_recs):
            assert (a.selected, a.dropped, a.staleness, a.retries,
                    a.sequential) == (b.selected, b.dropped, b.staleness,
                                      b.retries, b.sequential), (a, b)
            assert list(a.losses) == list(b.losses)
            np.testing.assert_allclose(list(b.losses.values()),
                                       list(a.losses.values()), **POLICY_TOL)
            np.testing.assert_allclose([b.duration, b.t_end],
                                       [a.duration, a.t_end], rtol=1e-6)
        for a, b in zip(tree_leaves(c_out["params"]) + tree_leaves(
                c_out["state"]), tree_leaves(g_out["params"])
                + tree_leaves(g_out["state"])):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       **POLICY_TOL)
        print(f"small model, {name}: card == CPU path, records "
              f"{[(r.selected, r.dropped, r.staleness, r.retries, r.sequential) for r in g_recs]}")


TABLE1_MEMORY = ([0.35, 0.5, 0.7, 0.9], [0.3, 0.3, 0.25, 0.15])
BASELINE_PROFILE_SAMPLES = 160


def _table1_memory(clients, full_mem):
    """``benchmarks/run.py:tab1_fl_accuracy``'s memory rule: each client
    holds ``full_mem`` times one of {0.35, 0.5, 0.7, 0.9}, drawn with
    ``RandomState(7)``, so that no client holds the full model."""
    import dataclasses
    import numpy as np
    rng = np.random.RandomState(7)
    return [dataclasses.replace(c, memory_bytes=full_mem * rng.choice(
        TABLE1_MEMORY[0], p=TABLE1_MEMORY[1])) for c in clients]


class _uplinks:
    """Inside the ``with``, the uplink bytes each round index sent,
    summed over the ``RoundEngine.run_round`` calls of that round (one a
    depth or scale group in DepthFL and HeteroFL)."""

    def __enter__(self):
        from repro_torch.fl import engine
        self.cls, self.fn = engine.RoundEngine, engine.RoundEngine.run_round
        log = {}

        def run_round(eng, clients, selected, params, state, round_idx, **kw):
            out = self.fn(eng, clients, selected, params, state, round_idx,
                          **kw)
            log[round_idx] = log.get(round_idx, 0) + eng.last_uplink_bytes
            return out
        self.cls.run_round = run_round
        return log

    def __exit__(self, *exc):
        self.cls.run_round = self.fn


def _expected_baseline_folds(ticks, leaves, group_of=None, sequential=False):
    """B1 launches a baseline run's ticks imply: a fused round folds once a
    leaf for each engine group (depth group in DepthFL, scale group in
    HeteroFL, else one), a sequential round once a leaf for each client
    trained. Every group's trained tree has ``leaves`` leaves."""
    n = 0
    for rec, _, _ in ticks:
        if sequential or rec.sequential:
            n += leaves * len(rec.selected)
        elif rec.selected:
            n += leaves * len({(group_of or {}).get(c) for c in rec.selected})
    return n


def phase_baselines(card):
    """The paper's baselines on full-width ResNet-18 (``phase_main_path``'s
    fleet, cohort, batch, top-k ratio and SGD, two rounds a run), over two
    fleets:

      A. Table 1's memory rule on this model's ``full_model_memory``
         (``_table1_memory``): nobody holds the full model, so AllSmall
         scales it down, HeteroFL splits the cohort into scale groups,
         DepthFL into depth groups, and ExclusiveFL, TiFL and Oort are
         inoperative;
      B. the fleet's own 2-8 GiB: ExclusiveFL, TiFL (one tier a round),
         Oort and ``FedAvgServer`` under sync; ``FedAvgServer`` also with
         ``fused=False`` and under ``DeadlineAggregation(factor=1.5)`` over
         ``phase_policies``' straggler fleet and time model.

    Each run prints its round walls (host clock, a synchronize on each
    side), losses, participation, uplink bytes, virtual time and peak
    device memory; B1's count is set to 0 before it and held after against
    the rounds (``_expected_baseline_folds``). One K = 1 fold of the path
    equals its plain version bit for bit, and so does one cohort fold
    against the plain version run on the CPU. Then one ExclusiveFL round
    over the cohort's shards cut to ``BASELINE_PROFILE_SAMPLES`` is
    profiled."""
    import collections
    import dataclasses
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl import baselines as B
    from repro_torch.fl.server import FedAvgServer
    from repro_torch.fl.sim import (DeadlineAggregation, FleetTimeModel,
                                    SyncAggregation)
    from repro_torch.kernels import ref, sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    clients, _ = _fleet(10_000, 20, 32, 10)
    model = CNN(RESNET18, device="cuda")
    full_mem = B.full_model_memory(model, 32)
    fleet_a = _table1_memory(clients, full_mem)
    stragglers = [dataclasses.replace(
        c, capability=0.05e9 if c.client_id % 4 == 0 else 1e9)
        for c in clients]
    depths = B.depthfl_depths(model, fleet_a, 32)
    scales = B.heterofl_scales(RESNET18, fleet_a, 32)
    mults = [round(float(c.memory_bytes / full_mem), 2) for c in fleet_a]
    print(f"baselines: full_model_memory {full_mem!r} bytes at batch 32; "
          f"fleet A memory x {mults}; fleet B memory "
          f"{sorted({c.memory_bytes for c in clients})}")
    print(f"fleet A depth groups "
          f"{dict(collections.Counter(depths.values()))}, scale groups "
          f"{dict(collections.Counter(scales.values()))}")
    common = dict(rounds=2, batch_size=32, clients_per_round=COHORT,
                  compress_ratio=RATIO, seed=0, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))

    def fedavg(fleet, **kw):
        srv = FedAvgServer(model, fleet, clients_per_round=COHORT,
                           batch_size=32, compress_ratio=RATIO, seed=0,
                           device="cuda", **kw)
        out = srv.run(params, state, rounds=2)
        return dict(out, model=model, fused=srv.fused)

    runs = [
        ("allsmall", lambda: B.run_allsmall(RESNET18, fleet_a, **common),
         None),
        ("heterofl", lambda: B.run_heterofl(RESNET18, fleet_a, **common),
         scales),
        ("depthfl", lambda: B.run_depthfl(RESNET18, fleet_a, **common),
         depths),
        ("exclusivefl inoperative",
         lambda: B.run_exclusivefl(RESNET18, fleet_a, **common), None),
        ("tifl inoperative", lambda: B.run_tifl(RESNET18, fleet_a, **common),
         None),
        ("oort inoperative", lambda: B.run_oort(RESNET18, fleet_a, **common),
         None),
        ("exclusivefl", lambda: B.run_exclusivefl(RESNET18, clients,
                                                  **common), None),
        ("tifl", lambda: B.run_tifl(RESNET18, clients, **common), None),
        ("oort", lambda: B.run_oort(RESNET18, clients, **common), None),
        ("fedavg", lambda: fedavg(clients), None),
        ("fedavg sequential (fused=False)",
         lambda: fedavg(clients, fused=False), None),
        ("fedavg deadline", lambda: fedavg(
            stragglers, aggregation=DeadlineAggregation(factor=1.5),
            time_model=FleetTimeModel.from_clients(stragglers,
                                                   flops_per_sample=5e7)),
         None)]
    launches = {}
    t_runs = time.perf_counter()
    with _first_single_fold() as single, \
            _first_single_fold(cohort=True) as cohort:
        for name, run, group_of in runs:
            torch.cuda.reset_peak_memory_stats()
            with _ticks() as ticks, _uplinks() as uplink:
                sparse_agg.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = run()
                torch.cuda.synchronize()
                b1 = sparse_agg.launches
            secs = time.perf_counter() - t0
            if name.endswith("inoperative"):
                print(f"{name}: inoperative {out.get('inoperative')}, "
                      f"participation {out['participation']!r}")
                assert out.get("inoperative") is True and b1 == 0, (name, b1)
                continue
            hist = out["history"]
            for (rec, tick_ms, _), rr in zip(ticks, hist):
                print(f"{name} round {rec.round_idx} loss {rr.loss:.4f} "
                      f"wall_ms {tick_ms:.1f} selected "
                      f"{[int(c) for c in rec.selected]} dropped "
                      f"{[int(c) for c in rec.dropped]} sequential "
                      f"{rec.sequential} "
                      f"uplink_bytes {uplink.get(rec.round_idx, 0)} "
                      f"duration {rec.duration!r} virtual_time "
                      f"{rec.t_end!r}")
            leaves = len(tree_leaves(out["params"]))
            want = _expected_baseline_folds(
                ticks, leaves, group_of,
                sequential=out.get("fused") is False)
            extra = (f", scale {out['scale']}" if "scale" in out else "")
            print(f"{name}: {secs:.2f} s, participation "
                  f"{out['participation']!r}{extra}, "
                  f"torch.cuda.max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated()} on {card}; "
                  f"sparse_cohort_add launches {b1} (expected {want})")
            assert len(ticks) == len(hist) == 2, (name, len(hist))
            assert all(math.isfinite(r.loss) for r in hist), name
            leaves_all = tree_leaves(out["params"]) + tree_leaves(out["state"])
            assert all(l.device.type == "cuda" for l in leaves_all)
            assert all(bool(torch.isfinite(l).all()) for l in leaves_all)
            assert b1 == want > 0, (name, b1, want)
            recs = [rec for rec, _, _ in ticks]
            if name == "allsmall":
                assert out["scale"] < 1
            if name == "heterofl":
                assert len(set(scales.values())) > 1
            if name == "tifl":
                times = {c.client_id: c.num_samples / c.capability
                         for c in clients}
                first, second = ([times[c] for c in r.selected]
                                 for r in recs)
                assert max(first) <= min(second)  # one tier a round
            if name.startswith("fedavg sequential"):
                assert all(r.selected for r in recs)
            if name == "fedavg deadline":
                assert all(r.sequential for r in recs)
                assert any(r.dropped for r in recs)
            launches[name] = b1
    assert torch.equal(single["out"], ref.sparse_cohort_add_ref(
        single["idx"], single["vals"], single["w"], single["L"]))
    print(f"K = 1 fold of the path (L {single['L']}, k "
          f"{single['idx'].shape[1]}) == plain version, bit for bit")
    assert torch.equal(cohort["out"].cpu(), _fold_cpu(
        cohort["idx"], cohort["vals"], cohort["w"], cohort["L"]))
    print(f"K = {cohort['idx'].shape[0]} fold of the path (L "
          f"{cohort['L']}) == plain version on the CPU, bit for bit")
    # where an ExclusiveFL round's time goes, on the cohort's shards cut
    # to BASELINE_PROFILE_SAMPLES (5 steps a client: a full round's
    # 135,000 kernels take the profiler's parser minutes): round 1 timed,
    # round 2 profiled for its kernels alone (round 0 warms cuDNN and the
    # allocator)
    t_prof = time.perf_counter()
    cut = [dataclasses.replace(c, data={
        k: v[:BASELINE_PROFILE_SAMPLES] for k, v in c.data.items()})
        for c in clients]
    tick = SyncAggregation.tick
    by_class = {}

    def profiled(policy, loop, r):
        if r != 2:
            return tick(policy, loop, r)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            rec = tick(policy, loop, r)
            torch.cuda.synchronize()
        for cls, us in _device_us_by_class(prof).items():
            by_class[cls] = by_class.get(cls, 0.0) + us
        return rec

    SyncAggregation.tick = profiled
    try:
        with _ticks() as ticks:
            B.run_exclusivefl(RESNET18, cut, **dict(common, rounds=3))
    finally:
        SyncAggregation.tick = tick
    wall_ms = ticks[1][1]
    steps = sum(cut[c].num_samples // 32 for c in ticks[1][0].selected)
    print(f"exclusivefl round 1 (shards cut to {BASELINE_PROFILE_SAMPLES} "
          f"samples): {steps} local steps, wall_ms {wall_ms:.1f} on {card}")
    if by_class:
        busy_ms = sum(by_class.values()) / 1e3
        print(f"profile exclusivefl round 2 (the same cut): device busy ms "
              f"{busy_ms:.1f}, idle share {1 - busy_ms / wall_ms:.3f} (of "
              f"round 1's wall)")
        for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"  {cls:>20}: {us / 1e3:9.2f} ms")
    else:
        print("profile exclusivefl: torch.profiler recorded no device time: "
              "not measured")
    print(f"baselines phase seconds: runs {t_prof - t_runs:.1f}, profile "
          f"{time.perf_counter() - t_prof:.1f}")
    return launches


def phase_small_baselines_reference(rounds=12):
    """Table 1's own configuration (``benchmarks/run.py:tab1_fl_accuracy``:
    16 clients over 2,000 16x16 samples of 8 classes, the high-contention
    pool under ``_table1_memory``, a (1, 1)-stage ResNet of widths
    (12, 24), 5 clients a round, batch 32, ``fused=False``): the six
    runners for 2 rounds on the card and in the port on the CPU (itself
    held against the JAX package by tests/test_torch_baselines.py), with
    selections, durations and participation equal and losses, params and
    BN state within rtol 1e-3, atol 1e-5; then Table 1's ``rounds`` rounds
    on the card alone, SmartFreeze with them, and the test accuracy of
    each printed as ``tab1_fl_accuracy`` prints its row."""
    import numpy as np
    import torch
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import SyntheticVision
    from repro_torch.fl import baselines as B
    from repro_torch.fl.client import make_client_fleet
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.models.module import tree_leaves
    sv = SyntheticVision(num_classes=8, image_size=16)
    train = sv.sample(2000, seed=1)
    test = sv.sample(400, seed=2)
    parts = dirichlet_partition(train["y"], 16, alpha=1.0, seed=0)
    cfg = CNNConfig("rn", "resnet", stage_sizes=(1, 1),
                    stage_channels=(12, 24), num_classes=8)
    clients = _table1_memory(
        make_client_fleet(train, parts, scenario="high", seed=0),
        B.full_model_memory(CNN(cfg, device="cpu"), 32))
    names = ["allsmall", "exclusivefl", "heterofl", "oort", "tifl",
             "depthfl"]
    kw = dict(batch_size=32, clients_per_round=5, fused=False)
    for name in names:
        run = getattr(B, f"run_{name}")
        c_out = run(cfg, clients, rounds=2, device="cpu", **kw)
        g_out = run(cfg, clients, rounds=2, device="cuda", **kw)
        assert set(c_out) == set(g_out), name
        assert c_out["participation"] == g_out["participation"], name
        assert c_out.get("scale") == g_out.get("scale"), name
        assert len(c_out["history"]) == len(g_out["history"]), name
        for a, b in zip(c_out["history"], g_out["history"]):
            assert (a.selected, a.dropped, a.duration, a.virtual_time) == \
                (b.selected, b.dropped, b.duration, b.virtual_time), name
            np.testing.assert_allclose(b.loss, a.loss, **POLICY_TOL)
        if "params" in c_out:
            for a, b in zip(tree_leaves(c_out["params"])
                            + tree_leaves(c_out["state"]),
                            tree_leaves(g_out["params"])
                            + tree_leaves(g_out["state"])):
                np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                           **POLICY_TOL)
        print(f"small baselines, {name}: card == CPU path "
              f"({'inoperative' if c_out.get('inoperative') else 'trained'},"
              f" participation {g_out['participation']!r}, selected "
              f"{[[int(c) for c in r.selected] for r in g_out['history']]})")
    tx = torch.as_tensor(test["x"], device="cuda")
    ty = torch.as_tensor(test["y"], device="cuda")

    def accuracy(model, p, s):
        with torch.no_grad():
            logits, _ = model.apply(p, s, tx, train=False)
        return float((logits.argmax(-1) == ty).float().mean())

    t0 = time.perf_counter()
    results = {}
    model = CNN(cfg, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    srv = SmartFreezeServer(model, clients, clients_per_round=5,
                            batch_size=32, rounds_per_stage=rounds // 2,
                            fused=False, device="cuda",
                            pace_kwargs=dict(min_rounds=3, mu=2,
                                             slope_lambda=3e-2))
    out = srv.run(params, state)
    results["smartfreeze"] = round(accuracy(model, out["params"],
                                            out["state"]), 3)
    for name in names:
        out = getattr(B, f"run_{name}")(cfg, clients, rounds=rounds,
                                        device="cuda", **kw)
        if out.get("inoperative"):
            results[name] = "NA(inoperative)"
        else:
            results[name] = round(accuracy(out["model"], out["params"],
                                           out["state"]), 3)
    us = (time.perf_counter() - t0) * 1e6
    print(f"tab1_fl_accuracy,{us:.1f},{str(results).replace(',', ';')} "
          f"(port on the card, {rounds} rounds)")
    assert all(v == "NA(inoperative)" if isinstance(v, str)
               else math.isfinite(v) for v in results.values()), results
    assert [k for k, v in results.items() if isinstance(v, str)] == \
        ["exclusivefl", "oort", "tifl"], results


FAULT_PACE = dict(min_rounds=3, mu=1, slope_lambda=10.0)


class _stage_starts:
    """Inside the ``with``: every ``fz.merge_cnn_params`` result, cloned
    as it is made (a freeze's snapshot), and the (stage, params) that each
    stage starts from."""

    def __enter__(self):
        from repro_torch.core import freezing_cnn as fz
        from repro_torch.models.module import tree_map
        self.fz, self.saved = fz, (fz.merge_cnn_params,
                                   fz.init_cnn_stage_active)
        merge, init = self.saved
        log = {"merged": [], "starts": []}

        def merged(*a):
            out = merge(*a)
            log["merged"].append((out, tree_map(lambda t: t.clone(), out)))
            return out

        def started(model, params, stage, *a, **k):
            log["starts"].append((stage, params))
            return init(model, params, stage, *a, **k)
        fz.merge_cnn_params, fz.init_cnn_stage_active = merged, started
        return log

    def __exit__(self, *exc):
        self.fz.merge_cnn_params, self.fz.init_cnn_stage_active = self.saved


def phase_faults(card):
    """Fault injection, update screening, the robust aggregators and freeze
    rollback on full-width ResNet-18: ``phase_policies``' straggler fleet
    (a quarter 20x slower, the Eq. 6 time model at 5e7 FLOPs a sample),
    ``COHORT`` clients a round, batch 32, SGD 0.05.

      a. ``SmartFreezeServer.run`` under ``DeadlineAggregation(1.5)`` with
         ``screen_updates=True`` and ``FaultInjector(p_fault=0.3,
         kinds=("nan", "inf", "amplify"))``, schedule [2, 2, 2, 2]: a
         client screened, every param finite after every round, B3 by
         ``phase_main_path``'s rule;
      b. one stage-0 round of the cohort with client 0's update
         sign-flipped under ``trimmed_mean`` and ``coord_median``, fused
         and ``fused=False`` (deterministic cuDNN): the two routes agree
         within rtol 1e-3, atol 1e-5; then the same call's undefended
         fused round, screened fused round and screened round with a NaN
         client, three each, in turns;
      c. ``freeze_rollback=True`` with a pace controller that freezes
         stage 0 after its fourth round (``FAULT_PACE``), a guard band
         below any loss and ``rollback_patience=1``, ``total_rounds=7``:
         the first stage-1 round rolls the freeze back, and stage 0
         restarts from params ``torch.equal`` to its freeze-time snapshot;
      d. top-k 0.1 uplinks under ``FaultInjector(p_fault=0.3,
         kinds=("crash", "hang"))``, sync (the plain fleet, schedule
         [2, 2, 2, 2]) and async (buffer 4, concurrency 8, watchdog at the
         median, 3 retries, [2, 2, 2, 2]): B1's count from the ticks (a
         crashed round folds only its survivors), one K > 1 fold equal
         to its plain version on the CPU bit for bit, a watchdog retry.

    Counts set to 0 before each run and read after."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.faults import FaultInjector
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.fl.sim import (AsyncBufferedAggregation,
                                    DeadlineAggregation, FleetTimeModel)
    from repro_torch.kernels import block_perturb, ref, sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    t_phase = time.perf_counter()
    clients, _ = _fleet(10_000, 20, 32, 10)
    stragglers = [dataclasses.replace(
        c, capability=0.05e9 if c.client_id % 4 == 0 else 1e9)
        for c in clients]
    deadline = lambda: dict(  # noqa: E731
        aggregation=DeadlineAggregation(factor=1.5),
        time_model=FleetTimeModel.from_clients(stragglers,
                                               flops_per_sample=5e7))
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    out = {}

    def finite(tree):
        return all(bool(torch.isfinite(t).all()) for t in tree_leaves(tree))

    def run(name, fleet, kw, **run_kw):
        srv = SmartFreezeServer(model, fleet, clients_per_round=COHORT,
                                batch_size=32, seed=0, device="cuda", **kw)
        with _ticks() as ticks:
            sparse_agg.launches = block_perturb.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = srv.run(params, state, **run_kw)
            torch.cuda.synchronize()
            b1, b3 = sparse_agg.launches, block_perturb.launches
        secs = time.perf_counter() - t0
        hist = res["history"]
        for (rec, tick_ms, _), rr in zip(ticks, hist):
            print(f"faults {name} round {rec.round_idx} stage {rr.stage} "
                  f"loss {rr.loss:.4f} wall_ms {tick_ms:.1f} selected "
                  f"{rec.selected} dropped {rec.dropped} faults {rec.faults} "
                  f"screened {rr.screened} rolled_back {rr.rolled_back} "
                  f"frozen {rr.frozen} retries {rec.retries} sequential "
                  f"{rec.sequential}")
        stages = [r.stage for r in hist]
        want_b3 = _expected_b3(model, res["params"], stages)
        print(f"faults {name}: {secs:.2f} s on {card}; sparse_cohort_add "
              f"launches {b1}, diff_sqnorm launches {b3} (expected "
              f"{want_b3})")
        assert len(ticks) == len(hist)
        assert b3 == want_b3, (name, b3, want_b3)
        assert finite(res["params"]) and finite(res["state"]), name
        assert all(l.device.type == "cuda"
                   for l in tree_leaves(res["params"]))
        return srv, res, ticks, b1, b3

    # a. screening under NaN, Inf and amplified updates, deadline policy
    checked = []

    def eval_fn(p, s, stage):
        assert finite(p) and finite(s), "a non-finite param after a round"
        checked.append(stage)
        return 0.0

    _, res, ticks, b1, b3 = run(
        "screened deadline", stragglers, dict(
            screen_updates=True, faults=FaultInjector(
                p_fault=0.3, kinds=("nan", "inf", "amplify"), seed=0),
            **deadline()),
        schedule=[2, 2, 2, 2], eval_fn=eval_fn, eval_every=1)
    hist = res["history"]
    screened = [c for r in hist for c in r.screened]
    kinds = [k for rec, _, _ in ticks for k in rec.faults.values()]
    print(f"faults screened deadline: faults drawn {kinds}, screened "
          f"{screened}")
    assert screened, "no client was screened"
    assert len(checked) == len(hist) == 8
    assert b1 == 0
    out["resnet18 screened deadline"] = (b1, b3)

    # b. signflip under the robust aggregators, fused and sequential; the
    # same call's undefended and screened fused rounds in turns
    srv = SmartFreezeServer(model, clients, clients_per_round=COHORT,
                            batch_size=32, device="cuda")
    frozen, active = fz.init_cnn_stage_active(
        model, params, 0, torch.Generator().manual_seed(0))
    engine = srv._stage_engine(0, frozen, state)
    cohort = list(range(COHORT))

    def one_round(r, seq=False, faults=None, **defense):
        for k, v in dict(dict(screen=False, aggregator="mean"),
                         **defense).items():
            setattr(engine, k, v)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p, s, losses = engine.run_round(srv.clients, cohort, active, state,
                                        r, sequential=seq, faults=faults)
        torch.cuda.synchronize()
        return p, s, (time.perf_counter() - t0) * 1e3

    # cuDNN's default convolution backward sums with atomics, so two runs
    # of the same local training part by a few ulps, and a robust combine
    # passes one client's value through per coordinate; deterministic
    # algorithms make the two routes train alike, so what is compared is
    # the routes' robust combine
    flip = {cohort[0]: "signflip"}
    torch.backends.cudnn.deterministic = True
    for agg in ("trimmed_mean", "coord_median"):
        pf, sf, ms_f = one_round(1, False, flip, aggregator=agg)
        ps, ss, ms_s = one_round(1, True, flip, aggregator=agg)
        worst = 0.0
        for a, b in zip(tree_leaves(pf) + tree_leaves(sf),
                        tree_leaves(ps) + tree_leaves(ss)):
            torch.testing.assert_close(a, b, **POLICY_TOL)
            worst = max(worst, float((a - b).abs().max()))
        assert finite(pf) and finite(ps)
        print(f"faults signflip round, {agg}: fused wall_ms {ms_f:.1f}, "
              f"sequential {ms_s:.1f} (deterministic cuDNN); fused == "
              f"sequential within rtol 1e-3, atol 1e-5 (max_abs_diff "
              f"{worst:.3e}) on {card}")
    torch.backends.cudnn.deterministic = False
    walls = {"undefended": [], "screened": [], "screened, 1 NaN": []}
    order = ["undefended", "screened", "screened, 1 NaN", "screened, 1 NaN",
             "screened", "undefended", "undefended", "screened",
             "screened, 1 NaN"]
    for r, name in enumerate(order, start=2):
        walls[name].append(one_round(
            r, faults={cohort[0]: "nan"} if "NaN" in name else None,
            screen=name != "undefended")[2])
    steps = sum(c.num_samples // 32 for c in clients[:COHORT])
    print(f"faults stage-0 fused round, {steps} local steps, in turns: "
          + "; ".join(f"{k} wall_ms " + ", ".join(f"{w:.1f}" for w in v)
                      for k, v in walls.items()) + f" on {card}")

    # c. freeze rollback
    with _stage_starts() as log:
        srv, res, ticks, b1, b3 = run(
            "rollback deadline", stragglers, dict(
                freeze_rollback=True, rollback_guard=-1e9,
                rollback_patience=1, pace_kwargs=FAULT_PACE, **deadline()),
            total_rounds=7)
    hist = res["history"]
    assert [r.stage for r in hist] == [0, 0, 0, 0, 1, 0, 1], \
        [r.stage for r in hist]
    assert hist[3].frozen and hist[4].rolled_back and srv.rollbacks == 1
    # the run's own stage starts (``_expected_b3`` makes more after it)
    starts = log["starts"][:6]
    assert [s for s, _ in starts] == [0, 1, 0, 1, 2, 3], [
        s for s, _ in starts]
    snapshot = next(c for m, c in log["merged"] if m is starts[1][1])
    restored = starts[2][1]
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(restored),
                                                 tree_leaves(snapshot)))
    print(f"faults rollback: stage 0 froze after round 3, round 4 rolled "
          f"it back, stage 0 restarted from params torch.equal to its "
          f"freeze-time snapshot ({len(tree_leaves(snapshot))} leaves)")
    out["resnet18 rollback deadline"] = (b1, b3)

    # d. crash and hang with compressed uplinks: B1 folds the survivors
    crash = lambda: FaultInjector(  # noqa: E731
        p_fault=0.3, kinds=("crash", "hang"), seed=0)
    timeout_s = float(np.median([c.num_samples / c.capability
                                 for c in clients]))
    with _first_single_fold(cohort=True) as kept:
        for name, kw in (
                ("crash sync", dict(compress_ratio=RATIO, faults=crash())),
                ("crash async", dict(
                    compress_ratio=RATIO, faults=crash(),
                    aggregation=AsyncBufferedAggregation(
                        buffer_size=4, concurrency=8, timeout_s=timeout_s,
                        max_retries=3)))):
            srv, res, ticks, b1, b3 = run(name, clients, kw,
                                          schedule=[2, 2, 2, 2])
            stages = [r.stage for r in res["history"]]
            want = _expected_fold_launches(model, res["params"], srv, ticks,
                                           stages)
            lost = [c for rec, _, _ in ticks for c, k in rec.faults.items()
                    if k in ("crash", "hang")]
            print(f"faults {name}: crashed or hung {lost}; "
                  f"sparse_cohort_add launches {b1} (expected {want})")
            assert lost, name
            assert b1 == want > 0, (name, b1, want)
            if name == "crash async":
                assert any(rec.retries for rec, _, _ in ticks), \
                    "no watchdog retry fired"
            else:
                assert any(rec.faults and len(rec.selected) > 1
                           for rec, _, _ in ticks), "no crashed cohort fold"
            out[f"resnet18 {name}"] = (b1, b3)
    assert kept["idx"].shape[0] > 1
    assert torch.equal(kept["out"].cpu(), _fold_cpu(
        kept["idx"], kept["vals"], kept["w"], kept["L"]))
    print(f"faults: K = {kept['idx'].shape[0]} survivor fold of the path "
          f"(L {kept['L']}) == plain version on the CPU, bit for bit")
    print(f"faults phase seconds {time.perf_counter() - t_phase:.1f}")
    return out


def phase_small_faults_reference():
    """The defenses on the card against the port's CPU path (itself held
    against the JAX package by tests/test_torch_rollback.py and
    tests/test_torch_faults_loop.py), on ``phase_small_reference``'s small
    model: (1) ``fused=False`` with ``screen_updates``, faults (nan,
    amplify, signflip, crash at 0.3) and freeze rollback under
    ``FAULT_PACE`` with a guard below any loss, ``total_rounds=6``; (2)
    fused sync rounds at ratio 1.0 under crash and hang faults (the
    compressed uplink takes no screen or robust aggregator), schedule
    [2, 1].
    The loop's records (selected, dropped, faults) and the server's
    (screened, rolled_back) equal; losses, params and BN state rtol 1e-3,
    atol 1e-5."""
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.fl.faults import FaultInjector
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import sparse_agg
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.models.module import tree_leaves
    cfg = CNNConfig("small", "resnet", stage_sizes=(1, 1),
                    stage_channels=(8, 16), num_classes=4)
    clients, _ = _fleet(256, 4, 16, 4)
    params, state = CNN(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    runs = {
        "screened rollback": (lambda: dict(
            fused=False, screen_updates=True, freeze_rollback=True,
            rollback_guard=-100.0, rollback_patience=1,
            pace_kwargs=FAULT_PACE, faults=FaultInjector(
                p_fault=0.3, kinds=("nan", "amplify", "signflip", "crash"),
                seed=5)), dict(total_rounds=6)),
        "crash compressed": (lambda: dict(
            compress_ratio=1.0, faults=FaultInjector(
                p_fault=0.3, kinds=("crash", "hang"), seed=2)),
            dict(schedule=[2, 1]))}
    for name, (kw, run_kw) in runs.items():
        results = {}
        for device in ("cpu", "cuda"):
            srv = SmartFreezeServer(CNN(cfg, device=device), clients,
                                    clients_per_round=3, batch_size=16,
                                    seed=0, device=device, **kw())
            before = sparse_agg.launches
            with _ticks() as ticks:
                out = srv.run(to_torch(to_numpy(params), device),
                              to_torch(to_numpy(state), device), **run_kw)
            if device == "cuda" and "compress_ratio" in kw():
                assert sparse_agg.launches > before
            results[device] = (out, [rec for rec, _, _ in ticks])
        (c_out, c_recs), (g_out, g_recs) = results["cpu"], results["cuda"]
        assert len(c_recs) == len(g_recs) == len(c_out["history"])
        for a, b in zip(c_recs, g_recs):
            assert (a.selected, a.dropped, a.faults) == \
                (b.selected, b.dropped, b.faults), (a, b)
            np.testing.assert_allclose(list(b.losses.values()),
                                       list(a.losses.values()), **POLICY_TOL)
        for a, b in zip(c_out["history"], g_out["history"]):
            assert (a.stage, a.screened, a.rolled_back, a.frozen) == \
                (b.stage, b.screened, b.rolled_back, b.frozen), (a, b)
        for a, b in zip(tree_leaves(c_out["params"]) + tree_leaves(
                c_out["state"]), tree_leaves(g_out["params"])
                + tree_leaves(g_out["state"])):
            np.testing.assert_allclose(b.cpu().numpy(), a.numpy(),
                                       **POLICY_TOL)
        hist = g_out["history"]
        if name == "screened rollback":
            assert any(r.rolled_back for r in hist)
            assert any(r.screened for r in hist)
        print(f"small model, {name}: card == CPU path, records "
              f"{[(r.selected, r.dropped, r.faults) for r in g_recs]}, "
              f"screened {[r.screened for r in hist]}, rolled_back "
              f"{[r.rolled_back for r in hist]}")


RESUME_PACE = dict(min_rounds=3, mu=2, slope_lambda=0.5)
# the bf16 LM rerun (its backward sums with atomics): losses rtol 1e-2,
# perturbations rtol 1e-1
LM_RESUME_TOL = (1e-2, 1e-1)


class _Crash(Exception):
    pass


def _crash_after(n):
    """An ``eval_fn`` that raises on its (n + 1)-th call."""
    calls = {"n": 0}

    def eval_fn(p, s, stage):
        calls["n"] += 1
        if calls["n"] > n:
            raise _Crash()
        return 0.0
    return eval_fn


def _deep_clone(tree):
    """A copy of a checkpoint tree that shares no memory with it: tensors
    cloned where they live, numpy arrays copied."""
    import numpy as np
    import torch
    if isinstance(tree, dict):
        return {k: _deep_clone(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    return np.array(tree, copy=True)


class _saved_trees:
    """Inside the ``with``: (step, a deep clone of the tree as the saving
    run held it, metadata) of every ``CheckpointManager.save`` that
    ``keep(step, metadata)`` chooses, the wall ms of every save call, and
    the managers that saved."""

    def __init__(self, keep=lambda step, meta: True):
        self.keep = keep

    def __enter__(self):
        from repro_torch.checkpoint import ckpt
        self.cls = ckpt.CheckpointManager
        self.save = save = self.cls.save
        self.log, self.ms, self.managers = [], [], []

        def saved(mgr, step, tree, metadata=None):
            if mgr not in self.managers:
                self.managers.append(mgr)
            if self.keep(step, metadata):
                self.log.append((step, _deep_clone(tree),
                                 dict(metadata or {})))
            t0 = time.perf_counter()
            save(mgr, step, tree, metadata)
            self.ms.append((time.perf_counter() - t0) * 1e3)
        self.cls.save = saved
        return self

    def __exit__(self, *exc):
        self.cls.save = self.save


class _restored:
    """Inside the ``with``: what a resuming run restored, as it holds it:
    ``module``'s ``tree_like`` outputs in call order, the engine's residual
    pools after ``load_ef_state``, its cache after ``load_cache_state``,
    and the pace window's card tensors after ``_TensorWindow.load``."""

    def __init__(self, module):
        self.module = module

    def __enter__(self):
        from repro_torch.core import pace
        from repro_torch.fl import engine
        mod, eng, win = self.module, engine.RoundEngine, pace._TensorWindow
        self.saved = [(mod, "tree_like", mod.tree_like),
                      (eng, "load_ef_state", eng.load_ef_state),
                      (eng, "load_cache_state", eng.load_cache_state),
                      (win, "load", win.load)]
        got = {"trees": [], "pools": None, "cache": None, "window": None}
        like, load_ef, load_cache, load_win = (s[2] for s in self.saved)

        def tree_like(t, r):
            res = like(t, r)
            got["trees"].append(_deep_clone(res))
            return res

        def ef(e, tree):
            load_ef(e, tree)
            got["pools"] = [p.clone() for p in e._res_pool]

        def cache(e, tree):
            load_cache(e, tree)
            got["cache"] = dict(e._features)

        def window(w, *a):
            load_win(w, *a)
            got["window"] = ([t.clone() for t in w.ring],
                             None if w.anchor is None else w.anchor.clone(),
                             None if w.prev is None else w.prev.clone())
        mod.tree_like, eng.load_ef_state = tree_like, ef
        eng.load_cache_state, win.load = cache, window
        return got

    def __exit__(self, *exc):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def _trees_equal(a, b, what):
    """Every leaf of ``a`` ``torch.equal`` to ``b``'s; returns the count."""
    import torch
    from repro_torch.models.module import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb) > 0, (what, len(la), len(lb))
    for x, y in zip(la, lb):
        y = torch.as_tensor(y).to(x.device)
        assert x.dtype == y.dtype and torch.equal(x, y), what
    return len(la)


def _window_equal(window, pace_state):
    """The restored card window against the saved pace state's host
    arrays, bit for bit; returns the snapshots compared."""
    import numpy as np
    import torch
    ring, anchor, prev = window
    n = 0
    for t, a in zip(ring, np.asarray(pace_state["window"])):
        assert t.device.type == "cuda"
        assert torch.equal(t, torch.from_numpy(a).to(t.device))
        n += 1
    for t, key in ((anchor, "anchor"), (prev, "prev")):
        a = np.asarray(pace_state[key])
        if t is not None and a.size:
            assert t.device.type == "cuda"
            assert torch.equal(t, torch.from_numpy(a).to(t.device))
            n += 1
    assert n > 0
    return n


def _step_bytes(ckpt_dir, step):
    d = os.path.join(ckpt_dir, f"step_{step}")
    return sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))


def phase_resume(card):
    """Checkpoint and resume on the card (``checkpoint/ckpt.py``, the
    servers' ``ckpt_manager`` / ``ckpt_every`` / ``resume``, the LM
    trainer's ``ckpt_dir`` / ``resume``), with checkpoints written under
    ``build/resume_ckpt`` and removed after, and deterministic cuDNN
    through (d):

      a. full-width ResNet-18 on phase 4's fleet (20 clients, 6 a round,
         batch 32, SGD 0.05, top-k 0.1 with error feedback), a pace
         controller loose enough that stage 0 freezes (``RESUME_PACE``),
         ``total_rounds=9``: a run without a break, then one with the
         async ``CheckpointManager`` every round, crashed by ``eval_fn`` in
         round 2, and a fresh server resuming it. Every restored tensor
         (stage base, active tree, BN state, residual pools, the pace
         window on the card) ``torch.equal`` to what the crashed run held
         when it saved; every round's cohort, loss, perturbation and
         freeze, and the final params and BN state, ``torch.equal`` to the
         unbroken run's, and so are a second unbroken run's (B1 sums in a
         fixed order, cuDNN is deterministic); B1 by
         ``_expected_fold_launches``, B3 by the main path's rule with the
         resumed run's first round continuing its restored window. Then a
         run with async saves every round and one without, in turns with
         the first: round walls, the bytes of a stage-0 and a stage-3 step,
         and synchronous save and restore walls of those steps;
      b. (a)'s setup with ``fused=False`` (B1 at K = 1), 6 rounds: the
         resumed trajectory ``torch.equal`` to the unbroken one;
      c. full-width ResNet-18 over 8 clients of 250 samples each
         (CIFAR-10's 50,000 cut so that a round stays near a second), all 8
         a round, ``cache_tiers="all"`` under the reference test's memory
         rule (int8, fp16, f32 and a declined client), schedule [1, 2, 1,
         1], crashed in stage 1's second round: the restored cache's codes,
         fp16 values, int8 scales and tiers ``torch.equal`` to the saved
         ones; the cohorts, cache bytes and losses equal the unbroken
         run's, the final params and BN state ``torch.equal``;
      d. ``FedAvgServer`` (``fused=False``, top-k 0.1) on (c)'s fleet, 3
         a round: 4 rounds against 2 checkpointed and a resume to 4, equal
         selections from the restored rng stream, losses and params within
         ``POLICY_TOL``;
      e. ``launch/train.py:train`` at Llama-3-8B width (d_model 4096, GQA
         32/8 of 128, vocab 128,256, bf16, ``use_pallas``) with its depth
         cut to 4 layers (a full-depth save holds 16 GB of merged bf16
         params) in 2 freeze blocks, 2 stages x 3 rounds of batch 4 x 1024
         tokens, saving every second round, crashed in stage 0's third
         round (resumed mid-stage, 4 rounds to go): the
         restored merged params, active tree and pace window
         ``torch.equal`` to the saved ones, the resumed losses and
         perturbations within ``LM_RESUME_TOL`` of the unbroken run's, B4
         and B3 counted;
      f. the small CNN: a card checkpoint continued on the CPU and a CPU
         checkpoint continued on the card, each within ``POLICY_TOL`` of
         the other and of an unbroken CPU run.

    Returns {path: (B1 or B4 launches, B3 launches)} of the resumed runs."""
    import dataclasses
    import shutil
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.checkpoint import (CheckpointManager, restore_checkpoint,
                                        save_checkpoint)
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.core.memory_model import cnn_stage_memory_bytes
    from repro_torch.fl import server as server_mod
    from repro_torch.fl.server import FedAvgServer, SmartFreezeServer
    from repro_torch.kernels import block_perturb, sparse_agg
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as train_mod
    from repro_torch.models.cnn import CNN, CNNConfig, RESNET18
    from repro_torch.models.module import tree_leaves
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "resume_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    print(f"resume: checkpoints under build/resume_ckpt, disk free "
          f"{shutil.disk_usage(root).free} bytes")
    out = {}
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    clients, _ = _fleet(10_000, 20, 32, 10)

    def run(srv, name, **kw):
        with _ticks() as ticks:
            sparse_agg.launches = block_perturb.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                res = srv.run(params, state, **kw)
            except _Crash:
                res = None
            torch.cuda.synchronize()
            b1, b3 = sparse_agg.launches, block_perturb.launches
        secs = time.perf_counter() - t0
        hist = srv.history if res is None else res["history"]
        print(f"resume {name}: {len(hist)} rounds recorded in {secs:.2f} s"
              f"{' (crashed)' if res is None else ''}, round walls ms "
              + ", ".join(f"{ms:.1f}" for _, ms, _ in ticks)
              + f" on {card}")
        return res, ticks, b1, b3

    def crash_resume(name, make, n_ok, run_kw, async_save=True):
        """Unbroken, crashed and resumed runs of ``make()``'s server, with
        what the crashed run last saved and what the resumed one
        restored."""
        r = {}
        r["a"], r["a_ticks"], _, _ = run(make(), f"{name} unbroken",
                                         **run_kw)
        mgr = CheckpointManager(os.path.join(root, name),
                                async_save=async_save)
        r["b_srv"] = make()
        with _saved_trees() as saved:
            run(r["b_srv"], f"{name} crashing", ckpt_manager=mgr,
                ckpt_every=1, eval_fn=_crash_after(n_ok), eval_every=1,
                **run_kw)
            mgr.wait()
        r["last"] = saved.log[-1]
        del saved.log[:]
        r["c_srv"] = make()
        with _restored(server_mod) as got:
            r["c"], r["c_ticks"], r["b1"], r["b3"] = run(
                r["c_srv"], f"{name} resumed", ckpt_manager=mgr,
                ckpt_every=1, resume=True, **run_kw)
            mgr.wait()
        r["got"] = got
        assert r["c"] is not None
        return r

    def check_restored(name, r):
        step, tree, meta = r["last"]
        got = r["got"]
        n = _trees_equal(got["trees"][0], tree["params"], "stage base")
        n += _trees_equal(got["trees"][1], tree["state"], "BN state")
        n += _trees_equal(got["trees"][2], tree["active"], "active")
        pools = len(got["pools"] or [])
        if "ef" in tree:
            assert pools == sum(k.startswith("pool") for k in tree["ef"])
            for i in range(pools):
                assert torch.equal(got["pools"][i], tree["ef"][f"pool{i}"])
        w = _window_equal(got["window"], tree["pace"])
        shape = tuple(got["pools"][0].shape) if pools else ()
        print(f"resume {name}: restored step {step} (stage {meta['stage']}, "
              f"round {meta['round_idx']}): {n} param and state leaves, "
              f"{pools} residual pools (the first {shape}) and {w} pace "
              f"snapshots on the card torch.equal to what the crashed run "
              f"held when it saved")

    def launches_match(name, r):
        hist = r["c"]["history"]
        stages = [x.stage for x in hist]
        b1 = _expected_fold_launches(model, params, r["c_srv"], r["c_ticks"],
                                     stages)
        # the first resumed round continues the restored window
        b3 = _expected_b3(model, params, stages[:1] + stages)
        print(f"resume {name}: resumed run sparse_cohort_add launches "
              f"{r['b1']} (expected {b1}), diff_sqnorm launches {r['b3']} "
              f"(expected {b3})")
        assert r["b1"] == b1 > 0 and r["b3"] == b3 > 0
        out[f"resnet18 resume {name}"] = (r["b1"], r["b3"])

    def sf(**kw):
        return lambda: SmartFreezeServer(
            model, clients, clients_per_round=COHORT, batch_size=32,
            compress_ratio=RATIO, seed=0, pace_kwargs=dict(RESUME_PACE),
            device="cuda", **kw)

    # cuDNN's convolution backward sums with atomics by default, and the
    # drift reorders the bandit's utilities (on an H100 a resumed fused
    # run's round-5 cohort differed from its unbroken twin's by a client).
    # With deterministic cuDNN through (d), and B1 summing in the
    # reference's order, a fused compressed run repeats itself bit for bit.
    torch.backends.cudnn.deterministic = True

    # a. compressed, fused, crash and resume across the stage-0 freeze
    r = crash_resume("fused", sf(), 2, dict(total_rounds=9))
    assert r["last"][2]["stage"] == 0 and r["last"][2]["round_idx"] == 1
    check_restored("fused", r)
    launches_match("fused", r)

    # the cost of saving: async saves every round and none, in turns with
    # the unbroken run above; a stage-0 and the last stage-3 step kept
    walls = {"none": [ms for _, ms, _ in r["a_ticks"]]}
    mgr = CheckpointManager(os.path.join(root, "timed"))
    with _saved_trees(lambda step, meta: step == 0 or meta["stage"] == 3) \
            as saved:
        _, ticks, _, _ = run(sf()(), "async saves every round",
                             ckpt_manager=mgr, ckpt_every=1, total_rounds=9)
        mgr.wait()
    walls["async"] = [ms for _, ms, _ in ticks]
    again, ticks, _, _ = run(sf()(), "no saves", total_rounds=9)
    walls["none, again"] = [ms for _, ms, _ in ticks]
    print("resume: round walls ms in turns, " + "; ".join(
        f"{k}: " + ", ".join(f"{w:.1f}" for w in v)
        for k, v in walls.items()) + f"; async save calls ms "
        + ", ".join(f"{m:.1f}" for m in saved.ms) + f" on {card}")
    for step, tree, meta in (saved.log[0], saved.log[-1]):
        d = os.path.join(root, f"sync_{step}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(d, step, tree, metadata=meta)
        t_save = time.perf_counter() - t0
        nbytes = _step_bytes(d, step)
        t0 = time.perf_counter()
        back = restore_checkpoint(d, device="cuda")
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        _trees_equal(tree["params"], back["tree"]["params"], "sync params")
        n_pools = sum(k.startswith("pool") for k in tree.get("ef", {}))
        print(f"resume: stage {meta['stage']} step {step}: {nbytes} bytes "
              f"({len(tree_leaves(tree['params']))} stage-base leaves, "
              f"{n_pools} residual pools), synchronous save "
              f"{t_save * 1e3:.1f} ms, restore onto the card "
              f"{t_restore * 1e3:.1f} ms on {card}")
        shutil.rmtree(d)
    del saved, back

    # (a)'s trajectory against the unbroken run, and a second unbroken run
    # ("no saves") against the first: each its twin bit for bit
    ha, hc = r["a"]["history"], r["b_srv"].history + r["c"]["history"]
    freeze = [x.round_idx for x in ha if x.frozen]
    assert freeze and ha[freeze[0]].stage == 0, freeze
    resumed = r["last"][2]["stage"]

    def twins(x, y):
        return [(a.round_idx, a.stage, a.selected, a.loss, a.perturbation,
                 a.frozen) != (b.round_idx, b.stage, b.selected, b.loss,
                               b.perturbation, b.frozen)
                for a, b in zip(x, y)]

    differ = [x.round_idx for x, bad in zip(ha, twins(ha, hc)) if bad]
    differ_again = [x.round_idx for x, bad in
                    zip(ha, twins(ha, again["history"])) if bad]
    print(f"resume fused: the freeze at round {freeze[0]}, resumed in stage "
          f"{resumed}; rounds whose cohort, loss, perturbation or freeze "
          f"differ from the unbroken run's: {differ} (a second unbroken "
          f"run's: {differ_again})")
    assert len(ha) == len(hc) == len(again["history"]) == 9
    assert not differ and not differ_again, (differ, differ_again)
    for twin, name in ((r["c"], "resumed"), (again, "second unbroken")):
        n = _trees_equal(r["a"]["params"], twin["params"], f"{name} params")
        n += _trees_equal(r["a"]["state"], twin["state"], f"{name} state")
    print(f"resume fused: the resumed run's and the second unbroken run's "
          f"final params and BN state torch.equal to the unbroken run's "
          f"({n} leaves)")

    # b. sequential (B1 at K = 1): bit for bit, over 6 rounds (9 took
    # 23 s)
    r = crash_resume("sequential", sf(fused=False), 2, dict(total_rounds=6))
    check_restored("sequential", r)
    ha, hc = r["a"]["history"], r["b_srv"].history + r["c"]["history"]
    assert len(ha) == len(hc)
    for x, y in zip(ha, hc):
        assert (x.round_idx, x.stage, x.selected, x.loss, x.perturbation,
                x.frozen) == (y.round_idx, y.stage, y.selected, y.loss,
                              y.perturbation, y.frozen), (x, y)
    n = _trees_equal(r["a"]["params"], r["c"]["params"], "sequential params")
    n += _trees_equal(r["a"]["state"], r["c"]["state"], "sequential state")
    print(f"resume sequential: the resumed trajectory torch.equal to the "
          f"unbroken one ({len(ha)} rounds, {n} final leaves, freeze at "
          f"round {[x.round_idx for x in ha if x.frozen]})")
    launches_match("sequential", r)

    # c. across a cache-tier decision, on a cut fleet
    small, _ = _fleet(2_000, 8, 32, 10)
    small = [dataclasses.replace(x) for x in small]
    need = lambda x, dt: cnn_stage_memory_bytes(  # noqa: E731
        model, 1, 32, 32, cache_samples=x.num_samples, cache_dtype=dt)
    small[0].memory_bytes = need(small[0], "int8") + 1.0
    small[1].memory_bytes = need(small[1], "float16") + 1.0
    small[2].memory_bytes = need(small[2], "float32") + 1.0
    small[3].memory_bytes = cnn_stage_memory_bytes(model, 1, 32, 32) + 1.0

    def tiered():
        return SmartFreezeServer(model, small, clients_per_round=8,
                                 batch_size=32, compress_ratio=RATIO, seed=0,
                                 cache_tiers="all", device="cuda")
    r = crash_resume("tiered", tiered, 2, dict(schedule=[1, 2, 1, 1]))
    step, tree, meta = r["last"]
    assert (step, meta["stage"]) == (1, 1), (step, meta)
    cache, got = tree["cache"], r["got"]["cache"]
    ids = [int(c) for c in np.asarray(cache["ids"])]
    assert sorted(got) == ids
    tiers = {}
    for i, cid in enumerate(ids):
        enc = got[cid]
        tiers[cid] = enc.tier
        assert enc.tier == ("f32", "fp16", "int8")[int(cache["tiers"][i])]
        assert enc.values.device.type == "cuda"
        assert torch.equal(enc.values, cache[f"val{i}"])
        if enc.scale is not None or f"scale{i}" in cache:
            assert torch.equal(enc.scale, cache[f"scale{i}"])
    assert set(tiers.values()) == {"f32", "fp16", "int8"}, tiers
    plan = r["c_srv"]._cache_plan(1)
    assert [plan[c] for c in range(4)] == ["int8", "fp16", "f32", None], plan
    ha, hc = r["a"]["history"], r["b_srv"].history + r["c"]["history"]
    for x, y in zip(ha, hc):
        assert (x.round_idx, x.stage, sorted(x.selected), x.cache_bytes) \
            == (y.round_idx, y.stage, sorted(y.selected), y.cache_bytes), \
            (x, y)
        assert x.loss == y.loss, (x, y)
    _trees_equal(r["a"]["params"], r["c"]["params"], "tiered params")
    _trees_equal(r["a"]["state"], r["c"]["state"], "tiered state")
    print(f"resume tiered: restored cache of {len(ids)} clients (tiers "
          f"{tiers}, client 3 declined) torch.equal to the saved codes, fp16 "
          f"values and int8 scales; cohorts, cache bytes and losses equal "
          f"the unbroken run's, final params and BN state torch.equal")
    launches_match("tiered", r)

    # d. FedAvg: the selection stream comes back

    def fedavg():
        return FedAvgServer(model, small, clients_per_round=3,
                            batch_size=32, compress_ratio=RATIO, seed=4,
                            fused=False, device="cuda")
    a, _, _, _ = run(fedavg(), "fedavg unbroken", rounds=4)
    mgr = CheckpointManager(os.path.join(root, "fedavg"))
    b_srv = fedavg()
    run(b_srv, "fedavg 2 rounds", rounds=2, ckpt_manager=mgr, ckpt_every=1)
    c_srv = fedavg()
    c, ticks, b1, _ = run(c_srv, "fedavg resumed", rounds=4,
                          ckpt_manager=mgr, resume=True)
    torch.backends.cudnn.deterministic = False
    hc = b_srv.history + c["history"]
    assert [x.selected for x in a["history"]] == [x.selected for x in hc]
    np.testing.assert_allclose([x.loss for x in hc],
                               [x.loss for x in a["history"]], **POLICY_TOL)
    for x, y in zip(tree_leaves(a["params"]), tree_leaves(c["params"])):
        torch.testing.assert_close(y, x, **POLICY_TOL)
    want = len(tree_leaves(params)) * sum(len(rec.selected)
                                          for rec, _, _ in ticks)
    picks = [[int(c) for c in x.selected] for x in hc]
    print(f"resume fedavg: selections {picks} equal the "
          f"unbroken run's; losses and params within rtol 1e-3, atol 1e-5; "
          f"sparse_cohort_add launches {b1} (expected {want})")
    assert b1 == want > 0
    out["resnet18 fedavg resume"] = (b1, 0)

    # e. the LM trainer at Llama-3-8B width, depth cut to 4 layers
    del r, a, c, b_srv, c_srv
    torch.cuda.empty_cache()
    arch = "llama3-8b-depth4"
    configs.register(dataclasses.replace(configs.get("llama3-8b"), name=arch,
                                         num_layers=4, num_freeze_blocks=2))
    kw = dict(reduced=False, steps=6, batch=4, seq=1024, num_pods=1,
              use_pallas=True, pace_kwargs=dict(LM_PACE), log_every=100,
              device="cuda")
    lm_a = train_mod.train(arch, **kw)
    draws, real_batch = {"n": 0}, train_mod.make_lm_batch

    def crashing_batch(*a, **k):
        draws["n"] += 1
        if draws["n"] == 3:
            raise _Crash()
        return real_batch(*a, **k)
    ckpt_dir = os.path.join(root, "lm")
    train_mod.make_lm_batch = crashing_batch
    try:
        with _saved_trees() as saved:
            try:
                train_mod.train(arch, ckpt_dir=ckpt_dir, ckpt_every=2, **kw)
            except _Crash:
                pass
            # the process died after round 1's save had landed
            for m in saved.managers:
                m.wait()
    finally:
        train_mod.make_lm_batch = real_batch
    step, tree, meta = saved.log[-1]
    save_ms = saved.ms
    del saved
    with _restored(train_mod) as got:
        fa.launches = block_perturb.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm_c = train_mod.train(arch, ckpt_dir=ckpt_dir, ckpt_every=1000,
                               resume=True, **kw)
        torch.cuda.synchronize()
        lm_secs = time.perf_counter() - t0
        flash, b3 = fa.launches, block_perturb.launches
    cfg = lm_c["config"]
    n = _trees_equal(got["trees"][0], tree["params"], "LM merged params")
    n += _trees_equal(got["trees"][1], tree["active"], "LM active")
    w = _window_equal(got["window"], tree["pace"])
    print(f"resume {arch}: restored step {step} (stage {meta['stage']} "
          f"round {meta['round']}): {n} merged-param and active leaves (the "
          f"output module among them) and {w} pace snapshots on the card "
          f"torch.equal to what the crashed run held when it saved; its "
          f"async save calls ms " + ", ".join(f"{m:.1f}" for m in save_ms))
    want, hist = lm_a["history"][meta["global_round"] + 1:], lm_c["history"]
    assert [(h["stage"], h["round"]) for h in hist] == \
        [(h["stage"], h["round"]) for h in want] and len(hist) == 4
    rtol_loss, rtol_p = LM_RESUME_TOL
    worst = [0.0, 0.0]
    for x, y in zip(want, hist):
        np.testing.assert_allclose(y["loss"], x["loss"], rtol=rtol_loss)
        worst[0] = max(worst[0], abs(y["loss"] - x["loss"]) / abs(x["loss"]))
        assert (x["perturbation"] is None) == (y["perturbation"] is None)
        if x["perturbation"] is not None:
            np.testing.assert_allclose(y["perturbation"], x["perturbation"],
                                       rtol=rtol_p)
            worst[1] = max(worst[1], abs(y["perturbation"]
                                         - x["perturbation"])
                           / abs(x["perturbation"]))
    assert hist[0]["perturbation"] is not None
    flash_want = _expected_lm_launches(cfg, hist)[0]
    b3_want = _expected_lm_launches(cfg, hist[:1] + hist)[2]
    print(f"resume {arch}: {len(hist)} resumed rounds in {lm_secs:.2f} s "
          f"(init and the final save included) on {card}; losses within "
          f"rtol {rtol_loss} (worst {worst[0]:.2e}), perturbations within "
          f"rtol {rtol_p} (worst {worst[1]:.2e}) of the unbroken run's; "
          f"flash_attention launches {flash} (expected {flash_want}), "
          f"diff_sqnorm launches {b3} (expected {b3_want})")
    assert flash == flash_want > 0 and b3 == b3_want > 0
    out["llama3-8b resume"] = (flash, b3)
    del lm_a, lm_c, got, tree
    shutil.rmtree(ckpt_dir)
    torch.cuda.empty_cache()

    # f. a checkpoint crosses between the card and the CPU
    cfg = CNNConfig("small", "resnet", stage_sizes=(1, 1),
                    stage_channels=(8, 16), num_classes=4)
    tiny, _ = _fleet(256, 4, 16, 4)
    p0, s0 = CNN(cfg, device="cpu").init(torch.Generator().manual_seed(0))

    def small(device):
        return SmartFreezeServer(CNN(cfg, device=device), tiny,
                                 clients_per_round=3, batch_size=16,
                                 compress_ratio=1.0, seed=0, device=device)

    def on(device, t):
        return to_torch(to_numpy(t), device)
    sched = dict(schedule=[3, 2])
    unbroken = small("cpu").run(on("cpu", p0), on("cpu", s0), **sched)
    conts = {}
    for writer, reader in (("cuda", "cpu"), ("cpu", "cuda")):
        mgr = CheckpointManager(os.path.join(root, f"{writer}_to_{reader}"))
        b = small(writer)
        try:
            b.run(on(writer, p0), on(writer, s0), ckpt_manager=mgr,
                  ckpt_every=1, eval_fn=_crash_after(2), eval_every=1,
                  **sched)
        except _Crash:
            pass
        mgr.wait()
        c = small(reader).run(on(reader, p0), on(reader, s0),
                              ckpt_manager=mgr, ckpt_every=1, resume=True,
                              **sched)
        mgr.wait()
        assert len(b.history) == 2
        conts[reader] = (b.history + c["history"], c)
    for x_hist, x in (conts["cpu"], (unbroken["history"], unbroken)):
        y_hist, y = conts["cuda"]
        assert [h.selected for h in x_hist] == [h.selected for h in y_hist]
        np.testing.assert_allclose([h.loss for h in y_hist],
                                   [h.loss for h in x_hist], **POLICY_TOL)
        for a, b in zip(tree_leaves(x["params"]) + tree_leaves(x["state"]),
                        tree_leaves(y["params"]) + tree_leaves(y["state"])):
            np.testing.assert_allclose(b.cpu().numpy(), a.cpu().numpy(),
                                       **POLICY_TOL)
    print("resume small: a card checkpoint continued on the CPU and a CPU "
          "checkpoint continued on the card agree with each other and with "
          "an unbroken CPU run (selections equal, losses and params rtol "
          "1e-3, atol 1e-5)")
    shutil.rmtree(root)
    print(f"resume phase seconds {time.perf_counter() - t_phase:.1f}")
    return out


# (name, B, S, Hq, Hkv, d, dtype, causal), d an int or (dk, dv): the first
# is the LM main path's shape (Llama-3-8B, batch 4 x 1024 tokens)
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
               ("d=80 f32", 2, 1000, 16, 4, 80, "float32", True),
               # run-time head dims: 96, the 256 ceiling, dv apart from dk
               ("d=96", 4, 1024, 32, 8, 96, "bfloat16", True),
               ("d=256", 4, 1024, 16, 16, 256, "bfloat16", True),
               ("dk=192 dv=128", 4, 1024, 32, 8, (192, 128), "bfloat16",
                True),
               ("d=256 f32", 2, 1000, 16, 4, 256, "float32", True),
               # the output module's GQA proxies of xLSTM-350M (4 heads of
               # 256) and MiniCPM3-4B (40 heads of 64)
               ("xlstm proxy d=256", 4, 1024, 4, 4, 256, "bfloat16", True),
               ("minicpm3 proxy d=64", 4, 1024, 40, 40, 64, "bfloat16",
                True),
               # grok-1-314b's layers, 48 q heads over 8 kv heads (g = 6,
               # no power of two), and deepseek-v2-236b's GQA proxies (128
               # heads of 128)
               ("grok-1 g=6", 4, 1024, 48, 8, 128, "bfloat16", True),
               ("deepseek-v2 proxy", 4, 1024, 128, 128, 128, "bfloat16",
                True),
               # internvl2-2b's layers: 16 q heads over 8 kv heads (g = 2),
               # 256 patch and 768 text positions, causal
               ("internvl2-2b g=2", 4, 1024, 16, 8, 128, "bfloat16", True),
               # a sequence shorter than one position tile and one kv tile
               ("S=1", 4, 1, 32, 8, 128, "bfloat16", True),
               ("S=17", 4, 17, 32, 8, 128, "bfloat16", True)]
# (rtol, atol) of |err| <= atol + rtol |plain|. bf16: rtol 2^-7, PR 13's,
# is one or two ulps of the output's own magnitude (the kernel carries p as
# two bf16 terms, so both versions compute in f32 and round once to bf16);
# atol 1e-5 covers outputs near zero, where q k^T's f32 sums on the tensor
# cores leave about 1e-6 of every output (B6 holds its bound at an atol of
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


def phase_flash_attention(build_logs=None):
    """Kernel B4 against its plain version (f32 scores and softmax, output
    in the input dtype) at the main path's shape and its variants: ragged S,
    a long sequence, full attention, g = 1, f32 at head_dim 16, Zamba2-7B's
    head dim 112 and hubert-xlarge's 80 (its encoder's full attention, bf16
    and f32), the output module's proxies of xLSTM-350M (4 heads of 256)
    and MiniCPM3-4B (40 of 64), grok-1-314b's layers (48 q heads over 8 kv
    heads, g = 6) and deepseek-v2-236b's proxies (128 heads of 128),
    internvl2-2b's layers (16 q heads over 8 kv heads, g = 2), the
    run-time widths 96 and 256 and dk 192 with dv 128, and sequences of 1
    and 17. Without the causal mask, the plain version one
    key short must break the bound somewhere, so that an off-by-one kernel
    could not pass it; a rerun must give equal bits. Each case prints the
    kernel's plan and the registers and spills of the instantiation it
    runs (from ``build_logs``, ``phase_build``'s nvcc output). Bound: the
    larger of (q, k, v, o bytes once) / 3.35 TB/s and the flops these
    inputs need (2 B Hq (dk + dv) per (query, key) pair: S (S + 1) / 2
    pairs when causal, S^2 when not) / the peak of the dtype's unit (989
    TFLOP/s bf16 tensor cores, 67 TFLOP/s f32)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ptxas = _ptxas_by_kernel((build_logs or {}).get("flash_attention", ""))
    rows, worst = [], 0.0
    for name, B, S, Hq, Hkv, d, dtype, causal in FLASH_CASES:
        dk, dv = d if isinstance(d, tuple) else (d, d)
        dt = getattr(torch, dtype)
        q = torch.randn(B, S, Hq, dk, generator=gen, device=dev).to(dt)
        k = torch.randn(B, S, Hkv, dk, generator=gen, device=dev).to(dt)
        v = torch.randn(B, S, Hkv, dv, generator=gen, device=dev).to(dt)
        scale = dk ** -0.5
        got = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        again = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        want = ref.flash_attention_ref(q, k, v, causal=causal, scale=scale)
        torch.cuda.synchronize()
        bits = torch.int16 if dtype == "bfloat16" else torch.int32
        equal_bits = torch.equal(got.view(bits), again.view(bits))
        del again
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
        flops = 2 * B * Hq * (dk + dv) * pairs
        nbytes = (B * S * Hq * (dk + dv) + B * S * Hkv * (dk + dv)) \
            * q.element_size()
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
        p = fa.plan(B, S, Hq, Hkv, dk, dv, q.element_size())
        lib_smem = fa.library_smem_bytes(dk, dv, q.element_size(), p.warps,
                                         p.stages)
        kern = ("flash_fwd_bf16" if dtype == "bfloat16" else "flash_fwd_f32",
                p.ceiling)
        regs = ptxas.get(kern)
        print(f"flash_attention {name:>14} B={B} S={S} Hq={Hq} Hkv={Hkv} "
              f"dk={dk} dv={dv} {dtype} causal={causal} "
              f"max_abs_err={max_err:.3e} "
              f"max_ulps_off_floor={ulps} needed_atol={need_atol:.2e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} library_ms="
              f"{library_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
              f"bound_share={bound_ms / ms:.3f} call_ms={call_ms:.4f} "
              f"equal_bits={equal_bits}")
        print(f"  plan: rows={p.rows} heads={p.heads} chunks={p.n_chunks} "
              f"warps={p.warps} positions={p.positions} "
              f"kv_rows={p.kv_rows} stages={p.stages} smem={p.smem} "
              f"(library {lib_smem}) grid={p.grid} ceiling={p.ceiling}; "
              f"{kern[0]}<{kern[1]}>: " + (
                  f"{regs[0]} registers, {regs[1]} bytes spill stores, "
                  f"{regs[2]} bytes spill loads" if regs else
                  "ptxas counts not in this run's build log"))
        if bad:
            raise AssertionError(f"flash_attention disagrees with its plain "
                                 f"version at {name}: max_abs_err {max_err}")
        if not sees_off:
            raise AssertionError(f"the tolerance at {name} does not tell the "
                                 "plain version from itself one key off")
        if not equal_bits:
            raise AssertionError(f"flash_attention at {name} gave other bits "
                                 "on a rerun")
        if lib_smem != p.smem:
            raise AssertionError(f"flash_attention plan at {name}: shared "
                                 f"memory {p.smem} in Python, {lib_smem} in "
                                 "the library")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_ulps=ulps,
                         bound_ms=bound_ms, bound_by=bound_by,
                         call_ms=call_ms, plan=p._asdict(),
                         ptxas=regs, shape=dict(B=B, S=S, Hq=Hq, Hkv=Hkv,
                                                dk=dk, dv=dv, dtype=dtype,
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
            "plan": top["plan"], "ptxas": top["ptxas"],
            # Zamba2-7B's and hubert-xlarge's shapes, and the xLSTM-350M and
            # MiniCPM3-4B proxies'
            "d112": next(r for r in rows if r["name"] == "d=112 g=1"),
            "d80": next(r for r in rows if r["name"] == "d=80 hubert"),
            "d256_xlstm": next(r for r in rows
                               if r["name"] == "xlstm proxy d=256"),
            "d64_minicpm3": next(r for r in rows
                                 if r["name"] == "minicpm3 proxy d=64"),
            "g6_grok1": next(r for r in rows if r["name"] == "grok-1 g=6"),
            "d128_deepseek_v2_proxy": next(
                r for r in rows if r["name"] == "deepseek-v2 proxy"),
            "g2_internvl2": next(r for r in rows
                                 if r["name"] == "internvl2-2b g=2")}


LM_PACE = dict(min_rounds=3, mu=2, slope_lambda=5e-3, low_memory=True)


def _gqa_layers(cfg, kinds):
    """How many of ``kinds`` are GQA attention layers, the only kind that
    launches B4 (full sequence) or B6 (decode): attention layers (dense,
    MoE and shared: ``attn_mlp``, ``attn_moe``, ``shared_attn``) when
    ``cfg.attention`` is GQA. MLA, Mamba2, mLSTM and sLSTM layers launch
    neither, and the MoE FFN launches no kernel."""
    if cfg.attention != "gqa":
        return 0
    return sum(k in ("attn_mlp", "attn_moe", "shared_attn") for k in kinds)


def _expected_lm_launches(cfg, history):
    """(flash attention, SSD scan, block perturbation) launches of the
    rounds in ``history``: one per GQA attention layer and one per Mamba2
    layer that a round's forward runs. Stage t runs layers [0, b_{t+1})
    (frozen prefix and active block) and T - t - 1 proxy layers of its
    output module, which are GQA for every family; neither backward
    launches a kernel (both are autograd through plain forms). The pace
    controller's observe launches B3 twice per leaf of the stage's block
    once it holds a previous snapshot: in every round of a stage but the
    first."""
    from repro_torch.core import freezing
    kinds = cfg.layer_kinds()
    flash = ssd = b3 = 0
    for i, h in enumerate(history):
        hi = freezing.make_stage_plan(cfg, h["stage"]).hi
        ssd += sum(k == "mamba2" for k in kinds[:hi])
        flash += _gqa_layers(cfg, kinds[:hi]) + (cfg.num_freeze_blocks
                                                  - h["stage"] - 1)
        if i and history[i - 1]["stage"] == h["stage"]:
            b3 += 2 * _pace_block(cfg, h["stage"])[0]
    return flash, ssd, b3


F32_PARAMS = ("A_log", "D", "dt_bias", "router")


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


def phase_lm_main_path(card, arch="llama3-8b", steps=8, expect=(172, 0, 72),
                       use_pallas=True):
    """Full width ``arch`` through launch/train.py:train on the card, bf16,
    random params from a seed, ``steps`` rounds of batch 4 x 1024 tokens
    spread evenly over the stages, one pod. Llama-3-8B: 32 layers, d_model
    4096, 32 q / 8 kv heads, vocab 128256, 4 stages x 2 rounds. Zamba2-7B:
    81 layers (68 Mamba2, 13 shared attention over 2 tied sets), d_model
    3584, 6 stages x 1 round. xLSTM-350M: 24 layers (21 mLSTM, 3 sLSTM),
    d_model 1024, 4 stages x 2 rounds. MiniCPM3-4B: 62 MLA layers, d_model
    2560, 40 heads, 6 stages x 2 rounds, ``use_pallas=False`` (the
    reference's trainer refuses it for MLA). deepseek-v2-236b at depth 2
    (``MOE_CUTS``: its dense layer, then one MoE layer of 160 experts, top-6,
    2 shared; MLA, 128 heads), 2 stages x 2 rounds, ``use_pallas=False``:
    B4 only in stage 0's GQA proxy. internvl2-2b: 24 layers, d_model 2048,
    16 q / 8 kv heads of 128, vocab 92553, each sequence 256 patch
    positions (1,024 features) and 768 text tokens, 4 stages x 2 rounds.
    hubert-xlarge: 48 encoder layers (layernorm, gelu), d_model 1280, 16
    heads of 80 attending non-causally, 504 units, 1,024 frames of 512
    features, 4 stages x 2 rounds. The pace controller's anchored
    window (low_memory) keeps two f32 copies of the active block on the
    card instead of six (the exact window does not fit beside Llama's
    round) and takes its norms with B3. ``expect`` is (flash attention,
    SSD scan, B3) launches, as ``_expected_lm_launches`` counts them, None
    where only the helper's count is asserted. Returns the launches, the
    trained params and the config."""
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
                    num_pods=1, use_pallas=use_pallas,
                    pace_kwargs=dict(LM_PACE), log_every=1, device="cuda")
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
    # bf16 params, but for Mamba2's A_log, D and dt_bias and the MoE
    # router, kept in f32
    for key, leaf in _named_leaves(out["params"]):
        want = torch.float32 if key in F32_PARAMS else torch.bfloat16
        assert leaf.dtype == want, (key, leaf.dtype)
    expected = _expected_lm_launches(cfg, hist)
    print(f"{arch} flash_attention, ssd_scan, diff_sqnorm launches "
          f"{launches} (expected {expected})")
    assert launches == expected, (launches, expected)
    assert all(e is None or e == n for e, n in zip(expect, launches)), \
        (launches, expect)
    assert sparse_agg.launches == 0
    return launches, out["params"], cfg


# the MoE models' depth cuts on one card (every width as published): the
# round step of any grok-1 block does not fit (a round holds about 14 bytes
# an active parameter at its peak: the bf16 block, its gradients and their
# clipped copy, the f32 update and the anchored pace window's two f32
# copies; a block of one 4.92 B-param layer and its output module, 5.7 B,
# would need about 80 GB), so grok-1 is served and one full-width layer
# runs forward and backward; deepseek-v2 trains at depth 2 (its dense layer
# and one 3.97 B-param MoE layer, one freeze block each). Each serving cut
# is the deepest whose init fits: ``LM.init`` draws a stacked expert leaf
# in f32 before it casts, so grok-1 at depth 4 peaks at 66.8 GB (depth 5
# would need about 83 of the card's 85.0, not tried) and deepseek-v2 at
# depth 7 (the dense layer and 6 MoE layers, 50.4 GB of weights) at 79.1. Serving does not use the
# freeze blocks; its cuts keep one layer a block.
MOE_CUTS = {"grok-1-314b-depth4": ("grok-1-314b", 4, 4),
            "deepseek-v2-236b-depth2": ("deepseek-v2-236b", 2, 2),
            "deepseek-v2-236b-depth7": ("deepseek-v2-236b", 7, 7)}


def _register_moe_cuts():
    import dataclasses
    from repro_torch import configs
    for name, (arch, layers, blocks) in MOE_CUTS.items():
        configs.register(dataclasses.replace(
            configs.get(arch), name=name, num_layers=layers,
            num_freeze_blocks=blocks))


def phase_moe_layer(card):
    """One full-width grok-1-314b ``attn_moe`` layer (d_model 6144, 48 q / 8
    kv heads of 128, 8 experts of 32,768, top-2; 4.92 B params, 9.84 GB in
    bf16, random from a seed) forward and backward on the card through the
    port's ``layer_apply`` with ``attention_impl="pallas"``, at the training
    shape (batch 4 x 1024 tokens: 8 MoE chunks of 128, 40 slots an expert
    a chunk). Loss: the output's mean square plus 0.01 x the MoE aux loss;
    the loss and every gradient must be finite. B4 must launch exactly
    once, in the forward (its backward is autograd through the plain
    form), counted from 0. One warm-up, one run timed on the host clock
    (ending in a synchronize), one under torch.profiler: device busy ms and
    ms by kernel class. The capacity drops: the share of the layer's token
    choices (4 x 1024 x 2) that no slot keeps, summed from the dispatch
    one-hots of the counted forward (a wrapper that only records them).
    Returns B4's launches."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import configs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import moe
    from repro_torch.models.module import (ParamFactory, param_count,
                                           tree_leaves)
    from repro_torch.models.transformer import layer_apply, layer_init
    dev = torch.device("cuda")
    cfg = dataclasses.replace(configs.get("grok-1-314b"),
                              attention_impl="pallas")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(0)
    p = layer_init(ParamFactory(gen, dev, torch.bfloat16), cfg, "attn_moe")
    leaves = [leaf.requires_grad_() for leaf in tree_leaves(p)]
    x = torch.randn(4, 1024, cfg.d_model, generator=gen,
                    device=dev).to(torch.bfloat16)
    B, S = x.shape[:2]

    def forward():
        y, aux = layer_apply(p, x, cfg, "attn_moe")
        return y.float().square().mean() + 0.01 * aux, aux

    def step():
        loss, aux = forward()
        grads = torch.autograd.grad(loss, leaves)
        torch.cuda.synchronize()
        return loss, aux, grads

    step()  # warm-up
    dispatch, kept = moe._dispatch_combine, []

    def recording_dispatch(*args, **kwargs):
        out = dispatch(*args, **kwargs)
        kept.append(out[0].detach().float().sum())
        return out

    moe._dispatch_combine = recording_dispatch
    fa.launches = 0
    try:
        loss, aux = forward()
    finally:
        moe._dispatch_combine = dispatch
    fwd_launches = fa.launches
    grads = torch.autograd.grad(loss, leaves)
    torch.cuda.synchronize()
    launches = fa.launches
    assert fwd_launches == launches == 1, (fwd_launches, launches)
    assert math.isfinite(float(loss.detach()))
    assert math.isfinite(float(aux.detach()))
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    del grads
    t0 = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step()
    by_class = _device_ms_by_class(prof)
    assert len(kept) == S // moe.MOE_CHUNK, len(kept)
    kept = float(sum(kept))
    choices = B * S * cfg.experts_per_token
    print(f"grok-1-314b attn_moe layer forward + backward (B={B}, S={S}, "
          f"{param_count(p)} params) on {card}: wall_ms {wall_ms:.1f}, loss "
          f"{float(loss.detach()):.6f}, aux {float(aux.detach()):.6f}, "
          f"flash_attention "
          f"launches {launches} (forward), capacity "
          f"{moe._capacity(moe.MOE_CHUNK, cfg)} a chunk, dropped token "
          f"choices {choices - kept:.0f} of {choices} "
          f"({(choices - kept) / choices:.4f}), "
          f"torch.cuda.max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()}")
    if not by_class:
        print("  torch.profiler recorded no device time: not measured")
    else:
        busy = sum(by_class.values())
        print(f"  device busy ms {busy:.1f}, idle share "
              f"{1 - busy / wall_ms:.3f}")
        for cls, ms in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"  {cls:>22}: {ms:9.2f} ms")
    del p, leaves, x
    torch.cuda.empty_cache()
    return launches


def _device_ms_by_class(prof):
    return {cls: us / 1e3 for cls, us in _device_us_by_class(prof).items()}


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
            fed = {k: torch.as_tensor(v, device=dev)[None, None]
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


# The cached LM round's loss against the recompute round's on the same
# batches. f32 tier (the prefix output kept as produced, bf16 here):
# the reference test's rtol and atol 1e-3 (tests/test_engine.py). fp16:
# a bf16 value converts to float16 exactly where 2^-14 <= |x| <= 65504
# (float16 keeps 10 mantissa bits to bf16's 7, and the range is checked),
# and below 2^-14 it moves by at most 2^-25, far under any rounding of
# the layers after it: the f32 tier's tolerance. int8: each feature
# moves by at most half a step, amax / 254 of its (sample, channel)
# group, about 2^-8 of the group's largest value, as much as one more
# bf16 rounding of the block's input, which every layer already adds;
# its effect on the mean cross-entropy is first order in that error, so
# rtol 2e-2 (five times 2^-8) on the loss.
CACHED_TOL = {"f32": (1e-3, 1e-3), "fp16": (1e-3, 1e-3), "int8": (2e-2, 0.0)}


def phase_lm_cached_round(card, params, cfg, stages=(1, 2, 3)):
    """The cached LM round (``fl/engine.py:make_lm_cached_fed_round_step``)
    on full-width ``cfg`` (internvl2-2b) from ``params``, at ``stages``: one
    pod, one SGD step (3e-3) a round, batch 4 x 1,024 positions (256 patch
    + 768 text). Per stage: the frozen prefix's features of two rounds'
    batches from ``stage_prefix_features``, once (B4 counted: the prefix's
    GQA layers twice); stored at each tier (f32: as produced; fp16; int8
    codes with f32 per-(sample, channel) scales), their bytes beside the
    memory model's; two cached rounds a tier and two recompute rounds
    (``make_fed_round_step``) from the same start, each round's loss held
    by ``CACHED_TOL``, every round's B4 launches asserted (cached: the
    active block's GQA layers and the proxies; recompute: the prefix's
    too); one more cached (f32) and one recompute round under
    torch.profiler: wall and device-busy ms, and the cached round's
    speedup beside Eq. 5's (``lm_cached_compute_scale``). Returns B4's
    launches."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import freezing
    from repro_torch.core.memory_model import (CACHE_TIER_DTYPES,
                                               feature_cache_bytes)
    from repro_torch.core.time_model import lm_cached_compute_scale
    from repro_torch.data.synthetic import make_lm_batch
    from repro_torch.fl.engine import make_lm_cached_fed_round_step
    from repro_torch.fl.quant import quantize_int8
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models.transformer import build
    from repro_torch.optim import sgd
    dev = torch.device("cuda")
    model = build(cfg, dev)
    kinds = cfg.layer_kinds()
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    w = torch.ones(1, device=dev)
    B, S = 4, 1024
    flash = 0
    for stage in stages:
        plan = freezing.make_stage_plan(cfg, stage)
        frozen, active = freezing.init_stage_active(
            model, params, plan,
            torch.Generator(device=dev).manual_seed(100 + stage))
        batches = [{k: torch.as_tensor(v, device=dev)[None, None]
                    for k, v in make_lm_batch(cfg, B, S,
                                              seed=1000 * stage + r).items()}
                   for r in range(2)]
        fa.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        feats = [freezing.stage_prefix_features(
            model, frozen, active, {k: v[0, 0] for k, v in b.items()}, plan)
            for b in batches]
        torch.cuda.synchronize()
        fill_ms = (time.perf_counter() - t0) * 1e3
        want = 2 * _gqa_layers(cfg, kinds[:plan.lo])
        assert fa.launches == want, (fa.launches, want)
        flash += fa.launches
        h_max = max(float(h.abs().max()) for h, _ in feats)
        assert all(h.shape == (B, S, cfg.d_model) for h, _ in feats)
        assert h_max < 65504, h_max  # float16's range holds the features
        per_round = (_gqa_layers(cfg, kinds[plan.lo:plan.hi])
                     + cfg.num_freeze_blocks - stage - 1)
        tokens = 2 * B * S

        def run(step, first, inputs, what):
            act, losses, walls = first, [], []
            nonlocal flash
            for b in inputs:
                fa.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                act, met = step(act, *b, w)
                losses.append(float(met["loss"]))
                walls.append((time.perf_counter() - t0) * 1e3)
                assert fa.launches == what, (fa.launches, what)
                flash += fa.launches
            return act, losses, walls

        recompute = freezing.make_fed_round_step(
            model, plan, sgd(3e-3), num_pods=1, local_steps=1, remat=False)
        r_inputs = [(frozen, b) for b in batches]
        _, r_loss, r_wall = run(recompute, active, r_inputs,
                                per_round + _gqa_layers(cfg, kinds[:plan.lo]))
        line = [f"internvl2 cached stage {stage}: prefix features of "
                f"{tokens} positions in {fill_ms:.1f} ms (max |h0| "
                f"{h_max:.2f}); flash_attention launches: prefix fill "
                f"{want}, a cached round {per_round}, a recompute round "
                f"{per_round + _gqa_layers(cfg, kinds[:plan.lo])}; "
                f"recompute round losses "
                f"{[round(x, 6) for x in r_loss]} wall_ms "
                f"{[round(x, 1) for x in r_wall]}"]
        steps = {}
        for tier in ("f32", "fp16", "int8"):
            stored = []
            for h0, aux0 in feats:
                if tier == "int8":
                    q, sc = quantize_int8(h0)
                    enc = {"h0": q, "h0_scale": sc}
                else:
                    enc = {"h0": h0 if tier == "f32"
                           else h0.to(torch.float16)}
                stored.append(enc)
            nbytes = sum(t.numel() * t.element_size()
                         for e in stored for t in e.values())
            model_bytes = feature_cache_bytes(
                cfg, tokens, None if tier == "f32"
                else CACHE_TIER_DTYPES[tier], scale_vectors=2 * B)
            steps[tier] = make_lm_cached_fed_round_step(
                model, plan, sgd(3e-3), num_pods=1, local_steps=1,
                remat=False, feature_tier=tier)
            inputs = [({"labels": b["labels"], "aux0": aux0[None, None],
                        **{k: t[None, None] for k, t in e.items()}},)
                      for b, (_, aux0), e in zip(batches, feats, stored)]
            _, c_loss, c_wall = run(steps[tier], active, inputs, per_round)
            rtol, atol = CACHED_TOL[tier]
            diff = [abs(a - b) for a, b in zip(c_loss, r_loss)]
            line.append(f"  {tier}: stored {nbytes} B (memory model "
                        f"{model_bytes:.0f}), losses "
                        f"{[round(x, 6) for x in c_loss]} (|cached - "
                        f"recompute| {[f'{x:.2e}' for x in diff]}, rtol "
                        f"{rtol}, atol {atol}), wall_ms "
                        f"{[round(x, 1) for x in c_wall]}")
            for a, b in zip(c_loss, r_loss):
                assert math.isfinite(a) and \
                    abs(a - b) <= atol + rtol * abs(b), \
                    (stage, tier, c_loss, r_loss)
            if tier == "f32":
                f32_inputs = inputs
        # one more round of each, profiled: wall and device-busy ms
        busy = {}
        fa.launches = 0
        for name, step, first in (("cached f32", steps["f32"],
                                   f32_inputs[0]),
                                  ("recompute", recompute, r_inputs[0])):
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                _, met = step(active, *first, w)
                float(met["loss"])
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            by_class = _device_ms_by_class(prof)
            busy[name] = (wall, sum(by_class.values()) if by_class else None)
        want = 2 * per_round + _gqa_layers(cfg, kinds[:plan.lo])
        assert fa.launches == want, (fa.launches, want)
        flash += fa.launches
        (cw, cb), (rw, rb) = busy["cached f32"], busy["recompute"]
        scale = lm_cached_compute_scale(cfg, stage, batch=B, seq=S)
        line.append(
            f"  profiled: cached wall_ms {cw:.1f} busy_ms "
            + (f"{cb:.1f}" if cb is not None else "not measured")
            + f", recompute wall_ms {rw:.1f} busy_ms "
            + (f"{rb:.1f}" if rb is not None else "not measured")
            + f"; cached speedup wall {rw / cw:.2f}x"
            + (f", busy {rb / cb:.2f}x" if cb and rb else "")
            + f" (Eq. 5: {1 / scale:.2f}x) on {card}")
        print("\n".join(line))
        del frozen, active, feats, batches, steps, recompute
    del model
    torch.cuda.empty_cache()
    return flash


def phase_slstm_loop(card, params, cfg):
    """xLSTM's sLSTM on the card is a host loop of S cells. One sLSTM
    layer (the first, layer 7 of xLSTM-350M) at the training shape, batch 4
    x 1024 tokens, bf16: the forward alone (no grad) and forward plus
    backward, each once as a warm-up, then timed on the host clock (ending
    in a synchronize): the wall and the wall per cell. The forward is run
    once more under torch.profiler for the device's busy ms and idle
    share."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import ssm
    from repro_torch.models.transformer import layer_at
    dev = torch.device("cuda")
    seg = next(str(i) for i, (k, _) in enumerate(cfg.segments())
               if k == "slstm")
    mix = layer_at(params["segments"][seg], 0)["mix"]
    p = {k: (v.detach().clone().requires_grad_() if torch.is_tensor(v) else
             {n: t.detach().clone().requires_grad_() for n, t in v.items()})
         for k, v in mix.items()}
    u = torch.randn(4, 1024, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    u = u.to(torch.bfloat16).requires_grad_()

    def forward():
        with torch.no_grad():
            ssm.slstm_forward(p, u, cfg)
        torch.cuda.synchronize()

    def forward_backward():
        ssm.slstm_forward(p, u, cfg).float().sum().backward()
        torch.cuda.synchronize()

    for name, fn in (("forward", forward), ("forward + backward",
                                            forward_backward)):
        fn()
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
        line = (f"{cfg.name} sLSTM layer {name} (S=1024 cells, B=4, d "
                f"{cfg.d_model}) on {card}: wall_ms {wall:.1f} "
                f"({wall / 1024 * 1e3:.1f} us a cell)")
        if fn is forward:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
            by_class = _device_ms_by_class(prof)
            busy = sum(by_class.values())
            line += (f", device busy ms {busy:.2f}, idle share "
                     f"{1 - busy / wall:.3f}" if by_class else
                     ", device busy not measured (torch.profiler recorded "
                     "no device time)")
        print(line)
    del p, u


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


def _mla_blockwise_card_vs_cpu(cfg):
    """One ``mla_forward`` of a reduced MLA layer at S = 2,048, causal, f32:
    the blockwise branch (dk = nope + rope, dv = v_head_dim) on the card
    against the CPU, rtol 1e-3, atol 1e-5, with no kernel launched."""
    import numpy as np
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import attention as attn
    from repro_torch.models.module import ParamFactory, tree_map
    assert 2048 >= attn.ATTN_BLOCK_THRESHOLD
    p = attn.mla_init(ParamFactory(torch.Generator().manual_seed(3), "cpu",
                                   torch.float32), cfg)
    x = torch.randn(1, 2048, cfg.d_model,
                    generator=torch.Generator().manual_seed(4))
    want = attn.mla_forward(p, x, cfg)
    before = fa.launches
    got = attn.mla_forward(tree_map(lambda t: t.cuda(), p), x.cuda(), cfg)
    torch.cuda.synchronize()
    assert fa.launches == before, "MLA reached the flash kernel"
    assert got.device.type == "cuda" and bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-3,
                               atol=1e-5)
    print(f"small {cfg.name} mla_forward S=2048 (blockwise, dk "
          f"{cfg.qk_nope_dim + cfg.qk_rope_dim}, dv {cfg.v_head_dim}): card "
          f"== CPU (rtol 1e-3, atol 1e-5), max_abs_err "
          f"{float((got.cpu() - want).abs().max()):.3e}")


def phase_small_lm_reference(arch="llama3-8b"):
    """The LM path on the card against the port's CPU path (itself held
    against the JAX package by tests/test_torch_lm.py and, for the hybrid,
    xLSTM, MLA and MoE families, tests/test_torch_hybrid.py,
    test_torch_xlstm.py, test_torch_mla.py and test_torch_moe.py), on the
    reduced ``arch`` in float32 (grok-1-314b: 4 MoE layers of 4 experts,
    top-2; deepseek-v2-236b: a dense MLA layer, then 3 MoE layers;
    Llama-3-8B:
    4 layers, d_model 64, 4 q / 4 kv heads; Zamba2-7B: 4 layers alternating
    Mamba2 and shared attention, d_model 64; xLSTM-350M: 3 mLSTM layers and
    an sLSTM; MiniCPM3-4B: 4 MLA layers, without ``use_pallas``;
    internvl2-2b: 4 layers, 8 patch positions of 32 features in each
    sequence; hubert-xlarge: 4 encoder layers over 32-feature frames; 2
    stages x 1 round, batch 2 x 64 positions). Both runs draw their params
    and output modules from CPU generators of the same seeds, so they
    start equal.
    Tolerance rtol 1e-3, atol 1e-5 on losses and final params (f32 on both
    devices, summed in other orders; the bf16 output modules can flip a
    rounding). Every kernel of the path launches on the card and never on
    the CPU. For an MLA arch, one ``mla_forward`` at S = 2,048
    (``ATTN_BLOCK_THRESHOLD``: the blockwise branch) on the card against the
    CPU, at the same tolerance."""
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
    use_pallas = configs.get(arch).attention == "gqa"  # MLA: SystemExit
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
                                    seq=64, use_pallas=use_pallas,
                                    log_every=100, device=device)
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
    if configs.get(arch).attention == "mla":
        _mla_blockwise_card_vs_cpu(configs.get(name).reduced())
    # the pace controller deciding: 6 rounds a stage at most, freezes
    # allowed from round 3; Llama with the exact window, Zamba2 anchored
    from repro_torch.kernels import block_perturb
    low_memory = configs.get(arch).family == "hybrid"
    before = block_perturb.launches
    with _pace_shadowed() as pairs:
        out = train(name, reduced=True, steps=12, batch=2, seq=64,
                    use_pallas=use_pallas, log_every=100, device="cuda",
                    pace_kwargs=dict(min_rounds=3, mu=1, slope_lambda=5e-2,
                                     fit_window=3, low_memory=low_memory))
    assert block_perturb.launches > before
    _check_pace_shadows(pairs, f"small {arch}")
    stages = [h["stage"] for h in out["history"]]
    print(f"small {arch}: pace-decided stages {stages} (low_memory="
          f"{low_memory}; card pace == CPU pace, rtol {PACE_RTOL})")


# (name, B, S, Hq, Hkv, d, dtype, lengths), d a head dim or (dk, dv): the
# first three are the serving path's shape (Llama-3-8B, batch 8, a
# 1,024-token cache) at three lengths; the fourth the decode_32k cut
# (DECODE_32K.seq_len, batch 128 cut to 8)
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
            ("d=80 f32", 4, 1000, 16, 4, 80, "float32", [1000, 0, 999, 2]),
            # run-time head dims: the MLA widths nope + rope (64 + 32 and
            # deepseek-v2's 128 + 64), dv below dk, and f32 at the ceiling
            ("d=96", 8, 1024, 32, 8, 96, "bfloat16",
             [1024, 1, 1023, 517, 0, 64, 800, 33]),
            ("d=192", 8, 1024, 16, 16, 192, "bfloat16",
             [1024, 1, 1023, 517, 0, 64, 800, 33]),
            ("dk=96 dv=64", 8, 1024, 32, 8, (96, 64), "bfloat16",
             [1024, 1, 1023, 517, 0, 64, 800, 33]),
            ("d=256 f32", 4, 1000, 16, 4, 256, "float32", [1000, 0, 999, 2]),
            # grok-1-314b's serving shape (192 + 64 tokens): 48 q heads
            # over 8 kv heads, g = 6, full and ragged
            ("grok-1 g=6", 8, 256, 48, 8, 128, "bfloat16", [256] * 8),
            ("grok-1 g=6 ragged", 8, 256, 48, 8, 128, "bfloat16",
             [256, 1, 255, 128, 0, 64, 200, 17]),
            # internvl2-2b's serving shape (192 + 64 tokens): 16 q heads
            # over 8 kv heads, g = 2, full and ragged
            ("internvl2-2b g=2", 8, 256, 16, 8, 128, "bfloat16", [256] * 8),
            ("internvl2-2b g=2 ragged", 8, 256, 16, 8, 128, "bfloat16",
             [256, 1, 255, 128, 0, 64, 200, 17])]


# (rtol, atol) of |err| <= atol + rtol |plain|. bf16: the plain version
# is evaluated in f64 (``_b6_floor``'s exact result, so its own f32
# roundings do not enter), rtol 2^-7 is one or two ulps of the output's
# own magnitude (the kernel rounds once to bf16), and atol, per output, is
# the floor ``_b6_floor`` derives from the kernel's f32 arithmetic. f32:
# the plain version in f32, summation order only. Every case also checks
# that the plain version one row short (length - 1) breaks the bound in
# every row it changes, so that an off-by-one kernel could not pass it.
DECODE_TOL = {"bfloat16": (2 ** -7, "_b6_floor"), "float32": (1e-5, 1e-5)}
U32 = 2.0 ** -24  # float32's unit roundoff


def _b6_exact(q, k, v, length, scale):
    """B6's function in f64 on the card, kv heads grouped without copies:
    (p [B, Hkv, g, S] = exp(s - max) on the rows below ``length``, l = sum
    p [B, Hkv, g, 1], o [B, Hkv, g, dv] = p v / l, the score gaps m - s);
    a row of length 0 gives o = 0."""
    import torch
    B, Hq, dk = q.shape
    S, Hkv = k.shape[1], k.shape[2]
    qd = q.double().reshape(B, Hkv, Hq // Hkv, dk)
    s_nat = torch.einsum("bhgd,bshd->bhgs", qd, k.double()) * scale
    valid = (torch.arange(S, device=q.device)[None, :]
             < length[:, None].long())[:, None, None, :]
    s_nat = s_nat.masked_fill(~valid, -math.inf)
    m = s_nat.amax(-1, keepdim=True)
    live = valid & torch.isfinite(m)
    gap = torch.where(live, m - s_nat, torch.zeros_like(s_nat))
    p = torch.where(live, torch.exp(-gap), torch.zeros_like(s_nat))
    l = p.sum(-1, keepdim=True).clamp_min(1e-300)
    return p, l, torch.einsum("bhgs,bshc->bhgc", p, v.double()) / l, gap


def _b6_floor(q, k, v, length, scale, chunk_rows):
    """(floor, exact) for a bf16 case of B6: a first-order bound on each
    output's distance from the exact result, from the kernel's own order
    of f32 sums, and the exact result (the plain version in f64), both
    computed in f64 on the card from the case's inputs. Near an output of
    0 the relative term rtol |plain| vanishes and the floor is what is
    left; the output's bf16 rounding (at most 2^-8 |o|) is in rtol.

    With p_j = exp(s_j - m) and o = sum_j p_j v_j / l, a relative error
    e_j of p_j moves o by sum_j p_j e_j (v_j - o) / l, which the floor
    takes as it is. A_j = sum_i |q_i k_ji| bounds every partial sum of
    q . k_j; t = s log2(e) is the kernel's score unit. Per cached row j
    (``decode_attention.cu``, bf16 path):
      * S^T = K q^T: ceil(dk / 16) m16n8k16 products chained over two
        accumulators, each step adding exact bf16 products to its f32
        accumulator with an error of at most 2 ulps of A_j (tensor cores
        align to the largest exponent and truncate), then one f32 add and
        the product with scale log2(e) (2 roundings): |dt_j| <=
        (2 ceil(dk / 16) + 3) u c A_j with c = scale log2(e);
      * p_j = ex2.approx(t_j - m): the subtraction's rounding u |t_j - m|
        and ex2's relative error 2^-22; each rescale of the running sums
        by ex2(m_old - m_new) (once per warp step at most, n of them) and
        the warp and split merges' ex2 weights reweight the earlier rows
        by 2^-22 each. So e_j <= ln 2 ((2 ceil(dk / 16) + 3) u c A_j + u
        |t_j - m|) + (n + 3) 2^-22;
      * numerator only: P^T as hi + lo bf16 terms keeps p to 2^-16 (each
        bf16 rounding is within 2^-8 of its value); 2 mma
        a warp step (n = ceil(chunk_rows / 64) steps: a split's rows over
        4 warps of 16 rows), the rescale products and the fmaf merges (4
        warps, up to 16 splits): (2^-16 + (5 n + 20) u) sum_j p_j |v_j|;
      * denominator: l's adds, shuffles and merges, (2 n + 24) u |o|.
    At the d 112 g 1 case a draw once left one output 1.35e-6 from f64 at
    f64 value -3.36e-6, past the old atol of 1e-6 (against the f32 plain
    version); the floor there is about 1e-5. ``phase_b6_d112_seeds``
    measures the kernel against it over 20 draws."""
    import torch
    B, Hq, dk = q.shape
    S, dv = k.shape[1], v.shape[3]
    p, l, o, gap = _b6_exact(q, k, v, length, scale)
    qa = q.double().abs().reshape(p.shape[:3] + (dk,))
    A = torch.einsum("bhgd,bshd->bhgs", qa, k.double().abs())
    vd = v.double()
    n = -(-chunk_rows // 64)
    c = scale * math.log2(math.e)
    e = (math.log(2) * ((2 * -(-dk // 16) + 3) * U32 * c * A
                        + U32 * gap * math.log2(math.e))
         + (n + 3) * 2.0 ** -22)
    reweight = torch.zeros_like(o)
    pe = p * e
    for r in range(0, S, 2048):  # sum_j p_j e_j |v_j - o|, row chunks
        dev_ = (vd[:, r:r + 2048].permute(0, 2, 1, 3)[:, :, None]
                - o[:, :, :, None]).abs()  # [B, Hkv, g, rows, dv]
        reweight += torch.einsum("bhgs,bhgsc->bhgc", pe[..., r:r + 2048],
                                 dev_)
        del dev_
    pv = torch.einsum("bhgs,bshc->bhgc", p, vd.abs()) / l
    floor = (reweight / l + (2.0 ** -16 + (5 * n + 20) * U32) * pv
             + (2 * n + 24) * U32 * o.abs())
    return floor.reshape(B, Hq, dv), o.reshape(B, Hq, dv)


def phase_b6_d112_seeds(seeds=20):
    """B6's d 112 g 1 case (Zamba2-7B's serving shape, ragged lengths) over
    ``seeds`` draws: each output of the kernel against the exact (f64)
    result within its floor (``_b6_floor``) and its bf16 rounding (at most
    2^-8 of the f32 value it rounds, itself within the floor of the exact
    one), and within ``DECODE_TOL``. Prints per draw the error over that
    bound, the error over the floor alone where the floor dominates the
    rounding (|o| <= 2^8 floor), and the outputs that the old check (atol
    1e-6 against the f32 plain version) would have failed."""
    import torch
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    name, B, S, Hq, Hkv, d, dtype, lengths = next(
        c for c in _decode_cases() if c[0] == "d=112 g=1")
    length = torch.tensor(lengths, dtype=torch.int32, device=dev)
    p = dec.card_plan(B, S, Hq, Hkv, d, d, torch.bfloat16, 0)
    rtol = DECODE_TOL[dtype][0]
    live = length > 0  # empty rows: exact zeros in both, floor 0
    worst = {"bound": 0.0, "floor near 0": 0.0, "tol": 0.0}
    old_misses = 0
    for seed in range(seeds):
        gen = torch.Generator(device=dev).manual_seed(1000 + seed)
        q = torch.randn(B, Hq, d, generator=gen, device=dev).bfloat16()
        k = torch.randn(B, S, Hkv, d, generator=gen, device=dev).bfloat16()
        v = torch.randn(B, S, Hkv, d, generator=gen, device=dev).bfloat16()
        got = dec.decode_attention(q, k, v, length).double()
        plain32 = ref.decode_attention_ref(q, k, v, length).double()
        floor, exact = _b6_floor(q, k, v, length, d ** -0.5, p.chunk_rows)
        err, mag = (got - exact).abs(), exact.abs()
        near0 = live[:, None, None] & (mag <= 2.0 ** 8 * floor)
        ratios = {
            "bound": float((err / ((1 + 2.0 ** -8) * floor
                                   + 2.0 ** -8 * mag))[live].max()),
            "floor near 0": (float((err / floor)[near0].max())
                             if bool(near0.any()) else 0.0),
            "tol": float((err / (floor + rtol * mag))[live].max())}
        assert bool((got[~live] == 0).all())
        misses = int(((got - plain32).abs()
                      > 1e-6 + rtol * plain32.abs()).sum())
        old_misses += misses
        for key in worst:
            worst[key] = max(worst[key], ratios[key])
        print(f"decode_attention d=112 g=1 seed {seed}: max |kernel - f64| "
              f"{float(err.max()):.3e}, floor at most {float(floor.max()):.3e}"
              f"; error / (floor + rounding) {ratios['bound']:.3f}, error / "
              f"floor where |o| <= 2^8 floor ({int(near0.sum())} outputs) "
              f"{ratios['floor near 0']:.3f}, error / DECODE_TOL "
              f"{ratios['tol']:.3f}; outputs past the old check (atol 1e-6 "
              f"against the f32 plain version): {misses}")
    print(f"decode_attention d=112 g=1 over {seeds} draws: worst error / "
          f"(floor + rounding) {worst['bound']:.3f}, / floor near 0 "
          f"{worst['floor near 0']:.3f}, / DECODE_TOL {worst['tol']:.3f}; "
          f"outputs the old check fails: {old_misses}")
    assert worst["bound"] <= 1.0 and worst["tol"] <= 1.0, worst
    return dict(seeds=seeds, worst=worst, old_check_misses=old_misses)


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


def _graph_nodes(fn):
    """Node types of one call of ``fn`` captured into a CUDA graph
    (stream capture through the CUDA runtime that torch loaded): 0 is a
    kernel, anything else a copy, a set or another node."""
    import ctypes
    import torch
    rt = ctypes.CDLL(f"libcudart.so.{torch.version.cuda.split('.')[0]}")
    stream = torch.cuda.Stream()
    graph, count = ctypes.c_void_p(), ctypes.c_size_t(0)
    torch.cuda.synchronize()
    with torch.cuda.stream(stream):
        # thread-local capture; the call's output comes from the cache
        # of the earlier calls, so nothing is allocated while capturing
        assert rt.cudaStreamBeginCapture(
            ctypes.c_void_p(stream.cuda_stream), 1) == 0
        fn()
        assert rt.cudaStreamEndCapture(ctypes.c_void_p(stream.cuda_stream),
                                       ctypes.byref(graph)) == 0
    assert rt.cudaGraphGetNodes(graph, None, ctypes.byref(count)) == 0
    nodes = (ctypes.c_void_p * count.value)()
    assert rt.cudaGraphGetNodes(graph, nodes, ctypes.byref(count)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert rt.cudaGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        types.append(kind.value)
    rt.cudaGraphDestroy(graph)
    return types


def _device_kernels(fn, lead=3):
    """Names of the device activities (kernels, copies, sets) that one
    call of ``fn`` runs, under torch.profiler, in the order they start.
    The call sits between ``lead`` marker kernels (``torch.cuda._sleep``)
    and one more after it, and its activities are those between the last
    leading marker recorded and the trailing one. On an H100, one-call
    windows early in a process recorded every activity; two minutes and
    some twenty windows in, one lost its first activity; after the
    training phases' profiles, ten minutes in, windows recorded nothing,
    or only after 3 s of host time before the first marker. So the window
    opens ``pad`` seconds of host time before the first marker, longer
    pads taken in turn until the markers are recorded, and the checks that
    use it run early in ``main``. Raises if the markers are never
    recorded, so a missed capture never reads as a call that ran no
    kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for pad in (0.2, 1.0, 3.0):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(lead):
                torch.cuda._sleep(1000)
            fn()
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        acts = [name for _, name in sorted(
            (ev.time_range.start, ev.name) for ev in prof.events()
            if ev.device_type == torch.autograd.DeviceType.CUDA)]
        marks = [i for i, name in enumerate(acts) if "spin_kernel" in name]
        if (len(marks) >= 2 and marks[-1] == len(acts) - 1
                and marks[len(marks) - 2] == len(marks) - 2):
            if pad > 0.2:
                print(f"  (the profiler recorded the call's markers with "
                      f"{pad} s of host time before them)")
            return acts[len(marks) - 1:-1]
    raise AssertionError(f"the profiler did not record the markers around "
                         f"the call: {acts}")


def phase_decode_attention():
    """Kernel B6 against its plain version at the serving shape and its
    variants: the kernel, the plain version and the one-call PyTorch
    yardstick (``scaled_dot_product_attention`` on a [B, Hq, 1, dk] query
    with kv pre-transposed to [B, Hkv, S, d] outside the timed region, a
    boolean length mask and ``enable_gqa``; it is compared on rows with
    length > 0 only, since it has no answer for an empty row). Bound: the
    bytes the function must move (K and V rows below each row's length, q
    and the output once) over 3.35 TB/s, against the flops these rows need
    (2 (dk + dv) per (q head, cached row)) at the peak of the input dtype.
    Each case also checks that one call runs exactly one device kernel
    (one kernel node when the call is captured into a CUDA graph, and
    nothing else under torch.profiler) and that a rerun gives equal
    bits."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    rows, worst = [], 0.0
    t_phase = time.perf_counter()
    for name, B, S, Hq, Hkv, d, dtype, lengths in _decode_cases():
        dk, dv = d if isinstance(d, tuple) else (d, d)
        dt = getattr(torch, dtype)
        elt = torch.tensor([], dtype=dt).element_size()
        kv_bytes = B * S * Hkv * (dk + dv) * elt
        copies = max(1, -(-3 * L2_BYTES // kv_bytes) + 1)
        sets = []
        for _ in range(copies):
            q = torch.randn(B, Hq, dk, generator=gen, device=dev).to(dt)
            k = torch.randn(B, S, Hkv, dk, generator=gen, device=dev).to(dt)
            v = torch.randn(B, S, Hkv, dv, generator=gen, device=dev).to(dt)
            sets.append((q, k, v))
        length = torch.tensor(lengths, dtype=torch.int32, device=dev)
        q, k, v = sets[0]
        got = dec.decode_attention(q, k, v, length)
        want = ref.decode_attention_ref(q, k, v, length)
        again = dec.decode_attention(q, k, v, length)
        torch.cuda.synchronize()
        bits = torch.int16 if elt == 2 else torch.int32
        equal_bits = torch.equal(got.view(bits), again.view(bits))
        # one call, one kernel: the nodes of a captured call, and what
        # torch.profiler records of one (in a process that profiled
        # earlier it may miss a launch from this library; it must not
        # see anything else)
        nodes = _graph_nodes(lambda: dec.decode_attention(q, k, v, length))
        one_call = _device_kernels(lambda: dec.decode_attention(q, k, v,
                                                                length))
        rtol, atol = DECODE_TOL[dtype]
        p = dec.card_plan(B, S, Hq, Hkv, dk, dv, dt, 0)
        shorter = (length - 1).clamp(min=0)
        if atol == "_b6_floor":  # against the plain version in f64
            atol, want = _b6_floor(q, k, v, length, dk ** -0.5,
                                   p.chunk_rows)
            short = _b6_exact(q, k, v, shorter, dk ** -0.5)[2].reshape(
                want.shape)
        else:
            short = ref.decode_attention_ref(q, k, v, shorter)
        err = (got.double() - want.double()).abs()
        floor_max = float(torch.as_tensor(atol).max())
        bad = bool((err > atol + rtol * want.double().abs()).any())
        max_err = float(err.max())
        # ulps where the relative term of the bound dominates (|plain| >=
        # atol / rtol), as B4 and B5 count them; nearer zero a sign flip is
        # many ulps and the floor holds it
        big = want.double().abs() >= atol / rtol
        ulps = (_bf16_ulps(got[big], want[big].to(dt))
                if dtype == "bfloat16" and bool(big.any()) else None)
        short_err = (short.double() - want.double()).abs()
        # every row the shortening changes must break the bound somewhere
        changed = (length >= 1) & (length <= S)
        sees_off_by_one = bool(
            (short_err > atol + rtol * want.double().abs()).flatten(1)
            .any(1)[changed].all())
        del short, short_err, again
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
        nbytes = ((valid * Hkv + B * Hq) * (dk + dv)) * elt + 4 * B
        flops = 2 * valid * Hq * (dk + dv)
        peak = BF16_FLOPS if dtype == "bfloat16" else F32_FLOPS
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / peak) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / peak
                    else "operations")
        resident = dec.resident_clusters(p, B, S, Hq, Hkv, dk, dv, dt)
        print(f"decode_attention {name:>15} B={B} S={S} Hq={Hq} Hkv={Hkv} "
              f"dk={dk} dv={dv} {dtype} splits={p.splits}x{p.chunk_rows} "
              f"cluster={p.splits} ring={p.stages}x{p.rows} rows "
              f"smem={p.smem} resident_clusters={resident} copies={copies} "
              f"max_abs_err={max_err:.3e} max_ulps_off_floor={ulps} "
              f"atol_max={floor_max:.3e} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} "
              f"library_ms={library_ms:.4f} (err {lib_err:.3e}) "
              f"bound_ms={bound_ms:.4f} ({bound_by}) "
              f"bound_share={bound_ms / ms:.3f} call_ms={call_ms:.4f} "
              f"graph_nodes_a_call={nodes} profiled_kernels_a_call="
              f"{len(one_call)} equal_bits={equal_bits}")
        if bad or not empty_ok:
            raise AssertionError(f"decode_attention disagrees with its plain "
                                 f"version at {name}: max_abs_err {max_err}, "
                                 f"empty rows zero: {empty_ok}")
        if not sees_off_by_one:
            raise AssertionError(f"the tolerance at {name} does not tell the "
                                 "plain version from itself one row short")
        if nodes != [0] or len(one_call) != 1 or any(
                "decode_attention_cluster" not in n for n in one_call):
            raise AssertionError(f"one decode_attention call at {name} ran "
                                 f"graph nodes {nodes}, profiled {one_call} "
                                 "on the card, not one kernel")
        if not equal_bits:
            raise AssertionError(f"decode_attention at {name} gave other bits "
                                 "on a rerun")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         library_ms=library_ms, max_ulps=ulps,
                         bound_ms=bound_ms, bound_by=bound_by,
                         call_ms=call_ms, shape=dict(
                             B=B, S=S, Hq=Hq, Hkv=Hkv, dk=dk, dv=dv,
                             dtype=dtype, length=max(lengths)),
                         plan=p._asdict()))
        del sets, q, k, v, got, want, err, atol
        torch.cuda.empty_cache()
    t_seeds = time.perf_counter()
    d112_seeds = phase_b6_d112_seeds()
    print(f"decode_attention phase seconds {time.perf_counter() - t_phase:.1f}"
          f" (the d 112 draws {time.perf_counter() - t_seeds:.1f})")
    top = rows[2]  # the serving path's shape with a full cache
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:25",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "call_ms": top["call_ms"], "shape": top["shape"],
            "plan": top["plan"],
            # the decode_32k cut, Zamba2-7B's serving shape, hubert-xlarge's
            # width and the run-time widths
            "decode_32k": rows[3],
            "d112": next(r for r in rows if r["name"] == "d=112 g=1"),
            "d80": next(r for r in rows if r["name"] == "d=80 hubert"),
            "dk96_dv64": next(r for r in rows if r["name"] == "dk=96 dv=64"),
            "g6_grok1": next(r for r in rows if r["name"] == "grok-1 g=6"),
            "g2_internvl2": next(r for r in rows
                                 if r["name"] == "internvl2-2b g=2"),
            "d112_seeds": d112_seeds}


# Llama-3-8B's serving shape: 960 prompt + 64 generated tokens, 1,024 steps
LLAMA_SERVE = dict(batch=8, prompt_len=960, gen_len=64)
# every other model's serving shape: 192 + 64 tokens, 256 steps
SERVE = dict(batch=8, prompt_len=192, gen_len=64)
# Zamba2-7B's and MiniCPM3-4B's serving cells, host-bound at 102-145 ms a
# step (256 steps took 33.7 and 37.4 s): 64 + 64 tokens, 128 steps; their
# decode profiles stay at a 256-row cache
SERVE_SHORT = dict(batch=8, prompt_len=64, gen_len=64)


def phase_serve(card, arch="llama3-8b", shape=None, expect=32_768):
    """Full-width ``arch`` through launch/serve.py:serve on the card, bf16,
    random params from a seed, a batch of prompts stepped one token at a
    time, then greedy tokens. Llama-3-8B (32 layers, d_model 4096, 32 q /
    8 kv heads, vocab 128256) at ``LLAMA_SERVE``, the default (batch 8,
    960 + 64 tokens: 1,024 decode steps over a 1,024-row cache); every
    other model at ``SERVE`` (batch 8, 192 + 64 tokens, 256 steps), but
    Zamba2-7B and MiniCPM3-4B at ``SERVE_SHORT`` (64 + 64, 128 steps). Zamba2-7B (13 shared
    attention layers over 2 tied sets, 68 Mamba2 layers stepping their
    O(1) recurrence). xLSTM-350M (24
    mLSTM and sLSTM layers stepping their recurrences) and MiniCPM3-4B (62
    MLA layers decoding matrix-absorbed over their latent caches in plain
    einsums): no B6 launch. internvl2-2b (24 layers, GQA 16 q / 8 kv
    heads: B6 at g = 2; the prompt is text, embedded by the token embed).
    The MoE cuts (``MOE_CUTS``): grok-1-314b at depth 4 (4 ``attn_moe``
    layers, GQA 48 q
    / 8 kv heads: B6 at g = 6) and deepseek-v2-236b at depth 7 (MLA, no
    B6), each step's MoE FFN routing the batch as one token group.
    ``expect`` is B6's launches, one per GQA attention layer (dense, MoE or
    shared) and step; the path launches no other kernel. The last step's
    logits are kept (by a wrapper that only records them) to check that
    they are finite. Returns B6's launches."""
    import numpy as np
    import torch
    from repro_torch import configs
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import sparse_agg, ssm_scan
    from repro_torch.launch.serve import serve
    from repro_torch.models import transformer
    shape = shape or LLAMA_SERVE
    cfg = configs.get(arch)
    steps = shape["prompt_len"] + shape["gen_len"]
    n_attn = _gqa_layers(cfg, cfg.layer_kinds())
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
    small = configs.get(name).reduced()
    n_attn = _gqa_layers(small, small.layer_kinds())
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
# kernel sweep's dt = 0.3 |n| and log_a = -0.2 |n|; x, B, C standard normal.
# "d_state 128" is Mamba2's published state size (mamba2-2.7b) at the
# training shape; hd and N are run-time widths up to 128.
SSD_CASES = [("main", 4, 1024, 112, 64, 64, "bfloat16", "model"),
             ("S=4096 B=1", 1, 4096, 112, 64, 64, "bfloat16", "model"),
             ("ragged S=1000", 4, 1000, 112, 64, 64, "bfloat16", "model"),
             ("d_state 128", 4, 1024, 112, 64, 128, "bfloat16", "model"),
             ("hd=32 N=16", 2, 1000, 8, 32, 16, "bfloat16", "sweep"),
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
    """(C B^T, decayed products, state decay) flops of one batch row of the
    chunked form at chunk length r, two per multiply-add: C B^T below the
    diagonal once per chunk (the same for every head); per head and chunk
    the decayed S x below the diagonal, C h^T and the state update's
    products (each with an f32 operand), and the state's decay h *
    exp(total)."""
    shared = decayed = decay = 0
    for n, rr in ((S // r, r), (1, S % r)):
        shared += n * rr * (rr + 1) * N
        decayed += n * H * (rr * (rr + 1) * hd + 4 * rr * N * hd)
        decay += n * H * N * hd * (rr > 0)
    return shared, decayed, decay


def _ssd_bound(B, S, H, hd, N, elt):
    """((bound ms, bound_by), (first bound ms, bound_by)): the bytes the
    function moves (x and y once, dt and log_a in f32, B and C once) over
    3.35 TB/s against its operations, at the chunk length that needs the
    fewest (any chunk length gives the same y; the kernel's is 64).
    Operations, bf16 x, B and C: every product on tensor cores at 989
    TFLOP/s, C B^T (exact bf16 operands) once and each product with an f32
    operand (the decayed scores, the state, w B) as three bf16 products,
    the terms that carry its 24 bits; the state decay at the f32 rate. f32
    x, B and C: every flop at the 67 TFLOP/s f32 rate. The first bound,
    kept beside it for one PR, priced the decayed products of bf16 inputs
    at the f32 rate too, which a kernel that runs them on tensor cores
    reads above 100%."""
    nbytes = 2 * B * S * H * hd * elt + 2 * B * S * H * 4 + 2 * B * S * N * elt
    t_bytes = nbytes / HBM_BYTES_PER_S
    flops = [_ssd_flops(S, H, hd, N, r) for r in range(1, S + 1)]
    if elt == 2:
        t_ops = B * min((cb + 3 * dec) / BF16_FLOPS + decay / F32_FLOPS
                        for cb, dec, decay in flops)
        t_first = B * min(cb / BF16_FLOPS + (dec + decay) / F32_FLOPS
                          for cb, dec, decay in flops)
    else:
        t_ops = t_first = B * min(sum(f) / F32_FLOPS for f in flops)

    def bound(t):
        return (max(t_bytes, t) * 1e3,
                "bytes" if t_bytes >= t else "operations")
    return bound(t_ops), bound(t_first)


def phase_ssd_scan(build_logs=None):
    """Kernel B5 against its plain version (the sequential recurrence, f32
    state) at the hybrid main path's shape and its variants: a 4,096-token
    sequence, a ragged length, Mamba2's published state size 128, the
    run-time widths (32, 16), f32 at full width and at the reduced widths,
    and the reference sweep's f32 widths. Times the kernel, the plain
    version and the chunked plain form (the model's CPU path and the
    kernel's backward, at the model's chunk); prints each case's plan, the
    instantiation's register and spill counts (from ``build_logs``,
    ``phase_build``'s nvcc output) and whether a rerun gives equal bits.
    No single PyTorch call computes this function: library_ms is None."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref, ssm_scan
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    ptxas = _ptxas_by_kernel((build_logs or {}).get("ssm_scan", ""))
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
        again = ssm_scan.ssd_scan(x, dt, la, Bm, Cm)
        want = ref.ssd_scan_ref(x, dt, la, Bm, Cm)
        torch.cuda.synchronize()
        equal_bits = torch.equal(got, again)
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
        del shifted, again
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
        (bound_ms, bound_by), (first_ms, first_by) = _ssd_bound(
            B, S, H, hd, N, x.element_size())
        p = ssm_scan.plan(hd, N, x.element_size())
        lib_smem = ssm_scan.library_smem_bytes(hd, N, x.element_size())
        regs = ptxas.get(("ssd_scan_bf16", p.hd_class, p.n_class)
                         if dtype == "bfloat16" else
                         ("ssd_scan_f32", p.hd_class, p.n_class,
                          int((hd, N) == (p.hd_class, p.n_class))))
        print(f"ssd_scan {name:>13} B={B} S={S} H={H} hd={hd} N={N} {dtype} "
              f"{dist} classes=({p.hd_class}, {p.n_class}) warps={p.warps} "
              f"plane_buffers={p.plane_buffers} smem={p.smem} "
              f"(library {lib_smem}) ptxas(regs, spill st, spill ld)={regs} "
              f"max_abs_err={max_err:.3e} max_ulps_off_floor={ulps} "
              f"equal_bits={equal_bits} "
              f"ms={ms:.4f} plain_ms={plain_ms:.4f} chunked_plain_ms="
              f"{chunked_ms:.4f} (chunk {chunk}) library_ms=None "
              f"bound_ms={bound_ms:.4f} ({bound_by}) bound_share="
              f"{bound_ms / ms:.3f} first_bound_ms={first_ms:.4f} "
              f"({first_by}) call_ms={call_ms:.4f}")
        if bad or not finite:
            raise AssertionError(f"ssd_scan disagrees with its plain version "
                                 f"at {name}: max_abs_err {max_err}, finite "
                                 f"{finite}")
        if not sees_shift:
            raise AssertionError(f"the tolerance at {name} does not tell the "
                                 "plain version from one with its decay "
                                 "shifted by a position")
        if not equal_bits:
            raise AssertionError(f"ssd_scan at {name} gave other bits on a "
                                 "rerun")
        if lib_smem != p.smem:
            raise AssertionError(f"ssd_scan's plan sizes {p.smem} bytes of "
                                 f"shared memory at {name}, the library "
                                 f"{lib_smem}")
        rows.append(dict(name=name, ms=ms, plain_ms=plain_ms,
                         chunked_plain_ms=chunked_ms, library_ms=None,
                         bound_ms=bound_ms, bound_by=bound_by,
                         first_bound_ms=first_ms, call_ms=call_ms,
                         plan=p._asdict(), ptxas=regs,
                         shape=dict(B=B, S=S, H=H, hd=hd, N=N, dtype=dtype)))
        del x, dt, la, la_shift, Bm, Cm, got, want, err
        torch.cuda.empty_cache()
    top = rows[0]  # the hybrid main path's shape
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/ssm_scan.cu",
            "replaces": "src/repro/kernels/ssm_scan.py:68",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": None,
            "first_bound_ms": top["first_bound_ms"],
            "chunked_plain_ms": top["chunked_plain_ms"],
            "call_ms": top["call_ms"], "shape": top["shape"],
            "plan": top["plan"], "ptxas": top["ptxas"],
            "d_state_128": next(r for r in rows if r["name"] == "d_state 128")}


# (name, M, K, N, q, scale, w dtype, out dtype): the first is the quant-aware
# path's shape (batch 32 of ResNet-18's stage-3 prefix, 8 x 8 x 256, into
# its final width 512); q "int8" is quantize_int8 of normal data
B2_CASES = [("main", 32, 16384, 512, "int8", "row", "float32", "float32"),
            ("bf16 w", 32, 16384, 512, "int8", "row", "bfloat16", "float32"),
            ("K 32768", 32, 32768, 512, "int8", "row", "float32", "float32"),
            ("M 4096", 4096, 16384, 512, "int8", "row", "float32", "float32"),
            ("col scale", 32, 16384, 512, "int8", "col", "float32",
             "float32"),
            ("full scale", 32, 16384, 512, "int8", "full", "float32",
             "float32"),
            ("0-d scale", 32, 16384, 512, "int8", "scalar", "float32",
             "float32"),
            ("f32 q", 32, 16384, 512, "float32", "row", "float32", "float32"),
            ("bf16 q", 32, 16384, 512, "bfloat16", "row", "float32",
             "float32"),
            ("1x1x1", 1, 1, 1, "int8", "row", "float32", "float32"),
            ("5x3x2", 5, 3, 2, "int8", "row", "float32", "float32"),
            ("257x129x65", 257, 129, 65, "int8", "row", "float32", "float32"),
            ("zero rows", 32, 16384, 512, "zero rows", "row", "float32",
             "float32"),
            ("denormal s", 32, 16384, 512, "denormal", "row", "float32",
             "float32"),
            ("near overflow", 32, 16384, 512, "overflow", "row", "float32",
             "float32"),
            ("bf16 out", 32, 16384, 512, "int8", "row", "float32",
             "bfloat16"),
            ("N 510", 32, 16384, 510, "int8", "row", "float32", "float32")]
B2_TIMED = ("main", "bf16 w", "K 32768", "M 4096", "N 510")


def _b2_bound(q, s, w):
    """Per output, the f32 summation bound for two orders of the same
    products, ``2 K 2^-24 (|q s| @ |w|)``, plus ``K 2^-149``: gradual
    underflow's absolute rounding, for denormal products. In f64."""
    K = q.shape[1]
    mag = (q.double() * s.double()).abs() @ w.double().abs()
    return 2 * K * 2.0 ** -24 * mag + K * 2.0 ** -149


def _b2_bounds(M, K, N, q, s, w, skind):
    """((bound ms, bound_by), (first bound ms, bound_by)): q, the scale and
    w read once and out written once over 3.35 TB/s, against the
    operations. The bound: each product of bf16 terms as 2 M N K at 989
    TFLOP/s (one term for int8 or bf16 q under a row or 0-d scale, else
    three of q s; one for bf16 w, three for f32 w; 3 x 3 keeps six
    products), q s (three-term q only) and the epilogue at the f32 rate.
    The first bound, printed beside it, priced 2 M N K + M K at the 67
    TFLOP/s f32 rate, which a kernel that runs its products on tensor
    cores reads above 100%."""
    import torch
    nbytes = (q.numel() * q.element_size() + s.numel() * 4
              + w.numel() * w.element_size() + M * N * 4)
    t_bytes = nbytes / HBM_BYTES_PER_S
    ta = 1 if q.dtype != torch.float32 and skind in ("row", "scalar") else 3
    tw = 3 if w.dtype == torch.float32 else 1
    products = {(1, 1): 1, (1, 3): 3, (3, 1): 3, (3, 3): 6}[ta, tw]
    t_ops = (products * 2 * M * N * K / BF16_FLOPS
             + (M * N + (M * K if ta == 3 else 0)) / F32_FLOPS)
    t_first = (2 * M * N * K + M * K) / F32_FLOPS

    def bound(t):
        return (max(t_bytes, t) * 1e3,
                "bytes" if t_bytes >= t else "operations")
    return bound(t_ops), bound(t_first)


def _b2_inputs(M, K, N, qkind, skind, wdt, gen, dev):
    import torch
    from repro_torch.fl.quant import quantize_int8
    x = torch.randn(M, K, generator=gen, device=dev)
    if qkind == "zero rows":
        x[3] = 0
        x[11] = 0
    q, s = quantize_int8(x)
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    if qkind == "denormal":
        s = torch.full_like(s, 1e-40)
    elif qkind == "overflow":
        # |q s| up to 1.27e38 against |w| < 1 / K: sums stay finite
        s = torch.full_like(s, 1e36)
        w = (torch.rand(K, N, generator=gen, device=dev) * 2 - 1) / K
    elif qkind in ("float32", "bfloat16"):
        q = x.to(getattr(torch, qkind))
    if skind == "col":
        s = torch.rand(K, generator=gen, device=dev) * 0.05 + 0.001
    elif skind == "full":
        s = torch.rand(M, K, generator=gen, device=dev) * 0.05 + 0.001
    elif skind == "scalar":
        s = torch.tensor(0.02, device=dev)
    return q, s, w.to(getattr(torch, wdt))


def _b2_nonfinite_rows(dqmm, ref, gen, dev):
    """Rows whose scale is not finite against the plain version's pattern,
    at the main shape with w in [0.5, 1.5) / 128 (no zero, so every q of
    one sign gives one infinity): row 1 s = inf over q with zeros (NaN),
    row 5 s = NaN (NaN), rows 7 and 8 s = inf over q all 3 and all -2
    (+inf and -inf); the other rows finite and within ``_b2_bound``."""
    import torch
    from repro_torch.fl.quant import quantize_int8
    M, K, N = 32, 16384, 512
    q, s = quantize_int8(torch.randn(M, K, generator=gen, device=dev))
    w = (torch.rand(K, N, generator=gen, device=dev) + 0.5) / K ** 0.5
    q[7], q[8] = 3, -2
    s[1], s[5], s[7], s[8] = float("inf"), float("nan"), float("inf"), \
        float("inf")
    got = dqmm.dequant_matmul(q, s, w)
    want = ref.dequant_matmul_ref(q, s, w)
    fin = torch.isfinite(s[:, 0])
    bound = _b2_bound(q[fin], s[fin], w)
    err = (got[fin].double() - want[fin].double()).abs()
    same = (bool(torch.equal(torch.isnan(got), torch.isnan(want)))
            and bool(torch.equal(torch.isinf(got), torch.isinf(want)))
            and bool((got[torch.isinf(want)] == want[torch.isinf(want)])
                     .all()))
    pattern = {r: ("NaN" if bool(torch.isnan(got[r]).all()) else
                   "+inf" if bool((got[r] == float("inf")).all()) else
                   "-inf" if bool((got[r] == -float("inf")).all()) else
                   "mixed") for r in (1, 5, 7, 8)}
    print(f"dequant_matmul non-finite row scales: rows {pattern}, plain "
          f"version's pattern {same}, finite rows max_err_over_bound="
          f"{float((err / bound).max()):.3e}")
    if not same or pattern != {1: "NaN", 5: "NaN", 7: "+inf", 8: "-inf"}:
        raise AssertionError("dequant_matmul: rows with a non-finite scale "
                             "do not give the plain version's NaN/inf")
    if not bool((err <= bound).all()):
        raise AssertionError("dequant_matmul: a finite row breaks its bound "
                             "beside non-finite ones")


def phase_dequant_matmul(build_logs=None):
    """Kernel B2 against its plain version on the card at the quant-aware
    path's shape and its variants. Tolerance, per output: the f32
    summation bound ``_b2_bound`` (plus one bf16 ulp of the plain value for
    bf16 out); a plain version missing the kernel's last split-K slice
    must break it, and a rerun must give equal bits. Times (cold in L2:
    the inputs cycle through copies of w, 100 MB or more in all, as the
    round finds w1 after its other work) the kernel, the plain version and
    the one-call yardstick ``torch.matmul(q.float() * s, w.float())`` with
    TF32 off, against ``_b2_bounds``. Prints each case's plan and its
    instantiation's ptxas register and spill counts (from ``build_logs``,
    ``phase_build``'s nvcc output). Then rows with non-finite scales
    against the plain version's NaN/inf pattern, and a bad scale shape."""
    import torch
    from repro_torch.kernels import dequant_matmul as dqmm
    from repro_torch.kernels import ref
    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ptxas = _ptxas_by_kernel((build_logs or {}).get("dequant_matmul", ""))
    names = {torch.int8: "int8", torch.float32: "f32", torch.bfloat16: "bf16"}
    rows, worst = {}, 0.0
    for name, M, K, N, qkind, skind, wdt, odt in B2_CASES:
        q, s, w = _b2_inputs(M, K, N, qkind, skind, wdt, gen, dev)
        out_dtype = getattr(torch, odt)
        got = dqmm.dequant_matmul(q, s, w, out_dtype)
        again = dqmm.dequant_matmul(q, s, w, out_dtype)
        want = ref.dequant_matmul_ref(q, s, w, out_dtype)
        _, s2 = ref.normalize_scale(s, M, K)
        bound = _b2_bound(q, s2, w)
        if out_dtype == torch.bfloat16:
            e = torch.floor(torch.log2(want.double().abs().clamp_min(
                2.0 ** -126)))
            bound = bound + torch.pow(2.0, e - 7)
        err = (got.double() - want.double()).abs()
        ok = bool((err <= bound).all()) and bool(torch.isfinite(got).all())
        splits, per = dqmm.plan(M, N, K, sms)
        cut = (splits - 1) * per
        short = ref.dequant_matmul_ref(q[:, :cut], s2[:, :cut]
                                       if s2.shape[1] == K else s2,
                                       w[:cut], out_dtype)
        sees_cut = bool(((got.double() - short.double()).abs()
                         > bound).any())
        max_err = float(err.max())
        worst = max(worst, max_err)
        kind = {"scalar": 0, "row": 0, "col": 1, "full": 2}[skind]
        regs = ptxas.get(("dequant_matmul_kernel", dqmm.block_m(M, K),
                          names[q.dtype], kind, names[w.dtype]))
        line = (f"dequant_matmul {name:>13} M={M} K={K} N={N} q={q.dtype} "
                f"scale={skind} w={w.dtype} out={odt} splits={splits}x{per} "
                f"block_m={dqmm.block_m(M, K)} ptxas(regs, spill st, spill "
                f"ld)={regs} max_abs_err={max_err:.3e} max_err_over_bound="
                f"{float((err / bound).max()):.3e} sees_missing_slice="
                f"{sees_cut}")
        if qkind == "zero rows":
            ok = ok and bool((got[[3, 11]] == 0).all())
        if name in B2_TIMED:
            copies = [w] + [w.clone() for _ in range(max(
                1, -(-2 * L2_BYTES // (w.numel() * w.element_size()))))]
            ms = _time_cold_ms([lambda c=c: dqmm.dequant_matmul(q, s, c)
                                for c in copies], reps=24)
            warm_ms = _time_ms(lambda: dqmm.dequant_matmul(q, s, w))
            plain_ms = _time_cold_ms([lambda c=c: ref.dequant_matmul_ref(
                q, s, c) for c in copies], reps=24)
            library_ms = _time_cold_ms([lambda c=c: torch.matmul(
                q.float() * s2, c.float()) for c in copies], reps=24)
            call_ms = _call_ms(lambda: dqmm.dequant_matmul(q, s, w))
            (bound_ms, bound_by), (first_ms, first_by) = _b2_bounds(
                M, K, N, q, s, w, skind)
            line += (f" ms={ms:.4f} warm_ms={warm_ms:.4f} plain_ms="
                     f"{plain_ms:.4f} library_ms={library_ms:.4f} bound_ms="
                     f"{bound_ms:.4f} ({bound_by}) first_bound_ms="
                     f"{first_ms:.4f} ({first_by}) bound_share="
                     f"{bound_ms / ms:.3f} call_ms={call_ms:.4f}")
            rows[name] = dict(ms=ms, warm_ms=warm_ms, plain_ms=plain_ms,
                              library_ms=library_ms, bound_ms=bound_ms,
                              bound_by=bound_by, first_bound_ms=first_ms,
                              call_ms=call_ms, ptxas=regs,
                              shape=dict(M=M, K=K, N=N, q=str(q.dtype),
                                         w=str(w.dtype)))
            del copies
        print(line)
        if not torch.equal(got, again):
            raise AssertionError(f"dequant_matmul at {name}: two runs differ")
        if not ok:
            raise AssertionError(f"dequant_matmul breaks its bound at {name}:"
                                 f" max_abs_err {max_err}")
        if not sees_cut:
            raise AssertionError(f"the bound at {name} does not tell the plain"
                                 " version from one missing its last slice")
        del q, s, w, got, again, want, bound, err, short
        torch.cuda.empty_cache()
    _b2_nonfinite_rows(dqmm, ref, gen, dev)
    q = torch.zeros(4, 8, dtype=torch.int8, device=dev)
    try:
        dqmm.dequant_matmul(q, torch.ones(3, 5, device=dev),
                            torch.ones(8, 2, device=dev))
    except ValueError as e:
        print(f"dequant_matmul bad scale shape raises: {e}")
    else:
        raise AssertionError("a [3, 5] scale for q [4, 8] did not raise")
    top = rows["main"]
    return {"name": "dequant_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/dequant_matmul.cu",
            "replaces": "src/repro/kernels/dequant_matmul.py:99",
            "launches": None, "max_abs_err": worst, "ms": top["ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            "first_bound_ms": top["first_bound_ms"],
            "warm_ms": top["warm_ms"], "call_ms": top["call_ms"],
            "shape": top["shape"], "ptxas": top["ptxas"],
            "bf16_w": rows["bf16 w"], "K_32768": rows["K 32768"],
            "M_4096": rows["M 4096"], "N_510": rows["N 510"]}


TIERED_PLAN = {1: {"f32": 6, "int8": 3, None: 1},
               2: {"f32": 6, "fp16": 3, "int8": 1},
               3: {"f32": 8, "fp16": 2}}


def _tiered_fleet():
    """CIFAR-10's own 50,000 training samples (SyntheticVision, 32 x 32 x 3,
    10 classes) over 10 clients, Dirichlet alpha 1.0, the paper's
    high-contention memory pool (0.5-2 GiB)."""
    from repro_torch.data.partition import dirichlet_partition
    from repro_torch.data.synthetic import SyntheticVision
    from repro_torch.fl.client import make_client_fleet
    sv = SyntheticVision(num_classes=10, image_size=32, seed=0)
    train = sv.sample(50_000, seed=1)
    parts = dirichlet_partition(train["y"], 10, alpha=1.0, seed=0)
    return (make_client_fleet(train, parts, scenario="high", seed=0),
            sv.sample(1000, seed=2))


class _group_log:
    """Records every fused group a RoundEngine runs inside the ``with``:
    (tier, client count, the dtype and device of the batch's ``x``, the
    device of the group's aggregate)."""

    def __enter__(self):
        from repro_torch.fl import engine
        self.cls = engine.RoundEngine
        self.run_fused = run_fused = self.cls._run_fused
        self.batches = batches = self.cls._client_batches
        log, seen = [], {}

        def client_batches(eng, client, plan, tier):
            out = batches(eng, client, plan, tier)
            seen[tier] = (out["x"].dtype, out["x"].device,
                          "x_scale" in out)
            return out

        def logged(eng, clients, cids, params, state, round_idx, *, tier,
                   **kw):
            out = run_fused(eng, clients, cids, params, state, round_idx,
                            tier=tier, **kw)
            from repro_torch.models.module import tree_leaves
            log.append(dict(tier=tier, n=len(cids), x=seen[tier],
                            agg_device=tree_leaves(out[0])[0].device.type))
            return out
        self.cls._client_batches = client_batches
        self.cls._run_fused = logged
        return log

    def __exit__(self, *exc):
        self.cls._run_fused = self.run_fused
        self.cls._client_batches = self.batches


def phase_tiered_path(card):
    """The memory tiers on the card: ``SmartFreezeServer.run`` on
    full-width ResNet-18 with ``cache_tiers="all"`` (f32 -> fp16 -> int8)
    and ``compute_dtype="bfloat16"``, 10 clients a round (the whole fleet),
    batch 32, top-k uplinks at ratio 0.1, ``schedule=[0, 1, 1, 1]``: stage
    0, which has no frozen prefix and so no cache, is skipped to keep the
    script inside its time limit (its round of 1,557 local steps took 20.4
    s), and stage 1's first round bootstraps the selector. Every
    kernel's launch count is set to 0 just before and read just after.
    Asserts the ladder's plan per stage and that every tier group ran on
    the card with its stored dtype."""
    import torch
    from collections import Counter
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import block_perturb, dequant_matmul, sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    dev = torch.device("cuda")
    clients, test = _tiered_fleet()
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))
    srv = SmartFreezeServer(model, clients, clients_per_round=10,
                            batch_size=32, local_epochs=1,
                            compress_ratio=RATIO, seed=0, cache_tiers="all",
                            compute_dtype="bfloat16", device="cuda")
    for stage, want in TIERED_PLAN.items():
        got = dict(Counter(srv._cache_plan(stage).values()))
        print(f"tiered plan stage {stage}: {got}")
        assert got == want, (stage, got, want)
    tx = torch.as_tensor(test["x"], device=dev)
    ty = torch.as_tensor(test["y"], device=dev).long()
    marks, engines, fills = [], [], []
    stage_engine = srv._stage_engine

    def keep_engine(stage, frozen, bn_state):
        eng = stage_engine(stage, frozen, bn_state)
        features_for = eng.features_for

        def timed_fill(client, tier="f32"):
            if client.client_id in eng._features:
                return features_for(client, tier)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = features_for(client, tier)
            torch.cuda.synchronize()
            fills.append((stage, (time.perf_counter() - t0) * 1e3))
            return out
        eng.features_for = timed_fill
        engines.append((stage, eng))
        return eng
    srv._stage_engine = keep_engine

    def eval_fn(p, s, stage):
        torch.cuda.synchronize()
        t_in = time.perf_counter()
        with torch.no_grad():
            logits = model.apply(p, s, tx, train=False)[0]
            acc = float((logits.argmax(-1) == ty).float().mean())
        torch.cuda.synchronize()
        marks.append((t_in, time.perf_counter()))
        return acc

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with _group_log() as groups:
        sparse_agg.launches = block_perturb.launches = 0
        dequant_matmul.launches = 0
        torch.cuda.synchronize()
        t_start = time.perf_counter()
        out = srv.run(params, state, eval_fn=eval_fn, eval_every=1,
                      schedule=[0, 1, 1, 1])
        torch.cuda.synchronize()
        b1, b3, b2 = (sparse_agg.launches, block_perturb.launches,
                      dequant_matmul.launches)
    total_s = time.perf_counter() - t_start
    peak = torch.cuda.max_memory_allocated()
    hist = out["history"]
    prev_end = t_start
    for rr, (t_in, t_out) in zip(hist, marks):
        wall_ms = (t_in - prev_end) * 1e3
        prev_end = t_out
        fill_ms = sum(ms for st, ms in fills if st == rr.stage)
        eng = dict(engines)[rr.stage]
        by_tier = {}
        for cid, tier in eng.cache_tiers().items():
            by_tier[tier] = by_tier.get(tier, 0) + eng._features[cid].nbytes
        share = {t: round(b / max(rr.cache_bytes, 1), 4)
                 for t, b in by_tier.items()}
        print(f"tiered round {rr.round_idx} stage {rr.stage} loss "
              f"{rr.loss:.4f} wall_ms {wall_ms:.1f} (cache fill "
              f"{fill_ms:.1f}) cache_bytes {rr.cache_bytes} by tier "
              f"{by_tier} share {share} uplink_bytes {rr.uplink_bytes} "
              f"test_acc {rr.test_acc:.3f}")
    print(f"tiered groups run: {[(g['tier'], g['n'], str(g['x'][0]), g['x'][1].type, g['agg_device']) for g in groups]}")
    print(f"tiered path seconds {total_s:.2f} (round 0, stage 1's, "
          f"includes the Eq. 8 bootstrap) on {card}; "
          f"torch.cuda.max_memory_allocated {peak}")
    assert [r.stage for r in hist] == [1, 2, 3]
    assert all(math.isfinite(r.loss) for r in hist), [r.loss for r in hist]
    leaves = tree_leaves(out["params"]) + tree_leaves(out["state"])
    assert all(l.device.type == "cuda" and l.dtype == torch.float32
               for l in leaves)
    assert all(bool(torch.isfinite(l).all()) for l in leaves)
    stored = {"f32": torch.float32, "fp16": torch.float16,
              "int8": torch.int8, None: torch.float32}
    i = expected_b1 = 0
    for rr in hist:
        plan = srv._cache_plan(rr.stage)
        want = dict(Counter(plan.get(c) for c in rr.selected))
        ran = groups[i:i + len(want)]
        i += len(want)
        assert {g["tier"]: g["n"] for g in ran} == want, (rr.stage, ran)
        for g in ran:
            assert g["x"][0] == stored[g["tier"]], g
            assert g["x"][1].type == "cuda" and g["agg_device"] == "cuda", g
            assert g["x"][2] == (g["tier"] == "int8"), g
        _, active = fz.init_cnn_stage_active(model, out["params"], rr.stage,
                                             torch.Generator().manual_seed(0))
        expected_b1 += len(tree_leaves(active)) * len(want)
    assert i == len(groups)
    print(f"tiered path launches: sparse_cohort_add {b1} (expected "
          f"{expected_b1}), diff_sqnorm {b3} (expected 0: one round a "
          f"stage takes first snapshots only), dequant_matmul {b2} "
          f"(expected 0: conv-first consumers dequantize first)")
    assert b1 == expected_b1 and b3 == 0 and b2 == 0, (b1, b3, b2)
    srv._stage_engine = stage_engine
    engines.clear()
    return b1, b3, out["params"], out["state"], srv


PROFILE_SAMPLES = 640  # a client's shard cut to 20 steps of 32 to profile


def phase_tiered_profile(card, params, state, srv):
    """Where a tiered round's time goes: stage 2 (all three tiers), a
    cohort of one client per tier, each client's shard cut to its first
    ``PROFILE_SAMPLES`` samples (the per-step work is the full run's; the
    profiler's cost grows with the steps), one warm-up round (cache fill),
    one round on the host clock and one under torch.profiler."""
    import dataclasses
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import freezing_cnn as fz
    plan = srv._cache_plan(2)
    cohort = [min((c for c, t in plan.items() if t == tier),
                  key=lambda c: srv.clients[c].num_samples)
              for tier in ("f32", "fp16", "int8") if tier in plan.values()]
    clients = {c: dataclasses.replace(srv.clients[c], data={
        k: v[:PROFILE_SAMPLES] for k, v in srv.clients[c].data.items()})
        for c in cohort}
    frozen, active = fz.init_cnn_stage_active(
        srv.model, params, 2, torch.Generator().manual_seed(2))
    engine = srv._stage_engine(2, frozen, state)
    use_cache = {c: plan[c] for c in cohort}
    steps = sum(clients[c].num_samples // 32 for c in cohort)

    def one_round(r):
        engine.run_round(clients, cohort, active, state, r,
                         use_cache=use_cache)
        torch.cuda.synchronize()

    one_round(0)
    t0 = time.perf_counter()
    one_round(1)
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        one_round(2)
    by_class = _device_us_by_class(prof)
    busy_ms = sum(by_class.values()) / 1e3
    print(f"tiered profile stage 2, cohort {cohort} ({use_cache}), "
          f"{steps} local steps in bf16: round wall_ms {wall_ms:.1f}, cache "
          f"bytes {engine.cache_nbytes()} on {card}")
    if not by_class:
        print("  torch.profiler recorded no device time: not measured")
        return
    print(f"  device busy ms {busy_ms:.1f}, idle share "
          f"{1 - busy_ms / wall_ms:.3f}")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls:>20}: {us / 1e3:9.2f} ms")


def quant_aware_consumer(params, frozen, state, batch):
    """The reference's quant-aware consumer
    (``tests/test_kernel_conformance.py:test_quant_aware_int8_round_pallas_parity``):
    ``tanh(tiered_matmul(x, x_scale, w1) + b1) @ w2`` and log-softmax NLL.
    ``h @ w2`` promotes a bf16 w2 to f32, as ``jnp`` promotes it."""
    import torch
    from repro_torch.fl.quant import tiered_matmul
    h = torch.tanh(tiered_matmul(batch["x"], batch.get("x_scale"),
                                 params["w1"]) + params["b1"])
    logp = torch.log_softmax(h @ params["w2"].to(h.dtype), dim=-1)
    nll = -logp.gather(1, batch["y"].long()[:, None])
    return nll.mean(), state


quant_aware_consumer.consumes_quantized = True


def _quant_aware_engine(model, params, bn_state, stage, device,
                        compute_dtype=None):
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.fl.engine import RoundEngine
    from repro_torch.optim import sgd
    frozen, _ = fz.split_cnn_params(model, params, stage)

    def feature_fn(x):
        h = fz.cnn_prefix_features(model, frozen, bn_state, x, stage)
        return h.reshape(h.shape[0], -1)
    return RoundEngine(loss_fn=quant_aware_consumer, optimizer=sgd(0.05),
                       cached_loss_fn=quant_aware_consumer,
                       feature_fn=feature_fn, batch_size=32,
                       compute_dtype=compute_dtype, device=device)


def _consumer_params(D, H, C, device, seed=0):
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    return {"w1": torch.as_tensor((rng.randn(D, H) / np.sqrt(D)).astype(
                np.float32), device=device),
            "b1": torch.zeros(H, device=device),
            "w2": torch.as_tensor((rng.randn(H, C) * 0.3).astype(
                np.float32), device=device)}


def phase_quant_aware(card, params, state, clients):
    """The path that launches B2: ``RoundEngine.run_round`` at ResNet-18's
    stage 3 over the whole fleet, every client's cache int8. The features
    are the frozen prefix (stem and stages 0-2 of the tiered run's
    params), flattened to [N, 8 x 8 x 256 = 16,384], so the 2-D quantizer
    gives [N, 1] row scales; the consumer's w1 is [16,384, 512], 512 being
    ResNet-18's final width, over 10 classes. One round in f32 and one in
    bf16 compute (sharing the int8 cache), counts set to 0 before each
    and read after: one B2 launch per local step. Then a round of the two
    smallest clients on the host clock and one under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.fl.client import batch_index_plan
    from repro_torch.kernels import dequant_matmul, sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    model = CNN(RESNET18, device="cuda")
    by_id = {c.client_id: c for c in clients}
    cohort = sorted(by_id)
    use_cache = {c: "int8" for c in cohort}
    consumer = _consumer_params(16384, 512, 10, "cuda")
    f32 = _quant_aware_engine(model, params, state, 3, "cuda")
    bf16 = _quant_aware_engine(model, params, state, 3, "cuda", "bfloat16")
    launches, walls = {}, {}
    for name, eng, r in (("f32", f32, 0), ("bf16", bf16, 1)):
        steps = sum(len(batch_index_plan(by_id[c].num_samples, 32, 1,
                                         by_id[c].round_seed(r)))
                    for c in cohort)
        if name == "bf16":
            bf16._features = f32._features  # the same int8 cache
        torch.cuda.synchronize()
        dequant_matmul.launches = sparse_agg.launches = 0
        t0 = time.perf_counter()
        p, _, losses = eng.run_round(by_id, cohort, consumer, {}, r,
                                     use_cache=use_cache)
        torch.cuda.synchronize()
        walls[name] = (time.perf_counter() - t0) * 1e3
        launches[name] = dequant_matmul.launches
        enc = eng._features[cohort[0]]
        print(f"quant-aware {name} round: {steps} local steps, "
              f"dequant_matmul launches {launches[name]}, wall_ms "
              f"{walls[name]:.1f}{' (includes the cache fill)' if name == 'f32' else ''}, "
              f"cache {eng.cache_nbytes()} B ({enc.values.dtype} "
              f"{tuple(enc.values.shape)}, scale {tuple(enc.scale.shape)}), "
              f"mean loss {sum(losses.values()) / len(losses):.4f} on {card}")
        assert launches[name] == steps > 0, (name, launches[name], steps)
        assert sparse_agg.launches == 0
        assert all(math.isfinite(v) for v in losses.values()), losses
        assert enc.values.dtype == torch.int8 and enc.scale.shape[1:] == (1,)
        assert all(l.device.type == "cuda" and l.dtype == torch.float32
                   and bool(torch.isfinite(l).all())
                   for l in tree_leaves(p))
    # the profiled round: the two smallest clients (the steps' work is the
    # whole fleet's; the profiler's cost grows with the steps)
    small = sorted(cohort, key=lambda c: by_id[c].num_samples)[:2]
    steps = sum(by_id[c].num_samples // 32 for c in small)
    t0 = time.perf_counter()
    f32.run_round(by_id, small, consumer, {}, 2, use_cache=use_cache)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        f32.run_round(by_id, small, consumer, {}, 3, use_cache=use_cache)
        torch.cuda.synchronize()
    by_class = _device_us_by_class(prof)
    busy_ms = sum(by_class.values()) / 1e3
    print(f"quant-aware profile (f32, warm cache), clients {small}, {steps} "
          f"local steps: round wall_ms {wall_ms:.1f}")
    if by_class:
        print(f"  device busy ms {busy_ms:.1f}, idle share "
              f"{1 - busy_ms / wall_ms:.3f}")
        for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
            print(f"  {cls:>20}: {us / 1e3:9.2f} ms")
    else:
        print("  torch.profiler recorded no device time: not measured")
    return launches


def phase_small_tiered_reference():
    """The tiers on the card against the port's CPU path (itself held
    against the JAX package by tests/test_torch_quant.py) on a small model:
    (1) a 2-stage tiered run in bf16, six clients, four of whose memories
    put them on the f32, fp16, int8 and no-cache rungs of stage 1's
    ladder, ratio 1.0; the plans must be equal, the losses within rtol 2e-2 (bf16 convs
    sum in other orders on the two devices, and a bf16 rounding is 2^-8)
    and the params within atol 2e-2; (2) one quant-aware int8 round on the
    small model's flattened stage-1 features, losses and params within
    rtol 1e-3, atol 1e-5 (f32, the kernel's sum order against the CPU's),
    with the int8 codes of the two devices' own features at most one step
    apart."""
    import dataclasses
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.core.memory_model import cnn_stage_memory_bytes
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import dequant_matmul
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.models.module import tree_leaves
    cfg = CNNConfig("small", "resnet", stage_sizes=(1, 1),
                    stage_channels=(8, 16), num_classes=4)
    clients, _ = _fleet(384, 6, 16, 4)
    cpu_model = CNN(cfg, device="cpu")
    need = lambda c, dt: cnn_stage_memory_bytes(
        cpu_model, 1, 16, 16, cache_samples=c.num_samples, cache_dtype=dt)
    # clients 0-3 just fit stage 1 with an f32, fp16, int8 and no cache;
    # 4 and 5 keep their memory (f32), so that stage 0 has its two clients
    clients = [dataclasses.replace(c) for c in clients]
    for c, dt in zip(clients, ("float32", "float16", "int8", None)):
        c.memory_bytes = 1.0 + (need(c, dt) if dt else
                                cnn_stage_memory_bytes(cpu_model, 1, 16, 16))
    params, state = cpu_model.init(torch.Generator().manual_seed(0))
    results, plans = {}, {}
    for device in ("cpu", "cuda"):
        srv = SmartFreezeServer(CNN(cfg, device=device), clients,
                                clients_per_round=6, batch_size=16,
                                compress_ratio=1.0, seed=0,
                                cache_tiers="all", compute_dtype="bfloat16",
                                device=device)
        results[device] = srv.run(to_torch(to_numpy(params), device),
                                  to_torch(to_numpy(state), device),
                                  schedule=[1, 1])
        plans[device] = srv.cache_tier_plan
    print(f"small tiered: stage-1 plan {plans['cuda']}")
    assert plans["cpu"] == plans["cuda"]
    assert set(plans["cuda"].values()) == {"f32", "fp16", "int8", None}
    for a, b in zip(results["cpu"]["history"], results["cuda"]["history"]):
        assert a.selected == b.selected and a.stage == b.stage
        assert a.cache_bytes == b.cache_bytes
        np.testing.assert_allclose(b.loss, a.loss, rtol=2e-2)
    worst = 0.0
    for a, b in zip(tree_leaves(results["cpu"]["params"]),
                    tree_leaves(results["cuda"]["params"])):
        worst = max(worst, float((b.cpu() - a).abs().max()))
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=0,
                                   atol=2e-2)
    print(f"small tiered bf16: card == CPU path (losses "
          f"{[round(r.loss, 5) for r in results['cuda']['history']]} vs "
          f"{[round(r.loss, 5) for r in results['cpu']['history']]}, "
          f"params max abs diff {worst:.3e})")
    # a quant-aware int8 round on the small model's stage-1 features
    by_id = {c.client_id: c for c in clients}
    cohort = sorted(by_id)
    out, codes = {}, {}
    for device in ("cpu", "cuda"):
        model = CNN(cfg, device=device)
        eng = _quant_aware_engine(model, to_torch(to_numpy(params), device),
                                  to_torch(to_numpy(state), device), 1,
                                  device)
        before = dequant_matmul.launches
        out[device] = eng.run_round(by_id, cohort, _consumer_params(
            16 * 16 * 8, 32, 4, device), {}, 0,
            use_cache={c: "int8" for c in cohort})
        if device == "cuda":
            assert dequant_matmul.launches > before
        codes[device] = {c: eng._features[c] for c in cohort}
    off = [int((codes["cuda"][c].values.cpu().int()
                - codes["cpu"][c].values.int()).abs().max()) for c in cohort]
    n_off = sum(int((codes["cuda"][c].values.cpu()
                     != codes["cpu"][c].values).sum()) for c in cohort)
    total = sum(codes["cpu"][c].values.numel() for c in cohort)
    print(f"small quant-aware: int8 codes one step apart {n_off} of {total} "
          f"(largest distance {max(off)})")
    assert max(off) <= 1
    (pc, _, lc), (pg, _, lg) = out["cpu"], out["cuda"]
    np.testing.assert_allclose([lg[c] for c in cohort],
                               [lc[c] for c in cohort], rtol=1e-3, atol=1e-5)
    for a, b in zip(tree_leaves(pc), tree_leaves(pg)):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-5)
    print("small quant-aware int8 round: card == CPU path (rtol 1e-3, "
          "atol 1e-5)")


POP_N = 100_000
POP_COMMUNITIES = 64
POP_K = 64
POP_MEM = 1.5 * 2**30
POP_REL = 1e-6       # epsilon > 0: CPU scores this close may swap on the card
SKETCH_GROUPS, SKETCH_PER, SKETCH_CLASSES = 50, 2_000, 100
SKETCH_ROWS = 2_048  # sampled rows held against a CPU top-m over all N


def _population_infos(n, n_comm, seed=0):
    """``benchmarks/run.py:selector_scale``'s ``build(n)``: memory {1, 2,
    4, 8} GiB, capability {1e9, 2.5e9, 5e9} FLOP/s, 32-511 samples,
    uniform loss, a uniform random community."""
    import numpy as np
    from repro_torch.core.selector import ClientInfo
    rng = np.random.RandomState(seed)
    mem = rng.choice([1.0, 2.0, 4.0, 8.0], size=n) * 2**30
    cap = rng.choice([1e9, 2.5e9, 5e9], size=n)
    samp = rng.randint(32, 512, size=n)
    loss = rng.rand(n).astype(np.float64)
    comm = rng.randint(0, n_comm, size=n)
    infos = {i: ClientInfo(i, float(mem[i]), float(cap[i]), int(samp[i]),
                           float(loss[i])) for i in range(n)}
    return infos, comm


def _planted_label_histograms(n_groups, per, num_classes, seed=0):
    """``tests/test_vectorized_selector.py:_planted_histograms`` at scale:
    group g dominant on classes 2g (50-59 samples) and 2g + 1 (30), plus
    uniform [0, 1) noise on every class."""
    import numpy as np
    rng = np.random.RandomState(seed)
    n = n_groups * per
    group = np.arange(n) // per
    hist = np.zeros((n, num_classes))
    hist[np.arange(n), group * 2] = 50 + rng.randint(0, 10, n)
    hist[np.arange(n), group * 2 + 1] = 30
    hist += rng.rand(n, num_classes)
    return hist, group


def _sync_s(fn):
    """Host seconds of ``fn()`` between two device synchronizations."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_population(card):
    """The resident population at a deployment's size: N = 100,000 clients
    in 64 communities (``benchmarks/run.py:selector_scale``'s fleet), k =
    64, a 1.5 GiB stage.

      1. 5 rounds of ``select_arrays`` at epsilon 0 and 5 at epsilon 0.2,
         each held against the port's CPU path on the same population
         (equal at 0; at 0.2 equal except where the two clients' CPU
         scores lie within 1e-6 relative, counted), each covering all 64
         communities once, timed between synchronizations; the Gumbel draw
         timed alone;
      2. ``assign_cache_tiers`` at f32 / fp16 / int8 for ResNet-18's
         stage 1 at 32x32, equal to the CPU's;
      3. ``sketch_communities``' steps on 100,000 planted CIFAR-100 label
         histograms (50 groups of 2,000, each dominant on two classes of
         its own): sketches, ``topm_neighbors`` (sketch_dim 64, m 8) and
         label propagation timed apart; the 50 groups must come back as 50
         communities; 2,048 sampled rows' top-m weights held against a CPU
         top-m over all N columns within 1e-5."""
    import numpy as np
    import torch
    from repro_torch.core.memory_model import (CACHE_TIER_DTYPES, CACHE_TIERS,
                                               cnn_feature_cache_bytes)
    from repro_torch.core.selector import (ClientPopulation,
                                           VectorizedSelector, _threefry)
    from repro_torch.core.selector.bandit import mix_seed
    from repro_torch.core.selector.rlcd import (_merge_by_centroid,
                                                label_propagation)
    from repro_torch.core.selector.similarity import (label_sketches,
                                                      sketch_projection,
                                                      topm_neighbors)
    from repro_torch.core.selector.vectorized import (_population_stats,
                                                      assign_cache_tiers)
    from repro_torch.models.cnn import CNN, RESNET18
    t_phase = time.perf_counter()
    infos, comm = _population_infos(POP_N, POP_COMMUNITIES)
    pop_card, pop_cpu = (ClientPopulation.from_infos(
        infos, community_id=comm, n_communities=POP_COMMUNITIES, device=dev)
        for dev in ("cuda", "cpu"))
    near_ties = 0
    for eps in (0.0, 0.2):
        sel_card, sel_cpu = (VectorizedSelector(epsilon=eps, seed=7,
                                                device=dev)
                             for dev in ("cuda", "cpu"))
        ms = []
        for r in range(5):
            picks, secs = _sync_s(lambda: sel_card.select_arrays(
                pop_card, POP_K, mem_required=POP_MEM))
            ms.append(secs * 1e3)
            want = sel_cpu.select_arrays(pop_cpu, POP_K, mem_required=POP_MEM)
            assert len(picks) == POP_K == len(set(picks.tolist()))
            assert len(set(comm[picks])) == POP_COMMUNITIES, r
            diff = np.flatnonzero(picks != want)
            if eps == 0.0:
                assert diff.size == 0, (r, diff)
                continue
            if diff.size:
                g = _threefry.gumbel(mix_seed(7, r + 1), POP_N, "cpu")
                f32 = lambda v: torch.tensor(np.float32(v))
                score = _population_stats(
                    pop_cpu.memory_bytes, pop_cpu.stage_time(),
                    pop_cpu.loss_sum, pop_cpu.community_id, g, f32(POP_MEM),
                    f32(1e-3), f32(eps), n_comm=POP_COMMUNITIES + 1
                )[0].double().numpy()
                for a, b in zip(picks[diff], want[diff]):
                    gap = abs(score[a] - score[b])
                    assert gap <= POP_REL * max(abs(score[a]), abs(score[b])),\
                        (r, a, b, score[a], score[b])
                    near_ties += 1
        np.testing.assert_array_equal(pop_card.last_seen.cpu().numpy(),
                                      pop_cpu.last_seen.numpy())
        print(f"population: select_arrays N {POP_N} communities "
              f"{POP_COMMUNITIES} k {POP_K} epsilon {eps}: ms "
              f"{[round(m, 3) for m in ms]} on {card}")
    print(f"population: epsilon 0.2 picks that differ from the CPU's, each "
          f"a near tie (CPU scores within {POP_REL} relative): {near_ties}")
    draw_s = []
    for r in range(5):
        _, secs = _sync_s(lambda: _threefry.gumbel(mix_seed(7, r + 1), POP_N,
                                                   "cuda"))
        draw_s.append(secs * 1e3)
    print(f"population: Gumbel draw (numpy Threefry bits on the host, two "
          f"logs on the card) ms {[round(m, 3) for m in draw_s]}")

    # ResNet-18's stage-1 cache rates at 32x32 behind a requirement that
    # leaves the 2 GiB clients 64 MiB: their shards split over the tiers
    model = CNN(RESNET18, device="cpu")
    stage_bytes = 2 * 2**30 - 64 * 2**20
    rates = [cnn_feature_cache_bytes(model, 1, 1, 32, CACHE_TIER_DTYPES[t])
             for t in CACHE_TIERS]
    tiers, secs = _sync_s(lambda: assign_cache_tiers(pop_card, stage_bytes,
                                                     rates))
    np.testing.assert_array_equal(tiers, assign_cache_tiers(
        pop_cpu, stage_bytes, rates))
    print(f"population: assign_cache_tiers {secs * 1e3:.3f} ms, tiers "
          f"{dict(zip(*np.unique(tiers, return_counts=True)))} (-1 "
          f"declined), equal to the CPU's")

    hist, group = _planted_label_histograms(SKETCH_GROUPS, SKETCH_PER,
                                            SKETCH_CLASSES)
    proj = sketch_projection(SKETCH_CLASSES, 64, 0)
    sketches, t_sk = _sync_s(lambda: label_sketches(hist, proj,
                                                    device="cuda"))
    (nb, w), t_nb = _sync_s(lambda: topm_neighbors(sketches, 8))
    labels, t_lpa = _sync_s(lambda: label_propagation(nb, w))
    t0 = time.perf_counter()
    merged = _merge_by_centroid(labels, sketches, merge_threshold=0.9)
    t_merge = time.perf_counter() - t0
    n_comm = int(merged.max()) + 1
    print(f"population: sketch_communities N {len(hist)} (sketch_dim 64, m "
          f"8): sketches {t_sk:.4f} s, topm_neighbors {t_nb:.4f} s, label "
          f"propagation {t_lpa:.4f} s ({int(labels.max()) + 1} labels), "
          f"centroid merge {t_merge:.4f} s -> {n_comm} communities")
    assert n_comm == SKETCH_GROUPS, n_comm
    for g in range(SKETCH_GROUPS):
        assert len(set(merged[group == g].tolist())) == 1, g
    assert len({int(merged[group == g][0]) for g in range(SKETCH_GROUPS)}) \
        == SKETCH_GROUPS
    rows = np.sort(np.random.RandomState(1).choice(len(hist), SKETCH_ROWS,
                                                   replace=False))
    sk_cpu = label_sketches(hist, proj, device="cpu")
    unit = sk_cpu / torch.clamp_min(torch.sqrt((sk_cpu * sk_cpu).sum(
        1, keepdim=True)), 1e-12)
    want_w, want_i = [], []
    for lo in range(0, SKETCH_ROWS, 256):
        r = torch.as_tensor(rows[lo:lo + 256])
        sims = unit[r] @ unit.T
        sims[torch.arange(len(r)), r] = -torch.inf
        top = torch.topk(sims, 8, dim=1)
        want_w.append(top.values)
        want_i.append(top.indices)
    want_w = torch.cat(want_w).numpy()
    at = torch.as_tensor(rows, device=w.device)
    err = float(np.abs(w[at].cpu().numpy() - want_w).max())
    same_idx = float((nb[at].cpu().numpy() == torch.cat(want_i).numpy()
                      ).mean())
    print(f"population: {SKETCH_ROWS} sampled rows' top-8 weights vs a CPU "
          f"top-8 over all {len(hist)} columns: max abs err {err:.3e}; "
          f"indices equal at {same_idx:.4f} of places (cosines within an ulp "
          f"may swap)")
    assert err <= 1e-5, err
    print(f"population phase seconds {time.perf_counter() - t_phase:.2f}")


class _recorded_selects:
    """Records every ``select`` call of a selector inside the ``with``:
    (the infos it was given, k, keywords, the picks, its host ms; both
    selectors end in the picks on the host)."""

    def __init__(self, selector):
        self.selector = selector

    def __enter__(self):
        select, log = self.selector.select, []

        def recorded(clients, k, **kw):
            t0 = time.perf_counter()
            out = select(clients, k, **kw)
            ms = (time.perf_counter() - t0) * 1e3
            log.append((dict(clients), k, kw, list(out), ms))
            return out
        self.selector.select = recorded
        return log

    def __exit__(self, *exc):
        del self.selector.select


def phase_population_path(card):
    """``SmartFreezeServer.run`` with the vectorized selector on the card:
    full-width ResNet-18 over ``phase_main_path``'s fleet, cohort, batch,
    top-k ratio 0.1 and SGD, ``VectorizedSelector(seed=0, epsilon=0,
    device="cuda")``, schedule [2, 1, 1, 1] (stage 0's second round is the
    one pace observe that takes the Eq. 2 norms). B1 and B3 counted by the
    main path's rule; each round's cohort equal to the port's list
    ``ParticipantSelector(epsilon=0, seed=0)`` given the same infos and
    communities on the CPU; ``RoundEngine.residual_norms`` on the card
    finite and within 1e-6 relative of an f64 CPU norm of the same pools.
    Then the same run with that list selector, for its round walls and
    select times beside the vectorized run's: its twin, whose cohorts and
    losses must equal the vectorized run's round for round. Both runs use
    deterministic cuDNN (its default convolution backward sums with
    atomics), so with B1 summing in a fixed order they repeat each other
    bit for bit."""
    import numpy as np
    import torch
    from repro_torch.core.selector import (ParticipantSelector,
                                           VectorizedSelector)
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.kernels import block_perturb, sparse_agg
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    clients, _ = _fleet(10_000, 20, 32, 10)
    model = CNN(RESNET18, device="cuda")
    params, state = model.init(torch.Generator().manual_seed(0))

    def drive(selector):
        srv = SmartFreezeServer(model, clients, clients_per_round=COHORT,
                                batch_size=32, local_epochs=1,
                                compress_ratio=RATIO, seed=0, device="cuda",
                                selector=selector)
        engines = []
        make_engine = srv._stage_engine
        srv._stage_engine = lambda *a, **k: engines.append(
            make_engine(*a, **k)) or engines[-1]
        with _timed_observes() as observe_ms, _ticks() as ticks, \
                _recorded_selects(selector) as selects:
            sparse_agg.launches = block_perturb.launches = 0
            res, secs = _sync_s(lambda: srv.run(params, state,
                                                schedule=[2, 1, 1, 1]))
            b1, b3 = sparse_agg.launches, block_perturb.launches
        walls = [tick_ms + o_ms for (_, tick_ms, _), o_ms
                 in zip(ticks, observe_ms)]
        return srv, res, secs, ticks, walls, selects, engines, b1, b3

    selector = VectorizedSelector(seed=0, epsilon=0.0, device="cuda")
    torch.backends.cudnn.deterministic = True
    srv, res, secs, ticks, walls, selects, engines, b1, b3 = drive(selector)
    hist = res["history"]
    stages = [r.stage for r in hist]
    for rr, wall, sel in zip(hist, walls, selects):
        print(f"vectorized selector round {rr.round_idx} stage {rr.stage} "
              f"loss {rr.loss:.4f} wall_ms {wall:.1f} select_ms "
              f"{sel[4]:.3f} selected {rr.selected}")
    want_b1 = _expected_fold_launches(model, res["params"], srv, ticks,
                                      stages)
    want_b3 = _expected_b3(model, res["params"], stages)
    print(f"vectorized selector path: {secs:.2f} s on {card}; "
          f"sparse_cohort_add launches {b1} (expected {want_b1}), "
          f"diff_sqnorm launches {b3} (expected {want_b3})")
    assert stages == [0, 0, 1, 2, 3], stages
    assert all(math.isfinite(r.loss) for r in hist), [r.loss for r in hist]
    leaves = tree_leaves(res["params"]) + tree_leaves(res["state"])
    assert all(l.device.type == "cuda" for l in leaves)
    assert all(bool(torch.isfinite(l).all()) for l in leaves)
    assert b1 == want_b1 > 0, (b1, want_b1)
    assert b3 == want_b3 > 0, (b3, want_b3)

    assert len(selects) == len(hist) and selector._round == len(hist)
    listed = ParticipantSelector(epsilon=0.0, seed=0)
    listed._communities = selector._communities
    for (infos, k, kw, picks, _), rr in zip(selects, hist):
        assert picks == rr.selected
        assert listed.select(infos, k, **kw) == picks, (rr.round_idx, picks)
    print(f"vectorized selector path: {len(selects)} cohorts equal to the "
          f"list selector's on the CPU ({len(selector._communities)} "
          f"communities)")

    engine = engines[-1]
    norms, secs = _sync_s(engine.residual_norms)
    assert sorted(norms) == sorted(engine._res_row) and norms
    worst = 0.0
    for cid, got in norms.items():
        rows = np.concatenate([r.double().cpu().numpy()
                               for r in engine.client_residuals(cid)])
        want = float(np.linalg.norm(rows))
        assert math.isfinite(got) and want > 0, (cid, got)
        worst = max(worst, abs(got - want) / want)
    print(f"vectorized selector path: residual_norms of {len(norms)} clients "
          f"over {len(engine._res_pool)} leaf pools {secs * 1e3:.3f} ms, max "
          f"rel diff from f64 CPU norms {worst:.2e}")
    assert worst <= 1e-6, worst

    _, list_res, _, _, list_walls, list_selects, _, _, _ = drive(
        ParticipantSelector(epsilon=0.0, seed=0))
    torch.backends.cudnn.deterministic = False
    for rv, rl, wv, wl, sv, sl in zip(hist, list_res["history"], walls,
                                      list_walls, selects, list_selects):
        print(f"round {rv.round_idx} stage {rv.stage}: wall_ms vectorized "
              f"{wv:.1f} list {wl:.1f}; select_ms vectorized {sv[4]:.3f} "
              f"list {sl[4]:.3f}; cohorts equal {rv.selected == rl.selected}"
              f", losses equal {rv.loss == rl.loss}")
    assert len(list_res["history"]) == len(hist)
    for rv, rl in zip(hist, list_res["history"]):
        assert (rv.selected, rv.loss) == (rl.selected, rl.loss), (rv, rl)
    return b1, b3


def phase_small_population_reference():
    """The small CNN with ``VectorizedSelector(seed=0, epsilon=0.2)`` (the
    reference's default exploration) on the card and on the CPU: the
    loop's records equal, losses and params allclose at
    ``phase_small_reference``'s tolerances."""
    import numpy as np
    import torch
    from repro_torch.convert import to_numpy, to_torch
    from repro_torch.core.selector import VectorizedSelector
    from repro_torch.fl.server import SmartFreezeServer
    from repro_torch.models.cnn import CNN, CNNConfig
    from repro_torch.models.module import tree_leaves
    cfg = CNNConfig("small", "resnet", stage_sizes=(1, 1),
                    stage_channels=(8, 16), num_classes=4)
    clients, _ = _fleet(256, 8, 16, 4)
    params, state = CNN(cfg, device="cpu").init(
        torch.Generator().manual_seed(0))
    results = {}
    for device in ("cpu", "cuda"):
        srv = SmartFreezeServer(
            CNN(cfg, device=device), clients, clients_per_round=3,
            batch_size=16, compress_ratio=1.0, seed=0, device=device,
            selector=VectorizedSelector(seed=0, epsilon=0.2, device=device))
        results[device] = srv.run(to_torch(to_numpy(params), device),
                                  to_torch(to_numpy(state), device),
                                  schedule=[2, 2])
    for a, b in zip(results["cpu"]["history"], results["cuda"]["history"]):
        assert (a.selected, a.stage, a.uplink_bytes) == \
            (b.selected, b.stage, b.uplink_bytes), (a, b)
        np.testing.assert_allclose(b.loss, a.loss, rtol=1e-3, atol=1e-5)
    for a, b in zip(tree_leaves(results["cpu"]["params"]),
                    tree_leaves(results["cuda"]["params"])):
        np.testing.assert_allclose(b.cpu().numpy(), a.numpy(), rtol=1e-3,
                                   atol=1e-5)
    print(f"small model, vectorized selector at epsilon 0.2: card == CPU "
          f"path, cohorts {[r.selected for r in results['cuda']['history']]}"
          f" (rtol 1e-3, atol 1e-5)")


class _Laps:
    """Calls phases and keeps each one's host-clock seconds."""

    def __init__(self):
        self.seconds = {}

    def __call__(self, name, phase, *args, **kwargs):
        t0 = time.perf_counter()
        out = phase(*args, **kwargs)
        self.seconds[name] = time.perf_counter() - t0
        return out

    def report(self):
        print("phase seconds: " + ", ".join(
            f"{name} {s:.2f}" for name, s in self.seconds.items())
            + f"; together {sum(self.seconds.values()):.2f}")


def main():
    import torch
    t_start = time.perf_counter()
    card = phase_versions()
    logs = phase_build()
    entry = phase_sparse_agg()
    # B6's one-call profiles come early: late in a long process with many
    # profiled windows, a one-call window recorded no device activity
    decode = phase_decode_attention()
    torch.cuda.empty_cache()
    perturb = phase_block_perturb()
    entry["launches"], cnn_b3 = phase_main_path(card)
    phase_profile(card)
    phase_fused_repeat(card)
    phase_small_reference()
    policies = phase_policies(card)
    phase_small_policies_reference()
    baselines = phase_baselines(card)
    phase_small_baselines_reference()
    faults = phase_faults(card)
    phase_small_faults_reference()
    resume = phase_resume(card)
    flash = phase_flash_attention(logs)
    (llama_flash, _, llama_b3), params, cfg = phase_lm_main_path(card)
    phase_lm_profile(card, params, cfg, exact_raises=True)
    del params
    phase_small_lm_reference()
    torch.cuda.empty_cache()  # the training phases' trees are gone
    llama_decode = phase_serve(card)
    phase_decode_profile(card)
    phase_small_serve_reference()
    torch.cuda.empty_cache()
    scan = phase_ssd_scan(logs)
    (hybrid_flash, scan["launches"], hybrid_b3), params, cfg = \
        phase_lm_main_path(card, "zamba2-7b", steps=6, expect=(61, 242, 0))
    phase_lm_profile(card, params, cfg, stages=(0, 5))
    del params
    phase_small_lm_reference("zamba2-7b")
    torch.cuda.empty_cache()
    hybrid_decode = phase_serve(card, "zamba2-7b", SERVE_SHORT,
                                expect=1_664)
    phase_decode_profile(card, "zamba2-7b", (("length 256", 256),))
    phase_small_serve_reference("zamba2-7b")
    torch.cuda.empty_cache()
    lap = _Laps()
    (xlstm_flash, _, xlstm_b3), params, cfg = lap("xlstm-350m train",
                                                  phase_lm_main_path,
                                                  card, "xlstm-350m", steps=8,
                                                  expect=(12, 0, None))
    lap("xlstm-350m profile", phase_lm_profile, card, params, cfg,
        stages=(0, 3))
    lap("xlstm-350m sLSTM loop", phase_slstm_loop, card, params, cfg)
    del params
    lap("xlstm-350m small train", phase_small_lm_reference, "xlstm-350m")
    torch.cuda.empty_cache()
    assert lap("xlstm-350m serve", phase_serve, card, "xlstm-350m",
               SERVE, expect=0) == 0
    lap("xlstm-350m decode profile", phase_decode_profile, card,
        "xlstm-350m", (("length 256", 256),))
    lap("xlstm-350m small serve", phase_small_serve_reference, "xlstm-350m")
    torch.cuda.empty_cache()
    (mla_flash, _, mla_b3), params, cfg = lap(
        "minicpm3-4b train", phase_lm_main_path, card, "minicpm3-4b",
        steps=12, expect=(30, 0, None), use_pallas=False)
    lap("minicpm3-4b profile", phase_lm_profile, card, params, cfg,
        stages=(0, 5))
    del params
    lap("minicpm3-4b small train", phase_small_lm_reference, "minicpm3-4b")
    torch.cuda.empty_cache()
    assert lap("minicpm3-4b serve", phase_serve, card, "minicpm3-4b",
               SERVE_SHORT, expect=0) == 0
    lap("minicpm3-4b decode profile", phase_decode_profile, card,
        "minicpm3-4b", (("length 256", 256),))
    lap("minicpm3-4b small serve", phase_small_serve_reference,
        "minicpm3-4b")
    torch.cuda.empty_cache()
    _register_moe_cuts()
    moe_layer_flash = lap("grok-1-314b attn_moe layer", phase_moe_layer, card)
    (ds_flash, _, ds_b3), params, cfg = lap(
        "deepseek-v2-236b-depth2 train", phase_lm_main_path, card,
        "deepseek-v2-236b-depth2", steps=4, expect=(2, 0, None),
        use_pallas=False)
    # the pace window's fit check counts the peak above what is held as the
    # round's transients: the trainer's own window, freed now, is not one
    torch.cuda.reset_peak_memory_stats()
    lap("deepseek-v2-236b-depth2 profile", phase_lm_profile, card, params,
        cfg, stages=(0, 1))
    del params
    torch.cuda.empty_cache()
    lap("deepseek-v2-236b small train", phase_small_lm_reference,
        "deepseek-v2-236b")
    lap("grok-1-314b small train", phase_small_lm_reference, "grok-1-314b")
    torch.cuda.empty_cache()
    grok_decode = lap("grok-1-314b-depth4 serve", phase_serve, card,
                      "grok-1-314b-depth4", SERVE, expect=1_024)
    lap("grok-1-314b-depth4 decode profile", phase_decode_profile, card,
        "grok-1-314b-depth4", (("length 256", 256),))
    lap("grok-1-314b small serve", phase_small_serve_reference,
        "grok-1-314b")
    torch.cuda.empty_cache()
    assert lap("deepseek-v2-236b-depth7 serve", phase_serve, card,
               "deepseek-v2-236b-depth7", SERVE, expect=0) == 0
    lap("deepseek-v2-236b-depth7 decode profile", phase_decode_profile, card,
        "deepseek-v2-236b-depth7", (("length 256", 256),))
    lap("deepseek-v2-236b small serve", phase_small_serve_reference,
        "deepseek-v2-236b")
    torch.cuda.empty_cache()
    # the modality frontends: the InternVL2 vision stub and the HuBERT
    # audio encoder
    (vlm_flash, _, vlm_b3), params, cfg = lap(
        "internvl2-2b train", phase_lm_main_path, card, "internvl2-2b",
        steps=8, expect=(132, 0, 72))
    lap("internvl2-2b profile", phase_lm_profile, card, params, cfg,
        stages=(0, 3))
    vlm_cached = lap("internvl2-2b cached round", phase_lm_cached_round,
                     card, params, cfg)
    del params
    lap("internvl2-2b small train", phase_small_lm_reference, "internvl2-2b")
    torch.cuda.empty_cache()
    (audio_flash, _, audio_b3), params, cfg = lap(
        "hubert-xlarge train", phase_lm_main_path, card, "hubert-xlarge",
        steps=8, expect=(252, 0, 88))
    lap("hubert-xlarge profile", phase_lm_profile, card, params, cfg,
        stages=(0, 3))
    del params
    lap("hubert-xlarge small train", phase_small_lm_reference,
        "hubert-xlarge")
    torch.cuda.empty_cache()
    vlm_decode = lap("internvl2-2b serve", phase_serve, card, "internvl2-2b",
                     SERVE, expect=6_144)
    lap("internvl2-2b decode profile", phase_decode_profile, card,
        "internvl2-2b", (("length 256", 256),))
    lap("internvl2-2b small serve", phase_small_serve_reference,
        "internvl2-2b")
    torch.cuda.empty_cache()
    lap.report()
    dequant = phase_dequant_matmul(logs)
    tiered_b1, tiered_b3, params, state, srv = phase_tiered_path(card)
    phase_tiered_profile(card, params, state, srv)
    qa = phase_quant_aware(card, params, state, list(srv.clients.values()))
    del params, state, srv
    torch.cuda.empty_cache()
    phase_small_tiered_reference()
    t0 = time.perf_counter()
    phase_population(card)
    t1 = time.perf_counter()
    pop_b1, pop_b3 = phase_population_path(card)
    t2 = time.perf_counter()
    phase_small_population_reference()
    print(f"phase seconds: population {t1 - t0:.2f}, population path "
          f"{t2 - t1:.2f}, small population reference "
          f"{time.perf_counter() - t2:.2f}")
    # launches: the sum over the main paths that run the kernel
    entry["launches_by_path"] = {"resnet18 sync": entry["launches"],
                                 "resnet18 tiered bf16": tiered_b1}
    entry["launches_by_path"].update(
        {f"resnet18 {name}": b1 for name, (b1, _) in policies.items()})
    entry["launches_by_path"].update(
        {f"resnet18 {name}": b1 for name, b1 in baselines.items()})
    entry["launches_by_path"].update(
        {name: b1 for name, (b1, _) in faults.items() if b1})
    entry["launches_by_path"].update(
        {name: b1 for name, (b1, _) in resume.items()
         if name.startswith("resnet18")})
    entry["launches_by_path"]["resnet18 vectorized selector"] = pop_b1
    entry["launches"] = sum(entry["launches_by_path"].values())
    flash["launches_by_path"] = {
        "llama3-8b train": llama_flash, "zamba2-7b train": hybrid_flash,
        "llama3-8b resume": resume["llama3-8b resume"][0],
        "xlstm-350m train": xlstm_flash, "minicpm3-4b train": mla_flash,
        "grok-1-314b attn_moe layer": moe_layer_flash,
        "deepseek-v2-236b-depth2 train": ds_flash,
        "internvl2-2b train": vlm_flash, "hubert-xlarge train": audio_flash,
        "internvl2-2b cached": vlm_cached}
    flash["launches"] = sum(flash["launches_by_path"].values())
    decode["launches_by_path"] = {"llama3-8b serve": llama_decode,
                                  "zamba2-7b serve": hybrid_decode,
                                  "grok-1-314b-depth4 serve": grok_decode,
                                  "internvl2-2b serve": vlm_decode}
    decode["launches"] = sum(decode["launches_by_path"].values())
    perturb["launches_by_path"] = {"resnet18 sync": cnn_b3,
                                   "llama3-8b train": llama_b3,
                                   "zamba2-7b train": hybrid_b3,
                                   "xlstm-350m train": xlstm_b3,
                                   "minicpm3-4b train": mla_b3,
                                   "deepseek-v2-236b-depth2 train": ds_b3,
                                   "internvl2-2b train": vlm_b3,
                                   "hubert-xlarge train": audio_b3,
                                   "resnet18 tiered bf16": tiered_b3}
    perturb["launches_by_path"].update(
        {f"resnet18 {name}": b3 for name, (_, b3) in policies.items()})
    perturb["launches_by_path"].update(
        {name: b3 for name, (_, b3) in faults.items()})
    perturb["launches_by_path"].update(
        {name: b3 for name, (_, b3) in resume.items() if b3})
    perturb["launches_by_path"]["resnet18 vectorized selector"] = pop_b3
    perturb["launches"] = sum(perturb["launches_by_path"].values())
    dequant["launches_by_path"] = {
        "resnet18 quant-aware int8 f32": qa["f32"],
        "resnet18 quant-aware int8 bf16": qa["bf16"]}
    dequant["launches"] = qa["f32"] + qa["bf16"]
    print(f"chip_smoke seconds {time.perf_counter() - t_start:.1f}")
    print(json.dumps({"kernels": [entry, flash, decode, scan, perturb,
                                  dequant]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    try:
        main()
    except Exception:  # report and fail; never print a result
        traceback.print_exc()
        sys.exit(1)
