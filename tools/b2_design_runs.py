"""Design runs of kernel B2 (``src/repro_torch/kernels/csrc/dequant_matmul.cu``)
on the card: builds of the source with other design choices, probes, and
the landed build under other split-K plans, timed in turns in one process.

Each variant is the landed source with a few text edits (another tile
shape, k-group count or ring depth; the merge as it was first written; or,
for a probe, a part of the work taken out, whose output is wrong and whose
time says what that part costs), compiled with the landed flags into
``build/b2_variants/``; all ``nvcc`` processes start together. Every case
is timed as ``chip_smoke.py``'s B2 phase times it (cold in L2, the inputs
cycling through copies of w), the variants in the order given and then in
the reverse order; every result but a probe's is checked against the plain
version by ``chip_smoke._b2_bound``. Prints one line per (variant, case,
turn) and the ptxas register and spill counts of each build's int8-q,
row-scale kernels; writes the landed build's SASS of its 32-row int8 /
row / f32 w kernel to ``build/b2_variants/landed_sass.txt``.

    python3 tools/b2_design_runs.py      # needs the card and nvcc
"""
from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (the phase's inputs, bound and timers)

# name: source edits (old, new)
_SPLIT_W = ("        split3(x0, x1, A[0][0], A[1][0], A[2][0]);\n"
            "        split3(x2, x3, A[0][1], A[1][1], A[2][1]);\n"
            "        split3(x4, x5, A[0][2], A[1][2], A[2][2]);\n"
            "        split3(x6, x7, A[0][3], A[1][3], A[2][3]);\n")
_PACK_W = ("        A[0][0] = A[1][0] = A[2][0] = pack_top(x0, x1);\n"
           "        A[0][1] = A[1][1] = A[2][1] = pack_top(x2, x3);\n"
           "        A[0][2] = A[1][2] = A[2][2] = pack_top(x4, x5);\n"
           "        A[0][3] = A[1][3] = A[2][3] = pack_top(x6, x7);\n")
_T32 = "  static constexpr int BN = 64, BK = 64, WN = 4, KG = 2;\n  static constexpr bool CHAIN = false;\n};\ntemplate <> struct Tile<64>"
_T128 = "  static constexpr int BN = 128, BK = 32, WN = 8, KG = 2;"
_STAGES = "constexpr int kMaxStages = 4;"
_MERGE = ("  __syncthreads();\n  if (tid == 0) {\n"
          "    __threadfence();  // the block's partial, ordered by the barrier, first\n"
          "    last = atomicAdd(a.counters + tile, 1) == a.splits - 1;\n  }\n")
_MERGE_ALL_FENCE = ("  __threadfence();\n  __syncthreads();\n"
                    "  if (tid == 0) last = atomicAdd(a.counters + tile, 1) "
                    "== a.splits - 1;\n")


def _tile32(bn, bk, wn, kg):
    return ((_T32, _T32.replace("BN = 64, BK = 64, WN = 4, KG = 2",
                                f"BN = {bn}, BK = {bk}, WN = {wn}, KG = {kg}")),)


VARIANTS = {
    "landed": (),
    "merge: every thread fences, 4 loads in flight": (
        (_MERGE, _MERGE_ALL_FENCE),
        ("#pragma unroll 16\n    for (int zz = 0;",
         "#pragma unroll 4\n    for (int zz = 0;")),
    "kg32=1": _tile32(64, 64, 4, 1),
    "kg32=4": _tile32(64, 64, 4, 4),
    "bn32=128": _tile32(128, 64, 8, 2),
    "bn32=32 bk32=128 kg32=4": _tile32(32, 128, 2, 4),
    "stages=3": ((_STAGES, "constexpr int kMaxStages = 3;"),),
    "stages=6": ((_STAGES, "constexpr int kMaxStages = 6;"),),
    "kg128=1": ((_T128, _T128.replace("KG = 2", "KG = 1")),),
    "probe: empty": (("    dequant_matmul_kernel(const Args a) {\n",
                      "    dequant_matmul_kernel(const Args a) {\n"
                      "  if (a.M > 0) return;\n"),),
    "probe: no merge": ((_MERGE, "  return;\n" + _MERGE),),
    "probe: no w split": ((_SPLIT_W, _PACK_W),),
    "probe: no products": (("  asm(\n      \"mma.sync",
                            "  if (0) asm(\n      \"mma.sync"),),
    "probe: no refills": (("    if (step + STAGES - 1 < nsteps) "
                           "load_stage(step + STAGES - 1);", ""),),
}
# slices of the 32-row cases, where a variant's tile width needs another
# count to keep about one block an SM (the landed plan's otherwise)
SPLITS_OF = {"bn32=128": 32, "bn32=32 bk32=128 kg32=4": 8}
PROBE = "probe: "
CASES = ("main", "bf16 w", "K 32768", "M 4096")
# split-K plans tried with the landed build at the main shape
SPLITS = (8, 16, 32)
def build_variants():
    """Every variant built at once; prints the ptxas counts of the main
    path's instantiations and writes the landed build's SASS of its
    32-row int8 / row / f32 w kernel to build/b2_variants/landed_sass.txt."""
    from repro_torch.kernels import _build
    out_dir = os.path.join(ROOT, "build", "b2_variants")
    os.makedirs(out_dir, exist_ok=True)
    text = (_build.CSRC / "dequant_matmul.cu").read_text()
    procs = {}
    for name, edits in VARIANTS.items():
        tag = re.sub(r"\W+", "_", name)
        src = text
        for old, new in edits:
            assert old in src, (name, old)
            src = src.replace(old, new)
        cu = os.path.join(out_dir, tag + ".cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(out_dir, tag + ".so")
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.flags("dequant_matmul"), "-o", so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            print(f"{name}: nvcc failed, left out:\n{log[-3000:]}")
            continue
        ptxas = chip_smoke._ptxas_by_kernel(log)
        main = {k[1:]: v for k, v in ptxas.items()
                if k[2] == "int8" and k[3] == 0}
        print(f"{name}: built; ptxas (registers, spill store bytes, spill "
              f"load bytes) of int8 q, row scale (BM, q, scale, w): {main}")
        libs[name] = ctypes.CDLL(so)
    sass = subprocess.run([os.path.join(os.path.dirname(_build._nvcc()),
                                        "cuobjdump"), "-sass",
                           procs["landed"][0]], capture_output=True,
                          text=True).stdout
    keep = [f for f in sass.split("Function : ") if "ILi32EaLi0EfE" in f]
    with open(os.path.join(out_dir, "landed_sass.txt"), "w") as f:
        f.write("Function : ".join([""] + keep))
    return libs


def main():
    import torch
    from repro_torch.kernels import dequant_matmul as dqmm
    from repro_torch.kernels import ref
    card = chip_smoke.phase_versions()
    t0 = time.perf_counter()
    libs = build_variants()
    print(f"build seconds {time.perf_counter() - t0:.1f}")
    bound = {name: dqmm._bind(lib) for name, lib in libs.items()}
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    cases = {c[0]: c for c in chip_smoke.B2_CASES}
    for case in CASES:
        _, M, K, N, qkind, skind, wdt, _ = cases[case]
        gen = torch.Generator(device=dev).manual_seed(0)
        q, s, w = chip_smoke._b2_inputs(M, K, N, qkind, skind, wdt, gen, dev)
        want = ref.dequant_matmul_ref(q, s, w)
        lim = chip_smoke._b2_bound(q, ref.normalize_scale(s, M, K)[1], w)
        copies = [w] + [w.clone() for _ in range(max(1, -(-2 * chip_smoke.L2_BYTES // (w.numel() * w.element_size()))))]
        runs = []
        for name in bound:
            split_plan = dqmm.plan(M, N, K, sms)
            if name in SPLITS_OF and dqmm.block_m(M, K) == 32:
                per = -(-(-(-K // SPLITS_OF[name])) // 64) * 64
                split_plan = (-(-K // per), per)
            runs.append((name, name, split_plan))
        if case == "main":
            for sp in SPLITS:
                per = -(-K // sp)
                per = -(-per // 64) * 64
                runs.append((f"landed splits={sp}", "landed",
                             (-(-K // per), per)))
        for turn, order in enumerate((runs, runs[::-1])):
            for name, lib, split_plan in order:
                b = bound[lib]
                got = dqmm._launch(b, q, s, "row", 1, w, torch.float32, split_plan)
                ok = (name.startswith(PROBE) or
                      bool(((got.double() - want.double()).abs() <= lim).all()))
                ms = chip_smoke._time_cold_ms(
                    [lambda c=c: dqmm._launch(b, q, s, "row", 1, c, torch.float32, split_plan)
                     for c in copies], reps=48)
                warm = chip_smoke._time_ms(
                    lambda: dqmm._launch(b, q, s, "row", 1, w, torch.float32, split_plan))
                print(f"b2 design {case:>8} {name:>20} turn {turn} plan "
                      f"{split_plan} ms={ms:.4f} warm_ms={warm:.4f} "
                      f"holds_bound={ok} on {card}", flush=True)
                if not ok:
                    raise AssertionError(f"{name} breaks the bound at {case}")
        del copies, q, s, w, want, lim
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
