"""Design runs of kernel B1 (``src/repro_torch/kernels/csrc/sparse_agg.cu``)
on the card: builds of the source with other design choices, and the
parent's atomic kernel, timed in turns in one process.

Each variant is the landed source with a few text edits (one tile size
at every leaf length, a wider segment search, no one-block shortcut),
compiled with the landed flags into ``build/b1_variants/``; all ``nvcc``
processes start together. ``--parent DIR`` adds the atomic kernel of an earlier
checkout (``DIR/src/repro_torch/kernels/csrc/sparse_agg.cu``, e.g. an
unpacked ``git archive`` of the parent commit), called as its wrapper
called it: the output zeroed by ``torch.zeros`` on the stream, then one
launch over the K * k entries. Every case is K = 6 clients at a ResNet-18
leaf length with k = topk_keep(L, 0.1) distinct ascending indices a row
(``chip_smoke.phase_sparse_agg``'s inputs), timed as that phase times it
(``chip_smoke._time_ms``: device time a call, inputs warm in L2), the
variants in the order given and then in the reverse order. An ordered
variant must equal the plain version run on the CPU bit for bit; the
atomic one is checked against it within 1e-6 x (1 + sum |contributions|).
``index_add_`` into a zeroed vector is timed beside them. Prints one line
per (variant, leaf, turn), then each variant's B1 device time summed over
the leaves of a round of each stage (the main path folds every active leaf
of the stage once a round, ``chip_smoke.phase_main_path``).

    python3 tools/b1_design_runs.py [--parent build/parent]   # needs the card
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "src"))

import chip_smoke  # noqa: E402  (the phase's inputs and timers)

# name: source edits (old, new)
VARIANTS = {
    "landed": (),
    "tile 4096 at every length": (
        ("constexpr long long kSmallTileLength = 1 << 20;",
         "constexpr long long kSmallTileLength = 0;"),),
    "tile 2048 at every length": (
        ("constexpr long long kSmallTileLength = 1 << 20;",
         "constexpr long long kSmallTileLength = 1LL << 40;"),),
    "8 probes a lane": (("constexpr int kProbes = 1;",
                         "constexpr int kProbes = 8;"),),
    "no one-block shortcut": (("  if (gridDim.x == 1) {",
                               "  if (false) {"),),
}
OUT = os.path.join(ROOT, "build", "b1_variants")


def _build(sources):
    """{name: library path}, every source compiled at once."""
    from repro_torch.kernels import _build as kb
    os.makedirs(OUT, exist_ok=True)
    procs = {}
    for name, src in sources.items():
        stem = name.replace(" ", "_").replace("(", "").replace(")", "")
        cu = os.path.join(OUT, f"{stem}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"{stem}.so")
        procs[name] = (subprocess.Popen(
            [kb._nvcc(), *kb.flags("sparse_agg"), "-o", so, cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{log}")
        regs = [line.strip() for line in log.splitlines()
                if "registers" in line]
        print(f"built {name}: {regs}")
        libs[name] = so
    return libs


def _ordered(path):
    lib = ctypes.CDLL(path)
    fn = lib.sparse_cohort_add_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(idx, vals, w, L):
        import torch
        out = torch.empty(L, dtype=torch.float32, device=idx.device)
        err = fn(idx.data_ptr(), vals.data_ptr(), w.data_ptr(),
                 out.data_ptr(), idx.shape[0], idx.shape[1], L,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return call


def _atomic(path):
    lib = ctypes.CDLL(path)
    fn = lib.sparse_cohort_add_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(idx, vals, w, L):
        import torch
        out = torch.zeros(L, dtype=torch.float32, device=idx.device)
        err = fn(idx.data_ptr(), vals.data_ptr(), w.data_ptr(),
                 out.data_ptr(), idx.numel(), idx.shape[1], L,
                 torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return out
    return call


def _stage_leaves():
    """Leaf lengths of each stage's active params (output module
    included), as the main path folds them."""
    import torch
    from repro_torch.core import freezing_cnn as fz
    from repro_torch.models.cnn import CNN, RESNET18
    from repro_torch.models.module import tree_leaves
    model = CNN(RESNET18, device="cpu")
    params, _ = model.init(torch.Generator().manual_seed(0))
    out = []
    for stage in range(len(RESNET18.stage_sizes)):
        _, active = fz.init_cnn_stage_active(model, params, stage,
                                             torch.Generator().manual_seed(0))
        out.append([int(l.numel()) for l in tree_leaves(active)])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None,
                    help="a checkout whose sparse_agg.cu is the atomic kernel")
    args = ap.parse_args(argv)
    import torch
    from repro_torch.fl.compression import topk_keep
    from repro_torch.kernels import _build as kb
    card = chip_smoke.phase_versions()
    src = open(kb.CSRC / "sparse_agg.cu").read()
    sources = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            assert old in text, (name, old)
            text = text.replace(old, new)
        sources[name] = text
    if args.parent:
        sources["parent (atomics)"] = open(os.path.join(
            args.parent, "src", "repro_torch", "kernels", "csrc",
            "sparse_agg.cu")).read()
    libs = _build(sources)
    calls = {name: (_atomic if name == "parent (atomics)" else _ordered)(so)
             for name, so in libs.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    stages = _stage_leaves()
    lengths = sorted({L for leaves in stages for L in leaves})
    times = {name: {} for name in calls}
    for L in lengths:
        K, k = chip_smoke.COHORT, topk_keep(L, chip_smoke.RATIO)
        idx = torch.stack([torch.sort(torch.randperm(
            L, generator=gen, device=dev)[:k]).values
            for _ in range(K)]).to(torch.int32)
        vals = torch.randn(K, k, generator=gen, device=dev)
        w = torch.rand(K, generator=gen, device=dev)
        w = w / w.sum()
        want = chip_smoke._fold_cpu(idx, vals, w, L)
        mag = chip_smoke._fold_cpu(idx, vals.abs(), w, L)
        for name, call in calls.items():
            got = call(idx, vals, w, L).cpu()
            if name == "parent (atomics)":
                ok = bool(((got - want).abs() <= 1e-6 * (1 + mag)).all())
            else:
                ok = torch.equal(got, want)
            assert ok, (name, L)
        flat = idx.reshape(-1).long()
        contrib = (w[:, None] * vals).reshape(-1)
        order = list(calls) + list(reversed(calls))
        for turn, name in enumerate(order):
            ms = chip_smoke._time_ms(lambda: calls[name](idx, vals, w, L))
            times[name].setdefault(L, []).append(ms)
            print(f"b1 L={L} k={k} {name}: ms={ms:.4f} (turn {turn})")
        lib_ms = chip_smoke._time_ms(lambda: torch.zeros(
            L, device=dev).index_add_(0, flat, contrib))
        times.setdefault("index_add_", {})[L] = [lib_ms]
        print(f"b1 L={L} k={k} index_add_: ms={lib_ms:.4f}")
    for name, by_len in times.items():
        best = {L: min(v) for L, v in by_len.items()}
        per_stage = [sum(best[L] for L in leaves) for leaves in stages]
        print(f"b1 {name}: device ms summed over a round's folds by stage "
              + ", ".join(f"{s}: {ms:.4f} ({len(stages[s])} leaves)"
                          for s, ms in enumerate(per_stage))
              + f"; largest leaf {best[max(best)]:.4f} on {card}")


if __name__ == "__main__":
    main()
