"""One ``chip_smoke.py`` phase of two checkouts, timed in turns on one card:
A, B, B, A, each turn in a fresh process that builds the phase's kernel
from that checkout's sources (into the checkout's own ``build/``) and calls
the phase, passing ``phase_build``-style build logs where the phase takes
them. Prints each turn's output under a header naming the checkout.

    python3 tools/compare_phase.py PARENT_DIR . dequant_matmul
    python3 tools/compare_phase.py build/parent . dequant_matmul --kernel dequant_matmul

The first argument is typically an unpacked ``git archive`` of the parent
commit in a directory that ``.gitignore`` lists; both checkouts need the
card and nvcc.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

CODE = """
import inspect, sys, time
sys.path.insert(0, {root!r})
import chip_smoke as c
from repro_torch.kernels import _build
c.phase_versions()
t0 = time.perf_counter()
logs = _build.build([{kernel!r}])
print("build seconds", round(time.perf_counter() - t0, 2))
phase = getattr(c, "phase_" + {phase!r})
if inspect.signature(phase).parameters:
    phase(logs)
else:
    phase()
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("a", help="first checkout (timed first and last)")
    ap.add_argument("b", help="second checkout (timed in the middle)")
    ap.add_argument("phase", help="chip_smoke phase name without 'phase_'")
    ap.add_argument("--kernel", default=None,
                    help="the kernel to build (default: the phase name)")
    args = ap.parse_args(argv)
    kernel = args.kernel or args.phase
    rc = 0
    for label, root in (("A", args.a), ("B", args.b), ("B", args.b),
                        ("A", args.a)):
        root = os.path.abspath(root)
        print(f"===== {label}: {root} =====", flush=True)
        r = subprocess.run([sys.executable, "-c", CODE.format(
            root=root, kernel=kernel, phase=args.phase)], cwd=root,
            capture_output=True, text=True)
        print(r.stdout, flush=True)
        if r.returncode:
            print(r.stderr[-5000:], flush=True)
            rc = r.returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
