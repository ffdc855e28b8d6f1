"""End-to-end A/B of the kernel route against the XLA route on the GPU.

Runs bgsa-align (cli.align_main) on chip_smoke.py's generated datasets
(BASELINE.json config 5 sizes) four times per family, in the order
``--backend pallas``, ``xla``, ``xla``, ``pallas`` (each route's first run
compiles cold unless the persistent cache holds it; its second is warm),
converts every result and checks them byte for byte, and prints one JSON
line per run with the stats (compile time, cal and total GCUPS) and the
card's name and power limit.

Usage:
  python scripts/route_ab.py                 # every family, full size
  python scripts/route_ab.py --scale 0.1 --only myers_global,myers_semiglobal
"""

from __future__ import annotations

import argparse
import filecmp
import json
import os
import shutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(chip_smoke.RUNS))
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the pallas, xla, xla, pallas sequence")
    args = ap.parse_args(argv)

    info = chip_smoke.phase_device()
    names = args.only.split(",")
    shutil.rmtree(chip_smoke.WORK, ignore_errors=True)
    ok = True
    try:
        paths = chip_smoke.make_data(args.scale, names)
        for name in names:
            qp, sp = paths[name]
            first = None
            same = True
            order = ("pallas", "xla", "xla", "pallas") * args.rounds
            for i, backend in enumerate(order):
                out = os.path.join(chip_smoke.WORK, name, f"{i}_{backend}")
                stats = chip_smoke.align(name, qp, sp, out,
                                         ["--backend", backend])
                chip_smoke.report(name, stats, f" --backend {backend} #{i}")
                conv = os.path.join(out, "conv.txt")
                if first is None:
                    first = conv
                    continue
                same &= filecmp.cmp(first, conv, shallow=False)
                shutil.rmtree(out)  # keep one run's output on disk
            print(json.dumps({"run": name, "routes_byte_equal": same}),
                  flush=True)
            ok &= same
            shutil.rmtree(os.path.join(chip_smoke.WORK, name))
    finally:
        shutil.rmtree(chip_smoke.WORK, ignore_errors=True)
    print(json.dumps({"ok": ok, "device": {k: info[k] for k in
                                           ("platform", "kind", "count")}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
