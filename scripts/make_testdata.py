"""Generate the benchmark datasets used by the perf runs (reproducible).

Usage:
  python scripts/make_testdata.py /tmp            # 20x150bp queries + 1M subjects
  python scripts/make_testdata.py /tmp --subjects 10000000
  python scripts/make_testdata.py /tmp --length 500 --queries 40
  python scripts/make_testdata.py /tmp --subjects 10000000 --filter-mix

``--filter-mix`` writes the banded read-filter workload
(bgsa_tpu.benchutil.filter_mix_subjects: 30% of the subjects are 0-5-edit
near-duplicates of the queries), generated one chunk at a time.
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

LUT = np.frombuffer(b"ACGT", np.uint8)


def _write_codes(f, codes: np.ndarray) -> None:
    n, length = codes.shape
    buf = np.empty((n, length + 1), np.uint8)
    buf[:, :length] = LUT[codes]
    buf[:, length] = ord("\n")
    f.write(buf.tobytes())


def write_dataset(outdir: str, queries: int, subjects: int, length: int,
                  seed: int = 1, filter_mix: bool = False,
                  chunk: int = 1_000_000) -> tuple[str, str]:
    """Write a query file and a subject file of random ACGT lines (or the
    read-filter mix); returns their paths."""
    from bgsa_tpu.benchutil import filter_mix_subjects

    rng = np.random.default_rng(seed)
    os.makedirs(outdir, exist_ok=True)
    tag = "_mix" if filter_mix else ""
    qp = os.path.join(outdir, f"query{queries}_{length}bp{tag}.txt")
    sp = os.path.join(outdir, f"subj{subjects}_{length}bp{tag}.txt")
    q = rng.integers(0, 4, size=(queries, length), dtype=np.uint8)
    with open(qp, "wb") as f:
        _write_codes(f, q)
    with open(sp, "wb") as f:
        done = 0
        while done < subjects:
            n = min(chunk, subjects - done)
            if filter_mix:
                codes = filter_mix_subjects(rng, q, n)
            else:
                codes = rng.integers(0, 4, size=(n, length), dtype=np.uint8)
            _write_codes(f, codes)
            done += n
    return qp, sp


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--subjects", type=int, default=1_000_000)
    ap.add_argument("--length", type=int, default=150)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--filter-mix", action="store_true",
                    help="banded read-filter mix instead of random subjects")
    args = ap.parse_args()
    for path in write_dataset(args.outdir, args.queries, args.subjects,
                              args.length, args.seed, args.filter_mix):
        print(path)


if __name__ == "__main__":
    main()
