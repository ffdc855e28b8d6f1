"""Randomized differential campaign vs the compiled reference binaries.

Random datasets through the full CLI (align + convert) byte-compared with
the compiled references (build recipe: .claude/skills/verify/SKILL.md),
rotating all seven builds — Myers global (orig_cpu), BitPAl global
(avx2/avx512), banded (banded_cpu), semi-global Myers (semi_cpu),
positive-factor Myers (pos_cpu), semi-global BitPAl (semib_avx2) — and the
engine variants that share each family's output (32-bit carry, --shards
over the CPU mesh, -N threaded packers, --no-packed, sequential --host
role splits merged with `merge`, in-process -t cpu+cpu co-compute).
Banded cases stay in the reference binary's well-defined geometry region
(PARITY.md divergence #1); the suite covers the OOB geometries against the
behavioral model instead. Any mismatch prints its repro seed.

Usage: python scripts/diff_campaign.py <start_seed> <count>
"""
import os
import subprocess
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()
import jax

jax.config.update("jax_platforms", "cpu")

from bgsa_tpu import cli
from bgsa_tpu.io import seqfile

ORIG = "/tmp/ref-build/orig_cpu"
BANDED = "/tmp/ref-build/banded_cpu"
AVX2 = "/tmp/ref-build/avx2"
AVX512 = "/tmp/ref-build/avx512"
SEMI = "/tmp/ref-build/semi_cpu"
POS = "/tmp/ref-build/pos_cpu"
SEMIB = "/tmp/ref-build/semib_avx2"

BASES = np.frombuffer(b"ACGT", np.uint8)


def write_seq(path, arr):
    seqfile.write_seq_file(path, arr)


def write_fasta(path, arr):
    """Same sequences as FASTA (exercises the CLI's auto-convert input path)."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i, row in enumerate(np.asarray(arr)):
            f.write(b">seq%d comment\n" % i + lut[row].tobytes() + b"\n")


def write_fastq(path, arr):
    """Same sequences as FASTQ ('@'-containing qualities included)."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "wb") as f:
        for i, row in enumerate(np.asarray(arr)):
            f.write(b"@read%d\n" % i + lut[row].tobytes() + b"\n+\n"
                    + b"@" * len(row) + b"\n")


class RefCrash(Exception):
    """The reference binary aborted on this dataset (its own fragility:
    e.g. the AVX2/AVX512 ports heap-overflow when the subject count is
    below V_NUM with multi-word subjects — PARITY.md divergence #5)."""


def run_ref(build, tmp, qp, sp, extra=()):
    res = os.path.join(tmp, "ref.bin")
    conv = os.path.join(tmp, "ref.txt")
    r = subprocess.run([f"{build}/aligner", "-q", qp, "-d", sp, "-f", res,
                        "-N", "1", *extra], capture_output=True, cwd=tmp)
    if r.returncode != 0:
        # Sentinel, raised by one_case only AFTER our side ran: the dataset
        # still exercises our CLI even when the reference cannot score it.
        return RefCrash(f"{build} rc={r.returncode}")
    subprocess.run([f"{build}/convert", "-r", res, "-o", conv],
                   check=True, capture_output=True, cwd=tmp)
    return conv


def run_ours(tmp, qp, sp, extra=(), banded=False, hosts=0):
    res = os.path.join(tmp, "our.bin")
    conv = os.path.join(tmp, "our.txt")
    if hosts:
        # Static multi-host roles run fine sequentially in one process (only
        # -D needs concurrency); merge interleaves the reference's
        # multi-device blocked layout, so convert diffs it end to end.
        shards = [os.path.join(tmp, f"sh{h}.bin") for h in range(hosts)]
        for h in range(hosts):
            assert cli.main(["align", "-q", qp, "-d", sp, "-f", shards[h],
                             "--quiet", "--backend", "xla",
                             "--host", f"{h}:{hosts}", *extra]) == 0
        margs = ["merge", *shards, "-o", res]
        if banded:
            margs.append("--banded")
        assert cli.main(margs) == 0
    else:
        assert cli.main(["align", "-q", qp, "-d", sp, "-f", res, "--quiet",
                         "--backend", "xla", *extra]) == 0
    args = ["convert", "-r", res, "-o", conv]
    if banded:
        args.append("--banded")
    assert cli.main(args) == 0
    return conv


# BGSA_CAMPAIGN_LONG=1: stretch sequence lengths ~4x (the reference chart's
# 120-960bp x-axis — multi-word Eq chains, carry propagation across 8-31
# words) with smaller subject counts so runtime stays comparable.
LONG = bool(os.environ.get("BGSA_CAMPAIGN_LONG"))


SCALE = 4 if LONG else 1


def one_case(seed):
    rng = np.random.default_rng(seed)
    kind = seed % 7
    with tempfile.TemporaryDirectory() as tmp:
        qp, sp = os.path.join(tmp, "q.txt"), os.path.join(tmp, "s.txt")
        if kind == 4:  # semi-global Myers vs the generator's own emission
            Q = int(rng.integers(1, 5))
            S = int(rng.integers(1, 700 // SCALE))
            m = int(rng.integers(1, 250 * SCALE))
            n = int(rng.integers(1, 250 * SCALE))
            write_seq(qp, rng.integers(0, 4, size=(Q, m)))
            write_seq(sp, rng.integers(0, 4, size=(S, n)))
            a = run_ref(SEMI, tmp, qp, sp)
            b = run_ours(tmp, qp, sp, extra=["--semi-global"])
            tag = f"semiglobal {m}x{n}"
        elif kind == 5:  # (0,1,1) — the generator's factor=+1 normalization
            Q = int(rng.integers(1, 5))
            S = int(rng.integers(1, 700 // SCALE))
            m = int(rng.integers(1, 250 * SCALE))
            n = int(rng.integers(1, 250 * SCALE))
            write_seq(qp, rng.integers(0, 4, size=(Q, m)))
            write_seq(sp, rng.integers(0, 4, size=(S, n)))
            a = run_ref(POS, tmp, qp, sp)
            b = run_ours(tmp, qp, sp, extra=["-M", "0", "-I", "1", "-G", "1"])
            tag = f"positive-factor {m}x{n}"
        elif kind == 6:  # semi-global BitPAl, packed / non-packed alternating
            Q = int(rng.integers(1, 4))
            S = int(rng.integers(8 if LONG else 1, 500 // SCALE))
            m = int(rng.integers(8, 150 * SCALE))
            n = int(rng.integers(8, 150 * SCALE))
            write_seq(qp, rng.integers(0, 4, size=(Q, m)))
            write_seq(sp, rng.integers(0, 4, size=(S, n)))
            extra = ["-M", "2", "-I", "-3", "-G", "-5", "--semi-global"]
            if (seed // 7) % 2:
                extra.append("--no-packed")
            a = run_ref(SEMIB, tmp, qp, sp)
            b = run_ours(tmp, qp, sp, extra=extra)
            tag = f"bitpal-semi {m}x{n} {extra[-1] if extra[-1].startswith('--no') else 'packed'}"
        elif kind == 3:  # banded — the reference binary's well-defined region
            # (qlen >= 64+k, n >= m, band <= 64, packer capacity bound;
            # outside it the binary corrupts its own scores via OOB reads,
            # PARITY.md divergence #1 — those geometries are verified
            # against banded_ref/oracle in the suite instead)
            k = int(rng.integers(1, 14))
            while True:
                m = int(rng.integers(64 + k, 250 * SCALE))
                cap = 64 * ((m - k + 63) // 64)
                if cap >= m:
                    break
            n = int(rng.integers(m, min(m + 64 - 2 * k, cap + 1)))
            Q = int(rng.integers(1, 3))
            S = int(rng.integers(1, 700))
            q = rng.integers(0, 4, size=(Q, m))
            s = rng.integers(0, 4, size=(S, n))
            ncopy = min(S, 8)
            s[:ncopy, : min(m, n)] = q[0][: min(m, n)]
            write_seq(qp, q)
            write_seq(sp, s)
            hosts = 2 if (seed // 7) % 2 else 0
            a = run_ref(BANDED, tmp, qp, sp, extra=["-k", str(k)])
            b = run_ours(tmp, qp, sp, extra=["-k", str(k)], banded=True,
                         hosts=hosts)
            tag = f"banded k={k} {m}x{n}{' 2-role merge' if hosts else ''}"
        elif kind == 2:  # BitPAl (2,-3,-5) vs AVX2, alternating carry / shards
            Q = int(rng.integers(1, 4))
            S = int(rng.integers(16 if LONG else 1, 500 // SCALE))
            m = int(rng.integers(8, 100 * SCALE))
            n = int(rng.integers(8, 100 * SCALE))
            write_seq(qp, rng.integers(0, 4, size=(Q, m)))
            write_seq(sp, rng.integers(0, 4, size=(S, n)))
            extra = ["-M", "2", "-I", "-3", "-G", "-5"]
            variant = (seed // 7) % 4
            if variant == 1:
                extra += ["--carry"]
            elif variant == 2:
                extra += ["--shards", "4"]
            elif variant == 3:
                # in-process heterogeneous co-compute over two CPU devices
                extra += ["-t", "cpu+cpu"]
            build = AVX512 if (seed // 7) % 2 else AVX2
            a = run_ref(build, tmp, qp, sp)
            b = run_ours(tmp, qp, sp, extra=extra)
            tag = f"bitpal {m}x{n} {' '.join(extra[6:]) or 'default'} vs {os.path.basename(build)}"
        else:  # Myers global, alternating shards / -N threads
            Q = int(rng.integers(1, 4))
            if (seed // 14) % 5 == 0:
                # Cross the reference's compiled-in REF_BUCKET_COUNT=100:
                # >100 queries block the result per (subject bucket, query
                # bucket) — a layout axis the small-Q draws never touch.
                Q = int(rng.integers(101, 140))
            S = int(rng.integers(1, 800 // SCALE))
            m = int(rng.integers(1, 170 * SCALE))
            n = int(rng.integers(1, 170 * SCALE))
            q = rng.integers(0, 4, size=(Q, m))
            s = rng.integers(0, 4, size=(S, n))
            write_seq(qp, q)
            write_seq(sp, s)
            extra = []
            hosts = 0
            variant = (seed // 7) % 4
            if variant == 1:
                extra = ["--shards", "4"]
            elif variant == 2:
                extra = ["-N", "4"]
            elif variant == 3:
                hosts = 2 + seed % 2  # 2- or 3-role split + merge
            # Rotate our side's input format: the CLI auto-converts
            # FASTA/FASTQ (the reference needs a manual ./convert pass,
            # which run_ref's plain-format files stand in for).
            qp_ours, sp_ours, fmt_tag = qp, sp, ""
            fmt = (seed // 28) % 3
            if fmt == 1:
                qp_ours = os.path.join(tmp, "q.fa")
                write_fasta(qp_ours, q)
                fmt_tag = " fasta-q"
            elif fmt == 2:
                sp_ours = os.path.join(tmp, "s.fq")
                write_fastq(sp_ours, s)
                fmt_tag = " fastq-d"
            a = run_ref(ORIG, tmp, qp, sp)
            b = run_ours(tmp, qp_ours, sp_ours, extra=extra, hosts=hosts)
            tag = (f"myers {m}x{n} "
                   f"{f'{hosts}-role merge' if hosts else ' '.join(extra) or 'default'}"
                   f"{fmt_tag}")
        if isinstance(a, RefCrash):
            raise a  # ours completed on this dataset; nothing to compare
        ok = open(a).read() == open(b).read()
        return ok, tag


def main():
    start, count = int(sys.argv[1]), int(sys.argv[2])
    bad = []
    ref_crashes = 0
    for i in range(start, start + count):
        try:
            ok, tag = one_case(i)
        except RefCrash as e:
            # our CLI already ran this dataset to completion (one_case
            # defers the crash until after run_ours); only the compare skips
            ref_crashes += 1
            print(f"reference crashed on seed={i} ({e}); skipping compare",
                  flush=True)
            continue
        if not ok:
            bad.append((i, tag))
            print(f"MISMATCH seed={i} {tag}", flush=True)
        if (i - start + 1) % 25 == 0:
            print(f"{i - start + 1}/{count} done, {len(bad)} mismatches", flush=True)
    print(f"CAMPAIGN DONE: {count} datasets, {len(bad)} mismatches, "
          f"{ref_crashes} reference crashes (skipped)", flush=True)
    if bad:
        print(bad)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
