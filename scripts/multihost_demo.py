"""BASELINE config-5 demo driver: the 10M x 150bp multi-host merge run.

N host roles over the 10M-subject dataset (sequentially on a one-card
machine, or concurrently with --concurrent, one card per role), then
`merge` + `convert`, byte-compared against the single-host run — for Myers
and (with --banded) banded k=8. Matches the multi-device result layout the
reference keeps (original/BGSA_KNC/cal_all.c:136-769: subjects scattered by
ratio, per-device sub-blocks concatenated in .info order).

Usage:
  python scripts/multihost_demo.py /tmp/mhdemo                # full 10M
  python scripts/multihost_demo.py /tmp/mhdemo --subjects 200000 --skip-single
  python scripts/multihost_demo.py /tmp/mhdemo --hosts 4 --banded --concurrent

With --concurrent, role h runs with CUDA_VISIBLE_DEVICES=h: a JAX process
reserves most of its card's memory at start-up, so two roles on one card
would fail. Byte-equality of the merged output vs the single-host run is
the correctness claim.
"""

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def sh(args, env_extra=None, tag=""):
    env = {**os.environ, **(env_extra or {})}
    t0 = time.perf_counter()
    print(f"[demo] run{' ' + tag if tag else ''}: {' '.join(args)}",
          file=sys.stderr, flush=True)
    proc = subprocess.run(args, env=env, cwd=REPO)
    dt = time.perf_counter() - t0
    if proc.returncode != 0:
        sys.exit(f"[demo] FAILED ({tag}): {' '.join(args)}")
    print(f"[demo] done {tag} in {dt:.1f}s", file=sys.stderr, flush=True)
    return dt


def cli(*args, env_extra=None, tag=""):
    return sh([sys.executable, "-m", "bgsa_tpu.cli", *args],
              env_extra=env_extra, tag=tag)


def run_family(name, qp, sp, outdir, hosts, extra, args):
    fam_dir = os.path.join(outdir, name)
    os.makedirs(fam_dir, exist_ok=True)
    backend = ["--backend", args.backend] if args.backend else []
    stats = {}

    single_conv = os.path.join(fam_dir, "single.txt")
    if not args.skip_single:
        single = os.path.join(fam_dir, "single.bin")
        stats["single_s"] = cli(
            "align", "-q", qp, "-d", sp, "-f", single, *extra, *backend,
            tag=f"{name} single-host")
        cli("convert", "-r", single, "-o", single_conv,
            tag=f"{name} convert single")

    shards = [os.path.join(fam_dir, f"shard{h}.bin") for h in range(hosts)]
    role_cmds = [
        ["align", "-q", qp, "-d", sp, "-f", shards[h],
         "--host", f"{h}:{hosts}", *extra, *backend]
        for h in range(hosts)
    ]
    if args.concurrent:
        # one card per role (see the module docstring)
        procs = [subprocess.Popen(
            [sys.executable, "-m", "bgsa_tpu.cli", *cmd], cwd=REPO,
            env={**os.environ, "CUDA_VISIBLE_DEVICES": str(h)})
            for h, cmd in enumerate(role_cmds)]
        t0 = time.perf_counter()
        for h, p in enumerate(procs):
            if p.wait() != 0:
                sys.exit(f"[demo] role {h} failed")
        stats["roles_s"] = [time.perf_counter() - t0] * hosts
    else:
        stats["roles_s"] = [
            cli(*cmd, tag=f"{name} role {h}/{hosts}")
            for h, cmd in enumerate(role_cmds)
        ]

    merged = os.path.join(fam_dir, "merged.bin")
    stats["merge_s"] = cli("merge", *shards, "-o", merged, tag=f"{name} merge")
    merged_conv = os.path.join(fam_dir, "merged.txt")
    stats["convert_s"] = cli("convert", "-r", merged, "-o", merged_conv,
                             tag=f"{name} convert merged")

    if not args.skip_single:
        t0 = time.perf_counter()
        same = open(merged_conv, "rb").read() == open(single_conv, "rb").read()
        stats["compare_s"] = time.perf_counter() - t0
        if not same:
            sys.exit(f"[demo] {name}: merged output != single-host output")
        stats["byte_equal_vs_single_host"] = True
        print(f"[demo] {name}: merged {hosts}-role output BYTE-EQUAL to the "
              "single-host run", file=sys.stderr, flush=True)
    return stats


def main():
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("outdir")
    ap.add_argument("--subjects", type=int, default=10_000_000)
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--length", type=int, default=150)
    ap.add_argument("--hosts", type=int, default=2)
    ap.add_argument("--k", type=int, default=8, help="banded threshold")
    ap.add_argument("--banded", action="store_true",
                    help="also run the banded family")
    ap.add_argument("--backend", default=None,
                    help="force a kernel backend (e.g. xla for a CPU box)")
    ap.add_argument("--concurrent", action="store_true",
                    help="run roles concurrently (use on a real multi-host "
                         "box; this 1-core box would just timeshare)")
    ap.add_argument("--skip-single", action="store_true",
                    help="skip the single-host reference run (no byte check)")
    args = ap.parse_args()

    os.makedirs(args.outdir, exist_ok=True)
    qp = os.path.join(args.outdir, f"query{args.queries}_{args.length}bp.txt")
    sp = os.path.join(args.outdir, f"subj{args.subjects}_{args.length}bp.txt")
    if not (os.path.exists(qp) and os.path.exists(sp)):
        sh([sys.executable, os.path.join(HERE, "make_testdata.py"), args.outdir,
            "--queries", str(args.queries), "--subjects", str(args.subjects),
            "--length", str(args.length)], tag="dataset")

    report = {"subjects": args.subjects, "queries": args.queries,
              "length": args.length, "hosts": args.hosts,
              "families": {}}
    report["families"]["myers"] = run_family("myers", qp, sp, args.outdir,
                                             args.hosts, [], args)
    if args.banded:
        report["families"]["banded"] = run_family(
            "banded", qp, sp, args.outdir, args.hosts, ["-k", str(args.k)], args)

    out = os.path.join(args.outdir, "report.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report))
    print(f"[demo] report: {out}", file=sys.stderr)


if __name__ == "__main__":
    main()
