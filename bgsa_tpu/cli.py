"""Command-line interface, flag-compatible with the reference binaries.

``bgsa-align`` mirrors ``./aligner`` (``original/BGSA_CPU/main.c:19-99``):
``-q`` query file, ``-d`` database file, ``-f`` result file (default
``data/result.txt``), ``-N`` host packing threads (the reference's OpenMP
fan-out; here it threads the native transport packers), banded adds ``-k``.
Scoring flags ``-M/-I/-G`` select the scheme at run time (the reference
bakes them in at codegen time).

``bgsa-convert`` mirrors ``./convert``: ``-f`` FASTA, ``-q`` FASTQ, ``-r``
result-to-text, ``-o`` output.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from .schemes import Mode, Scoring


def _auto_host_role() -> tuple[int, int] | None:
    """(host_id, n_hosts) for ``--host auto``: explicit env first, then an
    initialized jax.distributed runtime (process index/count)."""
    hid, nh = os.environ.get("BGSA_HOST_ID"), os.environ.get("BGSA_NUM_HOSTS")
    if hid is not None and nh is not None:
        return int(hid), int(nh)
    try:
        import jax

        if jax.process_count() > 1:
            return jax.process_index(), jax.process_count()
    except Exception:
        pass
    return None


def align_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bgsa-align", description=__doc__)
    p.add_argument("-q", dest="query", required=True, help="query file (fixed-length lines)")
    p.add_argument("-d", dest="database", required=True, help="database file")
    p.add_argument("-f", dest="result", default="data/result.txt", help="result file")
    p.add_argument("-N", dest="threads", type=int, default=0,
                   help="host packing threads (reference -N; 0 = all cores)")
    p.add_argument("-k", dest="threshold", type=int, default=None, help="banded error threshold")
    p.add_argument("-M", dest="match", type=int, default=None, help="match score (default 0)")
    p.add_argument("-I", dest="mismatch", type=int, default=None, help="mismatch score (default -1)")
    p.add_argument("-G", dest="gap", type=int, default=None, help="gap score (default -1)")
    p.add_argument("--semi-global", action="store_true", help="semi-global mode")
    p.add_argument("--backend", default="auto", choices=["auto", "pallas", "xla"])
    p.add_argument("--shards", type=int, default=1,
                   help="local device shards (0 = all local devices)")
    p.add_argument("--packed", action=argparse.BooleanOptionalAction, default=None,
                   help="packed bit-plane BitPAl representation (same scores; default on)")
    p.add_argument("--carry", action="store_true",
                   help="full-32-bit-word BitPAl with compare-carry adds "
                        "(the reference KNC port's hardware-adc analogue, on "
                        "either representation — combine with --no-packed "
                        "for the unpacked carry path; same scores, A/B "
                        "numbers in docs/PERF.md)")
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run (skip completed buckets)")
    p.add_argument("--host", default=None, metavar="I:N",
                   help="multi-host role: this process scores host I's slice of "
                        "every bucket (N hosts total), writing <result> as a raw "
                        "shard plus <result>.meta.json; combine with 'merge'. "
                        "'auto' derives I:N from BGSA_HOST_ID/BGSA_NUM_HOSTS or "
                        "an initialized jax.distributed runtime")
    p.add_argument("-R", dest="ratio_file", default=None,
                   help="device/host ratio file (reference -R: one positive "
                        "float per host, whitespace-separated)")
    p.add_argument("-t", dest="devices", default=None, metavar="SPEC",
                   help="heterogeneous co-compute: '+'-joined jax platforms "
                        "(e.g. gpu+cpu), one in-process device section per "
                        "entry — the reference's -t MICSSE; combine with -R/-D")
    p.add_argument("-n", dest="device_count", type=int, default=None,
                   help="with a single-platform -t: use this many devices of "
                        "that platform (the reference's -n mic count)")
    p.add_argument("-D", dest="dynamic", action="store_true",
                   help="dynamic load balancing (reference -D): re-split every "
                        "bucket from the measured device/host times; requires "
                        "--host or -t")
    p.add_argument("--sync-dir", default=None, metavar="DIR",
                   help="shared directory for -D time exchange (default: the "
                        "result file's directory). Time files are namespaced "
                        "by a run token derived from the input files; only a "
                        "byte-identical re-run of untouched inputs needs a "
                        "fresh directory")
    p.add_argument("--sync-timeout", type=float, default=None, metavar="SECS",
                   help="-D: seconds to wait for a peer host's per-bucket "
                        "time file before failing with a dead-peer error "
                        "(default 120; the reference hangs forever)")
    p.add_argument("--bucket-size", type=int, default=None, help="database bucket bytes")
    p.add_argument("--stats-json", default=None, metavar="PATH",
                   help="also write run statistics as JSON")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="capture a jax.profiler trace of the whole run into "
                        "DIR (open with TensorBoard / xprof; device-level "
                        "detail beyond the reference's GET_TIME phases)")
    p.add_argument("--profile-python", action="store_true",
                   help="with --profile: also run the host-side Python "
                        "tracer (10x trace overhead on slow hosts; device "
                        "timelines alone rarely need it)")
    p.add_argument("--quiet", action="store_true")
    args = p.parse_args(argv)

    from . import pipeline as pl_mod

    out_dir = os.path.dirname(args.result)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)

    # FASTA/FASTQ inputs convert to the line format transparently (the
    # reference requires a manual ./convert -f/-q pass first).
    import atexit
    import tempfile

    def _as_line_format(path: str) -> str:
        # Line-format files start with a base character; '>' means FASTA,
        # '@' with a '+' third line means FASTQ.
        if not os.path.exists(path):
            p.error(f"{path}: no such file")
        with open(path, "rb") as f:
            first = f.read(1)
            if first == b"@":
                f.readline()
                f.readline()
                is_fastq = f.readline()[:1] == b"+"
                if not is_fastq:
                    # Line-format files start with a base character; a '@'
                    # that fails the '+'-line sniff is a malformed FASTQ, not
                    # sequences — passing it through would silently encode
                    # headers/qualities as code 0 ('A').
                    p.error(f"{path}: starts with '@' but is not valid FASTQ "
                            "(third line of the first record must start with '+')")
            else:
                is_fastq = False
        if first != b">" and not is_fastq:
            return path
        from .io import fastx

        tmp = tempfile.NamedTemporaryFile(suffix=".txt", delete=False, prefix="bgsa_")
        tmp.close()
        atexit.register(os.unlink, tmp.name)
        if first == b">":
            fastx.convert_fasta(path, tmp.name)
        else:
            fastx.convert_fastq(path, tmp.name)
        return tmp.name

    args.query = _as_line_format(args.query)
    args.database = _as_line_format(args.database)

    scoring_explicit = any(
        v is not None for v in (args.match, args.mismatch, args.gap)
    )
    args.match = 0 if args.match is None else args.match
    args.mismatch = -1 if args.mismatch is None else args.mismatch
    args.gap = -1 if args.gap is None else args.gap
    if args.threshold is not None:
        # Banded is the unit-cost verification filter (the reference's banded
        # ports are generated for (0,-1,-1) only and have no runtime scoring
        # flags); accepting -M/-I/-G or --semi-global here would silently
        # score something other than what the user asked for.
        if scoring_explicit:
            print("error: -M/-I/-G cannot combine with -k (the banded filter "
                  "is unit-cost edit distance; drop the scoring flags, or "
                  "drop -k for a general-scoring run)", file=sys.stderr)
            return 1
        if args.semi_global:
            print("error: --semi-global cannot combine with -k (the banded "
                  "filter's mode is fixed: errors are minimized over the "
                  "final subject row, matching the reference's banded "
                  "kernels)", file=sys.stderr)
            return 1
        if args.threshold < 0:
            print("error: -k must be >= 0", file=sys.stderr)
            return 1
    packed_explicit = args.packed is not None
    args.packed = True if args.packed is None else args.packed
    if packed_explicit and (
        args.threshold is not None
        or Scoring(args.match, args.mismatch, args.gap).is_unit
    ):
        # Loud rejection beats a silent no-op: the packed/non-packed choice
        # only exists on the BitPAl path; Myers/banded runs would otherwise
        # accept and ignore the flag.
        print("error: --packed/--no-packed applies to BitPAl scoring "
              "schemes; this run selects a Myers/banded kernel (unit-cost "
              "or -k), which has no packed/non-packed representation choice",
              file=sys.stderr)
        return 1
    if args.carry:
        # Loud rejection beats a silent no-op (the carry layout exists on
        # both BitPAl representations; unit-cost schemes run Myers kernels,
        # whose full-word formulation is already the kernel route's).
        if args.threshold is not None or Scoring(
            args.match, args.mismatch, args.gap
        ).is_unit:
            print("error: --carry applies to BitPAl scoring schemes; "
                  "this run selects a Myers/banded kernel (unit-cost or -k), "
                  "whose full-word formulation is already the GPU default",
                  file=sys.stderr)
            return 1
    cfg_kwargs = {
        "backend": args.backend,
        "local_shards": args.shards,
        "bitpal_packed": args.packed,
        # store_true: absent means "auto" (measured-best layout per route),
        # not "force the 31-bit layout"
        "bitpal_carry": True if args.carry else None,
        "host_threads": args.threads,
    }
    if args.bucket_size:
        cfg_kwargs["bucket_size"] = args.bucket_size
    if args.sync_timeout is not None:
        cfg_kwargs["sync_timeout"] = args.sync_timeout
    config = pl_mod.PipelineConfig(**cfg_kwargs)
    mode = Mode.SEMI_GLOBAL if args.semi_global else Mode.GLOBAL
    scoring = Scoring(args.match, args.mismatch, args.gap)

    shard = None
    ratios = None
    if args.host == "auto":
        # Role from the environment: the jax.distributed launcher analogue of
        # the reference's one-process-drives-N-devices split (cal_all.c:71-96).
        role = _auto_host_role()
        if role is None:
            print("error: --host auto: set BGSA_HOST_ID and BGSA_NUM_HOSTS, or "
                  "initialize jax.distributed (JAX_PROCESS_COUNT et al.)",
                  file=sys.stderr)
            return 1
        args.host = "%d:%d" % role
    if args.host is not None:
        try:
            host_id, n_hosts = (int(x) for x in args.host.split(":"))
        except ValueError:
            print(f"error: --host expects I:N, got {args.host!r}", file=sys.stderr)
            return 1
        if not 0 <= host_id < n_hosts:
            print(f"error: --host {args.host}: need 0 <= I < N", file=sys.stderr)
            return 1
        shard = (host_id, n_hosts)
    if args.devices:
        # Accept the reference's own -t spellings (original/BGSA_KNC/
        # main.c:73-83): MIC = the accelerator alone, MICSSE = accelerator +
        # host CPU co-compute, SIMPLE/SSE = CPU-only. Mapped to jax platform
        # specs, the accelerator being the default platform.
        import jax

        accel = jax.default_backend()
        ref_alias = {"simple": "cpu", "sse": "cpu", "mic": accel,
                     "micsse": f"{accel}+cpu"}
        key = args.devices.strip().lower()
        if key in ref_alias:
            mapped = ref_alias[key]
            if not args.quiet:
                print(f"note: -t {args.devices} (reference spelling) -> -t {mapped}")
            args.devices = mapped
    if args.devices and shard is not None:
        print("error: -t and --host are mutually exclusive (in-process devices "
              "vs multi-host roles)", file=sys.stderr)
        return 1
    if args.devices and args.shards != 1:
        print("error: --shards and -t are mutually exclusive (-t builds one "
              "pinned engine per listed device; to use N devices of one "
              "platform, repeat it or pass -n N)", file=sys.stderr)
        return 1
    if args.devices and (args.resume or args.sync_dir):
        # run_hetero has no resume support (like the reference's in-process
        # heterogeneous mode); silently restarting from scratch would
        # overwrite the user's partial result file.
        flag = "--resume" if args.resume else "--sync-dir"
        print(f"error: {flag} is not supported with -t (in-process "
              "heterogeneous runs restart from scratch; use --host roles "
              "for recoverable runs)", file=sys.stderr)
        return 1
    if args.device_count is not None:
        if not args.devices or "+" in args.devices:
            print("error: -n needs a single-platform -t (e.g. -t gpu -n 4)",
                  file=sys.stderr)
            return 1
        if args.device_count < 1:
            print("error: -n must be >= 1", file=sys.stderr)
            return 1
        args.devices = "+".join([args.devices] * args.device_count)
    if args.dynamic and shard is None and not args.devices:
        print("error: -D requires --host I:N or -t SPEC (dynamic balancing "
              "re-splits device/host slices; single-role runs have nothing "
              "to balance)", file=sys.stderr)
        return 1
    dynamic_hosts = args.dynamic and shard is not None
    if args.sync_timeout is not None and not dynamic_hosts:
        print("error: --sync-timeout applies to -D --host runs (it bounds "
              "the wait for a peer's per-bucket time file); nothing reads "
              "it here", file=sys.stderr)
        return 1
    if args.sync_dir and not dynamic_hosts:
        print("error: --sync-dir applies to -D --host runs (the time-file "
              "exchange directory); nothing reads it here", file=sys.stderr)
        return 1
    if args.profile_python and not args.profile:
        print("error: --profile-python needs --profile DIR", file=sys.stderr)
        return 1
    if args.ratio_file:
        if shard is None and not args.devices:
            # Local shard_map splits evenly (homogeneous chips); ratios only
            # steer the multi-host or multi-device split. Failing loudly
            # beats a silent no-op.
            print("error: -R requires --host I:N or -t SPEC (ratios steer the "
                  "host/device split; local --shards devices are homogeneous "
                  "and split evenly)", file=sys.stderr)
            return 1
        from .parallel.multihost import read_ratio_file

        n_ratio = shard[1] if shard else len(args.devices.split("+"))
        ratios = read_ratio_file(args.ratio_file, n_ratio)

    import contextlib

    profile_cm = contextlib.nullcontext()
    if args.profile:
        import jax

        os.makedirs(args.profile, exist_ok=True)
        try:  # device-level trace by default: the Python tracer is ~10x
            # trace overhead and the device timeline answers the usual
            # "what is the chip doing" question without it
            opts = jax.profiler.ProfileOptions()
            opts.python_tracer_level = 1 if args.profile_python else 0
            profile_cm = jax.profiler.trace(args.profile, profiler_options=opts)
        except (AttributeError, TypeError):  # older jax: no ProfileOptions
            profile_cm = jax.profiler.trace(args.profile)

    try:
      with profile_cm:  # jax.profiler trace around the whole run (--profile)
        if args.devices:
            from .parallel.hetero import hetero_engines, run_hetero

            engines = hetero_engines(
                scoring, mode, config, args.devices, threshold=args.threshold
            )
            stats, _ = run_hetero(
                engines, args.query, args.database, args.result, config,
                ratios=ratios, dynamic=args.dynamic,
                write_dtype=np.int8 if args.threshold is not None else np.int16,
            )
        elif args.threshold is not None:
            from .banded_pipeline import run_banded

            stats = run_banded(
                args.query, args.database, args.result, args.threshold, config,
                shard=shard, shard_ratios=ratios, resume=args.resume,
                dynamic=args.dynamic, sync_dir=args.sync_dir,
            )
        else:
            stats = pl_mod.run_alignment(
                args.query, args.database, args.result, scoring, mode, config,
                shard=shard, shard_ratios=ratios, resume=args.resume,
                dynamic=args.dynamic, sync_dir=args.sync_dir,
            )
    except (ValueError, OSError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    if shard is not None:
        stats, meta = stats
        meta.save(args.result + ".meta.json")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(stats.to_json() + "\n")
    if not args.quiet:
        print(f"score is {scoring.match}, {scoring.mismatch}, {scoring.gap}")
        print(stats.report())
    return 0


def convert_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bgsa-convert")
    p.add_argument("-f", dest="fasta", help="convert FASTA file")
    p.add_argument("-q", dest="fastq", help="convert FASTQ file")
    p.add_argument("-r", dest="result", help="convert binary result file to text")
    p.add_argument("-o", dest="output", default="convert_result.txt", help="output file")
    p.add_argument("--banded", action="store_true",
                   help="force int8 banded scores (normally inferred from the "
                        "file size; the reference needs a per-family binary)")
    args = p.parse_args(argv)

    from .io import fastx, result as result_io

    try:
        if args.fasta:
            fastx.convert_fasta(args.fasta, args.output)
        elif args.fastq:
            fastx.convert_fastq(args.fastq, args.output)
        elif args.result:
            dtype = np.int8 if args.banded else None  # None -> infer from size
            result_io.convert_result(args.result, args.output, write_dtype=dtype)
        else:
            p.error("one of -f / -q / -r is required")
    except (ValueError, OSError) as e:
        p.error(str(e))
    return 0


def merge_main(argv=None) -> int:
    """Merge per-host shard files (from ``align --host I:N``) into one
    reference-layout result file (+ .info)."""
    p = argparse.ArgumentParser(prog="bgsa-merge", description=merge_main.__doc__)
    p.add_argument("shards", nargs="+", help="shard files, any order")
    p.add_argument("-o", dest="output", required=True, help="merged result file")
    p.add_argument("--banded", action="store_true",
                   help="shards hold int8 banded scores (only needed for shards "
                        "written before the dtype was recorded in the sidecar)")
    args = p.parse_args(argv)

    from .parallel.multihost import ShardMeta, merge_shards

    try:
        metas = [ShardMeta.load(s + ".meta.json") for s in args.shards]
        # Host-id completeness, cross-run consistency, and path/meta pairing
        # are merge_shards' own validation (it sorts pairs by host_id itself).
        # The sidecar records the score dtype (int16 full / int8 banded);
        # --banded only overrides legacy sidecars that predate the field;
        # dtype equality across sidecars is validated inside merge_shards.
        dtype = np.dtype(np.int8) if args.banded else np.dtype(metas[0].dtype)
        merge_shards(args.output, list(args.shards), metas, write_dtype=dtype)
    except (ValueError, OSError, TypeError) as e:
        # TypeError: np.dtype() on a garbage dtype string from a sidecar
        p.error(str(e))
    return 0


def main(argv=None) -> int:
    """``python -m bgsa_tpu.cli [align|convert|merge] ...`` dispatcher."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "convert":
        return convert_main(argv[1:])
    if argv and argv[0] == "merge":
        return merge_main(argv[1:])
    if argv and argv[0] == "align":
        argv = argv[1:]
    return align_main(argv)


if __name__ == "__main__":
    sys.exit(main())
