"""Smoke run of bgsa-align on one NVIDIA GPU, through the user's entry points.

Phases on one card, all but the first in this process:

1. device     — JAX's platform, device kind and count, and the card's name
                and power limit (nvidia-smi). Anything but a GPU fails.
2. compile    — the engine's jitted step for each family at its real width
                and one database bucket of rows; prints memory_analysis().
0. gpu tests  — the gpu-marked tests (tests/test_gpu.py) in a child pytest,
                before this process touches the card.
3. parity     — each Pallas kernel of the route (Triton: Myers global and
                semi-global, packed BitPAl) against the full result of its
                XLA twin, and a seeded sample of >= 2,000 (query, subject)
                pairs against the plain reference (oracle.py). Exact
                equality: every score is an integer and no floating-point
                product sits on these paths, so TF32 cannot arise. Banded
                has no kernel (banded_xla on every platform).
4. end-to-end — bgsa-align (cli.align_main) on generated data at the sizes
                of BASELINE.json config 5, converted by bgsa-convert and
                checked at the sampled pairs against oracle.py or
                banded_ref.py; then the sample-data goldens, byte for byte.

``--four-cards`` runs only the multi-device paths and their one-card
comparison: Myers global and banded k=8 with ``--shards 4``, and four
``--host h:4`` role processes (one per card, the parent off JAX while they
run) merged with bgsa-merge; each converted output must equal the one-card
run's byte for byte.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed phase exits non-zero before printing it.

Usage:
  python chip_smoke.py                 # one card, every phase
  python chip_smoke.py --four-cards    # four cards: --shards 4 and --host roles
  python chip_smoke.py --scale 0.01    # cut every subject count (rehearsal)
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

from bgsa_tpu.benchutil import card

HERE = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(HERE, "smoke_data")  # generated data, git-ignored
SAMPLE = 2048  # sampled (query, subject) pairs per check

# The end-to-end runs (BASELINE.json config 5): name -> (queries, subjects,
# length, bgsa-align flags, read-filter mix?)
RUNS = {
    "myers_global": (20, 10_000_000, 150, [], False),
    "myers_semiglobal": (20, 1_000_000, 150, ["--semi-global"], False),
    "bitpal": (20, 1_000_000, 500, ["-M", "2", "-I", "-3", "-G", "-5"], False),
    "banded_k8": (20, 10_000_000, 150, ["-k", "8"], True),
}
FOUR_CARD_RUNS = ("myers_global", "banded_k8")


def say(msg: str) -> None:
    print(f"[smoke {time.strftime('%H:%M:%S')}] {msg}", flush=True)


def fail(msg: str) -> None:
    say(f"FAILED: {msg}")
    sys.exit(1)


# ---------------------------------------------------------------- data

def make_data(scale: float, names=tuple(RUNS)) -> dict:
    """Generate the runs' files (seeded); returns name -> (qp, sp)."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    from make_testdata import write_dataset

    paths = {}
    for seed, (name, (nq, ns, length, _, mix)) in enumerate(RUNS.items()):
        if name not in names:
            continue
        ns = max(int(ns * scale), 1000)
        t0 = time.perf_counter()
        paths[name] = write_dataset(
            os.path.join(WORK, name), nq, ns, length, seed=seed + 1,
            filter_mix=mix)
        say(f"data {name}: {nq} x {ns} x {length} bp "
            f"({time.perf_counter() - t0:.1f} s)")
    return paths


def read_subjects(path: str, idx):
    """Symbol codes of the subject lines ``idx`` of a line-format file."""
    import numpy as np

    from bgsa_tpu import pack
    from bgsa_tpu.io import seqfile

    length = seqfile.detect_line_length(path)
    mm = np.memmap(path, np.uint8, mode="r").reshape(-1, length + 1)
    return pack.encode_ascii(np.asarray(mm[np.asarray(idx), :length]))


def converted_scores(path: str, lines):
    """Integers on the given 0-based line numbers of a converted file."""
    import numpy as np

    mm = np.memmap(path, np.uint8, mode="r")
    ends = np.flatnonzero(mm == ord("\n"))
    starts = np.concatenate([[0], ends[:-1] + 1])
    return np.array([int(bytes(mm[starts[i]:ends[i]])) for i in lines]), len(ends)


def reference_scores(name, queries, subjects, qi):
    """Plain-reference scores of pairs (queries[qi[j]], subjects[j])."""
    import numpy as np

    from bgsa_tpu import banded_ref, oracle
    from bgsa_tpu.schemes import Mode, Scoring

    flags = RUNS[name][3]
    want = np.empty(len(qi), np.int64)
    for q in np.unique(qi):
        sel = np.flatnonzero(qi == q)
        if name == "banded_k8":
            want[sel] = [banded_ref.banded_score(queries[q], s, 8)
                         for s in subjects[sel]]
        elif name == "bitpal":
            want[sel] = oracle.align_scores(queries[q], subjects[sel],
                                            Scoring(2, -3, -5))
        else:
            mode = Mode.SEMI_GLOBAL if "--semi-global" in flags else Mode.GLOBAL
            want[sel] = -oracle.edit_distances(queries[q], subjects[sel], mode)
    return want


def check_converted(name, qp, sp, conv, rng) -> None:
    """The converted text at SAMPLE seeded pairs equals the references."""
    import numpy as np

    from bgsa_tpu.io import seqfile

    queries = seqfile.read_queries(qp)
    n_sub = os.path.getsize(sp) // (seqfile.detect_line_length(sp) + 1)
    qi = rng.integers(0, len(queries), SAMPLE)
    si = rng.integers(0, n_sub, SAMPLE)
    got, n_lines = converted_scores(conv, qi * n_sub + si)
    if n_lines != len(queries) * n_sub:
        fail(f"{name}: converted output has {n_lines} lines, expected "
             f"{len(queries) * n_sub}")
    want = reference_scores(name, queries, read_subjects(sp, si), qi)
    bad = np.flatnonzero(got != want)
    if bad.size:
        j = bad[0]
        fail(f"{name}: {bad.size}/{SAMPLE} sampled pairs differ from the "
             f"reference (query {qi[j]}, subject {si[j]}: {got[j]} != {want[j]})")
    say(f"{name}: {SAMPLE} sampled pairs of the converted output equal the "
        "plain reference")


# ---------------------------------------------------------------- phases

def phase_device() -> dict:
    import jax

    dev = jax.devices()[0]
    info = {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}
    say(f"device: platform={info['platform']} kind={info['kind']} "
        f"count={info['count']}")
    print(card(), flush=True)  # name, power limit: nvidia-smi's own line
    if info["platform"] != "gpu":
        fail(f"no GPU: JAX's platform is {info['platform']!r}")
    return info


def _engine(name, config):
    from bgsa_tpu.banded_pipeline import BandedEngine
    from bgsa_tpu.pipeline import Engine
    from bgsa_tpu.schemes import Mode, Scoring, normalize

    if name == "banded_k8":
        return BandedEngine(8, config)
    if name == "bitpal":
        return Engine(normalize(Scoring(2, -3, -5)), config)
    mode = Mode.SEMI_GLOBAL if name == "myers_semiglobal" else Mode.GLOBAL
    return Engine(normalize(Scoring(0, -1, -1), mode), config)


def phase_compile() -> None:
    from bgsa_tpu.io import seqfile
    from bgsa_tpu.pipeline import PipelineConfig

    config = PipelineConfig()
    for name, (nq, _, length, _, _) in RUNS.items():
        rows = seqfile.DEFAULT_BUCKET_SIZE // (length + 1)
        rows -= rows % config.v_num
        eng = _engine(name, config)
        if name in PARITY and eng.backend != "pallas":
            fail(f"{name}: the engine chose the {eng.backend} route on a GPU")
        t0 = time.perf_counter()
        eng.compile_for(nq, length, rows, length, "2bit")
        ex = eng._exec[(nq, length, rows, length, "2bit", 0)]
        say(f"compile {name} ({nq} x {rows} x {length} bp, "
            f"{time.perf_counter() - t0:.1f} s): {ex.memory_analysis()}")


PARITY = ("myers_global", "myers_semiglobal", "bitpal")  # the kernels


def kernel_parity(name: str, rng, Q: int, S: int, sample: int = SAMPLE,
                  length: int | None = None) -> int:
    """One Pallas kernel on Q random queries x S random subjects (of the
    run's length unless given) against the full result of its XLA twin
    and, at ``sample`` seeded pairs, the plain reference (oracle.py); exact
    equality. Returns the score count. The gpu-marked tests run this at a
    small size."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bgsa_tpu import pack
    from bgsa_tpu.ops import bitpal_packed
    from bgsa_tpu.ops import myers_semiglobal as sg

    length = length or RUNS[name][2]
    q = rng.integers(0, 4, (Q, length)).astype(np.int32)
    s = rng.integers(0, 4, (S, length)).astype(np.int32)
    if name == "bitpal":
        eq = pack.pack_eq_jax(jnp.asarray(s), 31)
        kw = dict(match=2, mismatch=-3, gap=-5, read_len=length)
        kern, twin = bitpal_packed.bitpal_packed, bitpal_packed.bitpal_packed_xla
    else:
        eq = pack.pack_eq_jax(jnp.asarray(s), 32)
        kw = dict(read_len=length, is_global=name == "myers_global")
        kern, twin = sg.myers_semiglobal, sg.myers_semiglobal_xla
    got = np.asarray(jax.jit(lambda e, qq: kern(e, qq, **kw))(eq, q))
    want = np.asarray(jax.jit(lambda e, qq: twin(e, qq, **kw))(eq, q))
    if not np.array_equal(got, want):
        fail(f"parity {name}: kernel != XLA twin at "
             f"{np.count_nonzero(got != want)} of {got.size} scores")
    qi = rng.integers(0, Q, sample)
    si = rng.integers(0, S, sample)
    ref = reference_scores(name, q, s[si], qi)
    if not np.array_equal(got[qi, si], ref):
        fail(f"parity {name}: kernel != plain reference at "
             f"{np.count_nonzero(got[qi, si] != ref)} of {sample} pairs")
    return got.size


def phase_gpu_tests() -> None:
    """The gpu-marked tests (tests/test_gpu.py) in a child pytest on the
    card. Runs before this process touches JAX: each process reserves most
    of the card's memory."""
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-m", "gpu", os.path.join(HERE, "tests", "test_gpu.py")],
        cwd=HERE, env={**os.environ, "BGSA_TESTS_ON_GPU": "1"},
        capture_output=True, text=True)
    last = (proc.stdout.strip().splitlines() or [""])[-1]
    if proc.returncode or "skipped" in last or "passed" not in last:
        print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", flush=True)
        fail(f"gpu-marked tests: {last or proc.returncode}")
    say(f"gpu-marked tests on the card: {last}")


def phase_parity(rng) -> None:
    # Banded has no kernel (banded_xla on every platform); its scores are
    # checked against banded_ref in the end-to-end phase.
    for name in PARITY:
        n = kernel_parity(name, rng, 20, 65536)
        say(f"parity {name}: kernel == XLA twin on all {n} scores, "
            f"== plain reference on {SAMPLE} sampled pairs")


def align(name, qp, sp, out_dir, extra=()) -> dict:
    """One bgsa-align run + bgsa-convert; returns its stats dict."""
    from bgsa_tpu import cli

    os.makedirs(out_dir, exist_ok=True)
    res = os.path.join(out_dir, "result.bin")
    stats_path = os.path.join(out_dir, "stats.json")
    argv = ["-q", qp, "-d", sp, "-f", res, "--stats-json", stats_path,
            "--quiet", *RUNS[name][3], *extra]
    if cli.align_main(argv) != 0:
        fail(f"{name}: bgsa-align {' '.join(argv)} failed")
    if cli.convert_main(["-r", res, "-o", os.path.join(out_dir, "conv.txt")]) != 0:
        fail(f"{name}: bgsa-convert failed")
    with open(stats_path) as f:
        return json.load(f)


def report(name, stats, extra="") -> None:
    keep = {k: stats[k] for k in ("query_count", "subject_count", "cal_gcups",
                                  "total_gcups", "cal_time", "total_time",
                                  "compile_time", "read_time", "pack_time",
                                  "write_time", "bucket_cal_times")}
    print(json.dumps({"run": name + extra, "card": card(), **keep}),
          flush=True)


def phase_end_to_end(paths, rng) -> None:
    for name, (qp, sp) in paths.items():
        out_dir = os.path.join(WORK, name, "one_card")
        stats = align(name, qp, sp, out_dir)
        report(name, stats)
        check_converted(name, qp, sp, os.path.join(out_dir, "conv.txt"), rng)
        shutil.rmtree(out_dir)


def phase_goldens() -> None:
    from bgsa_tpu import cli

    golden = os.path.join(HERE, "tests", "golden")
    qp = os.path.join(HERE, "sample-data", "query.txt")
    sp = os.path.join(HERE, "sample-data", "subject.txt")
    d = os.path.join(WORK, "goldens")
    os.makedirs(d, exist_ok=True)
    # 96 bp prefixes of the sample files (the 96 bp BitPAl golden)
    short = []
    for src in (qp, sp):
        dst = os.path.join(d, "p96_" + os.path.basename(src))
        with open(src) as f, open(dst, "w") as g:
            g.writelines(line[:96] + "\n" for line in f)
        short.append(dst)
    for label, q, s, flags, want in (
        ("myers_global", qp, sp, [], "sample_myers_global.txt"),
        ("bitpal", qp, sp, ["-M", "2", "-I", "-3", "-G", "-5"],
         "sample_bitpal_2_m3_m5.txt"),
        ("bitpal_96bp", *short, ["-M", "2", "-I", "-3", "-G", "-5"],
         "sample_bitpal_2_m3_m5_96bp.txt"),
    ):
        res = os.path.join(d, label + ".bin")
        conv = os.path.join(d, label + ".txt")
        if cli.align_main(["-q", q, "-d", s, "-f", res, "--quiet", *flags]) != 0:
            fail(f"golden {label}: bgsa-align failed")
        cli.convert_main(["-r", res, "-o", conv])
        with open(conv, "rb") as a, open(os.path.join(golden, want), "rb") as b:
            if a.read() != b.read():
                fail(f"golden {label}: converted output != tests/golden/{want}")
        say(f"golden {label}: byte-identical to tests/golden/{want}")


# ---------------------------------------------------------------- four cards

def run_roles(name, qp, sp) -> str:
    """Four --host h:4 role processes, one per card, then bgsa-merge and
    bgsa-convert. Returns the merged converted file. Runs before this
    process touches JAX: each role reserves most of its card's memory."""
    out = os.path.join(WORK, name, "roles")
    os.makedirs(out, exist_ok=True)
    shards = [os.path.join(out, f"shard{h}.bin") for h in range(4)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "bgsa_tpu.cli", "align", "-q", qp, "-d", sp,
         "-f", shards[h], "--host", f"{h}:4", "--quiet", *RUNS[name][3]],
        cwd=HERE, env={**os.environ, "CUDA_VISIBLE_DEVICES": str(h)})
        for h in range(4)]
    codes = [p.wait() for p in procs]
    if any(codes):
        fail(f"{name}: --host roles exited with {codes}")
    say(f"{name}: four --host roles done in {time.perf_counter() - t0:.1f} s")
    from bgsa_tpu import cli

    merged = os.path.join(out, "merged.bin")
    if cli.merge_main([*shards, "-o", merged]) != 0:
        fail(f"{name}: bgsa-merge failed")
    conv = os.path.join(out, "conv.txt")
    cli.convert_main(["-r", merged, "-o", conv])
    return conv


def same_bytes(a: str, b: str) -> bool:
    import filecmp

    return filecmp.cmp(a, b, shallow=False)


def phase_four_cards(paths, rng) -> dict:
    roles = {name: run_roles(name, *paths[name]) for name in FOUR_CARD_RUNS}
    info = phase_device()
    if info["count"] < 4:
        fail(f"--four-cards needs 4 devices, JAX found {info['count']}")
    check_shard_placement()
    for name in FOUR_CARD_RUNS:
        qp, sp = paths[name]
        one = os.path.join(WORK, name, "one_card")
        report(name, align(name, qp, sp, one))
        sharded = os.path.join(WORK, name, "shards4")
        report(name, align(name, qp, sp, sharded, ["--shards", "4"]),
               " --shards 4")
        one_conv = os.path.join(one, "conv.txt")
        check_converted(name, qp, sp, one_conv, rng)
        for label, conv in (("--shards 4", os.path.join(sharded, "conv.txt")),
                            ("4 --host roles + merge", roles[name])):
            if not same_bytes(conv, one_conv):
                fail(f"{name}: {label} output != the one-card run")
            say(f"{name}: {label} output byte-identical to the one-card run")
    return info


def check_shard_placement() -> None:
    """Each --shards 4 shard computes on its own card."""
    import numpy as np

    from bgsa_tpu.pipeline import PipelineConfig

    for name in FOUR_CARD_RUNS:
        eng = _engine(name, PipelineConfig(local_shards=4))
        rng = np.random.default_rng(0)
        q = rng.integers(0, 4, (2, 150)).astype(np.int32)
        s = rng.integers(0, 4, (4 * 3 * 128, 150)).astype(np.uint8)
        out = eng.scores(q, s)
        devs = sorted(str(sh.device) for sh in out.addressable_shards)
        if len(set(devs)) != 4:
            fail(f"{name}: --shards 4 output lives on {devs}")
        say(f"{name}: --shards 4 shards on {devs}")


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card paths and their one-card "
                         "comparison")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply every subject count (default 1: the "
                         "BASELINE.json config 5 sizes)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import numpy as np

    rng = np.random.default_rng(args.seed)
    t_start = time.perf_counter()
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        # child processes run before this one touches JAX: count the cards
        # with nvidia-smi first
        cards = card().splitlines()
        want = 4 if args.four_cards else 1
        if len(cards) < want or cards[0].startswith("nvidia-smi"):
            fail(f"needs {want} GPU(s); nvidia-smi: {cards}")
        if args.four_cards:
            info = phase_four_cards(make_data(args.scale, FOUR_CARD_RUNS), rng)
        else:
            phase_gpu_tests()
            info = phase_device()
            phase_compile()
            phase_parity(rng)
            paths = make_data(args.scale)
            phase_end_to_end(paths, rng)
            phase_goldens()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    say(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": info["platform"], "kind": info["kind"],
        "count": info["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
