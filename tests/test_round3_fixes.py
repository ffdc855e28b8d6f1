"""Regressions for the round-3 advisor/judge items.

* -D time files carry a run-identity token (stale files from a previous run
  in a reused sync_dir must never be read as this run's times).
* -t rejects --resume/--sync-dir instead of silently overwriting.
* Dead-peer timeout raises a clear error naming the missing host file.
"""

import os
import time

import numpy as np
import pytest

from bgsa_tpu import cli
from bgsa_tpu.io import seqfile
from bgsa_tpu.parallel import multihost


def _write_inputs(tmp_path, rng, Q=2, m=20, S=200, n=20):
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    return qp, sp


def test_run_token_identity(tmp_path, rng):
    qp, sp = _write_inputs(tmp_path, rng)
    t1 = multihost.run_token(qp, sp, 2, None, 1024)
    # Deterministic across repeat derivations (every host must agree).
    assert t1 == multihost.run_token(qp, sp, 2, None, 1024)
    # Any schedule-relevant input changes the token.
    assert t1 != multihost.run_token(qp, sp, 3, None, 1024)
    assert t1 != multihost.run_token(qp, sp, 2, None, 2048)
    assert t1 != multihost.run_token(qp, sp, 2, [1.0, 2.0], 1024)
    # The token is content-based: renaming/copying/touching the inputs (the
    # CLI's FASTA auto-convert gives every host its own temp copy) must NOT
    # change it, or hosts would derive different namespaces and deadlock.
    st = os.stat(sp)
    os.utime(sp, ns=(st.st_atime_ns, st.st_mtime_ns + 1_000_000))
    assert t1 == multihost.run_token(qp, sp, 2, None, 1024)
    import shutil

    sp2 = str(tmp_path / "renamed_copy.txt")
    shutil.copy(sp, sp2)
    assert t1 == multihost.run_token(qp, sp2, 2, None, 1024)
    # Different *content* (same name/size) does change it.
    data = bytearray(open(sp, "rb").read())
    data[0] = ord("T") if data[0] != ord("T") else ord("G")
    open(sp, "wb").write(bytes(data))
    assert t1 != multihost.run_token(qp, sp, 2, None, 1024)


def test_time_files_are_token_namespaced(tmp_path):
    token = "abc123def456"
    multihost.write_bucket_time(str(tmp_path), 0, 1, 2.5, token=token)
    path = multihost.bucket_time_path(str(tmp_path), 0, 1, token)
    assert os.path.basename(path) == f"bgsa.{token}.bucket0.host1.time"
    assert os.path.exists(path)
    # A stale legacy (un-tokened) file is invisible to tokened readers.
    with open(multihost.bucket_time_path(str(tmp_path), 0, 0), "w") as f:
        f.write("999.0\n")
    with pytest.raises(TimeoutError, match="host 0 never announced"):
        multihost.read_bucket_times(str(tmp_path), 0, 2, timeout=0.05,
                                    token=token)
    # clear_bucket_times only touches this run's namespace.
    multihost.clear_bucket_times(str(tmp_path), 1, token="othertoken99")
    assert os.path.exists(path)
    multihost.clear_bucket_times(str(tmp_path), 1, token=token)
    assert not os.path.exists(path)


def test_dead_peer_error_names_file(tmp_path):
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError) as ei:
        multihost.read_bucket_times(str(tmp_path), 3, 2, timeout=0.2,
                                    token="deadbeef0123")
    assert time.perf_counter() - t0 < 5.0  # fails fast, not after an hour
    msg = str(ei.value)
    assert "bucket3" in msg and "host0" in msg and "--sync-dir" in msg

    # a host that announced itself (alive, e.g. inside a compile episode)
    # gets the 10x grace window instead
    multihost.write_hello(str(tmp_path), 0, token="deadbeef0123")
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="started but stalled"):
        multihost.read_bucket_times(str(tmp_path), 3, 2, timeout=0.1,
                                    token="deadbeef0123")
    assert 0.9 < time.perf_counter() - t0 < 10.0  # ~10 x 0.1s


def test_cli_rejects_resume_with_hetero(tmp_path, rng, capsys):
    qp, sp = _write_inputs(tmp_path, rng)
    out = str(tmp_path / "o.bin")
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", out,
                   "-t", "cpu+cpu", "--resume", "--quiet"])
    assert rc == 1
    assert "--resume" in capsys.readouterr().err
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", out,
                   "-t", "cpu+cpu", "--sync-dir", str(tmp_path), "--quiet"])
    assert rc == 1
    assert "--sync-dir" in capsys.readouterr().err


def test_cli_sync_timeout_flag(tmp_path, rng, monkeypatch):
    """--sync-timeout reaches PipelineConfig (the dead-peer knob)."""
    qp, sp = _write_inputs(tmp_path, rng)
    seen = {}
    from bgsa_tpu import pipeline as pl_mod

    real = pl_mod.run_alignment

    def spy(*a, **kw):
        seen["timeout"] = a[5].sync_timeout if len(a) > 5 else kw["config"].sync_timeout
        return real(*a, **kw)

    monkeypatch.setattr(pl_mod, "run_alignment", spy)
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "o.bin"),
                   "--backend", "xla", "--host", "0:1", "-D",
                   "--sync-timeout", "7.5", "--quiet"])
    assert rc == 0
    assert seen["timeout"] == 7.5


def test_cli_sync_flags_require_dynamic_hosts(tmp_path, rng, capsys):
    """--sync-timeout/--sync-dir outside -D --host (and --profile-python
    without --profile) fail loudly instead of being silently ignored."""
    qp, sp = _write_inputs(tmp_path, rng)
    base = ["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "o.bin"),
            "--quiet"]
    assert cli.main([*base, "--sync-timeout", "5"]) == 1
    assert "--sync-timeout" in capsys.readouterr().err
    assert cli.main([*base, "--sync-dir", str(tmp_path)]) == 1
    assert "--sync-dir" in capsys.readouterr().err
    # static --host roles exchange no time files either
    assert cli.main([*base, "--host", "0:2", "--sync-timeout", "5"]) == 1
    capsys.readouterr()
    assert cli.main([*base, "--profile-python"]) == 1
    assert "--profile" in capsys.readouterr().err


def test_cli_dead_peer_fails_fast(tmp_path, rng):
    """A -D role whose peer never starts errors out after --sync-timeout
    with the dead-peer message (the reference hangs forever), end to end
    through the CLI."""
    import subprocess
    import sys
    import time as _time

    qp, sp = _write_inputs(tmp_path, rng, S=600)
    env = {**os.environ, "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    t0 = _time.monotonic()
    proc = subprocess.run(
        [sys.executable, "-m", "bgsa_tpu.cli", "align", "-q", qp, "-d", sp,
         "-f", str(tmp_path / "sh0.bin"), "--host", "0:2", "-D",
         "--bucket-size", str(128 * 21), "--backend", "xla",
         "--sync-timeout", "1.5", "--quiet"],
        cwd=repo, env=env, capture_output=True, timeout=120,
    )
    assert proc.returncode == 1
    assert b"never announced" in proc.stderr
    assert _time.monotonic() - t0 < 60


def test_cli_profile_flag(tmp_path, rng):
    """--profile captures a jax.profiler trace of the run.

    Runs in a fresh subprocess: in-process, stop_trace serializes xplanes
    for everything the long-lived pytest process has ever compiled (~20 s
    by the time this file runs vs ~2 s alone)."""
    import subprocess
    import sys

    qp, sp = _write_inputs(tmp_path, rng)
    prof = str(tmp_path / "prof")
    env = {**os.environ, "PYTHONPATH": "", "JAX_PLATFORMS": "cpu"}
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run(
        [sys.executable, "-m", "bgsa_tpu.cli", "align", "-q", qp, "-d", sp,
         "-f", str(tmp_path / "o.bin"), "--backend", "xla",
         "--profile", prof, "--quiet"],
        cwd=repo, env=env, capture_output=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    import glob

    assert glob.glob(prof + "/**/*.xplane.pb", recursive=True) or \
        glob.glob(prof + "/**/*.trace.json*", recursive=True)


def test_cli_carry_rejects_non_applicable(tmp_path, rng, capsys):
    """--carry must fail loudly where the carry layout cannot apply (the
    same no-silent-ignore rule as --shards with -k). Since the unpacked
    compare-carry variant landed (round 5), only Myers/banded runs reject
    it — every BitPAl run (either representation, any scheme) accepts."""
    qp, sp = _write_inputs(tmp_path, rng)
    out = str(tmp_path / "o.bin")
    base = ["align", "-q", qp, "-d", sp, "-f", out, "--quiet"]
    # unit-cost scheme -> Myers kernel
    assert cli.main([*base, "--carry"]) == 1
    assert "Myers" in capsys.readouterr().err
    # banded
    assert cli.main([*base, "--carry", "-k", "4"]) == 1
    capsys.readouterr()
    # non-packed: rides the unpacked compare-carry kernel
    assert cli.main([*base, "--carry", "-M", "2", "-I", "-3", "-G", "-5",
                     "--no-packed", "--backend", "xla"]) == 0
    # outside the packed decode's range (M > 2I - 2G + 1): the engine falls
    # back to non-packed, which now has its own 32-bit carry layout
    assert cli.main([*base, "--carry", "-M", "9", "-I", "-1", "-G", "-2",
                     "--backend", "xla"]) == 0
    # applicable packed scheme still runs
    assert cli.main([*base, "--carry", "-M", "2", "-I", "-3", "-G", "-5",
                     "--backend", "xla"]) == 0


def test_cli_shards_with_hetero_rejected(tmp_path, rng, capsys):
    qp, sp = _write_inputs(tmp_path, rng)
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "o.bin"),
                   "-t", "cpu+cpu", "--shards", "4", "--quiet"])
    assert rc == 1
    assert "--shards" in capsys.readouterr().err


def test_run_token_field_separation_and_tail(tmp_path, rng):
    """Collision cases from the round-3 review: ambiguous field
    concatenation and the untouched 64-128 KB tail."""
    qp, sp = _write_inputs(tmp_path, rng)
    # distinct configs must never collide (verified collisions pre-fix)
    assert multihost.run_token(qp, sp, 2, None, 1024) != \
        multihost.run_token(qp, sp, 2, [1024.0], None)
    assert multihost.run_token(qp, sp, 1, [2.0], None) != \
        multihost.run_token(qp, sp, 12, None, None)
    # a same-size content change beyond the first 64 KB changes the token
    big = str(tmp_path / "big.txt")
    data = bytearray(rng.integers(65, 69, size=100_000).astype(np.uint8))
    open(big, "wb").write(bytes(data))
    t1 = multihost.run_token(qp, big, 2, None, None)
    data[90_000] ^= 1
    open(big, "wb").write(bytes(data))
    assert t1 != multihost.run_token(qp, big, 2, None, None)


def test_stale_hello_is_ignored(tmp_path):
    """A crashed previous run's hello (old mtime) must not defeat the
    fail-fast for a never-relaunched peer."""
    token = "feedbead0001"
    multihost.write_hello(str(tmp_path), 1, token)
    p = multihost.hello_path(str(tmp_path), 1, token)
    old = time.time() - multihost.HELLO_FRESH_SECS - 60
    os.utime(p, (old, old))
    t0 = time.perf_counter()
    with pytest.raises(TimeoutError, match="never announced"):
        multihost.read_bucket_times(str(tmp_path), 0, 2, timeout=0.2,
                                    token=token)
    assert time.perf_counter() - t0 < 1.5  # base timeout, not the 10x grace
    # publishing a bucket time refreshes the hello -> alive again
    multihost.write_bucket_time(str(tmp_path), 0, 1, 1.0, token=token)
    assert time.time() - os.path.getmtime(p) < multihost.HELLO_FRESH_SECS


def test_sync_dir_is_created(tmp_path, rng):
    """An explicit --sync-dir that does not exist yet must be created, not
    crash the role on its own hello write (found by the verify drive)."""
    qp, sp = _write_inputs(tmp_path, rng)
    out = str(tmp_path / "shard.bin")
    sync = str(tmp_path / "fresh" / "nested")
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", out, "--backend",
                     "xla", "--quiet", "--host", "0:1", "-D",
                     "--sync-dir", sync]) == 0
    assert os.path.isdir(sync)


def test_convert_and_merge_report_missing_files(tmp_path, capsys):
    """convert/merge print argparse errors for missing inputs instead of
    raw tracebacks."""
    with pytest.raises(SystemExit):
        cli.main(["convert", "-r", str(tmp_path / "nope.bin"),
                  "-o", str(tmp_path / "o.txt")])
    assert "nope.bin" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["merge", str(tmp_path / "ghost.bin"),
                  "-o", str(tmp_path / "m.bin")])
    assert "ghost.bin" in capsys.readouterr().err


def test_convert_and_merge_report_malformed_files(tmp_path, capsys):
    """Valid-JSON-wrong-shape sidecars and truncated .info files are argparse
    errors too, not TypeError/struct.error tracebacks."""
    shard = tmp_path / "s.bin"
    shard.write_bytes(b"\x00" * 8)
    for bad in ("{}", "[]", '{"host_id": 0, "bogus_key": 1}',
                '{"host_id": 0, "n_hosts": 1, "ref_count": 1, '
                '"block_counts": [4], "extra_counts": [0], "dtype": "garbage"}'):
        (tmp_path / "s.bin.meta.json").write_text(bad)
        with pytest.raises(SystemExit):
            cli.main(["merge", str(shard), "-o", str(tmp_path / "m.bin")])
        assert "usage" in capsys.readouterr().err
    res = tmp_path / "r.bin"
    res.write_bytes(b"\x00" * 8)
    (tmp_path / "r.bin.info").write_bytes(b"\x01\x00\x00\x00")  # truncated
    with pytest.raises(SystemExit):
        cli.main(["convert", "-r", str(res), "-o", str(tmp_path / "o.txt")])
    assert ".info" in capsys.readouterr().err


def test_reader_thread_failure_raises_instead_of_hanging(tmp_path, rng, monkeypatch):
    """A mid-run database read failure must surface as an error in the main
    loop — before the fix the reader thread died without enqueuing its
    sentinel and run_alignment blocked on the bucket queue forever."""
    import threading

    from bgsa_tpu import pipeline as pl_mod

    qp, sp = _write_inputs(tmp_path, rng, S=600)
    real_reader = pl_mod.seqfile.DatabaseReader

    class FailingReader(real_reader):
        def __iter__(self):
            it = super().__iter__()
            yield next(it)  # first bucket reads fine
            raise OSError("disk pulled mid-run")

    monkeypatch.setattr(pl_mod.seqfile, "DatabaseReader", FailingReader)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=128 * 21)
    before = threading.active_count()
    with pytest.raises(OSError, match="disk pulled mid-run"):
        pl_mod.run_alignment(qp, sp, str(tmp_path / "r.bin"), config=cfg)
    # the reader thread must exit too (stop event), not leak blocked on a
    # full queue holding the database file open
    deadline = time.time() + 5
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() <= before


def test_stats_json_output(tmp_path, rng):
    """--stats-json writes parseable run statistics with the reference's
    phase fields and computed GCUPS."""
    import json

    qp, sp = _write_inputs(tmp_path, rng)
    sj = tmp_path / "stats.json"
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "r.bin"),
                   "--quiet", "--backend", "xla", "--stats-json", str(sj)])
    assert rc == 0
    d = json.loads(sj.read_text())
    assert d["query_count"] == 2 and d["subject_count"] == 200
    for key in ("read_time", "pack_time", "cal_time", "write_time",
                "compile_time", "total_time", "cal_gcups", "total_gcups",
                "bucket_cal_times"):
        assert key in d
    assert d["cal_gcups"] is None or d["cal_gcups"] > 0
    assert d["total_time"] > 0


@pytest.mark.parametrize("extra, msg", [
    (["--host", "banana"], "expects I:N"),
    (["--host", "3:2"], "0 <= I < N"),
    (["--host", "0:2", "-t", "cpu+cpu"], "mutually exclusive"),
    (["-t", "cpu+cpu", "--shards", "2"], "mutually exclusive"),
    (["-n", "2"], "-n needs a single-platform -t"),
    (["-t", "cpu+cpu", "-n", "2"], "-n needs a single-platform -t"),
    (["-t", "cpu", "-n", "0"], "-n must be >= 1"),
    (["-D"], "-D requires"),
    (["--profile-python"], "--profile-python needs"),
    (["-R", "whatever.txt"], "-R requires"),
    # banded is the unit-cost filter: scoring/mode flags would be silently
    # ignored, and a negative threshold used to die with a misleading
    # geometry message
    (["-k", "5", "-M", "2", "-I", "-3", "-G", "-5"], "cannot combine with -k"),
    (["-k", "5", "-M", "0"], "cannot combine with -k"),
    (["-k", "5", "--semi-global"], "cannot combine with -k"),
    (["-k", "-1"], "-k must be >= 0"),
])
def test_cli_flag_validation_errors(tmp_path, rng, capsys, extra, msg):
    """Every invalid flag combination fails loudly before any compute (the
    reference silently ignores flags its port doesn't implement)."""
    qp, sp = _write_inputs(tmp_path, rng, S=130)
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "r.bin"),
                   "--quiet", "--backend", "xla", *extra])
    assert rc == 1
    assert msg in capsys.readouterr().err


def test_cli_convert_fasta_fastq_and_missing_inputs(tmp_path, rng, capsys):
    """bgsa-convert -f/-q through the CLI (not just the fastx functions),
    plus align's missing-input and runtime-error reporting."""
    lut = "ACGT"
    seqs = ["".join(lut[c] for c in row) for row in rng.integers(0, 4, size=(3, 12))]
    fa, fq = tmp_path / "in.fa", tmp_path / "in.fq"
    fa.write_text("".join(f">s{i} x\n{s}\n" for i, s in enumerate(seqs)))
    fq.write_text("".join(f"@r{i}\n{s}\n+\n{'@' * 12}\n" for i, s in enumerate(seqs)))
    want = "".join(s + "\n" for s in seqs)
    out = tmp_path / "o.txt"
    assert cli.main(["convert", "-f", str(fa), "-o", str(out)]) == 0
    assert out.read_text() == want
    assert cli.main(["convert", "-q", str(fq), "-o", str(out)]) == 0
    assert out.read_text() == want

    # align: nonexistent input is an argparse-style error
    with pytest.raises(SystemExit):
        cli.main(["align", "-q", str(tmp_path / "ghost.txt"), "-d", str(fa),
                  "-f", str(tmp_path / "r.bin"), "--quiet"])
    assert "ghost.txt" in capsys.readouterr().err

    # align: a runtime input error (ragged database) reports rc=1 + message
    ragged = tmp_path / "ragged.txt"
    ragged.write_bytes(b"ACGT\nACGTT\nAC\n")  # size lines up; caught mid-read
    qp, _ = _write_inputs(tmp_path, rng, S=130)
    rc = cli.main(["align", "-q", qp, "-d", str(ragged),
                   "-f", str(tmp_path / "r.bin"), "--quiet", "--backend", "xla"])
    assert rc == 1
    assert "ragged line" in capsys.readouterr().err


def test_benchutil_chain_and_dataset():
    """filter_mix_dataset must plant the advertised near-duplicate
    fraction."""
    from bgsa_tpu import benchutil

    rng = np.random.default_rng(0)
    qb, sb = benchutil.filter_mix_dataset(rng, 4, 400, 60, near_frac=0.25)
    assert qb.shape == (4, 60) and sb.shape == (400, 60)
    near = sum(
        min(int((sb != qrow).sum(1).min()) for qrow in qb) <= 5
        for sb in (sb[i][None] for i in range(400))
    )
    assert near >= 100  # every planted read is within 5 edits of some query


def test_scheme_validation_errors():
    from bgsa_tpu.schemes import Algorithm, Mode, Scoring, normalize

    # the explicit-algorithm success branches (the library-API path; the
    # engines construct banded schemes directly)
    banded = normalize(Scoring(0, 1, 1), Mode.GLOBAL, Algorithm.BANDED)
    assert banded.algorithm is Algorithm.BANDED and banded.factor == 1
    with pytest.raises(ValueError, match="unit weights"):
        normalize(Scoring(2, -3, -5), Mode.GLOBAL, Algorithm.BANDED)
    with pytest.raises(ValueError, match="unit weights"):
        normalize(Scoring(2, -3, -5), Mode.GLOBAL, Algorithm.MYERS)
    with pytest.raises(ValueError, match="match >= 0"):
        normalize(Scoring(-1, -3, -5))
    with pytest.raises(ValueError, match="gap < 0"):
        normalize(Scoring(2, -3, 1))
    with pytest.raises(ValueError, match="mismatch < match"):
        normalize(Scoring(2, 3, -5))


def test_cli_rejects_packed_flag_outside_bitpal(tmp_path, rng, capsys):
    qp, sp = _write_inputs(tmp_path, rng, S=130)
    base = ["align", "-q", qp, "-d", sp, "-f", str(tmp_path / "r.bin"),
            "--quiet", "--backend", "xla"]
    for extra in (["--no-packed"], ["--packed"], ["-k", "4", "--no-packed"]):
        rc = cli.main(base + extra)
        assert rc == 1
        assert "applies to BitPAl" in capsys.readouterr().err
    # still fine where it belongs
    assert cli.main(base + ["-M", "2", "-I", "-3", "-G", "-5",
                            "--no-packed"]) == 0
