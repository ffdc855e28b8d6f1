"""Crash-recovery robustness: resume must reproduce the uninterrupted run
byte-for-byte from any interruption point.

The reference has no restart logic at all (SURVEY §5); its append-only
result/.info pair merely survives. Our --resume turns that durability into
actual recovery — these tests cover a real SIGKILL mid-run and an
exhaustive sweep of truncation points.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from bgsa_tpu import pipeline as pl_mod
from bgsa_tpu.io import result as result_io
from bgsa_tpu.io import seqfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_resume_from_any_truncation_point(tmp_path, rng):
    """Chop the result file (and its .info) at every byte boundary of a
    3-bucket run; resume must always reconstruct the full run exactly."""
    Q, m, S, n = 2, 16, 700, 20
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=256 * (n + 1))

    full = str(tmp_path / "full.bin")
    pl_mod.run_alignment(qp, sp, full, config=cfg)
    want = open(full, "rb").read()
    want_info = open(full + ".info", "rb").read()

    db = seqfile.DatabaseReader(sp, cfg.bucket_size, cfg.v_num)
    bucket_bytes = [c * Q * 2 for c, _ in db.bucket_counts()]
    # Cut points: around every bucket boundary plus mid-bucket offsets.
    # Boundary cuts (where the .info manifest can be ahead of or behind the
    # result bytes) run with both a full and a truncated manifest; the
    # mid-bucket cuts exercise the same truncate-to-boundary path whatever
    # the manifest says, so one variant suffices — this halves the sweep's
    # resume-run count without losing a distinct recovery case.
    info_header = 16
    rec = 8 * 1 + 4  # one device
    boundary = {0, len(want)}
    mid = {1, len(want) - 1}
    off = 0
    for b in bucket_bytes:
        boundary.add(off)
        mid.update({max(off - 3, 0), off + 1, off + b // 2})
        off += b
    cases = [(c, (len(want_info), info_header + rec)) for c in boundary]
    cases += [(c, (len(want_info),)) for c in mid - boundary]
    for cut, info_lens in sorted(cases):
        part = str(tmp_path / "part.bin")
        open(part, "wb").write(want[:cut])
        for info_len in info_lens:
            open(part + ".info", "wb").write(want_info[:info_len])
            pl_mod.run_alignment(qp, sp, part, config=cfg, resume=True)
            assert open(part, "rb").read() == want, (cut, info_len)
            assert open(part + ".info", "rb").read() == want_info, (cut, info_len)


@pytest.mark.parametrize("mode", ["plain", "shard"])
def test_resume_after_sigkill(tmp_path, rng, mode):
    """Really SIGKILL a CLI run mid-bucket (slowed via the test hook), then
    resume and byte-compare against an uninterrupted run."""
    Q, m, S, n = 3, 20, 1500, 24
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    bucket_size = 256 * (n + 1)  # 6 buckets

    shard_args = ["--host", "0:2"] if mode == "shard" else []
    full = str(tmp_path / "full.bin")
    if mode == "shard":
        pl_mod.run_alignment(qp, sp, full, shard=(0, 2),
                             config=pl_mod.PipelineConfig(backend="xla", bucket_size=bucket_size))
    else:
        pl_mod.run_alignment(qp, sp, full,
                             config=pl_mod.PipelineConfig(backend="xla", bucket_size=bucket_size))
    want = open(full, "rb").read()

    part = str(tmp_path / "part.bin")
    env = {**os.environ, "PYTHONPATH": "", "JAX_PLATFORMS": "cpu",
           "BGSA_TEST_BUCKET_SLEEP": "0.3"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "bgsa_tpu.cli", "align", "-q", qp, "-d", sp,
         "-f", part, "--backend", "xla", "--bucket-size", str(bucket_size),
         "--quiet", *shard_args],
        cwd=REPO, env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
    )
    # wait until some buckets hit disk, then kill mid-run
    deadline = time.monotonic() + 120
    while time.monotonic() < deadline:
        if os.path.exists(part) and os.path.getsize(part) > 0:
            break
        time.sleep(0.05)
    else:
        proc.kill()
        pytest.fail("run never produced output")
    time.sleep(0.45)  # land inside a later bucket
    proc.send_signal(signal.SIGKILL)
    proc.wait()
    assert 0 < os.path.getsize(part), "nothing written before the kill"

    kw = dict(config=pl_mod.PipelineConfig(backend="xla", bucket_size=bucket_size),
              resume=True)
    if mode == "shard":
        pl_mod.run_alignment(qp, sp, part, shard=(0, 2), **kw)
    else:
        pl_mod.run_alignment(qp, sp, part, **kw)
    assert open(part, "rb").read() == want
    if mode == "plain":
        conv_a, conv_b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
        result_io.convert_result(full, conv_a)
        result_io.convert_result(part, conv_b)
        assert open(conv_a).read() == open(conv_b).read()
