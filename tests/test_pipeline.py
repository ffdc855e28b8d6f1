import subprocess
import sys

import numpy as np
import pytest

from bgsa_tpu import pipeline as pl_mod
from bgsa_tpu.io import result as result_io
from bgsa_tpu.io import seqfile
from bgsa_tpu.oracle import edit_distances
from bgsa_tpu.schemes import Mode, Scoring

ALPHA = np.array(list("ACGT"))


def make_files(tmp_path, rng, Q=3, m=40, S=10, n=50):
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    return qp, sp, q, s


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_end_to_end_matches_oracle(tmp_path, rng, backend):
    qp, sp, q, s = make_files(tmp_path, rng, Q=3, m=40, S=300, n=50)
    res = str(tmp_path / "r.bin")
    cfg = pl_mod.PipelineConfig(backend=backend, interpret=(backend == "pallas"))
    stats = pl_mod.run_alignment(qp, sp, res, Scoring(0, -1, -1), Mode.GLOBAL, cfg)
    assert stats.subject_count == 300
    out = str(tmp_path / "conv.txt")
    result_io.convert_result(res, out)
    got = np.loadtxt(out, dtype=np.int64).reshape(3, 300)
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_multi_bucket_multi_query_bucket(tmp_path, rng):
    # Force several database buckets and 2 query buckets.
    Q, m, S, n = 5, 30, 700, 40
    qp, sp, q, s = make_files(tmp_path, rng, Q=Q, m=m, S=S, n=n)
    res = str(tmp_path / "r.bin")
    cfg = pl_mod.PipelineConfig(
        backend="xla", bucket_size=256 * (n + 1), ref_bucket_count=3, v_num=128
    )
    pl_mod.run_alignment(qp, sp, res, config=cfg)
    info = result_io.read_info(res + ".info")
    assert info.block_num == 3
    assert info.device_read_counts == [[256], [256], [256]]
    assert info.extra_counts == [0, 0, 68]
    out = str(tmp_path / "conv.txt")
    result_io.convert_result(res, out, ref_bucket_count=3)
    got = np.loadtxt(out, dtype=np.int64).reshape(Q, S)
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_cli_roundtrip(tmp_path, rng):
    qp, sp, q, s = make_files(tmp_path, rng, Q=2, m=25, S=9, n=30)
    res = str(tmp_path / "out" / "r.bin")
    from bgsa_tpu import cli

    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", res, "--backend", "xla", "--quiet"])
    assert rc == 0
    out = str(tmp_path / "c.txt")
    rc = cli.main(["convert", "-r", res, "-o", out])
    assert rc == 0
    got = np.loadtxt(out, dtype=np.int64).reshape(2, 9)
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_semiglobal_pipeline(tmp_path, rng):
    from bgsa_tpu.oracle import align_scores

    qp, sp, q, s = make_files(tmp_path, rng, Q=3, m=60, S=200, n=35)
    res = str(tmp_path / "r.bin")
    cfg = pl_mod.PipelineConfig(backend="xla")
    pl_mod.run_alignment(qp, sp, res, Scoring(0, -1, -1), Mode.SEMI_GLOBAL, cfg)
    out = str(tmp_path / "c.txt")
    result_io.convert_result(res, out)
    got = np.loadtxt(out, dtype=np.int64).reshape(3, 200)
    want = np.stack([align_scores(qi, s, Scoring(0, -1, -1), Mode.SEMI_GLOBAL) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_bitpal_pipeline(tmp_path, rng):
    from bgsa_tpu.oracle import align_scores

    qp, sp, q, s = make_files(tmp_path, rng, Q=2, m=30, S=150, n=40)
    res = str(tmp_path / "r.bin")
    cfg = pl_mod.PipelineConfig(backend="xla")
    pl_mod.run_alignment(qp, sp, res, Scoring(2, -3, -5), Mode.GLOBAL, cfg)
    out = str(tmp_path / "c.txt")
    result_io.convert_result(res, out)
    got = np.loadtxt(out, dtype=np.int64).reshape(2, 150)
    want = np.stack([align_scores(qi, s, Scoring(2, -3, -5)) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_resume_after_interruption(tmp_path, rng):
    Q, m, S, n = 3, 30, 900, 40
    qp, sp, q, s = make_files(tmp_path, rng, Q=Q, m=m, S=S, n=n)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=256 * (n + 1))
    full = str(tmp_path / "full.bin")
    pl_mod.run_alignment(qp, sp, full, config=cfg)

    # simulate a crash: bucket 0+1 complete, bucket 2's record written but
    # its scores only partially flushed
    part = str(tmp_path / "part.bin")
    import shutil

    shutil.copy(full, part)
    shutil.copy(full + ".info", part + ".info")
    bucket_bytes = 256 * Q * 2
    with open(part, "r+b") as f:
        f.truncate(2 * bucket_bytes + 100)

    stats = pl_mod.run_alignment(qp, sp, part, config=cfg, resume=True)
    assert stats.subject_count == S - 2 * 256  # only the last bucket recomputed
    assert open(part, "rb").read() == open(full, "rb").read()
    assert open(part + ".info", "rb").read() == open(full + ".info", "rb").read()


def test_bitpal_pipeline_pallas_interpret(tmp_path, rng):
    """The Engine's kernel-route BitPAl dispatch (packed: the Pallas
    kernel in interpret mode; non-packed: bitpal_xla on every route)."""
    from bgsa_tpu.oracle import align_scores

    qp, sp, q, s = make_files(tmp_path, rng, Q=2, m=24, S=256, n=30)
    want = np.stack([align_scores(qi, s, Scoring(2, -3, -5)) for qi in q])
    for packed in (True, False):
        cfg = pl_mod.PipelineConfig(backend="pallas", interpret=True,
                                    bitpal_packed=packed)
        res = str(tmp_path / f"r{packed}.bin")
        pl_mod.run_alignment(qp, sp, res, Scoring(2, -3, -5), Mode.GLOBAL, cfg)
        out = str(tmp_path / f"c{packed}.txt")
        result_io.convert_result(res, out)
        got = np.loadtxt(out, dtype=np.int64).reshape(2, 256)
        np.testing.assert_array_equal(got, want)


def test_run_bucketed_warm_fallback_without_compile_for(tmp_path, rng):
    """A custom engine exposing only scores() (the documented minimal
    surface) takes the dummy-bucket warm-up fallback; output unchanged."""
    qp, sp, q, s = make_files(tmp_path, rng, Q=2, m=20, S=300, n=25)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=128 * 26)

    class MinimalEngine:
        n_shards = 1

        def __init__(self):
            from bgsa_tpu.schemes import normalize

            self._inner = pl_mod.Engine(normalize(Scoring(0, -1, -1)), cfg)

        def scores(self, qc, sc):
            return self._inner.scores(qc, sc)

    res = str(tmp_path / "r.bin")
    pl_mod.run_bucketed(MinimalEngine(), qp, sp, res, cfg, shard=None,
                        shard_ratios=None, resume=False,
                        write_dtype=np.int16)
    ref = str(tmp_path / "ref.bin")
    pl_mod.run_alignment(qp, sp, ref, config=cfg)
    assert open(res, "rb").read() == open(ref, "rb").read()


def test_run_bucketed_dynamic_requires_shard(tmp_path, rng):
    qp, sp, _, _ = make_files(tmp_path, rng)
    with pytest.raises(ValueError, match="requires shard"):
        pl_mod.run_alignment(qp, sp, str(tmp_path / "r.bin"),
                             config=pl_mod.PipelineConfig(backend="xla"),
                             dynamic=True)
