"""In-process heterogeneous co-compute (the reference's -t MICSSE mode):
N unequal devices share every bucket, device 0 ratio-pinned, optional
dynamic re-splitting — parallel/hetero.py vs cal_all.c:136-1487."""

import jax
import numpy as np
import pytest

from bgsa_tpu import pipeline as pl_mod
from bgsa_tpu.io import result as result_io
from bgsa_tpu.io import seqfile
from bgsa_tpu.parallel.hetero import hetero_engines, run_hetero
from bgsa_tpu.schemes import Mode, Scoring, normalize


def _dataset(tmp_path, rng, Q=4, m=30, S=2100, n=40):
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    return qp, sp, n


def test_hetero_static_matches_single(tmp_path, rng):
    qp, sp, n = _dataset(tmp_path, rng)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=512 * (n + 1))

    single = str(tmp_path / "single.bin")
    pl_mod.run_alignment(qp, sp, single, config=cfg)
    conv_single = str(tmp_path / "single.txt")
    result_io.convert_result(single, conv_single)

    scheme = normalize(Scoring(0, -1, -1), Mode.GLOBAL)
    devs = jax.devices()
    engines = [pl_mod.Engine(scheme, cfg, device=devs[i % len(devs)]) for i in range(2)]
    het = str(tmp_path / "het.bin")
    stats, times = run_hetero(engines, qp, sp, het, cfg, ratios=[1.0, 3.0])
    assert len(times) == 2 and all(t > 0 for t in times)

    info = result_io.read_info(het + ".info")
    assert info.device_num == 2
    # ratio-weighted split, chunk-aligned
    assert info.device_read_counts[0][0] < info.device_read_counts[0][1]
    conv_het = str(tmp_path / "het.txt")
    result_io.convert_result(het, conv_het)
    assert open(conv_het).read() == open(conv_single).read()


def test_hetero_dynamic_rebalances(tmp_path, rng):
    """Device 1 artificially slowed: later buckets shift subjects to device
    0, output still identical to the single-device run.

    This is the suite's ONE sanctioned end-to-end sleep test (slow-marked):
    it asserts convergence *direction* from a real slowed device. All other
    dynamic tests assert on deterministic artifacts only (published time
    files / recorded ratio schedules) — see test_dynamic.py."""
    qp, sp, n = _dataset(tmp_path, rng, S=4200)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=1024 * (n + 1))

    single = str(tmp_path / "single.bin")
    pl_mod.run_alignment(qp, sp, single, config=cfg)
    conv_single = str(tmp_path / "single.txt")
    result_io.convert_result(single, conv_single)

    scheme = normalize(Scoring(0, -1, -1), Mode.GLOBAL)
    devs = jax.devices()
    engines = [pl_mod.Engine(scheme, cfg, device=devs[i % len(devs)]) for i in range(2)]
    engines[1].test_sleep = 0.15  # hetero driver's per-bucket slow hook
    het = str(tmp_path / "het.bin")
    stats, times = run_hetero(engines, qp, sp, het, cfg, dynamic=True)
    assert times[1] > times[0]

    info = result_io.read_info(het + ".info")
    counts = info.device_read_counts
    assert counts[0][0] == counts[0][1] == 512  # bucket 0 even
    # Wall-clock-insensitive checks: the measured slowdown must push every
    # post-measurement ratio below 1 (direction, not magnitude), and the
    # applied splits must be exactly split_counts of the recorded schedule.
    ratios = stats.dynamic_ratios
    assert len(ratios) == len(counts) and ratios[0] == [1.0, 1.0]
    assert all(r[1] < 1.0 for r in ratios[1:])
    from bgsa_tpu.parallel.multihost import split_counts

    for b, r in enumerate(ratios):
        assert list(counts[b]) == split_counts(sum(counts[b]), 2, 128, r)
    conv_het = str(tmp_path / "het.txt")
    result_io.convert_result(het, conv_het)
    assert open(conv_het).read() == open(conv_single).read()


def test_hetero_banded_and_cli(tmp_path, rng):
    """-t cpu+cpu through the CLI, banded family, dynamic."""
    from bgsa_tpu import cli
    from bgsa_tpu.banded_pipeline import run_banded

    Q, m, S, n = 3, 40, 1200, 44
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    s[:100, :m] = q[0]
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=256 * (n + 1))

    single = str(tmp_path / "single.bin")
    run_banded(qp, sp, single, 6, cfg)
    conv_single = str(tmp_path / "single.txt")
    result_io.convert_result(single, conv_single, write_dtype=np.int8)

    het = str(tmp_path / "het.bin")
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", het, "-k", "6",
                   "-t", "cpu+cpu", "-D", "--backend", "xla",
                   "--bucket-size", str(256 * (n + 1)), "--quiet"])
    assert rc == 0
    conv_het = str(tmp_path / "het.txt")
    result_io.convert_result(het, conv_het, write_dtype=np.int8)
    assert open(conv_het).read() == open(conv_single).read()


def test_hetero_rejects_unknown_platform(tmp_path, rng):
    cfg = pl_mod.PipelineConfig(backend="xla")
    with pytest.raises(ValueError, match="not registered|device"):
        hetero_engines(Scoring(0, -1, -1), Mode.GLOBAL, cfg, "nope+cpu")


def test_cli_n_device_count(tmp_path, rng):
    """-t cpu -n 2 == -t cpu+cpu (the reference's -n mic count)."""
    from bgsa_tpu import cli

    q = rng.integers(0, 4, size=(2, 20))
    s = rng.integers(0, 4, size=(500, 24))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    het = str(tmp_path / "het.bin")
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", het,
                   "-t", "cpu", "-n", "2", "--backend", "xla", "--quiet"])
    assert rc == 0
    info = result_io.read_info(het + ".info")
    assert info.device_num == 2

    single = str(tmp_path / "single.bin")
    pl_mod.run_alignment(qp, sp, single, config=pl_mod.PipelineConfig(backend="xla"))
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    result_io.convert_result(single, a)
    result_io.convert_result(het, b)
    assert open(a).read() == open(b).read()

    # -n with a multi-platform spec is rejected
    assert cli.main(["align", "-q", qp, "-d", sp, "-f", het,
                     "-t", "cpu+cpu", "-n", "2", "--quiet"]) == 1


def test_hetero_worker_error_propagates(tmp_path, rng):
    """An engine failure inside a device worker thread must surface as the
    run's exception (not deadlock or a silently truncated result file)."""
    qp, sp, n = _dataset(tmp_path, rng, S=600)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=512 * (n + 1))
    engines = [
        pl_mod.Engine(normalize(Scoring(0, -1, -1), Mode.GLOBAL), cfg)
        for _ in range(2)
    ]

    class Boom(RuntimeError):
        pass

    import threading

    orig = engines[1].scores_packed

    def broken(*a, **k):
        # fail only inside the device worker thread — the main-thread
        # warm-up calls must succeed so the error exercises the worker's
        # errs[] propagation, not the warm-up path
        if threading.current_thread() is not threading.main_thread():
            raise Boom("device fell over")
        return orig(*a, **k)

    engines[1].scores_packed = broken
    with pytest.raises(Boom, match="device fell over"):
        run_hetero(engines, qp, sp, str(tmp_path / "r.bin"), cfg)


def test_hetero_zero_count_middle_device(tmp_path, rng):
    """Extreme ratios can floor a middle device's slice to zero subjects;
    the multi-device result/.info layout must still convert identically to
    a single-device run (the reference's convert handles 0-count devices)."""
    qp, sp, n = _dataset(tmp_path, rng, S=700)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=512 * (n + 1))

    single = str(tmp_path / "single.bin")
    pl_mod.run_alignment(qp, sp, single, config=cfg)
    conv_single = str(tmp_path / "single.txt")
    result_io.convert_result(single, conv_single)

    scheme = normalize(Scoring(0, -1, -1), Mode.GLOBAL)
    engines = [pl_mod.Engine(scheme, cfg) for _ in range(3)]
    multi = str(tmp_path / "multi.bin")
    _, times = run_hetero(engines, qp, sp, multi, cfg, ratios=[1e9, 1.0, 1e9])
    info = result_io.read_info(multi + ".info")
    assert any(c == 0 for counts in info.device_read_counts for c in counts)
    conv_multi = str(tmp_path / "multi.txt")
    result_io.convert_result(multi, conv_multi)
    assert open(conv_multi).read() == open(conv_single).read()


def test_cli_reference_type_aliases(tmp_path, rng, capsys):
    """The reference's -t SIMPLE/SSE/MIC/MICSSE spellings map to platform
    specs (original/BGSA_KNC/main.c:73-83) — SIMPLE/SSE run CPU-only."""
    from bgsa_tpu import cli

    q = rng.integers(0, 4, size=(2, 20))
    s = rng.integers(0, 4, size=(400, 24))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    het = str(tmp_path / "het.bin")
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", het,
                   "-t", "SIMPLE", "--backend", "xla"])
    assert rc == 0
    assert "-t cpu" in capsys.readouterr().out
    single = str(tmp_path / "single.bin")
    pl_mod.run_alignment(qp, sp, single, config=pl_mod.PipelineConfig(backend="xla"))
    a, b = str(tmp_path / "a.txt"), str(tmp_path / "b.txt")
    result_io.convert_result(single, a)
    result_io.convert_result(het, b)
    assert open(a).read() == open(b).read()

    # MIC / MICSSE name JAX's default platform (the GPU on the card); on
    # this CPU test box MICSSE is cpu+cpu and scores like a single run
    rc = cli.main(["align", "-q", qp, "-d", sp, "-f", het,
                   "-t", "MICSSE", "--backend", "xla"])
    assert rc == 0
    assert "-t cpu+cpu" in capsys.readouterr().out
    result_io.convert_result(het, b)
    assert open(a).read() == open(b).read()


def test_hetero_sparse_n_sidecar_and_uneven_tail(tmp_path, rng):
    """Sparse-N subjects through the heterogeneous driver: workers must ride
    the 2bit+sidecar transport (its geometry warmed lazily outside the timed
    window) — the round-3 sidecar work covered shard_map and --host with
    tests, but no hetero run ever carried N. The dataset size also leaves
    the last device a non-chunk-multiple slice (the pad-rows branch)."""
    # Geometry chosen against the routing math: 2048-row buckets give a
    # 256-row dynamic chunk; ratios 1:2 give device 1 a 1536-row slice in
    # bucket 0 (>= pack.SIDECAR_QUANT, so sparse N selects 2bitN there) and
    # a 128-row tail-bucket slice (not a chunk multiple -> the pad-rows
    # branch; device 0's tail share rounds to zero -> the skip branch).
    Q, m, S, n = 2, 24, 2100, 33
    q = rng.integers(0, 4, size=(Q, m))
    s = rng.integers(0, 4, size=(S, n))
    s[rng.integers(0, S, 50), rng.integers(0, n, 50)] = 4  # sparse N
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    cfg = pl_mod.PipelineConfig(backend="xla", bucket_size=2048 * (n + 1))

    from bgsa_tpu import pack

    # the 1536-row slice really is sparse-N enough for the sidecar gate
    assert pack.select_transport(s[512:2048].astype(np.uint8))[0] == "2bitN"

    single = str(tmp_path / "single.bin")
    pl_mod.run_alignment(qp, sp, single, config=cfg)
    conv_single = str(tmp_path / "single.txt")
    result_io.convert_result(single, conv_single)

    scheme = normalize(Scoring(0, -1, -1), Mode.GLOBAL)
    devs = jax.devices()
    engines = [pl_mod.Engine(scheme, cfg, device=devs[i % len(devs)])
               for i in range(2)]
    het = str(tmp_path / "het.bin")
    run_hetero(engines, qp, sp, het, cfg, ratios=[1.0, 2.0])
    conv_het = str(tmp_path / "het.txt")
    result_io.convert_result(het, conv_het)
    assert open(conv_het).read() == open(conv_single).read()
