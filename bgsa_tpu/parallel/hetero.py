"""In-process heterogeneous co-compute: N unequal devices share every bucket.

Analogue of the reference's KNC ``-t MICSSE`` mode
(``/root/reference/original/BGSA_KNC/cal_all.c:136-769`` static,
``:772-1487`` dynamic): there, one process drives the host CPU plus N Xeon
Phis, one OpenMP section per device, splitting each subject bucket by
``device_compute_ratio`` (``dispatch_task``, ``global.c:373-431``) and
re-measuring after every bucket in ``-D`` mode. Here, one process drives N
jax Devices (e.g. the GPU plus the XLA CPU backend) with one worker
thread per device; JAX's async dispatch plays the role of the LEO offload
signals, and the per-device wall times feed the same bit-exact
``DynamicBalancer``.

Device 0 is the pinned-ratio device (the reference's CPU); results are
written in device order per query bucket — the reference's multi-device
``.info``/result layout, so ``convert`` output is identical to a
single-device run.

Works on homogeneous virtual devices too (tests run N CPU devices with an
artificial slowdown); the split math is shared with the multi-host path
(``multihost.split_counts``).
"""

from __future__ import annotations

import threading
import time

import numpy as np

from .. import pack
from ..io import result as result_io
from ..io import seqfile
from ..stats import RunStats
from .multihost import DynamicBalancer, split_counts


def run_hetero(
    engines,
    query_path: str,
    db_path: str,
    result_path: str,
    config,
    *,
    ratios=None,
    dynamic: bool = False,
    write_dtype=np.int16,
    grid: int | None = None,
):
    """Bucketed run over N per-device engines; returns (stats, per-device times).

    engines: one Engine/BandedEngine per device, each pinned via its
      ``device=`` argument (or sharing one backend in tests).
    ratios: initial split weights (reference ``-R`` / ``mic_cpu_ratio``);
      even when None.
    dynamic: re-split every bucket from measured per-device wall times
      (the reference's ``-D``).

    No resume support — same as the reference's in-process heterogeneous
    mode (it has no restart logic anywhere); use the multi-host roles
    (``--host`` + ``--resume``) for recoverable long runs.
    """
    n_dev = len(engines)
    stats = RunStats()
    t_start = time.perf_counter()

    v_num = config.v_num
    t0 = time.perf_counter()
    queries = seqfile.read_queries(query_path)
    db = seqfile.DatabaseReader(db_path, config.bucket_size, v_num)
    stats.read_time += time.perf_counter() - t0
    stats.query_count, stats.query_len = queries.shape
    stats.subject_len = db.length

    q_buckets = [
        queries[s : s + config.ref_bucket_count]
        for s in range(0, len(queries), config.ref_bucket_count)
    ]

    # Same shape-quantization as the multi-host dynamic mode: slices align to
    # chunk so at most `grid` distinct shapes compile per device.
    grid = grid or config.dynamic_grid
    chunk = v_num
    if db.bucket_count > 1:
        chunk = v_num * max(1, -(-db.seqs_per_bucket // (v_num * grid)))

    balancer = DynamicBalancer(n_dev, initial_ratios=ratios)
    cur_ratios = list(balancer.ratios)

    writer = result_io.ResultWriter(
        result_path, ref_count=len(queries), block_num=db.bucket_count,
        device_num=n_dev, write_dtype=write_dtype,
    )

    warmed: list[set] = [set() for _ in range(n_dev)]
    # Pre-warm the nibble step only when the tail bucket carries 'N' lane
    # pads (same policy as run_bucketed; other N geometries warm lazily).
    warm_fills = (0, 4) if db.bucket_counts()[-1][1] else (0,)

    def ensure_warm(dev: int, rows: int) -> None:
        if not rows or rows in warmed[dev]:
            return
        warmed[dev].add(rows)
        t0 = time.perf_counter()
        for fill in warm_fills:
            dummy = np.full((rows, db.length), fill, np.uint8)
            for nq in sorted({qb.shape[0] for qb in q_buckets}):
                # compile + run once outside the timed bucket, so the
                # balancer never sees a compile
                engines[dev].scores(queries[:nq], dummy).block_until_ready()
            warmed_geom[dev].add(
                ("2bit" if fill == 0 else "nib", (rows, db.length), None)
            )
        stats.compile_time += time.perf_counter() - t0

    device_times = [0.0] * n_dev
    slow_hooks = [getattr(e, "test_sleep", 0.0) for e in engines]
    # Sidecar geometries a device's jit cache has already compiled (the
    # pre-bucket ensure_warm can't know sidecar sizes).
    warmed_geom: list[set] = [set() for _ in range(n_dev)]

    for bucket in db:
        counts = split_counts(bucket.count, n_dev, chunk, cur_ratios)
        if dynamic:
            # Applied ratio schedule (the reference prints its
            # device_compute_ratio per round); also what the tests replay.
            stats.dynamic_ratios.append(list(cur_ratios))
        starts = np.cumsum([0] + counts[:-1])
        pads = [-(-c // chunk) * chunk for c in counts]
        for d in range(n_dev):
            ensure_warm(d, pads[d])

        # Pack every device's slice on the main thread (the reference's
        # handle_reads phase runs before its compute section too), and warm
        # any new sidecar geometry — pinned engines trace through jit, so a
        # first-call compile inside the timed worker would distort the
        # balancer's measurement for this bucket.
        slices: list = [None] * n_dev
        for d in range(n_dev):
            if not counts[d]:
                continue
            t0 = time.perf_counter()
            codes = bucket.codes[starts[d] : starts[d] + counts[d]]
            if counts[d] < pads[d]:
                codes = np.concatenate(
                    [codes, np.zeros((pads[d] - counts[d], codes.shape[1]),
                                     codes.dtype)]
                )
            from ..pipeline import _pack_threads

            transport, packed = pack.select_transport(
                codes, threads=_pack_threads(config)
            )
            stats.pack_time += time.perf_counter() - t0
            key = (transport, codes.shape,
                   packed[1].shape if isinstance(packed, tuple) else None)
            if key not in warmed_geom[d]:
                warmed_geom[d].add(key)
                t0 = time.perf_counter()
                parts = packed if isinstance(packed, tuple) else (packed,)
                zeros = tuple(np.zeros(p.shape, p.dtype) for p in parts)
                payload = zeros if isinstance(packed, tuple) else zeros[0]
                for nq in sorted({qb.shape[0] for qb in q_buckets}):
                    engines[d].scores_packed(
                        q_buckets[0][:nq], transport, payload, codes.shape[1]
                    ).block_until_ready()
                stats.compile_time += time.perf_counter() - t0
            slices[d] = (transport, packed, codes.shape[1])

        # One worker per device — the reference's `omp parallel
        # num_threads(devices)` section (cal_all.c:564-606). Each worker
        # dispatches every query bucket and blocks on the fetch; results
        # land in a (device, q_bucket) grid for ordered writing afterwards.
        results: list[list] = [[None] * len(q_buckets) for _ in range(n_dev)]
        times = [1e-3] * n_dev
        errs: list = [None] * n_dev

        def worker(d: int):
            try:
                t0 = time.perf_counter()
                if slices[d] is not None:
                    transport, packed, s_len = slices[d]
                    devs = [
                        engines[d].scores_packed(qb, transport, packed, s_len)
                        for qb in q_buckets
                    ]
                    for i, dv in enumerate(devs):
                        results[d][i] = np.asarray(dv)[:, : counts[d]]
                if slow_hooks[d]:
                    time.sleep(slow_hooks[d])  # test hook
                times[d] = max(time.perf_counter() - t0, 1e-3)
            except BaseException as e:  # propagate to the main thread
                errs[d] = e

        threads = [threading.Thread(target=worker, args=(d,)) for d in range(n_dev)]
        t_cal = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        stats.cal_time += time.perf_counter() - t_cal
        for e in errs:
            if e is not None:
                raise e
        device_times = [a + b for a, b in zip(device_times, times)]

        writer.start_bucket(counts, bucket.extra_count)
        t0 = time.perf_counter()
        for i in range(len(q_buckets)):
            for d in range(n_dev):
                if results[d][i] is not None:
                    writer.write_scores(results[d][i])
        stats.write_time += time.perf_counter() - t0
        stats.subject_count += bucket.count - bucket.extra_count
        # The reference's use_times row collapses to max over devices (the
        # bucket is done when the slowest device is).
        stats.bucket_cal_times.append(max(times))

        if dynamic:
            cur_ratios = balancer.update(times)

    writer.close()
    stats.total_time = time.perf_counter() - t_start
    return stats, device_times


def hetero_engines(scoring, mode, config, spec: str, threshold: int | None = None):
    """Build one pinned engine per device from a spec like ``"gpu+cpu"``.

    The first platform is device 0 (ratio pinned to 1, the reference's CPU
    slot). Requires both platforms registered (JAX registers the CPU beside
    the GPU unless ``JAX_PLATFORMS`` says otherwise). Each engine takes its
    device's route (pipeline.kernel_route).
    A platform may repeat (``"cpu+cpu"``) to use multiple devices of one kind.
    With ``threshold`` set, builds banded engines instead.
    """
    import dataclasses

    import jax

    from ..banded_pipeline import BandedEngine
    from ..pipeline import Engine
    from ..schemes import normalize

    scheme = None if threshold is not None else normalize(scoring, mode)
    used: dict[str, int] = {}
    engines = []
    for part in spec.split("+"):
        name = part.strip().lower()
        try:
            devs = jax.devices(name)
        except RuntimeError as e:
            raise ValueError(
                f"device spec {spec!r}: platform {name!r} is not registered "
                f"(set JAX_PLATFORMS to include it): {e}"
            ) from None
        idx = used.get(name, 0)
        if idx >= len(devs):
            raise ValueError(f"device spec {spec!r}: only {len(devs)} {name} device(s)")
        used[name] = idx + 1
        cfg = dataclasses.replace(config, backend="auto", local_shards=1)
        if threshold is not None:
            engines.append(BandedEngine(threshold, cfg, device=devs[idx]))
        else:
            engines.append(Engine(scheme, cfg, device=devs[idx]))
    return engines
