"""Batch alignment pipeline: read -> pack -> kernel -> result file.

Replacement for the reference's 3-stage pthread pipeline
(``/root/reference/original/BGSA_CPU/cal_cpu.c:121-476`` + ``thread.c``):

* the condvar/A-B double-buffer handshake becomes a bounded prefetch queue
  (reader thread) plus JAX's async dispatch — the device computes bucket k
  while the host reads and uploads bucket k+1;
* bit-packing happens on-device inside the jitted step (the reference burns
  host cores in ``*_handle_reads``; we ship raw symbol codes and let the
  device pack);
* the OpenMP (query x chunk) tiling is the kernel grid.

Output is written in the reference's exact blocked order via io.result.
"""

from __future__ import annotations

import dataclasses
import functools
import os
import queue
import threading
import time

import numpy as np

from . import pack
from .io import result as result_io
from .io import seqfile
from .schemes import Algorithm, Mode, NormalizedScheme, Scoring, normalize
from .stats import RunStats


# The persistent compile cache's directory when JAX_COMPILATION_CACHE_DIR is
# unset: one fixed path inside the checkout (listed in .gitignore), so a
# second run of the same geometry skips compilation.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def enable_compilation_cache(jax) -> None:
    """Persist compiled programs across processes. JAX itself reads
    JAX_COMPILATION_CACHE_DIR when it is set; otherwise the cache lives in
    CACHE_DIR."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", CACHE_DIR)


def kernel_route(backend: str = "auto", interpret: bool = False,
                 platform: str | None = None) -> str:
    """The one backend decision: "pallas" (the Triton-route kernels) on a
    GPU, "xla" (the scan twins) elsewhere. Interpret mode runs the kernels
    on any platform and is only used when a caller asks for it; an explicit
    "pallas" elsewhere is an error, not a silent fallback."""
    if platform is None:
        import jax

        platform = jax.default_backend()
    platform = "gpu" if platform in ("gpu", "cuda") else platform
    if backend == "auto":
        return "pallas" if platform == "gpu" or interpret else "xla"
    if backend == "pallas" and platform != "gpu" and not interpret:
        raise ValueError(
            f"--backend pallas needs a GPU (this run's platform is "
            f"{platform!r}); use --backend xla or auto"
        )
    return backend


def bitpal_packed_route(scheme: NormalizedScheme,
                        bitpal_packed: bool = True) -> bool:
    """Whether a BitPAl run rides the packed bit-plane kernel — the single
    predicate behind Engine.word_bits's layout auto-pick AND _build_step's
    kernel selection (one definition keeps the Eq packing width and the
    kernel actually traced in lockstep; they disagree = wrong scores).
    False means the run lands on the non-packed kernel (user opt-out, or a
    scheme the packed decode cannot serve: M > 2I - 2G + 1)."""
    if scheme.algorithm is not Algorithm.BITPAL or not bitpal_packed:
        return False
    from .ops import bitpal as _bitpal
    from .ops import bitpal_packed as _bp  # don't shadow the bool param

    return _bp.packed_supported(
        _bitpal.BitpalParams(scheme.match, scheme.mismatch, scheme.gap)
    )


def _pack_threads(config) -> int:
    """Resolved host packing thread count (-N; 0 = all cores)."""
    import os

    return config.host_threads or (os.cpu_count() or 1)


def _local_mesh(jax, config):
    """(n_shards, mesh) for the local multi-chip path (``--shards``).

    The reference's one-process-drives-N-devices layer (cal_all.c:134-771)
    becomes a 1-axis jax Mesh over the first n local devices; None mesh for
    the single-device case.
    """
    n = config.local_shards
    if n == 0:
        try:
            n = len(jax.local_devices())
        except RuntimeError:
            n = 1
    n = max(n, 1)
    if n == 1:
        return 1, None
    from jax.sharding import Mesh

    devices = jax.local_devices()
    if n > len(devices):
        # The reference errors when more MICs are requested than exist
        # (original/BGSA_KNC/main.c:145-153). Truncating the mesh while
        # keeping n_shards would mis-place the pre-split sidecar rows.
        raise ValueError(
            f"--shards {n} exceeds the {len(devices)} visible local "
            f"device(s); use --shards 0 for all local devices"
        )
    return n, Mesh(np.asarray(devices[:n]), ("subjects",))


def _shard_map_step(step_local, mesh, transport: str):
    """Wrap a (qcodes, payload) scoring step in shard_map over ``mesh``:
    subjects sharded, queries replicated, pack + kernel shard-local (no
    collectives on the hot path). The "2bitN" payload is a (packed, pos)
    tuple whose sidecar rows are pre-split per shard (pack.sidecar_pack),
    so both leaves shard on axis 0."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    rows = P("subjects", None)
    payload_spec = (rows, rows) if transport == "2bitN" else rows
    return shard_map(
        step_local,
        mesh=mesh,
        in_specs=(P(None, None), payload_spec),
        out_specs=P(None, "subjects"),
        check_vma=False,
    )


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    bucket_size: int = seqfile.DEFAULT_BUCKET_SIZE
    ref_bucket_count: int = seqfile.REF_BUCKET_COUNT
    v_num: int = 128  # subject pad unit (the reference's V_NUM lane count)
    backend: str = "auto"  # "pallas" | "xla" | "auto" (see kernel_route)
    interpret: bool = False  # Pallas interpreter mode (tests)
    prefetch: int = 2
    local_shards: int = 1  # 1 = single device; 0 = all local devices; n = first n
    # Host packing threads (the reference's -N OpenMP fan-out over
    # handle_reads); 0 = all cores. Only the native packers fan out.
    host_threads: int = 0
    # Dynamic (-D) split granularity: host slices are aligned to
    # seqs_per_bucket/dynamic_grid so at most dynamic_grid distinct shapes
    # ever compile (the reference re-splits at V_NUM granularity because its
    # C kernels take any count; XLA compiles per shape).
    dynamic_grid: int = 8
    # -D: how long to wait for a peer's per-bucket time file before failing
    # the run with a clear error (the reference would hang in its barrier
    # forever; a crashed peer should surface in minutes, not hours).
    sync_timeout: float = 120.0
    # Packed bit-plane BitPAl: identical scores, fewer planes per word
    # (falls back to non-packed where the packed decode doesn't apply).
    bitpal_packed: bool = True
    # Full 32-bit-word BitPAl with compare-carry inter-word adds — the
    # analogue of the reference KNC port's hardware add-with-carry
    # (original/BGSA_KNC/align_core.c:1153): 1/31 fewer words and denser
    # planes, at ~2 extra compare ops per cross-word add. Exists on both
    # representations; identical scores either way. None = auto (31-bit
    # for packed, 32-bit for unpacked); True/False force 32/31 bits.
    bitpal_carry: bool | None = None


class _ReaderFailed:
    """Queue sentinel: the reader thread died with this exception."""

    def __init__(self, error: BaseException):
        self.error = error


class Engine:
    """Compiled scoring step for one normalized scheme.

    ``device`` pins every computation to one jax.Device — the heterogeneous
    driver (parallel.hetero) runs one Engine per device, the analogue of the
    reference's per-device offload sections (cal_all.c:564-606).
    """

    def __init__(self, scheme: NormalizedScheme, config: PipelineConfig,
                 device=None):
        self.scheme = scheme
        self.config = config
        self.device = device
        import jax

        self._jax = jax
        enable_compilation_cache(jax)
        self.backend = kernel_route(
            config.backend, config.interpret,
            None if device is None else device.platform,
        )
        self.n_shards, self.mesh = _local_mesh(jax, config)
        self._step = functools.lru_cache(maxsize=None)(self._build_step)
        self._exec: dict = {}  # AOT-compiled executables per batch geometry

    @property
    def word_bits(self) -> int:
        # The reserved-carry layout (31 usable bits) exists for the multiword
        # add chain; the full-word block formulation threads an explicit
        # horizontal delta instead (the reference's full_bits path,
        # GeneratorUtils.java:66-70). The kernel route uses it for every
        # Myers mode; the XLA route keeps the reference's 31-bit global
        # kernel (docs/PERF.md). BitPAl's full-word option is the
        # compare-carry variant (config.bitpal_carry, the KNC hw-adc
        # analogue) on either representation; bitpal_carry=None takes
        # 31-bit words on the packed route and 32-bit words on the unpacked
        # one, whose plane networks are word-count-dominated.
        if self.scheme.algorithm is Algorithm.MYERS and (
            self.scheme.mode is Mode.SEMI_GLOBAL or self.backend == "pallas"
        ):
            return 32
        if self.scheme.algorithm is Algorithm.BITPAL:
            carry = self.config.bitpal_carry
            if carry is None:
                carry = not bitpal_packed_route(
                    self.scheme, self.config.bitpal_packed
                )
            if carry:
                return 32
        return 31

    def _build_step(self, q_len: int, s_len: int, transport: str = "nib"):
        jax, config, scheme = self._jax, self.config, self.scheme
        import jax.numpy as jnp

        word_bits = self.word_bits

        def kernel(eq, qcodes):
            if scheme.algorithm is Algorithm.BITPAL:
                from .ops import bitpal, bitpal_packed

                kw = dict(
                    match=scheme.match, mismatch=scheme.mismatch, gap=scheme.gap,
                    read_len=s_len, factor=scheme.factor,
                    semi_global=scheme.mode is Mode.SEMI_GLOBAL,
                )
                kw["word_bits"] = word_bits
                if bitpal_packed_route(scheme, config.bitpal_packed):
                    if self.backend == "pallas":
                        return bitpal_packed.bitpal_packed(
                            eq, qcodes, interpret=config.interpret, **kw
                        )
                    return bitpal_packed.bitpal_packed_xla(eq, qcodes, **kw)
                # the unpacked representation has no kernel: its planes
                # outgrow a thread's registers (docs/PERF.md)
                return bitpal.bitpal_xla(eq, qcodes, **kw)
            is_semi = scheme.mode is Mode.SEMI_GLOBAL
            if self.backend == "pallas":
                # Full-word block kernel for both modes (word_bits == 32).
                from .ops import myers_semiglobal

                return myers_semiglobal.myers_semiglobal(
                    eq, qcodes, read_len=s_len, factor=scheme.factor,
                    is_global=not is_semi, interpret=config.interpret,
                )
            if is_semi:
                from .ops import myers_semiglobal

                return myers_semiglobal.myers_semiglobal_xla(
                    eq, qcodes, read_len=s_len, factor=scheme.factor
                )
            from .ops import myers_xla

            return myers_xla.myers_global(
                eq, qcodes, read_len=s_len, word_bits=word_bits, factor=scheme.factor
            )

        unpack = pack.transport_unpack_jax(transport)

        def step_local(qcodes, packed):
            scodes = unpack(packed, s_len)
            eq = pack.pack_eq_jax(scodes, word_bits)
            return kernel(eq, qcodes).astype(jnp.int16)

        if self.mesh is not None:
            # Local multi-device: subjects sharded over the device mesh, queries
            # replicated — the reference's per-device bucket split (R10), with
            # pack + kernel running shard-local (no collectives on the hot path).
            step_local = _shard_map_step(step_local, self.mesh, transport)

        return jax.jit(step_local)

    def compile_for(self, nq: int, q_len: int, rows: int, s_len: int,
                    transport: str, sidecar: int = 0) -> None:
        """AOT-compile the step for one batch geometry without executing it —
        the pipeline's warm-up path (a dummy bucket execution would double
        small runs' cost for nothing)."""
        import jax.numpy as jnp

        key = (nq, q_len, rows, s_len, transport, sidecar)
        if key in self._exec:
            return
        step = self._step(q_len, s_len, transport)
        qs = self._jax.ShapeDtypeStruct((nq, q_len), jnp.int32)
        specs = [
            self._jax.ShapeDtypeStruct(sh, dt)
            for sh, dt in pack.transport_specs(transport, rows, s_len, sidecar)
        ]
        payload = specs[0] if len(specs) == 1 else tuple(specs)
        self._exec[key] = step.lower(qs, payload).compile()

    def scores_packed(self, query_codes: np.ndarray, transport: str, payload, s_len: int):
        """Score against a transport-packed subject batch (see pack.select_transport).

        The pipeline packs each bucket once and reuses it across every query
        bucket (the reference packs once per bucket too, in its input thread).
        """
        if self.device is not None:
            # Pinned engines (heterogeneous driver) use the jit path: AOT
            # lowering does not capture jax.default_device.
            step = self._step(query_codes.shape[1], s_len, transport)
            with self._jax.default_device(self.device):
                return step(np.asarray(query_codes, np.int32), payload)
        main = payload[0] if isinstance(payload, tuple) else payload
        sidecar = payload[1].shape[0] if isinstance(payload, tuple) else 0
        key = (query_codes.shape[0], query_codes.shape[1], main.shape[0],
               s_len, transport, sidecar)
        if key not in self._exec:
            self.compile_for(*key)
        return self._exec[key](np.asarray(query_codes, np.int32), payload)

    def scores(self, query_codes: np.ndarray, subject_codes: np.ndarray):
        """(Q, m) x (S, n) codes -> device array of (Q, S) int16 scores.

        Subjects travel packed — 4 codes/byte for N-free batches, 2+sidecar
        for rare-N batches, 2 codes/byte otherwise — and are unpacked +
        Eq-packed on device inside the jitted step (the upload is the
        production bottleneck).
        """
        transport, payload = pack.select_transport(
            subject_codes, n_shards=self.n_shards,
            threads=_pack_threads(self.config),
        )
        return self.scores_packed(
            query_codes, transport, payload, subject_codes.shape[1]
        )


def run_alignment(
    query_path: str,
    db_path: str,
    result_path: str,
    scoring: Scoring = Scoring(0, -1, -1),
    mode: Mode = Mode.GLOBAL,
    config: PipelineConfig = PipelineConfig(),
    shard: tuple[int, int] | None = None,
    shard_ratios=None,
    resume: bool = False,
    dynamic: bool = False,
    sync_dir: str | None = None,
):
    """Full aligner run, reference CLI semantics; returns run statistics.

    With ``shard=(host_id, n_hosts)`` this process plays one host role of a
    multi-host run: it scores its lane-aligned slice of every bucket and
    writes a raw shard file plus a ShardMeta (merge with
    parallel.multihost.merge_shards). Returns (stats, meta) in that case.

    ``dynamic=True`` (the reference's ``-D``) re-splits every bucket from the
    hosts' measured per-bucket times, exchanged through ``sync_dir`` (default:
    the result file's directory) — requires ``shard``.

    ``resume=True`` continues an interrupted run: completed buckets (found in
    the existing result/.info pair, partial tails truncated) are skipped.
    """
    scheme = normalize(scoring, mode)
    engine = Engine(scheme, config)
    return run_bucketed(
        engine, query_path, db_path, result_path, config,
        shard=shard, shard_ratios=shard_ratios, resume=resume,
        write_dtype=np.int16, dynamic=dynamic, sync_dir=sync_dir,
    )


def run_bucketed(
    engine,
    query_path: str,
    db_path: str,
    result_path: str,
    config: PipelineConfig,
    *,
    shard: tuple[int, int] | None,
    shard_ratios,
    resume: bool,
    write_dtype,
    dynamic: bool = False,
    sync_dir: str | None = None,
):
    """Shared bucketed driver for every kernel family (Myers/BitPAl/banded).

    ``engine`` needs ``n_shards`` and ``scores(query_codes, subject_codes) ->
    (Q, S) device array``. Handles bucketing, uniform-shape padding (single
    compile per run), warm-up compile accounting, the reader prefetch thread,
    lag-1 result draining, reference result/.info writing, host-role shard
    files, dynamic re-splitting (-D), and resume for both modes.
    """
    if dynamic and shard is None:
        raise ValueError("dynamic balancing requires shard=(host_id, n_hosts)")
    stats = RunStats()
    t_start = time.perf_counter()
    # Test hook: per-host artificial slowdown for dynamic-balancing tests.
    _test_sleep = float(os.environ.get("BGSA_TEST_BUCKET_SLEEP", "0") or 0)

    v_num = config.v_num * engine.n_shards
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

    # Pad every bucket's *computation* to the full-bucket shape so the jitted
    # step compiles once per run — a tail bucket with a different subject
    # count would otherwise trigger a second compile inside the timed loop.
    # Result bytes are unchanged: pad scores are sliced off before writing.
    pad_to = db.seqs_per_bucket if db.bucket_count > 1 else 0

    meta = None
    meta_path = result_path + ".meta.json"
    done_buckets = 0
    if shard is not None:
        from .parallel.multihost import ShardMeta, host_slice, shard_resume_point

        host_id, n_hosts = shard
        from .parallel.multihost import normalized_ratios

        # Static -R splits are resume-critical (a different ratio vector
        # re-slices every remaining bucket); dynamic mode's schedule is
        # protected by the run token instead, so its sidecar records None.
        static_ratios = None if dynamic else normalized_ratios(shard_ratios, n_hosts)
        if resume:
            done_buckets, meta = shard_resume_point(
                result_path, meta_path, len(queries),
                np.dtype(write_dtype), n_hosts, host_id,
                seqs_per_bucket=db.seqs_per_bucket,
                db_subjects=db.total_count,
                ratios=None if dynamic else shard_ratios,
            )
            if meta is not None:
                stats.subject_count += sum(
                    c - e for c, e in zip(meta.block_counts, meta.extra_counts)
                )
        if meta is None:
            meta = ShardMeta(
                host_id, n_hosts, len(queries), [], [],
                dtype=np.dtype(write_dtype).name,
                seqs_per_bucket=db.seqs_per_bucket,
                db_subjects=db.total_count,
                ratios=static_ratios,
            )
        writer_fp = open(result_path, "ab" if done_buckets else "wb")
        if dynamic:
            # Live re-splitting (the reference's -D, cal_on_all_dynamic,
            # original/BGSA_KNC/cal_all.c:772-1487): each bucket's split comes
            # from the measured per-host times of the previous bucket,
            # exchanged as files in sync_dir; every host replays the same
            # published times, so the ratio schedule is bit-identical on all
            # of them. Slices are aligned to `chunk` so at most dynamic_grid
            # distinct shapes ever compile.
            from .parallel import multihost as mh

            sync_dir = sync_dir or (os.path.dirname(result_path) or ".")
            # an explicit --sync-dir need not pre-exist (every host creates
            # it; makedirs is atomic-enough for concurrent roles)
            os.makedirs(sync_dir, exist_ok=True)
            # Time files carry a run-identity token so a reused sync_dir's
            # stale files from a previous (different) run can never be read
            # as this run's times (which would silently fork the schedule
            # across hosts).
            sync_token = mh.run_token(
                query_path, db_path, n_hosts, shard_ratios, config.bucket_size
            )
            chunk = v_num
            if db.bucket_count > 1:
                chunk = v_num * max(
                    1, -(-db.seqs_per_bucket // (v_num * config.dynamic_grid))
                )
            balancer = mh.DynamicBalancer(n_hosts, initial_ratios=shard_ratios)
            # Announce this role before any compile work: peers extend their
            # dead-peer timeout 10x for hosts that are alive but still
            # compiling (read_bucket_times).
            mh.write_hello(sync_dir, host_id, sync_token)
            if done_buckets:
                for b in range(done_buckets):
                    if not os.path.exists(
                        mh.bucket_time_path(sync_dir, b, host_id, sync_token)
                    ):
                        # Crashed after writing bucket b's scores but before
                        # publishing its time; peers are still blocked on this
                        # file, so a neutral re-publish keeps everyone moving
                        # on one consistent schedule.
                        mh.write_bucket_time(sync_dir, b, host_id, 1.0,
                                             token=sync_token)
                    balancer.update(mh.read_bucket_times(
                        sync_dir, b, n_hosts, timeout=config.sync_timeout,
                        token=sync_token,
                    ))
            elif not resume:
                # A resumed role whose shard lost all buckets must still not
                # delete time files its peers may have consumed already.
                mh.clear_bucket_times(sync_dir, host_id, token=sync_token)
            dyn_ratios = list(balancer.ratios)
            pad_to = 0  # per-bucket chunk-aligned padding instead
        elif pad_to:
            # Max over every bucket's slice, not the full bucket's slice:
            # host_slice rounds to v_num multiples and gives the last host
            # the remainder, so under skewed -R ratios a *tail* bucket's
            # slice can exceed that host's full-bucket slice — padding to
            # the full-bucket slice alone would compile a second geometry
            # mid-run (which pad_to exists to avoid).
            pad_to = max(
                host_slice(c, n_hosts, host_id, v_num, shard_ratios)[1]
                for c, _ in db.bucket_counts()
            )
    else:
        if resume:
            done_buckets = result_io.resume_point(
                result_path, len(queries), write_dtype=write_dtype,
                expected_buckets=db.bucket_counts(),
            )
        writer = result_io.ResultWriter(
            result_path, ref_count=len(queries), block_num=db.bucket_count,
            device_num=1, write_dtype=write_dtype, append=done_buckets > 0,
        )

    # Compile up front against the run's bucket shape so cal_time is
    # steady-state kernel time (the reference has no compile phase) — also
    # for single-bucket runs, whose shape is known from the file geometry.
    # N-free buckets ride the 2-bit path; the nibble step is pre-warmed only
    # when the file geometry says the final bucket carries the reference's
    # 'N' lane pads (file.c's extra_count) — data-driven N buckets (dense N
    # -> nib, rare N -> 2bitN sidecar shapes) compile lazily in the loop,
    # outside cal_time, like every geometry the pre-warm can't know. This
    # halves the AOT warm-up cost for lane-aligned datasets.
    warmed: set[int] = set()
    # The 'N' lane pads sit at the end of the final bucket, so under --host
    # only the role whose slice overlaps them ever selects nib for that
    # geometry — other roles would pay a wasted nib compile for a transport
    # they never use on N-free data.
    _tail_count, _tail_extra = db.bucket_counts()[-1]
    _has_pads = bool(_tail_extra)
    if _has_pads and shard is not None and not dynamic:
        _start, _cnt = host_slice(
            _tail_count, shard[1], shard[0], v_num, shard_ratios
        )
        _has_pads = _start + _cnt > _tail_count - _tail_extra
    warm_transports = ("2bit", "nib") if _has_pads else ("2bit",)

    def ensure_warm(rows: int) -> None:
        """Warm-compile the predictable transports at this batch shape
        (idempotent). AOT compile only — no dummy execution (engines expose
        compile_for; a custom engine without it falls back to a dummy-bucket
        run)."""
        if not rows or rows in warmed:
            return
        warmed.add(rows)
        t0 = time.perf_counter()
        nqs = sorted({qb.shape[0] for qb in q_buckets})
        if hasattr(engine, "compile_for"):
            for transport in warm_transports:
                for nq in nqs:
                    engine.compile_for(nq, queries.shape[1], rows, db.length, transport)
        else:
            fills = (0, 4) if len(warm_transports) == 2 else (0,)
            for fill in fills:
                dummy = np.full((rows, db.length), fill, np.uint8)
                for nq in nqs:
                    engine.scores(queries[:nq], dummy).block_until_ready()
        stats.compile_time += time.perf_counter() - t0

    if not dynamic and done_buckets < db.bucket_count:
        warm_rows = pad_to
        if not warm_rows:
            warm_rows = db.bucket_counts()[0][0]
            if shard is not None:
                warm_rows = host_slice(warm_rows, n_hosts, host_id, v_num, shard_ratios)[1]
        ensure_warm(warm_rows)

    # Reader thread keeps the device fed (the reference's input_task thread).
    buckets: queue.Queue = queue.Queue(maxsize=config.prefetch)
    stop_reader = threading.Event()

    def read_all():
        # A mid-run read failure (disk error, database truncated while we
        # run) must surface in the main loop, not silently kill this thread
        # — without the sentinel the main loop would block on buckets.get()
        # forever. The reference's input thread exits the whole process on
        # read errors (file.c:13-16); we raise instead.
        try:
            payload = None
            for bucket in db:
                payload = bucket
                while not stop_reader.is_set():
                    try:
                        buckets.put(bucket, timeout=0.2)
                        payload = None
                        break
                    except queue.Full:
                        continue
                if stop_reader.is_set():
                    return  # main loop failed; don't block on a full queue
        except BaseException as e:  # noqa: BLE001 — forwarded, re-raised below
            # BaseException (not Exception) on purpose: a KeyboardInterrupt/
            # SystemExit landing here would otherwise kill the thread with
            # no sentinel and deadlock the main loop on buckets.get().  The
            # main loop re-raises interrupt-class exceptions as themselves
            # (not wrapped in OSError) to keep signal semantics.
            payload = _ReaderFailed(e)
        while not stop_reader.is_set():
            try:
                buckets.put(payload, timeout=0.2)
                return
            except queue.Full:
                continue

    reader = threading.Thread(target=read_all, daemon=True)
    reader.start()

    # Result events drain with a lag of one scoring step, so the device
    # computes step k+1 while step k's scores download and hit disk (the
    # reference's output thread, without the thread).
    import collections

    events: collections.deque = collections.deque()
    n_pending = 0

    def drain(keep: int):
        nonlocal n_pending
        while n_pending > keep:
            ev = events.popleft()
            if ev[0] == "bucket":
                writer.start_bucket(*ev[1:])
                continue
            _, dev, real, bidx = ev
            # Reference accounting split (cal_sse.c:485 vs its output
            # thread): compute belongs to cal, the result download to
            # write.
            t = time.perf_counter()
            dev.block_until_ready()
            dt = time.perf_counter() - t
            stats.cal_time += dt
            while len(stats.bucket_cal_times) <= bidx:
                stats.bucket_cal_times.append(0.0)
            stats.bucket_cal_times[bidx] += dt
            t = time.perf_counter()
            host_scores = np.asarray(dev)[:, :real]
            if shard is not None:
                writer_fp.write(host_scores.tobytes())
            else:
                writer.write_scores(host_scores)
            stats.write_time += time.perf_counter() - t
            n_pending -= 1

    try:
        bucket_index = -1
        while True:
            bucket = buckets.get()
            if bucket is None:
                break
            if isinstance(bucket, _ReaderFailed):
                if not isinstance(bucket.error, Exception):
                    # KeyboardInterrupt / SystemExit keep their own type —
                    # wrapping them in OSError broke Ctrl-C semantics.
                    raise bucket.error
                raise OSError(
                    f"reading {db_path} failed mid-run: {bucket.error}"
                ) from bucket.error
            bucket_index += 1
            if bucket_index < done_buckets:
                continue  # completed before the interruption
            codes = bucket.codes
            if shard is not None:
                if dynamic and bucket_index > done_buckets:
                    # The previous bucket's measured times steer this bucket's
                    # split (adjust_device_ratio3 between buckets, cal_all.c:1332).
                    times = mh.read_bucket_times(
                        sync_dir, bucket_index - 1, n_hosts,
                        timeout=config.sync_timeout, token=sync_token,
                    )
                    dyn_ratios = balancer.update(times)
                if dynamic:
                    stats.dynamic_ratios.append(list(dyn_ratios))
                    start, count = host_slice(bucket.count, n_hosts, host_id, chunk, dyn_ratios)
                else:
                    start, count = host_slice(bucket.count, n_hosts, host_id, v_num, shard_ratios)
                codes = codes[start : start + count]
                meta.block_counts.append(count)
                meta.extra_counts.append(bucket.extra_count if host_id == n_hosts - 1 else 0)
                stats.subject_count += count - meta.extra_counts[-1]
                # Persist incrementally so shard resume can trust the recorded
                # split (the file itself arbitrates how many buckets completed).
                meta.save(meta_path)
            else:
                events.append(("bucket", [bucket.count], bucket.extra_count))
                stats.subject_count += bucket.count - bucket.extra_count
            real = codes.shape[0]
            pad_this = pad_to
            if dynamic:
                # Chunk-aligned shape so re-splitting cycles through at most
                # dynamic_grid compiled shapes; warm new ones outside the timed
                # region (compile in the measurement would distort the balancer).
                pad_this = -(-real // chunk) * chunk
                ensure_warm(pad_this)
                t_bucket = time.perf_counter()
            if real == 0 and not dynamic:
                continue
            if real and real < pad_this:
                # Shape-pad rows are discarded before writing (unlike the
                # reference's extra_count 'N' pads inside bucket.codes), so use
                # code 0 and keep the bucket on the 2-bit transport when its
                # real rows are N-free.
                pad = np.zeros((pad_this - real, codes.shape[1]), codes.dtype)
                codes = np.concatenate([codes, pad])
            if real:
                # Host-side transport packing, once per bucket (reused across
                # query buckets) — the analogue of the reference's pack phase,
                # billed to mem_total_time like its *_handle_reads
                # (cal_sse.c:469-487). Under shard_map the sidecar is pre-split
                # into shard-local position lists (pack.sidecar_pack).
                # A custom engine exposing only the documented minimal surface
                # (n_shards + scores) skips the transport layer and packs its
                # own way — matching ensure_warm's dummy-bucket fallback.
                packed_path = hasattr(engine, "scores_packed")
                t0 = time.perf_counter()
                if packed_path:
                    transport, payload = pack.select_transport(
                        codes, n_shards=engine.n_shards, threads=_pack_threads(config)
                    )
                stats.pack_time += time.perf_counter() - t0
                if packed_path and hasattr(engine, "compile_for"):
                    # Geometries the pre-warm can't know (sidecar sizes, dynamic
                    # shapes): compile now so cal_time stays compile-free; a
                    # cache hit makes this free.
                    main = payload[0] if isinstance(payload, tuple) else payload
                    sidecar = payload[1].shape[0] if isinstance(payload, tuple) else 0
                    t0 = time.perf_counter()
                    for nq in sorted({qb.shape[0] for qb in q_buckets}):
                        engine.compile_for(nq, queries.shape[1], main.shape[0],
                                           codes.shape[1], transport, sidecar)
                    dt = time.perf_counter() - t0
                    stats.compile_time += dt
                    if dynamic:
                        t_bucket += dt  # keep compile out of the balancer's wall time
                for qb in q_buckets:
                    t_cal = time.perf_counter()
                    if packed_path:
                        dev_scores = engine.scores_packed(qb, transport, payload, codes.shape[1])
                    else:
                        dev_scores = engine.scores(qb, codes)
                    stats.cal_time += time.perf_counter() - t_cal  # async dispatch
                    events.append(("scores", dev_scores, real, bucket_index))
                    n_pending += 1
                    drain(1)
            if dynamic:
                # Per-bucket barrier: the measured wall time (pack + compute +
                # fetch + write) is this host's previous_device_times entry.
                # Floored so a host with an empty slice can't report ~0 time and
                # blow up the next ratio update.
                drain(0)
                if _test_sleep:
                    time.sleep(_test_sleep)  # test hook: artificially slow host
                # Flush the shard bytes to the OS before publishing the time: a
                # published time must imply the bucket's scores survive a crash,
                # or resume's file-size arbitration would replay the bucket and
                # re-publish a different time than the one peers consumed.
                writer_fp.flush()
                mh.write_bucket_time(
                    sync_dir, bucket_index, host_id,
                    max(time.perf_counter() - t_bucket, 1e-3),
                    token=sync_token,
                )
            elif _test_sleep:
                drain(0)
                time.sleep(_test_sleep)  # test hook (SIGKILL-mid-run tests)

        drain(0)
        while events:  # trailing bucket records (empty shard slices)
            ev = events.popleft()
            writer.start_bucket(*ev[1:])
    finally:
        # Release a reader blocked on a full queue: any exception
        # escaping the loop (engine failure, -D dead-peer timeout)
        # must not leak a thread holding the database file open.
        stop_reader.set()
    reader.join()
    if shard is not None:
        writer_fp.close()
        stats.total_time = time.perf_counter() - t_start
        return stats, meta
    writer.close()
    stats.total_time = time.perf_counter() - t_start
    return stats
