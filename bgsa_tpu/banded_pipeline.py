"""Banded-Myers pipeline: the read-verification filter workload.

Same bucketed driver as pipeline.run_alignment (pipeline.run_bucketed) with
the banded engine and int8 result records (MAX_ERROR=127 sentinel), matching
the reference banded ports' ``common_write_t int8_t``
(``banded/BGSA_CPU/config.h``).
"""

from __future__ import annotations

import functools

import numpy as np

from . import pack
from .pipeline import PipelineConfig, enable_compilation_cache, run_bucketed


class BandedEngine:
    """Compiled banded-verification step (threshold k).

    Same surface as pipeline.Engine: ``scores(query_codes, subject_codes)``.
    Subjects travel 2-bit/nibble-packed; the banded packing (the 64-bit Peq
    window + injection stream) runs on the device inside the jitted step
    (the reference burns host cores in its banded handle_reads). Local
    multi-device rides the same shard_map path as Engine (subjects sharded,
    packing shard-local) — the reference's banded KNC port drives all
    devices from one process too (``banded/BGSA_KNC/cal_all.c:134-771``).
    """

    def __init__(self, threshold: int, config: PipelineConfig, device=None):
        import jax

        self._jax = jax
        enable_compilation_cache(jax)
        self.k = threshold
        self.config = config
        self.device = device  # pin to one jax.Device (heterogeneous driver)
        from .pipeline import _local_mesh

        self.n_shards, self.mesh = _local_mesh(jax, config)
        self._step = functools.lru_cache(maxsize=None)(self._build_step)
        self._exec: dict = {}  # AOT-compiled executables per batch geometry

    def _build_step(self, q_len: int, s_len: int, transport: str = "nib"):
        jax, k = self._jax, self.k
        import jax.numpy as jnp

        from .ops import banded as banded_ops

        unpack = pack.transport_unpack_jax(transport)

        def step_local(qcodes, packed):
            # Every geometry runs banded_xla on every platform: a Triton
            # kernel was 27x faster alone but tied end to end, where the
            # host bounds the run (docs/PERF.md).
            scodes = unpack(packed, s_len)
            args = pack.pack_banded_jax(scodes, k, q_len)
            s = banded_ops.banded_xla(*args, qcodes, q_len=q_len, s_len=s_len,
                                      k=k)
            return s.astype(jnp.int8)

        if self.mesh is not None:
            from .pipeline import _shard_map_step

            step_local = _shard_map_step(step_local, self.mesh, transport)

        return jax.jit(step_local)

    def compile_for(self, nq: int, q_len: int, rows: int, s_len: int,
                    transport: str, sidecar: int = 0) -> None:
        """AOT-compile one batch geometry without executing (warm-up path)."""
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
        """Score against a transport-packed subject batch (pipeline hot path)."""
        if self.device is not None:
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
        """(Q, m) x (S, n) codes -> device array of (Q, S) int8 error counts."""
        from .pipeline import _pack_threads

        transport, payload = pack.select_transport(
            subject_codes, n_shards=self.n_shards,
            threads=_pack_threads(self.config),
        )
        return self.scores_packed(
            query_codes, transport, payload, subject_codes.shape[1]
        )


def run_banded(
    query_path: str,
    db_path: str,
    result_path: str,
    threshold: int,
    config: PipelineConfig = PipelineConfig(),
    shard: tuple[int, int] | None = None,
    shard_ratios=None,
    resume: bool = False,
    dynamic: bool = False,
    sync_dir: str | None = None,
):
    """Banded filter run; same multi-host/resume/-D surface as run_alignment.

    With ``shard=(host_id, n_hosts)`` writes this host's raw shard file and
    returns (stats, ShardMeta) for parallel.multihost.merge_shards.
    """
    engine = BandedEngine(threshold, config)
    return run_bucketed(
        engine, query_path, db_path, result_path, config,
        shard=shard, shard_ratios=shard_ratios, resume=resume,
        write_dtype=np.int8, dynamic=dynamic, sync_dir=sync_dir,
    )
