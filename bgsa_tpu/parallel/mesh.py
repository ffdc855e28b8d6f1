"""Device-mesh sharding of the batch scorer.

Replacement for the reference's device-level parallelism
(``/root/reference/original/BGSA_KNC/cal_all.c:136-769``): there, one host
splits each subject bucket across CPU+N Xeon Phis by a compute ratio and
re-broadcasts the queries to every device per offload. Here the same
decomposition is a `shard_map` over a `jax.sharding.Mesh`: subjects sharded
(optionally queries too), queries replicated along the subject axis, no
collectives on the hot path — scores come back sharded and are gathered by
the host (or by `jax.lax.all_gather` when a merged device array is wanted).
Homogeneous chips make the reference's dynamic ratio balancing (R11)
unnecessary: even splits are optimal.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

SUBJECT_AXIS = "subjects"
QUERY_AXIS = "queries"


def make_mesh(devices=None, query_shards: int = 1) -> Mesh:
    """(n/query_shards, query_shards) mesh over the given or all devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n % query_shards:
        raise ValueError(f"{n} devices not divisible by query_shards={query_shards}")
    return Mesh(devices.reshape(n // query_shards, query_shards), (SUBJECT_AXIS, QUERY_AXIS))


def myers_global_sharded(
    eq,
    queries,
    mesh: Mesh,
    *,
    read_len: int,
    word_bits: int = 31,
    factor: int = -1,
    merge: bool = False,
):
    """Myers scores with subjects (and optionally queries) sharded over ``mesh``.

    Args:
      eq: (5, W, S) uint32; S divisible by the subject-axis size.
      queries: (Q, m) int32; Q divisible by the query-axis size.
      merge: if True, all-gather so every device holds the full (Q, S) scores
        (the reference's host-side result gather, over the device links).

    Returns:
      (Q, S) int32 scores — sharded over the mesh unless ``merge``.
    """

    def local(eq_shard, q_shard):
        from ..ops import myers_xla

        s = myers_xla.myers_global(
            eq_shard, q_shard, read_len=read_len, word_bits=word_bits, factor=factor
        )
        if merge:
            s = jax.lax.all_gather(s, SUBJECT_AXIS, axis=1, tiled=True)
            s = jax.lax.all_gather(s, QUERY_AXIS, axis=0, tiled=True)
        return s

    in_specs = (P(None, None, SUBJECT_AXIS), P(QUERY_AXIS, None))
    out_specs = P(None, None) if merge else P(QUERY_AXIS, SUBJECT_AXIS)
    # check_vma=False: the kernel creates fresh loop-carry constants inside the
    # shard, which JAX 0.9's varying-manual-axes check would reject.
    fn = shard_map(local, mesh=mesh, in_specs=in_specs, out_specs=out_specs, check_vma=False)
    return jax.jit(fn)(eq, queries)


def shard_inputs(eq, queries, mesh: Mesh):
    """Place eq (subject-sharded) and queries (query-sharded) on the mesh."""
    eq_s = jax.device_put(eq, NamedSharding(mesh, P(None, None, SUBJECT_AXIS)))
    q_s = jax.device_put(queries, NamedSharding(mesh, P(QUERY_AXIS, None)))
    return eq_s, q_s
