import jax
import numpy as np
import pytest

from bgsa_tpu import pack
from bgsa_tpu.oracle import edit_distances
from bgsa_tpu.parallel import mesh as mesh_mod


@pytest.fixture(scope="module")
def mesh8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return mesh_mod.make_mesh(query_shards=2)  # (4, 2) mesh


def test_sharded_matches_oracle(rng, mesh8):
    Q, m, S, n = 4, 30, 512, 40
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n))
    eq = pack.pack_eq(s, 31)
    eq_s, q_s = mesh_mod.shard_inputs(eq, q, mesh8)
    got = np.asarray(
        mesh_mod.myers_global_sharded(eq_s, q_s, mesh8, read_len=n)
    )
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_sharded_merge(rng, mesh8):
    Q, m, S, n = 2, 20, 256, 30
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n))
    eq = pack.pack_eq(s, 31)
    eq_s, q_s = mesh_mod.shard_inputs(eq, q, mesh8)
    got = mesh_mod.myers_global_sharded(eq_s, q_s, mesh8, read_len=n, merge=True)
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(np.asarray(got), want)


def test_sharded_pallas_interpret(rng, mesh8):
    """The kernel route inside a manual shard (interpret mode): the
    full-word Myers kernel under shard_map, subjects split over the mesh —
    the shape of the engine's --shards path."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from bgsa_tpu.ops import myers_semiglobal

    Q, m, S, n = 2, 20, 1024, 30
    q = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    s = rng.integers(0, 4, size=(S, n))
    eq = pack.pack_eq(s, 32)
    mesh = mesh_mod.make_mesh()

    def local(e, qq):
        return myers_semiglobal.myers_semiglobal(
            e, qq, read_len=n, is_global=True, interpret=True)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(None, None, mesh_mod.SUBJECT_AXIS), P()),
                   out_specs=P(None, mesh_mod.SUBJECT_AXIS), check_vma=False)
    got = np.asarray(jax.jit(fn)(eq, q))
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_make_mesh_rejects_indivisible_query_shards():
    with pytest.raises(ValueError, match="not divisible"):
        mesh_mod.make_mesh(query_shards=3)  # 8 devices
