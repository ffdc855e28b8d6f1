import numpy as np
import pytest

from bgsa_tpu import pack
from bgsa_tpu.oracle import align_scores
from bgsa_tpu.ops import myers_semiglobal as sg
from bgsa_tpu.schemes import Mode, Scoring


def oracle(queries, subjects, mode):
    return np.stack([align_scores(q, subjects, Scoring(0, -1, -1), mode) for q in queries])


@pytest.mark.parametrize("n", [10, 32, 33, 64, 90])
def test_xla_semiglobal(rng, n):
    q = rng.integers(0, 4, size=(3, 50)).astype(np.int32)
    s = rng.integers(0, 4, size=(8, n))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(sg.myers_semiglobal_xla(eq, q, read_len=n))
    np.testing.assert_array_equal(got, oracle(q, s, Mode.SEMI_GLOBAL), err_msg=f"n={n}")


def test_xla_global_mode(rng):
    # the same block formulation with h boundary=1 must equal global scores
    q = rng.integers(0, 4, size=(2, 40)).astype(np.int32)
    s = rng.integers(0, 4, size=(8, 70))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(sg.myers_semiglobal_xla(eq, q, read_len=70, is_global=True))
    np.testing.assert_array_equal(got, oracle(q, s, Mode.GLOBAL))


def test_substring_is_free(rng):
    # subject embedded in query -> score 0
    q = rng.integers(0, 4, size=(1, 60)).astype(np.int32)
    s = np.tile(q[0, 17:49], (8, 1))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(sg.myers_semiglobal_xla(eq, q, read_len=32))
    np.testing.assert_array_equal(got, 0)


@pytest.mark.parametrize("n", [20, 40, 70])
def test_pallas_semiglobal(rng, n):
    q = rng.integers(0, 4, size=(2, 45)).astype(np.int32)
    s = rng.integers(0, 4, size=(256, n))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(sg.myers_semiglobal(eq, q, read_len=n, interpret=True))
    np.testing.assert_array_equal(got, oracle(q, s, Mode.SEMI_GLOBAL))


def test_fullword_global_pallas_matches_oracle(rng):
    # The pipeline's GPU global path: full-word kernel with is_global=True,
    # multi-word (subject longer than one 32-bit word).
    import jax.numpy as jnp

    from bgsa_tpu import oracle, pack
    from bgsa_tpu.ops import myers_semiglobal as sg

    q = rng.integers(0, 4, size=(3, 45)).astype(np.int32)
    s = rng.integers(0, 4, size=(256, 70))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(
        sg.myers_semiglobal(eq, q, read_len=70, is_global=True, interpret=True)
    )
    want = np.stack([-oracle.edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)
