"""Global unit-cost Myers on the kernel route: the full-word block kernel
(ops/myers_semiglobal.py, is_global=True) in interpret mode vs the oracle."""

import numpy as np
import pytest

from bgsa_tpu import pack
from bgsa_tpu.oracle import edit_distances
from bgsa_tpu.ops import myers_semiglobal


def run(queries, subjects):
    eq = pack.pack_eq(subjects, 32)
    return np.asarray(
        myers_semiglobal.myers_semiglobal(
            eq, queries.astype(np.int32), read_len=subjects.shape[1],
            is_global=True, interpret=True,
        )
    )


@pytest.mark.parametrize("n", [20, 31, 64, 100])
def test_matches_oracle(rng, n):
    q = rng.integers(0, 4, size=(2, 40)).astype(np.int32)
    s = rng.integers(0, 4, size=(256, n))
    got = run(q, s)
    want = np.stack([-edit_distances(qi, s) for qi in q])
    np.testing.assert_array_equal(got, want)


def test_multiple_blocks(rng):
    q = rng.integers(0, 4, size=(1, 30)).astype(np.int32)
    s = rng.integers(0, 4, size=(3 * 128 + 5, 45))  # 4 blocks, last padded
    got = run(q, s)
    want = -edit_distances(q[0], s)[None]
    np.testing.assert_array_equal(got, want)
