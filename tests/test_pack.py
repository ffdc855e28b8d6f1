import numpy as np
import pytest

from bgsa_tpu import pack


def test_encode_ascii():
    got = pack.encode_ascii(np.frombuffer(b"ACGTNX\n", dtype=np.uint8))
    np.testing.assert_array_equal(got, [0, 1, 2, 3, 4, 0, 0])


def test_pack_roundtrip(rng):
    for word_bits in (31, 32):
        for L in (5, 31, 32, 33, 95, 100):
            codes = rng.integers(0, 5, size=(6, L))
            eq = pack.pack_eq(codes, word_bits)
            assert eq.shape == (5, pack.word_count(L, word_bits), 6)
            back = pack.unpack_eq(eq, L, word_bits)
            np.testing.assert_array_equal(back, codes)


def test_pack_matches_reference_layout():
    # One subject "ACGT" in a 31-bit word: bit b set in plane of char at b.
    eq = pack.pack_eq(np.array([[0, 1, 2, 3]]), 31)
    assert eq[0, 0, 0] == 0b0001
    assert eq[1, 0, 0] == 0b0010
    assert eq[2, 0, 0] == 0b0100
    assert eq[3, 0, 0] == 0b1000
    assert eq[4, 0, 0] == 0


def test_pack_jax_matches_numpy(rng):
    import jax

    codes = rng.integers(0, 5, size=(4, 70)).astype(np.int32)
    for word_bits in (31, 32):
        want = pack.pack_eq(codes, word_bits)
        got = np.asarray(jax.jit(pack.pack_eq_jax, static_argnames="word_bits")(codes, word_bits))
        np.testing.assert_array_equal(got, want)


def test_nibble_roundtrip(rng):
    from bgsa_tpu import pack

    for n in (7, 8, 150):
        codes = rng.integers(0, 5, size=(9, n)).astype(np.uint8)
        nib = pack.nibble_pack(codes)
        assert nib.shape == (9, (n + 1) // 2)
        back = np.asarray(pack.nibble_unpack_jax(nib, n))
        np.testing.assert_array_equal(back, codes)


@pytest.mark.parametrize("S,L,k,m", [
    (9, 70, 6, 64), (4, 40, 3, 50), (3, 33, 8, 33),
    # the engine's packer at the filter geometry and the band's corners
    (16, 150, 8, 150), (16, 158, 8, 150), (16, 64, 8, 70), (16, 20, 40, 55),
    (16, 101, 31, 100),
])
def test_pack_banded_jax_matches_numpy(rng, S, L, k, m):
    import jax

    from bgsa_tpu import pack

    # jitted as the pipeline calls it (eager op-by-op dispatch takes ~4x the
    # wall time for identical coverage)
    pb = jax.jit(pack.pack_banded_jax, static_argnums=(1, 2))
    codes = rng.integers(0, 5, size=(S, L))
    lo, hi, inj = pack.pack_banded(codes, k, m)
    jlo, jhi, jinj = (np.asarray(x) for x in pb(codes, k, m))
    np.testing.assert_array_equal(jlo, lo)
    np.testing.assert_array_equal(jhi, hi)
    np.testing.assert_array_equal(jinj, inj)


def test_two_bit_roundtrip(rng):
    from bgsa_tpu import pack

    for n in (7, 8, 150):
        codes = rng.integers(0, 4, size=(9, n)).astype(np.uint8)
        packed = pack.two_bit_pack(codes)
        assert packed.shape == (9, (n + 3) // 4)
        back = np.asarray(pack.two_bit_unpack_jax(packed, n))
        np.testing.assert_array_equal(back, codes)


def test_sidecar_transport_roundtrip(rng):
    """Rare-N batches ride 2-bit + N-position sidecar; dense-N fall back."""
    import jax

    from bgsa_tpu import pack

    codes = rng.integers(0, 4, size=(300, 150)).astype(np.uint8)
    nr = rng.integers(0, 300, size=40)
    nc = rng.integers(0, 150, size=40)
    codes[nr, nc] = 4
    name, payload = pack.select_transport(codes)
    assert name == "2bitN"
    unpack = jax.jit(pack.transport_unpack_jax(name), static_argnums=1)
    got = np.asarray(unpack(payload, 150))
    np.testing.assert_array_equal(got, codes)

    # N-free -> plain 2bit; mostly-N -> nibble; sidecar disabled -> nibble
    clean = rng.integers(0, 4, size=(64, 40)).astype(np.uint8)
    assert pack.select_transport(clean)[0] == "2bit"
    dense = np.full((64, 40), 4, np.uint8)
    assert pack.select_transport(dense)[0] == "nib"
    assert pack.select_transport(codes, allow_sidecar=False)[0] == "nib"


def test_pipeline_rare_n_uses_sidecar(tmp_path, rng):
    """End-to-end: a database with occasional N scores identically through
    the sidecar transport (vs the same data forced onto nibbles)."""
    from bgsa_tpu import pipeline as pl_mod
    from bgsa_tpu.io import seqfile

    q = rng.integers(0, 4, size=(3, 30))
    s = rng.integers(0, 4, size=(2000, 40))
    s[rng.integers(0, 2000, 25), rng.integers(0, 40, 25)] = 4
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    pl_mod.run_alignment(qp, sp, a, config=pl_mod.PipelineConfig(backend="xla"))
    # local_shards rides the sidecar too (pre-split per shard); scores agree
    import jax

    shards = min(2, len(jax.devices()))
    pl_mod.run_alignment(
        qp, sp, b, config=pl_mod.PipelineConfig(backend="xla", local_shards=shards)
    )
    assert open(a, "rb").read() == open(b, "rb").read()
