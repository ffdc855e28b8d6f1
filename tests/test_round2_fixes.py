"""Round-2 fixes: honest stats, input sniffing, long first lines, debug
printers, and interpret-mode coverage of every kernel at an odd query
length (q_len=25)."""

import numpy as np
import pytest

from bgsa_tpu import debug, pack
from bgsa_tpu import pipeline as pl_mod
from bgsa_tpu.io import seqfile
from bgsa_tpu.oracle import align_scores
from bgsa_tpu.schemes import Mode, Scoring


def _matrix(queries, subjects, scoring, mode=Mode.GLOBAL):
    return np.stack([align_scores(q, subjects, scoring, mode) for q in queries])


def test_single_bucket_run_excludes_compile_from_cal_time(tmp_path, rng):
    """Single-bucket runs (most demos) must warm up the compile like
    multi-bucket runs do, so cal GCUPS is steady-state kernel time."""
    q = rng.integers(0, 4, size=(3, 25))
    s = rng.integers(0, 4, size=(300, 30))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    stats = pl_mod.run_alignment(
        qp, sp, str(tmp_path / "r.bin"),
        config=pl_mod.PipelineConfig(backend="xla"),
    )
    assert stats.compile_time > 0
    assert stats.cal_time < stats.compile_time + stats.total_time
    assert stats.gcups(stats.cal_time) > 0


def test_pack_time_is_accounted(tmp_path, rng):
    """mem_total_time (the reference's pack phase) is measured, not a
    constant 0: the host-side transport pack is billed there."""
    q = rng.integers(0, 4, size=(2, 20))
    s = rng.integers(0, 4, size=(1000, 40))
    qp, sp = str(tmp_path / "q.txt"), str(tmp_path / "s.txt")
    seqfile.write_seq_file(qp, q)
    seqfile.write_seq_file(sp, s)
    stats = pl_mod.run_alignment(
        qp, sp, str(tmp_path / "r.bin"),
        config=pl_mod.PipelineConfig(backend="xla"),
    )
    assert stats.pack_time > 0
    assert f"{stats.pack_time:.2f}" in stats.report()


def test_fastq_lookalike_is_rejected(tmp_path, rng):
    """A file starting with '@' that fails the FASTQ structure sniff must
    error out, not be encoded as sequences (headers would become 'A' runs)."""
    from bgsa_tpu import cli

    bad = str(tmp_path / "bad.txt")
    open(bad, "w").write("@read1\nACGT\nACGT\nACGT\n")  # no '+' third line
    s = rng.integers(0, 4, size=(200, 20))
    sp = str(tmp_path / "s.txt")
    seqfile.write_seq_file(sp, s)
    with pytest.raises(SystemExit):
        cli.main(["align", "-q", bad, "-d", sp, "-f", str(tmp_path / "r.bin"),
                  "--quiet"])


def test_detect_line_length_beyond_1mb(tmp_path):
    n = (1 << 20) + 12345
    p = str(tmp_path / "long.txt")
    with open(p, "wb") as f:
        f.write(b"A" * n + b"\n" + b"C" * n + b"\n")
    assert seqfile.detect_line_length(p) == n


def test_debug_formatters():
    assert debug.format_binary(0b1011, bits=8) == "11010000"
    assert debug.format_binary(0b1011, bits=8, lsb_first=False) == "00001011"
    two = debug.format_words([1, 2], bits=4)
    assert two == "1000 | 0100"
    s = debug.format_lanes(np.arange(16, dtype=np.uint32), max_lanes=2)
    assert "(16 lanes)" in s


def test_debug_kprint_interpret(capfd):
    """kprint works inside an interpret-mode Pallas kernel body."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    def kernel(x_ref, o_ref):
        debug.kprint("probe {}", x_ref[0, 0])
        o_ref[...] = x_ref[...]

    x = jnp.arange(8 * 128, dtype=jnp.int32).reshape(8, 128)
    out = pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype), interpret=True
    )(x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(x))


# --- interpret mode at q_len=25: every kernel's column loop at an odd
# length (the unrolled-column variants these tests once covered are gone;
# the kernels loop one column at a time) ---


def _codes(rng, shape):
    return rng.integers(0, 4, size=shape).astype(np.int32)


def test_myers_global_unroll_interpret(rng):
    from bgsa_tpu.ops import myers_semiglobal

    q, s = _codes(rng, (2, 25)), _codes(rng, (128, 30))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(myers_semiglobal.myers_semiglobal(
        eq, q, read_len=30, interpret=True, is_global=True))
    want = _matrix(q, s, Scoring(0, -1, -1))
    np.testing.assert_array_equal(got, want)


def test_myers_semiglobal_unroll_interpret(rng):
    from bgsa_tpu.ops import myers_semiglobal

    q, s = _codes(rng, (2, 25)), _codes(rng, (128, 30))
    eq = pack.pack_eq(s, 32)
    for is_global in (True, False):
        got = np.asarray(myers_semiglobal.myers_semiglobal(
            eq, q, read_len=30, interpret=True, is_global=is_global))
        want = _matrix(q, s, Scoring(0, -1, -1),
                       Mode.GLOBAL if is_global else Mode.SEMI_GLOBAL)
        np.testing.assert_array_equal(got, want)


def test_bitpal_unroll_interpret(rng):
    from bgsa_tpu.ops import bitpal

    q, s = _codes(rng, (2, 25)), _codes(rng, (128, 30))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(bitpal.bitpal_xla(  # the unpacked route: XLA only
        eq, q, match=2, mismatch=-3, gap=-5, read_len=30, word_bits=32))
    want = _matrix(q, s, Scoring(2, -3, -5))
    np.testing.assert_array_equal(got, want)


def test_bitpal_packed_unroll_interpret(rng):
    from bgsa_tpu.ops import bitpal_packed

    q, s = _codes(rng, (2, 25)), _codes(rng, (128, 30))
    eq = pack.pack_eq(s, 32)
    got = np.asarray(bitpal_packed.bitpal_packed(
        eq, q, match=2, mismatch=-3, gap=-5, read_len=30,
        interpret=True, word_bits=32))
    want = _matrix(q, s, Scoring(2, -3, -5))
    np.testing.assert_array_equal(got, want)


def test_banded_stream_unroll_interpret(rng):
    # the banded route is banded_xla on every platform (no kernel)
    from bgsa_tpu import banded_ref
    from bgsa_tpu.ops import banded

    k, m, n = 6, 40, 44
    q, s = _codes(rng, (2, m)), _codes(rng, (128, n))
    s[:50, :m] = q[0]
    lo, hi, inj = pack.pack_banded_jax(s, k, m)
    got = np.asarray(banded.banded_xla(lo, hi, inj, q, q_len=m, s_len=n, k=k))
    want = np.stack([banded_ref.banded_scores(qi, s, k) for qi in q])
    np.testing.assert_array_equal(got, want)
