"""Symbol mapping and Eq bitvector packing.

The reference packs each subject into per-character match bitvectors Eq[c]
("handle_reads", ``/root/reference/original/BGSA_CPU/global.c:25-70``), using
``word_size - 1`` usable bits per word (the top bit is reserved so the Myers
add cannot carry across words) unless the scheme needs full words
(semi-global). We do the same with uint32 words — 31 usable bits on the
reserved-carry path, 32 on the full-bit path — but the packing itself runs
vectorized (NumPy on host or JAX on device) instead of an OpenMP char loop.

Layouts:
  * functional API: ``eq[c, w, s]`` — character plane, word index, subject.
  * the kernels take the subject axis in blocks of ``ops.blockutil.BLOCK``.
"""

from __future__ import annotations

import numpy as np

CHAR_NUM = 5  # A C G T N, as in the reference (CHAR_NUM, config.h)
PAD_CODE = 255  # matches no character plane

# Characters outside ACGTN map to 0 ('A'), matching the reference's
# zero-initialized mapping table (global.c:6-15).
MAPPING = np.zeros(256, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    MAPPING[_c] = _i
MAPPING[ord("N")] = 4


def encode_ascii(buf: np.ndarray) -> np.ndarray:
    """Map ASCII bytes (any shape) to symbol codes 0..4."""
    return MAPPING[np.asarray(buf, dtype=np.uint8)]


def word_count(length: int, word_bits: int) -> int:
    """Number of uint words covering ``length`` subject positions."""
    return -(-length // word_bits)


def pack_eq(codes: np.ndarray, word_bits: int = 31) -> np.ndarray:
    """Pack subject codes into Eq planes.

    Args:
      codes: (S, L) integer symbol codes 0..4.
      word_bits: usable bits per 32-bit word (31 reserved-carry, 32 full).

    Returns:
      (CHAR_NUM, W, S) uint32 — bit b of eq[c, w, s] is set iff
      codes[s, w*word_bits + b] == c.
    """
    codes = np.atleast_2d(np.asarray(codes))
    from . import native

    if codes.size == 0 or (0 <= codes.min() and codes.max() <= 4):
        # The C packer indexes planes by raw code value; out-of-range codes
        # (e.g. PAD_CODE re-packs) take the pure-NumPy path, which maps them
        # to no plane.
        fast = native.pack_eq(codes, word_bits)
        if fast is not None:
            return fast
    S, L = codes.shape
    W = word_count(L, word_bits)
    padded = np.full((S, W * word_bits), PAD_CODE, dtype=np.int16)
    padded[:, :L] = codes
    padded = padded.reshape(S, W, word_bits)
    weights = (np.uint32(1) << np.arange(word_bits, dtype=np.uint32))
    eq = np.zeros((CHAR_NUM, W, S), dtype=np.uint32)
    for c in range(CHAR_NUM):
        # Distinct powers of two: plain sum assembles the word without carries.
        eq[c] = np.sum((padded == c) * weights, axis=2, dtype=np.uint32).T
    return eq


def unpack_eq(eq: np.ndarray, length: int, word_bits: int = 31) -> np.ndarray:
    """Inverse of pack_eq (testing aid): (C, W, S) -> (S, length) codes."""
    C, W, S = eq.shape
    bits = np.arange(word_bits, dtype=np.uint32)
    # (C, W, S, word_bits) -> (C, S, W*word_bits)
    planes = ((eq[..., None] >> bits) & 1).transpose(0, 2, 1, 3).reshape(C, S, W * word_bits)
    codes = np.full((S, W * word_bits), PAD_CODE, dtype=np.int16)
    for c in range(C):
        codes[planes[c] == 1] = c
    return codes[:, :length]


def pack_eq_jax(codes, word_bits: int = 31):
    """Device-side Eq packing (jit-friendly; shapes static).

    Args:
      codes: (S, L) int32/uint8 symbol codes on device.
    Returns:
      (CHAR_NUM, W, S) uint32.
    """
    import jax.numpy as jnp

    S, L = codes.shape
    W = word_count(L, word_bits)
    pad = W * word_bits - L
    cw = jnp.asarray(codes, jnp.int32)
    if pad:
        cw = jnp.pad(cw, ((0, 0), (0, pad)), constant_values=PAD_CODE)
    cw = cw.reshape(S, W, word_bits)
    # Build words bit by bit over (S, W) arrays: avoids materializing a
    # (C, S, W, word_bits) one-hot intermediate for large batches.
    planes = []
    for c in range(CHAR_NUM):
        w = jnp.zeros((S, W), jnp.uint32)
        for b in range(word_bits):
            w = w | ((cw[:, :, b] == c).astype(jnp.uint32) << b)
        planes.append(w.T)
    return jnp.stack(planes)  # (C, W, S)


def nibble_pack(codes: np.ndarray, threads: int = 1) -> np.ndarray:
    """Host-side transport packing: two symbol codes (0..4) per byte.

    Shrinks the host->device subject upload 8x vs int32 codes — the dominant
    end-to-end cost at production sizes (the reference never ships raw text to
    a device either: its offload sends pre-packed Eq planes, R12).
    ``threads`` fans the native packer over host cores (the reference's -N).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    from . import native

    fast = native.transport_pack(codes, two_bit=False, threads=threads)
    if fast is not None:
        return fast
    S, n = codes.shape
    if n % 2:
        codes = np.concatenate([codes, np.full((S, 1), 0, np.uint8)], axis=1)
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def two_bit_pack(codes: np.ndarray, threads: int = 1) -> np.ndarray:
    """Host-side transport packing for N-free data: four codes (0..3)/byte.

    16x smaller than int32 codes; the pipeline uses it whenever a bucket
    contains no 'N' (codes > 3 would be corrupted — callers must check).
    """
    codes = np.asarray(codes, dtype=np.uint8)
    from . import native

    fast = native.transport_pack(codes, two_bit=True, threads=threads)
    if fast is not None:
        return fast
    S, n = codes.shape
    pad = (-n) % 4
    if pad:
        codes = np.concatenate([codes, np.zeros((S, pad), np.uint8)], axis=1)
    c = codes.reshape(S, -1, 4)
    return c[:, :, 0] | (c[:, :, 1] << 2) | (c[:, :, 2] << 4) | (c[:, :, 3] << 6)


def two_bit_unpack_jax(packed, length: int):
    """Device-side inverse of two_bit_pack: (S, ceil(n/4)) uint8 -> (S, n)."""
    import jax.numpy as jnp

    p = jnp.asarray(packed, jnp.uint8)
    three = jnp.uint8(3)
    parts = [(p >> (2 * i)) & three for i in range(4)]
    out = jnp.stack(parts, axis=-1).reshape(p.shape[0], -1)
    return out[:, :length].astype(jnp.int32)


# N-position sidecar rows are padded to this granularity so the device step
# compiles for a bounded set of sidecar shapes (per-shard granularity shrinks
# with the shard count so the padded total stays ~constant).
SIDECAR_QUANT = 1024


def _sidecar_quant(n_shards: int) -> int:
    return max(SIDECAR_QUANT // n_shards, 128)


def sidecar_pack(codes: np.ndarray, n_shards: int = 1) -> np.ndarray:
    """(K', 2) int32 positions of the N characters (row, col), K' padded up
    to a quant multiple with out-of-range rows (scatter-dropped).

    With ``n_shards > 1`` the batch is row-split into n_shards equal groups
    (the shard_map layout) and the result is the concatenation of n_shards
    equal-size per-shard position lists with *shard-local* row indices —
    sharding the sidecar on axis 0 then hands each device exactly its own
    N fix-ups, so the 2bit+sidecar transport works under shard_map (the
    scatter is shard-local, no global indices cross device boundaries).
    """
    codes = np.asarray(codes)
    S = codes.shape[0]
    quant = _sidecar_quant(n_shards)
    if n_shards == 1:
        rows, cols = np.nonzero(codes > 3)
        k = len(rows)
        padded = max(-(-k // quant), 1) * quant
        pos = np.full((padded, 2), S, np.int32)  # row == S -> dropped
        pos[:k, 0] = rows
        pos[:k, 1] = cols
        return pos
    if S % n_shards:
        raise ValueError(f"sidecar_pack: {S} rows not divisible by {n_shards} shards")
    per = S // n_shards
    parts = [np.nonzero(codes[i * per : (i + 1) * per] > 3) for i in range(n_shards)]
    k_pad = max(-(-max(len(r) for r, _ in parts) // quant), 1) * quant
    pos = np.full((n_shards * k_pad, 2), per, np.int32)  # row == per -> dropped
    for i, (r, c) in enumerate(parts):
        pos[i * k_pad : i * k_pad + len(r), 0] = r
        pos[i * k_pad : i * k_pad + len(r), 1] = c
    return pos


def select_transport(codes: np.ndarray, allow_sidecar: bool = True,
                     n_shards: int = 1, threads: int = 1):
    """Pick the host->device subject encoding for a batch.

    * N-free: 4 codes/byte ("2bit").
    * rare N (sidecar smaller than the nibble-vs-2bit delta): 4 codes/byte
      plus a sparse N fix-up list ("2bitN", payload is a (packed, positions)
      tuple) — halves the upload again for real-read data with occasional N.
    * otherwise: 2 codes/byte ("nib").

    Returns (name, payload); pair with transport_unpack_jax(name) on the
    device side. ``n_shards`` pre-splits the sidecar into shard-local
    position lists (see sidecar_pack) so every multi-device path rides the
    cheap transport; ``allow_sidecar=False`` restricts to the single-array
    transports.
    """
    codes = np.asarray(codes)
    from . import native

    n_count = None
    if codes.dtype == np.uint8 and codes.flags.c_contiguous:
        n_count = native.count_n(codes)
    if n_count is None:
        n_count = int(np.count_nonzero(codes > 3))
    if n_count == 0:
        return "2bit", two_bit_pack(codes, threads)
    S, L = codes.shape
    delta = S * (-(-L // 2) - (-(-L // 4)))  # nibble bytes minus 2bit bytes
    # Cheap lower bound on the padded sidecar size gates the exact check.
    min_rows = n_shards * _sidecar_quant(n_shards)
    if allow_sidecar and min_rows * 8 <= delta and n_count * 8 <= delta:
        pos = sidecar_pack(codes, n_shards)
        if pos.shape[0] * 8 <= delta:
            clean = np.where(codes > 3, 0, codes).astype(np.uint8)
            return "2bitN", (two_bit_pack(clean, threads), pos)
    return "nib", nibble_pack(codes, threads)


def two_bit_sidecar_unpack_jax(payload, length: int):
    """Device-side inverse of the "2bitN" transport: 2-bit unpack, then
    scatter code 4 at the sidecar positions (padded rows are out of range
    and dropped)."""
    packed, pos = payload
    out = two_bit_unpack_jax(packed, length)
    return out.at[pos[:, 0], pos[:, 1]].set(4, mode="drop")


def transport_unpack_jax(name: str):
    """Device-side unpacker matching select_transport's name."""
    return {
        "2bit": two_bit_unpack_jax,
        "2bitN": two_bit_sidecar_unpack_jax,
        "nib": nibble_unpack_jax,
    }[name]


def transport_width(name: str, length: int) -> int:
    """Packed bytes per subject for a transport (AOT shape computation)."""
    return -(-length // 4) if name in ("2bit", "2bitN") else -(-length // 2)


def transport_specs(name: str, rows: int, length: int, sidecar: int = 0):
    """(shape, dtype) leaves of a transport payload (AOT warm-up shapes)."""
    main = ((rows, transport_width(name, length)), np.uint8)
    if name == "2bitN":
        return [main, ((sidecar, 2), np.int32)]
    return [main]


def nibble_unpack_jax(nib, length: int):
    """Device-side inverse of nibble_pack: (S, ceil(n/2)) uint8 -> (S, n) int32."""
    import jax.numpy as jnp

    nib = jnp.asarray(nib, jnp.uint8)
    lo = nib & jnp.uint8(0xF)
    hi = nib >> 4
    out = jnp.stack([lo, hi], axis=-1).reshape(nib.shape[0], -1)
    return out[:, :length].astype(jnp.int32)


def pack_banded_jax(codes, threshold: int, query_len: int):
    """Device-side pack_banded (same outputs; see pack_banded for layout).

    The injection stream is exactly an Eq packing (full 32-bit words) of the
    subject slice starting at position k; the initial window is k one-hot
    bits shifted into place.
    """
    import jax.numpy as jnp

    codes = jnp.atleast_2d(jnp.asarray(codes, jnp.int32))
    S, L = codes.shape
    k = threshold
    if k + min(k, L) > 63:
        raise ValueError(
            f"banded preload needs bit {k + min(k, L)} (> 63): threshold {k} "
            f"with {L}bp subjects exceeds the 64-bit band register"
        )
    lo = jnp.zeros((CHAR_NUM, S), jnp.uint32)
    hi = jnp.zeros((CHAR_NUM, S), jnp.uint32)
    for i in range(min(k, L)):
        pos = k + 1 + i
        onehot = jnp.stack(
            [(codes[:, i] == c).astype(jnp.uint32) for c in range(CHAR_NUM)]
        )
        if pos < 32:
            lo = lo | (onehot << pos)
        else:
            hi = hi | (onehot << (pos - 32))

    n_inj = max(query_len - k, 1)
    W = -(-n_inj // 32)
    avail = max(min(n_inj, L - k), 0)
    if avail:
        inj = pack_eq_jax(codes[:, k : k + avail], 32)  # (C, W_avail, S)
        wa = inj.shape[1]
        if wa < W:
            inj = jnp.concatenate(
                [inj, jnp.zeros((CHAR_NUM, W - wa, S), jnp.uint32)], axis=1
            )
    else:
        inj = jnp.zeros((CHAR_NUM, W, S), jnp.uint32)
    return lo, hi, inj


def pack_banded(codes: np.ndarray, threshold: int, query_len: int,
                threads: int = 1):
    """Banded packing: initial 64-bit Peq window + per-column injection bits.

    Mirrors the reference's banded layout (``banded/BGSA_CPU/global.c:25-85``):
    word 0 holds subject[0..k-1] pre-shifted to bits k+1..2k of a 64-bit band
    register; the remaining subject characters are consumed one bit per query
    column as the band slides. We store the initial window as (lo, hi) uint32
    pairs and the injection stream packed 32 columns per uint32 word. Unlike
    the reference we never read past the subject (its packer overruns into
    adjacent memory when the subject tail exceeds the word capacity); beyond
    the subject end we inject zero bits.

    Args:
      codes: (S, L) symbol codes.
      threshold: error threshold k (band fits 64 bits:
        2k + (L - query_len) + 1 <= 64 required).
      query_len: query length m (injections run for columns t < m - k).

    Returns:
      init_lo, init_hi: (CHAR_NUM, S) uint32 — initial Peq window.
      inj: (CHAR_NUM, W, S) uint32 — injection bit w*32+b = column t bit,
        i.e. subject[k + t] == c; W = ceil(max(query_len - k, 1) / 32).
    """
    codes = np.atleast_2d(np.asarray(codes))
    if threshold + min(threshold, codes.shape[1]) > 63:
        raise ValueError(
            f"banded preload needs bit {threshold + min(threshold, codes.shape[1])} "
            f"(> 63): threshold {threshold} with {codes.shape[1]}bp subjects "
            "exceeds the 64-bit band register"
        )
    from . import native

    fast = native.pack_banded(codes, threshold, query_len, threads=threads)
    if fast is not None:
        return fast
    S, L = codes.shape
    k = threshold
    init = np.zeros((CHAR_NUM, S), dtype=np.uint64)
    for i in range(min(k, L)):
        for c in range(CHAR_NUM):
            init[c] |= (codes[:, i] == c).astype(np.uint64) << np.uint64(k + 1 + i)
    n_inj = max(query_len - k, 1)
    W = -(-n_inj // 32)
    inj = np.zeros((CHAR_NUM, W, S), dtype=np.uint32)
    for t in range(min(n_inj, max(L - k, 0))):
        idx = k + t
        w, b = divmod(t, 32)
        for c in range(CHAR_NUM):
            inj[c, w] |= (codes[:, idx] == c).astype(np.uint32) << np.uint32(b)
    return (init & np.uint64(0xFFFFFFFF)).astype(np.uint32), (init >> np.uint64(32)).astype(np.uint32), inj
