"""Benchmark: one JSON line per kernel family on one GPU.

Line 1: unit-cost global Myers (500 bp). Lines 2-3: banded-Myers filter
(k=8, 150 bp read-filter mix) and packed BitPAl (2,-3,-5). Line 4: 960 bp
multi-word Myers (W=30 words), so cross-word-carry regressions show.
Every line runs the engine's GPU route — the Pallas kernels
(pipeline.kernel_route) and, for banded, banded_xla — and names the device
it ran on: JAX's platform, device kind and device count,
and the card's name and power limit. Without a GPU the script fails; it
never measures another platform.

All lines report the reference's "cal GCUPS" (kernel time only,
original/BGSA_SSE/cal_sse.c:485): cells = ref_len * ref_count * read_len *
subject_count — the banded reference bills the FULL matrix in its GCUPS
too (banded/BGSA_SSE/cal_sse.c:487), so the banded line is comparable on
the reference's own terms.

vs_baseline divides each line by ITS OWN family's measured reference
denominator (BASELINE_FAMILIES.json, reproduced by
scripts/measure_baseline.py): Myers 500 GCUPS per AVX-512 socket (the
published chart), packed BitPAl (2,-3,-5) 74.5, banded k=8 1223.5.

Each time is the median of ``REPS`` runs that end in
``block_until_ready``, after one warm-up run that compiles.
"""

import json
import os
import statistics
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

# Per-family reference denominators (GCUPS per AVX-512 socket). Measured by
# scripts/measure_baseline.py from the compiled reference binaries; the
# committed record is BASELINE_FAMILIES.json (fallback constants below are
# that file's 2026-08-19 values).
_FALLBACK_DENOMS = {"myers": 500.0, "bitpal": 74.5, "banded": 1223.5}

# The four metric lines, in emission order.
LINE_IDS = ("myers", "banded", "bitpal", "myers960")
REPS = 5


def family_denominators():
    try:
        with open(os.path.join(REPO, "BASELINE_FAMILIES.json")) as f:
            return json.load(f)["family_denominators_gcups"]
    except (OSError, KeyError, ValueError):
        return dict(_FALLBACK_DENOMS)


BASELINES = family_denominators()


def note(msg):
    """Progress marker on stderr (stdout carries only the JSON lines)."""
    print(f"[bench {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
          flush=True)


def emit(line_id, metric, gcups, device, family="myers"):
    print(json.dumps({
        "metric": metric,
        "value": gcups,
        "unit": "GCUPS",
        "vs_baseline": gcups / BASELINES[family],
        "baseline_family": f"{family} {BASELINES[family]:g} GCUPS/socket",
        "line": line_id,
        "device": device,
    }), flush=True)


def median_seconds(run, q, reps=REPS):
    """Median device seconds of run(q), after a compiling warm-up."""
    run(q).block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run(q).block_until_ready()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def main() -> int:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from bgsa_tpu import oracle, pack
    from bgsa_tpu.benchutil import device_info, filter_mix_dataset
    from bgsa_tpu.ops import banded, bitpal_packed, myers_semiglobal
    from bgsa_tpu.pipeline import kernel_route

    device = device_info()
    note(f"device: {device}")
    if device["platform"] != "gpu":
        print(f"error: bench.py measures a GPU; JAX found {device['platform']}",
              file=sys.stderr)
        return 1
    assert kernel_route() == "pallas"

    rng = np.random.default_rng(0)
    Q, m, S, n = 40, 500, 32768, 500
    queries = rng.integers(0, 4, size=(Q, m)).astype(np.int32)
    subjects = rng.integers(0, 4, size=(S, n))
    qd = jax.device_put(queries)
    cells = Q * m * S * n

    # --- 1. unit-cost global Myers: full-word kernel, global mode ---
    eq = jax.device_put(pack.pack_eq(subjects, 32))
    run = jax.jit(lambda q: myers_semiglobal.myers_semiglobal(
        eq, q, read_len=n, factor=-1, is_global=True))
    out = np.asarray(run(qd))
    want = -oracle.edit_distances(queries[0], subjects[:4])
    assert (out[0, :4] == want).all(), (out[0, :4], want)
    emit("myers", "unit-cost Myers cal GCUPS (1 GPU, 500bp x 500bp)",
         cells / median_seconds(run, qd) / 1e9, device)

    # --- 2. banded-Myers filter (k=8, 150bp reads): banded_xla ---
    k, nb, Sb = 8, 150, 65536
    qb, sb = filter_mix_dataset(rng, 8, Sb, nb)
    lo, hi, inj = jax.device_put(jax.jit(
        pack.pack_banded_jax, static_argnums=(1, 2))(
            jnp.asarray(sb, jnp.int32), k, nb))
    run_b = jax.jit(lambda q: banded.banded_xla(
        lo, hi, inj, q, q_len=nb, s_len=nb, k=k))
    qbd = jax.device_put(qb)
    emit("banded",
         "banded Myers k=8 cal GCUPS (150bp filter; full-matrix cells as "
         "the reference bills it)",
         8 * nb * Sb * nb / median_seconds(run_b, qbd) / 1e9, device,
         family="banded")

    # --- 3. packed BitPAl (2,-3,-5) ---
    bp = dict(match=2, mismatch=-3, gap=-5, read_len=n, factor=1)
    eq31 = jax.device_put(pack.pack_eq(subjects, 31))
    run_p = jax.jit(lambda q: bitpal_packed.bitpal_packed(eq31, q, **bp))
    emit("bitpal", "packed BitPAl (2,-3,-5) cal GCUPS (500bp)",
         cells / median_seconds(run_p, qd) / 1e9, device, family="bitpal")

    # --- 4. multi-word Myers (960 bp subjects, W = 30 words) ---
    n4, Q4, S4 = 960, 16, 16384
    queries4 = rng.integers(0, 4, size=(Q4, n4)).astype(np.int32)
    subjects4 = rng.integers(0, 4, size=(S4, n4))
    q4d = jax.device_put(queries4)
    eq4 = jax.device_put(pack.pack_eq(subjects4, 32))
    run4 = jax.jit(lambda q: myers_semiglobal.myers_semiglobal(
        eq4, q, read_len=n4, factor=-1, is_global=True))
    out4 = np.asarray(run4(q4d))
    want4 = -oracle.edit_distances(queries4[0], subjects4[:4])
    assert (out4[0, :4] == want4).all(), (out4[0, :4], want4)
    emit("myers960", "multi-word Myers cal GCUPS (960bp x 960bp, W=30)",
         Q4 * n4 * S4 * n4 / median_seconds(run4, q4d) / 1e9, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
