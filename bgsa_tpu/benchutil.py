"""Benchmark datasets shared by bench.py, chip_smoke.py and the scripts."""

import numpy as np


def filter_mix_subjects(rng, queries: np.ndarray, n_subjects: int,
                        near_frac: float = 0.3) -> np.ndarray:
    """The banded benchmark's read-filter mix: ``n_subjects`` rows of codes
    where ``near_frac`` of them are near-duplicates of some query (0-5
    random substitutions) and the rest random. Vectorized, so a large
    database is written chunk by chunk with one call per chunk."""
    n_queries, length = queries.shape
    sb = rng.integers(0, 4, size=(n_subjects, length), dtype=np.uint8)
    n_near = int(n_subjects * near_frac)
    if n_near:
        near = queries[np.arange(n_near) % n_queries].astype(np.uint8)
        n_edits = rng.integers(0, 6, size=n_near)
        pos = rng.integers(0, length, size=(n_near, 5))
        val = rng.integers(0, 4, size=(n_near, 5), dtype=np.uint8)
        rows, slots = np.nonzero(np.arange(5)[None, :] < n_edits[:, None])
        near[rows, pos[rows, slots]] = val[rows, slots]
        sb[:n_near] = near
    rng.shuffle(sb, axis=0)
    return sb


def filter_mix_dataset(rng, n_queries: int, n_subjects: int, length: int,
                       near_frac: float = 0.3):
    """(queries int32, subjects uint8) for the read-filter mix."""
    qb = rng.integers(0, 4, size=(n_queries, length)).astype(np.int32)
    return qb, filter_mix_subjects(rng, qb, n_subjects, near_frac)


def card() -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them
    (a child process that never imports JAX). A card set below its maximum
    power runs slower under load, so every device number names it."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or f"nvidia-smi failed: {out.stderr.strip()}"


def device_info() -> dict:
    """The device as JAX reports it, plus the card's name and power limit."""
    import jax

    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()), "card": card()}
