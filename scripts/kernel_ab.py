"""Time each Pallas kernel against its XLA twin on the GPU, one bucket.

Compiles every kernel on the engine's kernel route at one database
bucket's shape (the pipeline's default bucket of 150/500 bp subjects),
prints ``compiled.memory_analysis()``, checks the kernel's full result
against its XLA twin (exact equality), and times both on the device.
One JSON line per comparison; the last line names the device.

Usage:
  python scripts/kernel_ab.py                      # all kernels
  python scripts/kernel_ab.py --only myers,bitpal --subjects 131072
  python scripts/kernel_ab.py --sweep-words        # Myers/BitPAl word limits
  python scripts/kernel_ab.py --sweep-blocks       # block size x warps

Times are medians of ``--reps`` runs that end in ``block_until_ready``;
compile time is reported apart.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, args, reps):
    """(compile seconds, median run seconds, result) of jit(fn)(*args)."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    out = compiled(*args)
    out.block_until_ready()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        compiled(*args).block_until_ready()
        times.append(time.perf_counter() - t0)
    return t_compile, statistics.median(times), compiled, out


def compare(name, kernel, twin, args, cells, reps):
    """Time kernel and twin and check them equal; with twin None, time the
    kernel alone."""
    import numpy as np

    tk = timed(kernel, args, reps)
    if twin is None:
        print(json.dumps({"kernel": name, "cells": cells,
                          "kernel_compile_s": tk[0], "kernel_s": tk[1],
                          "kernel_gcups": cells / tk[1] / 1e9}), flush=True)
        return True
    tx = timed(twin, args, reps)
    print(f"[{name}] kernel memory_analysis: {tk[2].memory_analysis()}",
          flush=True)
    same = bool(np.array_equal(np.asarray(tk[3]), np.asarray(tx[3])))
    rec = {
        "kernel": name, "equal_to_twin": same, "cells": cells,
        "kernel_compile_s": tk[0], "kernel_s": tk[1],
        "kernel_gcups": cells / tk[1] / 1e9,
        "twin_compile_s": tx[0], "twin_s": tx[1],
        "twin_gcups": cells / tx[1] / 1e9,
        "speedup": tx[1] / tk[1],
    }
    print(json.dumps(rec), flush=True)
    return same


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default="myers,myers_semi,bitpal")
    ap.add_argument("--queries", type=int, default=20)
    ap.add_argument("--subjects", type=int, default=262144)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sweep-words", action="store_true",
                    help="time Myers and packed BitPAl against their twins "
                         "over subject lengths (the word-count limits)")
    ap.add_argument("--sweep-blocks", action="store_true",
                    help="time every kernel at several (block, warps)")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    import numpy as np

    from bgsa_tpu import pack
    from bgsa_tpu.benchutil import card
    from bgsa_tpu.ops import bitpal_packed
    from bgsa_tpu.ops import myers_semiglobal as sg
    from bgsa_tpu.ops import myers_xla

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"error: no GPU (platform {dev.platform})", file=sys.stderr)
        return 1
    print(f"card: {card()}", flush=True)
    rng = np.random.default_rng(args.seed)
    Q, S = args.queries, args.subjects
    only = set(args.only.split(","))
    ok = True

    def random_case(n):
        q = jnp.asarray(rng.integers(0, 4, (Q, n)), jnp.int32)
        s = jnp.asarray(rng.integers(0, 4, (S, n)), jnp.int32)
        return q, s

    def compares(with_twin=True):
        ok = True

        def twin(f):
            return f if with_twin else None

        if "myers" in only or "myers_semi" in only:
            n = 150
            q, s = random_case(n)
            eq32 = jax.block_until_ready(pack.pack_eq_jax(s, 32))
            if "myers" in only:
                ok &= compare(
                    "myers_global",
                    lambda e, qq: sg.myers_semiglobal(e, qq, read_len=n,
                                                      is_global=True),
                    twin(lambda e, qq: sg.myers_semiglobal_xla(
                        e, qq, read_len=n, is_global=True)),
                    (eq32, q), Q * S * n * n, args.reps)
                if with_twin:
                    # the XLA route's own choice: 31-bit reserved carry
                    eq31 = jax.block_until_ready(pack.pack_eq_jax(s, 31))
                    ok &= compare(
                        "myers_global_xla31_vs_xla32",
                        lambda e, qq: myers_xla.myers_global(e[0], qq, read_len=n),
                        lambda e, qq: sg.myers_semiglobal_xla(e[1], qq, read_len=n,
                                                              is_global=True),
                        ((eq31, eq32), q), Q * S * n * n, args.reps)
            if "myers_semi" in only:
                ok &= compare(
                    "myers_semiglobal",
                    lambda e, qq: sg.myers_semiglobal(e, qq, read_len=n),
                    twin(lambda e, qq: sg.myers_semiglobal_xla(e, qq,
                                                               read_len=n)),
                    (eq32, q), Q * S * n * n, args.reps)
        if "bitpal" in only:
            n = 500
            q, s = random_case(n)
            s = s[: S // 4]
            eq = jax.block_until_ready(pack.pack_eq_jax(s, 31))
            kw = dict(match=2, mismatch=-3, gap=-5, read_len=n)
            ok &= compare(
                "bitpal_packed",
                lambda e, qq: bitpal_packed.bitpal_packed(e, qq, **kw),
                twin(lambda e, qq: bitpal_packed.bitpal_packed_xla(e, qq, **kw)),
                (eq, q), Q * (S // 4) * n * n, args.reps)
        return ok

    if args.sweep_blocks:
        from bgsa_tpu.ops import blockutil

        settings = ((64, 2), (128, 4), (256, 4), (256, 8), (128, 2))
        for block, warps in settings:
            blockutil.BLOCK, blockutil.NUM_WARPS = block, warps
            jax.clear_caches()
            print(f"== block {block}, num_warps {warps}", flush=True)
            ok &= compares(with_twin=False)
    elif args.sweep_words:
        # lift the routing limits so the kernels themselves are timed
        sg.MAX_WORDS = bitpal_packed.MAX_STATE = 1 << 30
        for n in (150, 500, 1000, 2000, 3000):
            q, s = random_case(n)
            eq = jax.block_until_ready(pack.pack_eq_jax(s, 32))
            for g in (True,):
                ok &= compare(
                    f"myers_global_{n}bp",
                    lambda e, qq: sg.myers_semiglobal(e, qq, read_len=n,
                                                      is_global=g),
                    lambda e, qq: sg.myers_semiglobal_xla(e, qq, read_len=n,
                                                          is_global=g),
                    (eq, q), Q * S * n * n, args.reps)
        for n in (250, 500, 750, 1000):
            q, s = random_case(n)
            eq = jax.block_until_ready(pack.pack_eq_jax(s, 31))
            kw = dict(match=2, mismatch=-3, gap=-5, read_len=n)
            ok &= compare(
                f"bitpal_packed_{n}bp",
                lambda e, qq: bitpal_packed.bitpal_packed(e, qq, **kw),
                lambda e, qq: bitpal_packed.bitpal_packed_xla(e, qq, **kw),
                (eq, q), Q * S * n * n, args.reps)
    else:
        ok = compares()
    print(json.dumps({"ok": ok, "card": card(), "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
