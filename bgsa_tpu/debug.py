"""Debug printers for bit-vector kernel development.

Analogue of the reference's lane printers
(``/root/reference/original/BGSA_KNC/util.c:4-62``: ``print_binary`` /
``printf_mm512*``). Host helpers format packed words for eyeballing; the
kernel-side helper wraps ``pl.debug_print`` so a single probe line works in
both interpret mode (tests) and compiled kernels.

Usage inside a Pallas kernel body::

    from bgsa_tpu import debug
    debug.kprint("vp[0] lane0 = {}", vp[0, 0, 0])

Host-side, after pulling state out of a kernel (or from the XLA twin)::

    print(debug.format_binary(word))            # one word, LSB-first marks
    print(debug.format_words(eq[0, :, 0]))      # a word chain (multi-word Eq)
"""

from __future__ import annotations

import numpy as np


def format_binary(word, bits: int = 32, lsb_first: bool = True) -> str:
    """One packed word as a bit string (reference print_binary, util.c:26-37).

    The reference prints MSB-first; subject positions grow LSB-first, so the
    default here puts bit 0 on the left — pass ``lsb_first=False`` for the
    reference's orientation.
    """
    w = int(np.uint64(word))
    s = "".join("1" if (w >> b) & 1 else "0" for b in range(bits))
    return s if lsb_first else s[::-1]


def format_words(words, bits: int = 32, sep: str = " | ") -> str:
    """A multi-word chain (e.g. ``eq[c, :, s]``) as joined bit strings."""
    return sep.join(format_binary(w, bits) for w in np.asarray(words).ravel())


def format_lanes(arr, max_lanes: int = 8) -> str:
    """First lanes of a block of subject words, one formatted word per lane
    (reference printf_mm512_i32, util.c:39-49)."""
    flat = np.asarray(arr).reshape(-1)
    shown = ", ".join(format_binary(v) for v in flat[:max_lanes])
    more = f", ... ({flat.size} lanes)" if flat.size > max_lanes else ""
    return f"[{shown}{more}]"


def kprint(fmt: str, *args) -> None:
    """``pl.debug_print`` passthrough for kernel bodies.

    Works under ``interpret=True`` (prints eagerly from the Pallas
    interpreter) and in compiled kernels. Import stays inside so host-only
    users never pull Pallas.
    """
    from jax.experimental import pallas as pl

    pl.debug_print(fmt, *args)
