"""Worked example: the read-mapper filter-then-verify workflow.

1. Banded Myers (k errors) filters 100k candidate reads against a target in
   one kernel launch — most reads early-exit.
2. Survivors get exact unit-cost scores with the full Myers kernel.

Run: python examples/read_filter.py   (CPU or GPU)
"""

import numpy as np

import bgsa_tpu
from bgsa_tpu.schemes import Mode

rng = np.random.default_rng(7)
READ_LEN, N_READS, K = 150, 100_000, 8

# a target region and reads: 1% are noisy copies of it, the rest random
target = rng.integers(0, 4, size=READ_LEN)
reads = rng.integers(0, 4, size=(N_READS, READ_LEN))
planted = rng.choice(N_READS, size=N_READS // 100, replace=False)
for i in planted:
    reads[i] = target
    pos = rng.choice(READ_LEN, size=rng.integers(0, K), replace=False)
    reads[i, pos] = rng.integers(0, 4, size=len(pos))

# 1. filter: error counts, 127 = exceeds K
errs = bgsa_tpu.align(target, reads, k=K)
hits = np.where(errs < 127)[0]
print(f"filter: {len(hits)} / {N_READS} reads within {K} errors "
      f"({len(set(hits) & set(planted))} of {len(planted)} planted)")

# 2. verify survivors with exact global scores (negative edit distance)
scores = bgsa_tpu.align(target, reads[hits])
order = np.argsort(scores)[::-1]
print("best 5 (read index, edit distance):")
for j in order[:5]:
    print(f"  read {hits[j]:6d}  distance {-int(scores[j])}")
