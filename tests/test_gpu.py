"""On-card parity: the compiled Triton kernels against their XLA twins and
the plain reference.

Marked ``gpu``; they skip on the CPU (the ``gpu`` fixture). On the card,
``python chip_smoke.py`` runs them first (its "gpu tests" phase), then the
same check, ``chip_smoke.kernel_parity``, at full width.
"""

import pytest

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("name,length", [("myers_global", 150),
                                         ("myers_semiglobal", 150),
                                         ("bitpal", 120)])
def test_kernel_matches_twin_and_reference(gpu, rng, name, length):
    import chip_smoke

    n = chip_smoke.kernel_parity(name, rng, 4, 4096, sample=256,
                                 length=length)
    assert n == 4 * 4096
