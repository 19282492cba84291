"""On the card only (``-m cuda``): at each cell's own size, the control
(the reference with TF32 products in the program's place) fails the cell's
limits where the program passes them.

    python -m pytest --noconftest -m cuda bench_port/tests/test_bench_port_card.py
"""

import pytest

from bench_port import compare, spec
from bench_port.control import readings
from bench_port.tests.tiny import CELLS


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_program_passes(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    r = readings(cell, 20261017, 3.0)
    limits = spec.limits(cell)
    assert compare.verdict(r["program"], limits)[0], r["program"]
    assert not compare.verdict(r["control"], limits)[0], r["control"]
