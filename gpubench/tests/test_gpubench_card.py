"""On the card (marker ``cuda``): the control, the port's bfloat16 tower,
comes out not correct at each cell's own size on three seeds, and a sound
run of the same seeds comes out correct.

    python -m pytest -p no:cacheprovider -m cuda gpubench/tests
"""

import pytest

import readings
from conftest import CELLS
from harness import check, spec

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_the_cell_size(cuda, cell):
    limits = spec.limits(cell)
    for seed in (2**31 + 301, 2**31 + 302, 2**31 + 303):
        r = readings.reading(cell, seed, "bf16", device=cuda)
        ok, checks = check.judge(r, limits)
        assert not ok, checks
        sound = readings.reading(cell, seed, device=cuda)
        ok, checks = check.judge(sound, limits)
        assert ok, checks
