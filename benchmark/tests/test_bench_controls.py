"""Each cell's control on the card, at the cell's own size and load: the
control has to fail one of the cell's limits on every seed, and a sound run
has to pass them all. On the chip:
`python -m pytest benchmark/tests/test_bench_controls.py -m cuda -q`."""
import pytest

import readings
from harness import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]
SECONDS = 3.0


def _fails_a_limit(r: dict, limits: dict) -> bool:
    return any(r[k] > lim for k, lim in limits.items())


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_system_passes(cuda_device, name):
    cell = spec.cell(name)
    limits = cell["limits"]["checks"]
    for seed, r, bad in readings.control_readings(cell, cuda_device, [424242, 434343, 444444]):
        assert bad or _fails_a_limit(r, limits), (seed, r)
    for seed, r, bad, _ in readings.program_readings(cell, cuda_device, [515151], SECONDS):
        assert not bad and not _fails_a_limit(r, limits), (seed, r)
