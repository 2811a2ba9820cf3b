"""On the card: each cell's control (the reference in the precision just
below the configuration's, put in the program's place) fails a limit of
the cell, and the program at the same size passes them; at a size a test
run can hold (a request cell's shortest clip), on three seeds.

    python -m pytest -m gpu port_bench/tests/test_port_bench_control.py
"""

import pytest
import torch

from port_bench import harness

CELLS = [w["name"] for w in harness.load_json(harness.MANIFEST)["workloads"]]
SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


def small(cell):
    """The cell with only its shortest clip (request mixes)."""
    tr = cell.traffic
    if tr["loop"] == "request":
        from port_bench import traffic

        shortest = min(traffic.lengths_s(tr))
        tr = {k: v for k, v in tr.items() if k not in ("lognormal", "order")}
        tr.update(lengths_s=[shortest], check={"positions": "all"})
    return harness.Cell(cell.name, cell.chips, cell.config, tr, cell.limits, cell.metrics)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name, cuda):
    from port_bench import program

    program.set_build_root(harness.BUILD_ROOT)
    cell = small(harness.resolve(name))
    loop = harness.load_loop(cell.traffic["loop"])
    for seed in SEEDS:
        control = dict(loop.control_checks(cell, seed, cuda, cell.config["control"]))
        assert any(control[k] > limit for k, limit in cell.limits.items()), (seed, control)
        torch.cuda.empty_cache()
    sound = dict(loop.run(cell, SEEDS[0], 0.1, False, cuda, 0.0)["checks"])
    assert all(sound[k] <= limit for k, limit in cell.limits.items()), sound
