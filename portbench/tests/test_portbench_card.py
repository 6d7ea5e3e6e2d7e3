"""On the card: one short run of each cell at its full size comes out
correct and reports its metrics.  Skips without a CUDA device."""

import pytest

from portbench import harness, manifest
from portbench.tests.test_portbench_manifest import BENCH


@pytest.mark.card
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(cuda_device, cell):
    c = manifest.load_cell(cell)
    res = harness.run_cell(c, 2 ** 31 + 41, 2.0, True, device=cuda_device,
                           log=lambda *a, **k: None)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert set(res["metrics"]) <= {m["name"] for m in c.per_layer}
