"""Runs of each cell at a size the CPU holds, the kernels' plain versions
serving: a sound run comes out correct, and the control and every planted
fault under the timed path come out not correct (control.py)."""

import pytest

from portbench import control, harness, manifest

CELLS = ("lb-1m-zipf.sat", "mixed-10m.sat")


def small(name):
    """The cell at 8 shards x 4096 slots and 8192 keys, its callers cut to
    8 (3 checked); the drain's width, the RPC size and the draws kept."""
    cell = manifest.load_cell(name)
    cell.config["instance"]["engine_config"]["capacity_per_shard"] = 4096
    cell.config["keys"]["count"] = 8192
    cell.traffic.update(groups=8, check_groups=3,
                        params=dict(items_per_caller=1000),
                        warmup=dict(seconds=0.2,
                                    params=dict(items_per_caller=200)))
    return cell


def quiet(*a, **k):
    pass


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    res = harness.run_cell(small(name), 2 ** 31 + 17, 1.0, False,
                           device="cpu", log=quiet)
    assert res["correct"], res["checks"]
    checks = res["checks"]
    assert checks["answers_checked"][0] > 1000
    assert checks["answers_wrong"][0] == 0
    assert checks["rows_minus_keys"][0] == 0
    assert res["failed"] == 0 and res["attempted"] > 0
    # a run on the CPU has no device trace to read
    assert set(res["metrics"]) == {m["name"] for m in
                                   manifest.load_cell(name).end_to_end
                                   if m["source"] != "device_trace"}


@pytest.mark.parametrize("mode", ["control", "state", "half", "answer"])
@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_are_not_correct(name, mode):
    res = control.run(small(name), 2 ** 31 + 29, 1.0, mode, device="cpu",
                      log=quiet)
    assert not res["correct"], res["checks"]
    assert res["checks"]["answers_wrong"][0] > 0


def test_off_lane_rpcs_are_caught(monkeypatch):
    """An RPC the raw-bytes lane refuses is served by the protobuf path
    here; the run must not come out correct."""
    cell = small("mixed-10m.sat")
    from gubernator_tpu_torch.native import NativeRouter
    orig = NativeRouter.parse_stack_fast
    seen = [0]

    def refuse_some(self, data, *a, **k):
        seen[0] += 1
        return -2 if seen[0] % 50 == 0 else orig(self, data, *a, **k)

    monkeypatch.setattr(NativeRouter, "parse_stack_fast", refuse_some)
    res = harness.run_cell(cell, 3, 1.0, False, device="cpu", log=quiet)
    assert not res["correct"]
    assert res["checks"]["rpcs_not_staged_once"][0] > 0
