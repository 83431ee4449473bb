"""A whole run, the look for a card left out, on the CPU at a small pool:
the result line's keys, ``correct`` on a sound run, and ``correct`` false
under the control and under each fault a codec call can have."""

import pytest

from codec_bench import controls, runner, registry
from codec_bench.tests import helpers

BENCH = registry.benchmark()
CELLS = [c["name"] for c in BENCH["workloads"]]
SEED = 2**31 + 4099  # past 32 signed bits, as seeds may be


def _scale(cell):
    # the max-window cells' plain matcher on the CPU wants smaller files
    return 40000 if cell.startswith("max-window") else 20000


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct_and_prints_the_contract_keys(cell):
    r = helpers.run_cell(cell, runner.System("cpu"), seed=SEED,
                         scale=_scale(cell), deck=64)
    keys = list(r)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0
    assert r["attempted"] > 0
    want = {m["name"] for m in registry.end_to_end(BENCH, cell)}
    assert set(r["metrics"]) == want
    for name, m in r["metrics"].items():
        assert m["value"] > 0, name
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    assert all(c["value"] == 0 == c["limit"] for c in r["checks"].values())
    assert r["judged"]["tokens_sampled"] > 0


def _applies(cell, fault):
    mix = registry.traffic(registry.cell(BENCH, cell)["traffic"])
    if fault == "output-altered":
        return "decompress" in mix["ops"]
    return True


@pytest.mark.parametrize("fault", sorted(controls.FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_planted_fault_makes_the_run_incorrect(cell, fault):
    if not _applies(cell, fault):
        pytest.skip(f"{cell} makes no decompress call for {fault} to alter")
    system = controls.FAULTS[fault](runner.System("cpu"))
    r = helpers.run_cell(cell, system, seed=SEED, scale=_scale(cell),
                         deck=64)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("cell", [c for c in CELLS
                                  if c.startswith("default-window")])
def test_the_control_makes_the_run_incorrect(cell):
    # files of 1.3-12.8 KB, some wider than the control's window of 2,049
    # bytes; blocks cut to the smallest file, 5.3 KB at a thousandth
    system = controls.CONTROLS["half-window"](runner.System("cpu"))
    blocks = cell.endswith("blocks-rw")
    r = helpers.run_cell(cell, system, seed=SEED,
                         scale=1000 if blocks else 4000, deck=16,
                         seconds=3.0 if blocks else 0.3)
    assert r["correct"] is False
    assert r["checks"]["token_diff"]["value"] > 0
    assert r["checks"]["decode_diff_bytes"]["value"] == 0
