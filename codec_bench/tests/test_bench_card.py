"""On the card: a sound run of each cell is correct, and its control is
not, at a pool a test run can hold (a 64th of the corpus: files of
80-800 KB, wider than either configuration's control window).

    python -m pytest codec_bench/tests -m card
"""

import pytest

from codec_bench import controls, runner, registry
from codec_bench.tests import helpers

CELLS = [c["name"] for c in registry.benchmark()["workloads"]]
SEEDS = [2**31 + 11, 2**31 + 12, 2**31 + 13]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_on_the_card(cell, cuda_card):
    r = helpers.run_cell(cell, runner.System(cuda_card), seed=SEEDS[0],
                         scale=64, device=cuda_card, seconds=1.0,
                         traced=True)
    assert r["correct"] is True, r["checks"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
    assert r["metrics"], "the traced run read no per-layer metric"


@pytest.mark.card
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_on_the_card_is_not_correct(cell, seed, cuda_card):
    system = controls.CONTROLS["half-window"](runner.System(cuda_card))
    r = helpers.run_cell(cell, system, seed=seed, scale=64,
                         device=cuda_card, seconds=1.0)
    assert r["correct"] is False
    assert r["checks"]["token_diff"]["value"] > 0
