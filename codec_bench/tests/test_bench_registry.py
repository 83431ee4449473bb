"""Cells, configurations, mixes and metrics are found by name, a new one is
picked up from added files alone, and BENCHMARK.json keeps to its contract's
shape."""

import json
import os
import re
import shutil

import pytest

from codec_bench import registry

BENCH = registry.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "codec_bench/run.py"]
    assert BENCH["paths"] == ["codec_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(registry.REPO, "BENCHMARK.json")) \
        <= 64 << 10


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_finds_its_files(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and cell["chips"] == 1
    assert 1 <= len(cell["why"]) <= 200
    cfg = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    assert cfg["name"] == cell["config"]
    assert mix["items"] in ("files", "blocks")
    e2e = [m["name"] for m in registry.end_to_end(BENCH, cell["name"])]
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = registry.per_layer(BENCH, cell["name"])
    assert layer
    for m in layer:  # each per-layer metric moves a metric its cell reports
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_has_a_reader(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert 0.01 <= metric["bound"] <= 0.25
        assert metric["source"] in ("host_clock", "device_trace")
    else:
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
    assert callable(registry.reader(metric["name"]).read)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(entry):
    cfg = registry.config(entry["name"])
    assert entry["file"] == f"codec_bench/configs/{entry['name']}.json"
    assert cfg["reduced"] == entry["reduced"] == []
    assert cfg["source"] == entry["source"] and len(entry["source"]) <= 200
    assert sum(f["bytes"] for f in cfg["files"]) == 211_938_580
    assert len(cfg["files"]) == 12
    assert cfg["token_bits"] == ((cfg["sb"] - 1).bit_length()
                                 + (cfg["la"] - 1).bit_length() + 8)


def test_a_new_cell_comes_from_added_files_alone(tmp_path):
    root = tmp_path / "codec_bench"
    shutil.copytree(registry.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__"))
    cfg = registry.config("default-window")
    cfg.update(name="tiny-window", la=8, sb=500)
    (root / "configs" / "tiny-window.json").write_text(json.dumps(cfg))
    mix = registry.traffic("blocks-rw")
    mix["ops"] = {"compress": 1.0}
    (root / "traffic" / "blocks-w.json").write_text(json.dumps(mix))
    (root / "metrics" / "calls.count.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "tiny-window.blocks-w",
                               "config": "tiny-window",
                               "traffic": "blocks-w", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "calls.count", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "codec entry", "moves": "setup_s",
                               "workloads": ["tiny-window.blocks-w"]})
    cell = registry.cell(bench, "tiny-window.blocks-w")
    assert registry.config(cell["config"], root=str(root))["sb"] == 500
    assert registry.traffic(cell["traffic"], root=str(root))["ops"] == {
        "compress": 1.0}
    names = [m["name"] for m in registry.per_layer(bench, cell["name"])]
    assert names == ["calls.count"]
    assert [m["name"] for m in registry.end_to_end(bench, cell["name"])] \
        == ["setup_s"]

    class Run:
        calls = [1, 2, 3]

    assert registry.reader("calls.count", root=str(root)).read(Run) == 3
