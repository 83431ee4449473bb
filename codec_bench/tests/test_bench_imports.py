"""Nothing a run loads is ``jax`` or the JAX package (top-level names
compared whole: the port's name begins with the JAX package's), and the
yardstick imports nothing of the program.

Each check runs in a fresh interpreter: the repository's root
``conftest.py`` imports ``lz77_tpu.native`` into any pytest process."""

import ast
import json
import os
import shutil
import subprocess
import sys

from codec_bench import registry

REPO = registry.REPO
FORBIDDEN = {"jax", "jaxlib", "flax", "lz77_tpu"}
# the yardstick: everything under codec_bench/ but the system's binding
YARDSTICK = ["reference.py", "judge.py", "pool.py", "traffic.py",
             "trace.py", "registry.py", "controls.py"] + [
    os.path.join("metrics", f)
    for f in os.listdir(os.path.join(REPO, "codec_bench", "metrics"))]


def _run(code: str) -> subprocess.CompletedProcess:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=600)


def _tops(stdout: str) -> set:
    return set(json.loads(stdout.strip().splitlines()[-1]))


def test_a_whole_run_loads_no_jax_and_no_jax_package():
    code = (
        "import sys, json, time\n"
        "sys.path.insert(0, '.')\n"
        "from codec_bench.tests import helpers\n"
        "from codec_bench import runner\n"
        "mod = helpers.run_module()\n"
        "r = helpers.run_cell('default-window.blocks-rw',"
        " runner.System('cpu'), seed=7, scale=20000, deck=32)\n"
        "assert r['correct'], r['checks']\n"
        "assert mod.forbidden_modules() == []\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = _run(code)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = _tops(p.stdout)
    assert "lz77_tpu_torch" in tops and "torch" in tops
    assert not tops & FORBIDDEN


def test_forbidden_names_are_compared_whole():
    mod = __import__("codec_bench.tests.helpers",
                     fromlist=["run_module"]).run_module()
    sys.modules["lz77_tpu_torch_like"] = sys
    try:
        assert "lz77_tpu" not in mod.forbidden_modules()
    finally:
        del sys.modules["lz77_tpu_torch_like"]


def test_the_yardstick_imports_nothing_of_the_program():
    for rel in YARDSTICK:
        path = os.path.join(REPO, "codec_bench", rel)
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN | {
                    "lz77_tpu_torch"}, (rel, n)
    code = (
        "import sys, json\n"
        "sys.path.insert(0, '.')\n"
        "from codec_bench import reference, judge, pool, traffic, trace\n"
        "from codec_bench import registry, controls\n"
        "for m in registry.benchmark()['per_layer']:\n"
        "    registry.reader(m['name'])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    p = _run(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert not _tops(p.stdout) & (FORBIDDEN | {"lz77_tpu_torch"})


def test_no_card_no_result():
    p = subprocess.run(
        [sys.executable, "codec_bench/run.py", "--workload",
         "default-window.files-encode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        timeout=600, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})
    assert p.returncode != 0 and p.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "codec_bench"),
                    tmp_path / "codec_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run(
        [sys.executable, "codec_bench/run.py", "--workload",
         "default-window.files-encode", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=600)
    assert p.returncode != 0 and p.stdout == ""
