"""The benchmark's shape: ``BENCHMARK.json`` and the files it names, the
result line, the exit without a chip, and a run's modules (no JAX, not the
JAX package, by whole top-level name)."""
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from bench_testutil import run_smoke, smoke_cell

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_names_files_and_metrics():
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    names = [c["name"] for c in BENCH["configs"]]
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["name"]) and w["config"] in names
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "workloads" / f"{w['name']}.json").is_file()
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["per_layer"]:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
        moved = e2e[m["moves"]]
        for c in m["workloads"]:
            assert c in moved.get("workloads", cells), (m["name"], c)
    for c in cells:
        reports = [m for m in BENCH["end_to_end"]
                   if c in m.get("workloads", cells)]
        assert len(reports) >= 2
        assert any(c in m["workloads"] for m in BENCH["per_layer"])


def test_result_line_keys_in_order():
    _, res = run_smoke(smoke_cell("olmo-1b.train"), seconds=0.3)
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(res)[-1] == "checks"
    assert set(res["metrics"]) == {"train_tok_s", "setup_s"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


def test_exits_2_without_a_chip():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: this checks the exit without one")
    env = dict(os.environ, PYTHONPATH="")
    p = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload",
                        "olmo-1b.train", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 2, p.stderr
    assert p.stdout == ""


def test_a_run_loads_no_jax_and_not_the_jax_package():
    code = (
        "import sys\n"
        f"sys.path[:0] = [{str(HERE)!r}, {str(ROOT / 'src')!r}]\n"
        "from bench_testutil import run_smoke, smoke_cell\n"
        "run_smoke(smoke_cell('olmo-1b.train'), seconds=0.2)\n"
        "run_smoke(smoke_cell('mixtral-8x22b-pp8.chat'), seconds=0.3)\n"
        "bad = {'jax', 'jaxlib', 'flax', 'repro'}\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & bad))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
