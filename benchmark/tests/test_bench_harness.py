"""The harness: driven by data, failing without a card or without the
program, and BENCHMARK.json within the benchmark contract's static rules."""

import json
import os
import re
import subprocess
import sys

import pytest

from benchtools import BENCH, ROOT, run_cpu, tiny_bench  # noqa: F401 (a fixture)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_a_config_traffic_cell_and_metric_added_as_files_are_found(tiny_bench):
    """The tiny configuration, its traffic and cell come as new files and
    entries (conftest); so does a new per-layer metric here. One run on
    the CPU reports it beside the cell's end-to-end metrics."""
    metric = tiny_bench / "benchmark" / "metrics" / "instances_proven.py"
    metric.write_text("def read(record):\n"
                      "    return sum(r['instances'] for r in record['requests'] if r['proof'])\n")
    bench = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "instances_proven", "unit": "instances", "better": "higher",
                               "source": "program_counter", "layer": "tracegen", "moves": "proof_s",
                               "workloads": ["g1-exp-2.closed"]})
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cpu(tiny_bench, "g1-exp-2.closed", trace=1)
    assert out["correct"] is True
    assert out["metrics"]["instances_proven"]["value"] == 2
    assert {"composition_ms", "fri_ms", "tracegen_ms"} <= set(out["metrics"])
    assert list(out)[-2] == "checks"  # the compared numbers come last in the line
    assert out["stderr"][-3:] == [f"check {k}: 0 (limit 0)" for k in ("unproven", "wrong_outputs",
                                                                       "rejected")]
    e2e = run_cpu(tiny_bench, "g1-exp-2.closed", seed=2**31 + 99)
    assert set(e2e["metrics"]) == {"proof_s", "setup_s"}


BURST_LOOP = """
\"\"\"A caller that makes `burst` statements, then proves them one by one.\"\"\"
from loops import closed


def setup(runner, maker):
    closed.setup(runner, maker)


def window(runner, maker, seconds, trace, rec):
    from generator import clock

    t0 = clock()
    statements = [maker.request(0, i) for i in range(runner.traffic["burst"])]
    rec["requests"] = []
    for i, _ in enumerate(statements):
        rec["requests"].append(runner.request(maker, 0, i, timed=trace))
    rec["window"] = (t0, rec["requests"][-1]["end"])
    rec["loop"] = "closed"


def profile(runner, maker, rec, n):
    return closed.profile(runner, maker, rec, n)
"""


def test_a_loop_added_as_a_file_drives_a_new_cell(tiny_bench):
    """A third way to drive the program: a loop module, the mix that names
    it with a parameter of its own, and a cell, all new files and entries.
    The run proves as many statements as the mix asks and judges them."""
    (tiny_bench / "benchmark" / "loops" / "burst.py").write_text(BURST_LOOP)
    (tiny_bench / "benchmark" / "traffic" / "tiny-burst.json").write_text(
        json.dumps({"name": "tiny-burst", "loop": "burst", "burst": 2, "profile": 1}))
    bench = json.loads((tiny_bench / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "g1-exp-2.burst", "config": "g1-exp-2",
                               "traffic": "tiny-burst", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "g1-exp-2.closed" in m.get("workloads", []):
            m["workloads"].append("g1-exp-2.burst")
    (tiny_bench / "BENCHMARK.json").write_text(json.dumps(bench))
    out = run_cpu(tiny_bench, "g1-exp-2.burst", seed=2**31 + 3)
    assert out["correct"] is True and out["attempted"] == 2
    assert set(out["metrics"]) == {"proof_s", "setup_s"}


def test_without_a_card_there_is_no_result():
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "g1-exp-128.single",
                        "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no CUDA card" in p.stderr


def test_with_only_the_benchmark_there_is_no_result(tiny_bench):
    """A checkout holding BENCHMARK.json and the benchmark alone: the
    program is missing, so the run fails before any result."""
    bench = os.path.join(str(tiny_bench), "benchmark")
    code = (f"import sys, time; sys.path[:0] = [{bench!r}, {str(tiny_bench)!r}]\n"
            "import harness, run\n"
            f"cell = harness.Cell(harness.load_json({str(tiny_bench)!r} + '/BENCHMARK.json'), "
            f"'g1-exp-2.closed', here={bench!r})\n"
            "run.report(run.run_cell(cell, 1, 0.1, False, 'cpu', time.perf_counter()))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=str(tiny_bench), capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "starky_bn254_tpu_torch" in p.stderr


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_benchmark_json_keys_names_and_files():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and b["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and os.path.exists(os.path.join(ROOT, c["file"]))
        with open(os.path.join(ROOT, c["file"])) as f:
            assert json.load(f)["reduced"] == c["reduced"]
    configs = {c["name"] for c in b["configs"]}
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        for w in m["workloads"]:  # every cell the metric reads reports what it moves
            assert w in e2e[m["moves"]].get("workloads", [w])


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_every_cell_reports_setup_another_end_to_end_and_a_layer(cell):
    b = _bench()
    mine = [m["name"] for m in b["end_to_end"] if cell in m.get("workloads", [cell])]
    assert "setup_s" in mine and len(mine) >= 2
    assert any(cell in m["workloads"] for m in b["per_layer"])
