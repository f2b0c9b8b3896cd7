"""The control at a size a test run holds: the tiny G1 cell on the CPU,
the program under its configuration's STARK config and under each control
(half the proof-of-work bits, half the queries), judged on three seeds.
On the card, `python3 benchmark/control.py` reads the same at a cell's
own size."""

import os
import subprocess
import sys
import textwrap

import pytest

from benchtools import ROOT

SEEDS = [2**31 + 101, 2**31 + 102, 2**31 + 103]


def _readings(root):
    bench = os.path.join(str(root), "benchmark")
    code = textwrap.dedent(f"""
        import json, sys
        sys.path[:0] = [{bench!r}, {str(root)!r}, {ROOT!r}]
        import torch
        torch.set_num_threads(2)
        import control, harness
        cell = harness.Cell(harness.load_json({str(root)!r} + "/BENCHMARK.json"), "g1-exp-2.closed",
                            here={bench!r})
        for r in control.readings(cell, {SEEDS!r}, 0.1, ["pow", "queries"], "cpu"):
            print(json.dumps(r))
        """)
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    import json

    return [json.loads(line) for line in p.stdout.splitlines() if line.startswith("{")]


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    from benchtools import make_tiny_bench

    return _readings(make_tiny_bench(tmp_path_factory.mktemp("control")))


def _failed(r):
    return any(c["value"] > c["limit"] for c in r["checks"].values())


def test_the_program_passes_on_every_seed(readings):
    sound = [r for r in readings if r["side"] == "program"]
    assert len(sound) == len(SEEDS) and not any(_failed(r) for r in sound)


def test_half_the_queries_fails_on_every_seed(readings):
    ctrl = [r for r in readings if r["side"] == "queries"]
    assert len(ctrl) == len(SEEDS) and all(r["checks"]["rejected"]["value"] >= 1 for r in ctrl)


def test_half_the_proof_of_work_fails(readings):
    """test_config states 4 bits: a nonce of 2 bits passes 4 with chance
    1/4 a proof, so the control fails on most seeds, never on none."""
    ctrl = [r for r in readings if r["side"] == "pow"]
    assert len(ctrl) == len(SEEDS) and sum(_failed(r) for r in ctrl) >= 1


@pytest.mark.cuda
def test_the_g1_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cell's kernels run only there")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "g1-exp-128.single",
                        "--seed", str(2**31 + 7), "--seconds", "3", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    import json

    assert p.returncode == 0, p.stderr[-3000:]
    assert json.loads(p.stdout.strip().splitlines()[-1])["correct"] is True
