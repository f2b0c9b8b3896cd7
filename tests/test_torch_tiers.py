"""The test tiers: `slow` is what tier-1 leaves out, and every `heavy` test is `slow`.

A command-line `-m` replaces the `-m` of `pytest.ini`'s `addopts`, so tier-1's
`-m 'not slow'` must deselect the heavy tests just as a bare run does. Each
case collects the two files that hold heavy tests in a child pytest, from the
repo root, and compares the selected node ids with the six heavy ones.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = ["tests/test_heavy_roundtrips.py", "tests/test_parallel.py"]
HEAVY = {
    *(f"tests/test_heavy_roundtrips.py::test_family_roundtrip_isolated[{family}]"
      for family in ("TestG2Exp", "TestFq12Exp", "TestFq12ExpU64", "TestHashToG2",
                     "TestBatchFriG1")),
    "tests/test_parallel.py::test_sharded_prove_g1_num_io_16_byte_identical",
}


def _collected(marker_args):
    env = os.environ.copy()
    env.pop("PYTEST_ADDOPTS", None)  # the repo's own configuration only
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "--collect-only", "-q", "-p", "no:cacheprovider",
         *marker_args, *FILES],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stdout[-3000:] + "\n" + r.stderr[-1500:]
    return {line.strip() for line in r.stdout.splitlines() if "::" in line}


@pytest.mark.parametrize("marker_args, heavy_selected", [
    ([], False),  # addopts alone
    (["-m", "not slow"], False),  # tier-1's expression
    (["-m", "heavy"], True),
], ids=["addopts", "not-slow", "heavy"])
def test_heavy_tests_are_slow_under_every_marker_expression(marker_args, heavy_selected):
    ids = _collected(marker_args)
    if heavy_selected:
        assert ids == HEAVY
    else:
        assert ids and not ids & HEAVY
