"""The port's scripts (starky_bn254_tpu_torch/scripts/) and its graft
entry point (starky_bn254_tpu_torch/graft_entry.py) through their `run`
functions on the CPU, each at its smallest size, one parametrised test.
The numbers they record on the CPU are CPU times, not the card's. The
scripts that drive mesh proves are tested with the mesh proves
(tests/test_torch_sharded_prove.py).

The dry run (its G1ExpAir(16) prove over 8 shards takes minutes on the
CPU) runs on the card, as chip_smoke.py's sharded phase also runs it.
"""

import numpy as np
import pytest
import torch

from starky_bn254_tpu_torch import graft_entry, merkle, ntt, xnp
from starky_bn254_tpu_torch.scripts import (bench_hashers, bench_kernels, heavy_standard_config,
                                            profile_prove)
from starky_bn254_tpu_torch.stark import StarkConfig

torch.set_num_threads(1)
CFG = StarkConfig.test_config()


def check_entry():
    fn, (trace,) = graft_entry.entry(device="cpu")
    assert trace.shape == (512, 158) and trace.device.type == "cpu"
    lde = ntt.coset_lde(trace, graft_entry.RATE_BITS)
    want = merkle.build_merkle_tree(lde, graft_entry.CAP_HEIGHT, "poseidon").cap
    assert torch.equal(fn(trace), want)


def check_profile_prove():
    rec = profile_prove.run(1, CFG, device="cpu")
    assert rec["instrumented_s"] > 0 and rec["device"] == "cpu"
    assert rec["first_s"] == rec["warm_s"] > 0  # one prove on the CPU
    assert {"merkle.build_tree", "composition.eval", "fri.grind"} <= set(rec["functions"])
    assert [c["name"] for c in rec["phases"]["children"]][0] == "trace commit"


def check_heavy_standard_config():
    rec = heavy_standard_config.run("g2", 1, CFG, device="cpu")
    assert rec["detail"]["rows"] == 512 and rec["detail"]["device"] == "cpu"
    assert rec["detail"]["prove_first_s"] == rec["value"] > 0  # one prove on the CPU


def check_bench_kernels():
    out = bench_kernels.run(8, 16, device="cpu", reps=1)
    assert [r["name"].split()[0] for r in out["rows"]] == ["poseidon", "ntt", "fri", "commit"]
    assert all(r["ms"] > 0 and "bound_ms" not in r for r in out["rows"])  # no bound off the card


def check_bench_hashers():
    recs = bench_hashers.run(8, 16, device="cpu", reps=1)
    assert [r["hasher"] for r in recs] == ["keccak", "poseidon"]


CHECKS = [check_entry, check_profile_prove, check_heavy_standard_config, check_bench_kernels,
          check_bench_hashers]


@pytest.mark.parametrize("check", CHECKS, ids=[c.__name__[len("check_"):] for c in CHECKS])
def test_script_runs_on_the_cpu(check):
    check()


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card():
    """The whole dry run, its G1ExpAir(16) prove included, over 8 shards of
    one card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    out = graft_entry.dryrun_multichip(8, device="cuda:0")
    assert out["g1_exp_16"] == [8192, 1229]
    assert np.array_equal(xnp.to_numpy(graft_entry.entry()[0](graft_entry.entry()[1][0])),
                          xnp.to_numpy(graft_entry.entry(device="cpu")[0](
                              graft_entry.entry(device="cpu")[1][0])))
