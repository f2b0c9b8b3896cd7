"""The frozen yardstick: the bounds it gives at the shapes the port's
kernel table lists, and its count of a prove's launches against what the
port's prover calls today."""

import benchtools  # noqa: F401  (puts the benchmark on sys.path)

import math

import pytest

import work

# (kernel, shape, bound ms) from the port's kernel table (PERF.md, Findings)
NTT = [((131072, 888, False), 2.735), ((65536, 404, True), 0.633), ((131072, 404, False), 1.244),
       ((65536, 390, True), 0.611), ((131072, 390, False), 1.201), ((65536, 4412, True), 6.914),
       ((131072, 4412, False), 13.587)]
POSEIDON = [((131072, 51, 404, 4), 18.756), ((131072, 49, 390, 4), 18.021),
            ((131072, 552, 4412, 4), 203.010), ((262144, 1, 0, 0), 0.736)]
KECCAK = [((131072, 812), 1.751), ((131072, 404), 0.876), ((131072, 4402), 9.449)]


@pytest.mark.parametrize("args, ms", NTT)
def test_ntt_bound(args, ms):
    assert work.ntt_bound(*args)["bound_ms"] == pytest.approx(ms, abs=6e-4)


@pytest.mark.parametrize("args, ms", POSEIDON)
def test_poseidon_bound(args, ms):
    assert work.poseidon_bound(*args)["bound_ms"] == pytest.approx(ms, abs=6e-4)


@pytest.mark.parametrize("args, ms", KECCAK)
def test_keccak_bound(args, ms):
    assert work.keccak_bound(*args)["bound_ms"] == pytest.approx(ms, abs=6e-4)


def test_grind_batch_is_the_tables():
    assert work.grind_bound_ms(_shape(65536, 404, 390), 1) == pytest.approx(0.736, abs=6e-4)


def _shape(rows, trace, aux, pi=7168, **kw):
    args = dict(num_challenges=2, rate_bits=1, cap_height=4, final_poly_bits=7, pow_bits=16)
    args.update(kw)
    return work.ProveShape(rows=rows, trace_cols=trace, aux_cols=aux, public_inputs=pi, **args)


def test_the_cells_leaf_sponges_dominate_k3():
    """At the g1 cell's shape the two leaf sponges are most of K3's bound,
    the Merkle levels and digests the rest."""
    s = _shape(65536, 404, 390)
    total = work.poseidon_bound_ms(s, 1)
    assert 36.7 < total < 40
    assert work.ntt_bound_ms(s) == pytest.approx(0.633 + 1.244 + 0.611 + 1.201 + 0.0067 + 0.0123
                                                 + work.ntt_bound(256, 2, True)["bound_ms"], abs=2e-3)


def test_call_model_matches_the_ports_prover():
    """Every NTT and Poseidon sponge a CPU prove of G1ExpAir(2) makes,
    recorded under the port's entry points, equals work.py's count."""
    import numpy as np

    from inputs import g1_exp
    from starky_bn254_tpu_torch import ntt, poseidon
    from starky_bn254_tpu_torch.airs.g1_exp import G1ExpAir
    from starky_bn254_tpu_torch.stark import StarkConfig, prove

    sponges, transforms = [], []
    sponge, transform = poseidon._sponge, ntt.ntt

    def rec_sponge(state, block, out_words):
        sponges.append((math.prod(block.shape[:-1]), -(-block.shape[-1] // 8), block.shape[-1],
                        out_words))
        return sponge(state, block, out_words)

    def rec_ntt(values, inverse=False):
        transforms.append((values.shape[0], values.shape[1] if values.ndim == 2 else 1, inverse))
        return transform(values, inverse)

    air = G1ExpAir(2, range_check="logup", io_binding="rlc")
    trace, pi = air.generate_trace_and_pi(g1_exp.Maker(5, 2).request(0, 0))
    poseidon._sponge, ntt.ntt = rec_sponge, rec_ntt
    try:
        proof = prove(air, trace, np.asarray(pi), StarkConfig.test_config(), device="cpu")
    finally:
        poseidon._sponge, ntt.ntt = sponge, transform
    s = work.ProveShape(rows=1 << proof.degree_bits, trace_cols=air.num_columns,
                        aux_cols=proof.openings.z_zeta.shape[0], public_inputs=len(pi),
                        num_challenges=2, rate_bits=1, cap_height=1, final_poly_bits=3, pow_bits=4)
    assert transforms == work.ntt_calls(s)
    assert sponges == work.poseidon_calls(s, 0)  # the CPU grind does not go through _sponge


@pytest.mark.parametrize("rows, trace, aux, pi", [(65536, 404, 390, 7168), (8192, 4475, 2668, 7552)],
                         ids=["g1-exp-128", "fq12-exp-16"])
def test_launch_model_matches_the_ports_pass_plan(rows, trace, aux, pi):
    """K1's launches a prove at the cells' shapes: one a pass of the port's
    plan for each NTT call (13 at g1, as the port's counters read on the card)."""
    from starky_bn254_tpu_torch import ntt

    s = _shape(rows, trace, aux, pi=pi)
    planned = sum(len(ntt._pass_plan(n.bit_length() - 1, c)) for n, c, _ in work.ntt_calls(s))
    assert work.ntt_launches(s) == planned
    if rows == 65536:
        assert planned == 13


def test_a_roofline_whose_launches_differ_from_the_model_is_left_out(capsys):
    import readers

    s = _shape(65536, 404, 390)
    record = {"requests": [{"proof": b"x", "shape": dict(rows=65536, trace_cols=404, aux_cols=390,
                                                         public_inputs=7168)}],
              "stark": dict(num_challenges=2, rate_bits=1, cap_height=4, final_poly_bits=7,
                            pow_bits=16, merkle_hash="poseidon"),
              "profile": {"requests": 1, "dropped": {},
                          "kernels": {"ntt_pass_kernel": {"launches": 13, "seconds": 0.01}}}}
    pct = readers.roofline_pct(record, "ntt", readers.K1_NAMES,
                               lambda sh, prof: work.ntt_bound_ms(sh),
                               lambda sh, prof: work.ntt_launches(sh))
    assert pct == pytest.approx(100 * work.ntt_bound_ms(s) / 10)
    record["profile"]["kernels"]["ntt_pass_kernel"]["launches"] = 11  # two calls fused away
    assert readers.roofline_pct(record, "ntt", readers.K1_NAMES,
                                lambda sh, prof: work.ntt_bound_ms(sh),
                                lambda sh, prof: work.ntt_launches(sh)) is None
    assert "11 ntt launches where work.py counts 13" in capsys.readouterr().err
