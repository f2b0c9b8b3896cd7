"""Entry points of the port beside the JAX package's __graft_entry__.py: a
one-device step of the flagship path and a multi-shard dry run.

    from starky_bn254_tpu_torch import graft_entry
    fn, args = graft_entry.entry()          # on the current CUDA card
    cap = fn(*args)
    graft_entry.dryrun_multichip(8)         # 8 cards; or device="cuda:0" / "cpu" for 8 shards on one

Both run on the CUDA card unless `device` names another; with no card and
no device they raise.
"""

from __future__ import annotations

import numpy as np
import torch

from . import bn254, ntt, poseidon, xnp
from . import goldilocks as gl
from .parallel import sharded
from .stark.prover import _prove_device

RATE_BITS = 1
CAP_HEIGHT = 4


def commit_root(trace: torch.Tensor) -> torch.Tensor:
    """The fused trace commitment on trace's device: INTT and coset LDE
    (K1), Poseidon leaves (K3), then two-to-one compressions down to the
    cap [2^CAP_HEIGHT, 4]."""
    lde = ntt.lde_from_coeffs(ntt.interpolate_coeffs(trace), RATE_BITS)
    digests = poseidon.hash_or_noop(lde)
    while digests.shape[0] > (1 << CAP_HEIGHT):
        digests = poseidon.compress(digests[0::2], digests[1::2])
    return digests


def entry(device=None):
    """(fn, args): fn is commit_root, args an FqExp-shaped [512, 158] trace
    of words below 2^16 from default_rng(0), on `device` (None: the current
    CUDA card)."""
    rng = np.random.default_rng(0)
    trace = rng.integers(0, 1 << 16, size=(512, 158), dtype=np.uint64)
    return commit_root, (xnp.to_torch(trace, _prove_device(device)),)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """One sharded proving step over make_mesh(n_devices, device=device),
    the JAX package's dry run at its shapes: sharded_commit (column-sharded
    LDE, all_to_all, row-sharded Poseidon leaves, subtree roots
    all_gather-ed), a toy row-sharded composition (a' - a - 1 on column 0,
    halo rows by ppermute) and a sharded arity-4 FRI fold, each held
    against its single-device result; then G1ExpAir(16,
    range_check="logup") proved over the mesh under test_config and
    verified. Returns what ran; raises on any disagreement."""
    from .airs.g1_exp import G1ExpAir
    from .stark import StarkConfig, verify
    from .stark import prove as stark_prove
    from .stark.fri import _fold_step4

    mesh = sharded.make_mesh(n_devices, device=device)
    dev, d = mesh.devices[0], mesh.size
    n_rows = 1 << (max(4 * d, 32) - 1).bit_length()
    rng = np.random.default_rng(1)
    trace = xnp.to_torch(rng.integers(0, 1 << 16, size=(n_rows, 2 * d), dtype=np.uint64), dev)

    lde_rows, tree = sharded.sharded_commit(mesh, trace, RATE_BITS, cap_height=1)
    if tree["cap"].shape[1] != 4 or not torch.equal(xnp.on_device(lde_rows, dev),
                                                    ntt.coset_lde(trace, RATE_BITS)):
        raise AssertionError("dryrun_multichip: the sharded commit's LDE is not the single one")

    def eval_rows(rows, nxt):  # a' - a - 1 on column 0
        return gl.sub(gl.sub(nxt[:, 0], rows[:, 0]), 1)

    blowup = 1 << RATE_BITS
    comp = sharded.sharded_composition(mesh, eval_rows, lde_rows, blowup)
    single = xnp.on_device(lde_rows, dev)
    if not torch.equal(xnp.on_device(comp, dev), eval_rows(single, torch.roll(single, -blowup, 0))):
        raise AssertionError("dryrun_multichip: the sharded composition is not the single one")

    m = n_rows << RATE_BITS
    fold_in = xnp.to_torch(rng.integers(0, 2**63, size=(m, 2)).astype(np.uint64), dev)
    w_m_inv = pow(gl.primitive_root_of_unity(m.bit_length() - 1), gl.P - 2, gl.P)
    s_inv = pow(gl.GENERATOR, gl.P - 2, gl.P)
    folded = sharded.sharded_fri_fold(mesh, fold_in, (3, 5), w_m_inv, s_inv)
    if folded.shape != (m // 4, 2) or not torch.equal(
            xnp.on_device(folded, dev), _fold_step4(fold_in, (3, 5), w_m_inv, s_inv)):
        raise AssertionError("dryrun_multichip: the sharded fold is not _fold_step4's")
    out = dict(mesh=d, devices=[str(x) for x in mesh.devices], lde_rows=list(lde_rows.shape),
               cap=list(tree["cap"].shape), comp=list(comp.shape), fri_fold=list(folded.shape))

    rng2 = np.random.default_rng(5)

    def scalar():
        return int.from_bytes(rng2.bytes(40), "little") % bn254.R_BN

    def point():
        return bn254.g1_mul(bn254.G1_GEN, scalar())

    air = G1ExpAir(16, range_check="logup")
    g1_trace, g1_pi = air.generate_trace_and_pi([(point(), point(), scalar()) for _ in range(16)])
    cfg = StarkConfig.test_config()
    proof = stark_prove(air, g1_trace, g1_pi, cfg, mesh=mesh)
    if verify(air, proof, cfg) is not True:
        raise AssertionError("dryrun_multichip: the sharded G1ExpAir(16) proof was not accepted")
    out["g1_exp_16"] = list(g1_trace.shape)
    print(f"dryrun_multichip ok: {out}", flush=True)
    return out
