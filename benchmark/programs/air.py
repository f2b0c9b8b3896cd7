"""The system under test for a configuration whose "program" is "air": the
port's AIR of the configuration's statement, its STARK config, tracegen,
`prove` and `prove_pipelined`, and the launch counters of its hand
kernels. Everything of the port such a cell touches goes through here.

A program module names one entry point of the port; a configuration picks
it by name (configs/<config>.json "program" -> programs/<program>.py), so a
cell of another entry point (a batch, an MSM) comes as a new module with
the same members: Program(config, device, fri_overrides) with tracegen,
prove, prove_stream, timing_tree, proof_bytes, shape, launch_counts and
stark_params."""

from __future__ import annotations

import dataclasses
import importlib

PACKAGE = "starky_bn254_tpu_torch"


def make_stark_config(stark_cls, spec: dict, fri_overrides: dict | None = None):
    """A preset of `stark_cls` with its arguments; fri_overrides replace
    FRI fields (the control's weakened guarantee)."""
    cfg = getattr(stark_cls, spec["preset"])(**spec.get("args", {}))
    if fri_overrides:
        cfg = dataclasses.replace(cfg, fri=dataclasses.replace(cfg.fri, **fri_overrides))
    return cfg


class Program:
    def __init__(self, config: dict, device, fri_overrides: dict | None = None):
        stark = importlib.import_module(f"{PACKAGE}.stark")
        self.bn254 = importlib.import_module(f"{PACKAGE}.bn254")
        st = config["statement"]
        air_cls = getattr(importlib.import_module(f"{PACKAGE}.airs.{st['module']}"), st["air"])
        self.air = air_cls(st["num_io"], range_check=st["range_check"], io_binding=st["io_binding"])
        self.cfg = make_stark_config(stark.StarkConfig, config["stark"], fri_overrides)
        self.device = device
        self._stark = stark
        self._kernels = [importlib.import_module(f"{PACKAGE}.{m}") for m in ("ntt", "poseidon", "keccak")]

    def tracegen(self, inputs):
        return self.air.generate_trace_and_pi(inputs)

    def prove(self, trace, pi, timing=None):
        return self._stark.prove(self.air, trace, pi, self.cfg, timing=timing, device=self.device)

    def prove_stream(self, batches: list, on_proof) -> list:
        return self._stark.prove_pipelined(self.air, batches, self.cfg, on_proof=on_proof,
                                           device=self.device)

    def timing_tree(self):
        from starky_bn254_tpu_torch.utils.timing import TimingTree

        return TimingTree("prove", self.device)

    def proof_bytes(self, proof) -> bytes:
        return self._stark.proof_to_bytes(proof)

    @staticmethod
    def shape(proof) -> dict:
        """What fixes a prove's kernel work, read off its proof."""
        z = proof.openings.z_zeta
        return dict(rows=1 << proof.degree_bits, trace_cols=int(proof.openings.trace_zeta.shape[0]),
                    aux_cols=0 if z is None else int(z.shape[0]),
                    public_inputs=int(proof.public_inputs.shape[0]))

    def launch_counts(self) -> dict[str, int]:
        """K1 (ntt), K3 (poseidon) and K2 (keccak) launches so far."""
        return {m.__name__.rsplit(".", 1)[1]: m.LAUNCHES for m in self._kernels}

    def stark_params(self) -> dict:
        f = self.cfg.fri
        return dict(num_challenges=self.cfg.num_challenges, rate_bits=f.rate_bits,
                    cap_height=f.cap_height, final_poly_bits=f.final_poly_bits,
                    pow_bits=f.proof_of_work_bits, merkle_hash=f.merkle_hash)
