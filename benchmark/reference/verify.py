"""Judge a proof as a verifier receives it: its bytes, against the
configuration's statement and STARK config, with the frozen verifier, and
its public cells against the statement's exact arithmetic."""

from __future__ import annotations

import functools
import importlib
import json

from .frozen.stark.config import StarkConfig
from .frozen.stark.proof import proof_from_bytes
from .frozen.stark.verifier import verify


def stark_config(spec: dict) -> StarkConfig:
    """The config a configuration file names: a preset and its arguments."""
    return getattr(StarkConfig, spec["preset"])(**spec.get("args", {}))


def parse(proof_bytes: bytes):
    return proof_from_bytes(proof_bytes)


def rejection(air, proof, cfg: StarkConfig) -> str | None:
    """None when the frozen verifier accepts the proof, else why not (any
    failure to check it is a rejection)."""
    try:
        verify(air, proof, cfg)
    except Exception as e:  # a malformed proof fails on its way through
        return f"{type(e).__name__}: {e}"
    return None


@functools.lru_cache(maxsize=None)
def _statement(kind: str, statement_json: str, stark_json: str):
    ref = importlib.import_module(f"{__package__}.{kind}")
    return ref, ref.air(json.loads(statement_json)), stark_config(json.loads(stark_json))


def check(kind: str, statement: dict, stark: dict, inputs: list, proof_bytes: bytes):
    """(instances whose public cells differ from reference/<kind>.py's
    exact arithmetic, why the frozen verifier rejects the proof or None)
    for one request's inputs and proof bytes."""
    ref, air, cfg = _statement(kind, json.dumps(statement, sort_keys=True),
                               json.dumps(stark, sort_keys=True))
    try:
        proof = parse(proof_bytes)
    except Exception as e:  # bytes no verifier can read
        return len(inputs), f"unreadable proof: {type(e).__name__}: {e}"
    return ref.wrong_outputs(inputs, proof.public_inputs), rejection(air, proof, cfg)
