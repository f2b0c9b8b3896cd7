"""Finds a cell's pieces by name and turns one run into its result line.

BENCHMARK.json names each cell's configuration and traffic mix and each
metric; the pieces are files found by those names:

    configs/<config>.json     the statement, its STARK config, its program and makers
    programs/<program>.py     the port's entry point the configuration names
    inputs/<inputs>.py        the statement maker the configuration names
    reference/<reference>.py  the plain reference the configuration names
    traffic/<traffic>.json    the parameters the one generator (generator.py) reads
    loops/<loop>.py           the loop the traffic mix names
    metrics/<metric>.py       one reader per metric: read(record) -> value or None

so a configuration, an entry point, a traffic mix, a loop, a cell or a
metric is added by adding files and entries alone."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    def __init__(self, bench: dict, name: str, here: str = HERE):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json (have: {sorted(cells)})")
        spec = cells[name]
        self.name = name
        self.chips = spec["chips"]
        configs = {c["name"]: c for c in bench["configs"]}
        root = os.path.dirname(here)
        self.config = load_json(os.path.join(root, configs[spec["config"]]["file"]))
        self.traffic = load_json(os.path.join(here, "traffic", spec["traffic"] + ".json"))
        self.end_to_end = [m for m in bench["end_to_end"] if self._mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if self._mine(m)]
        self.here = here

    def _mine(self, metric: dict) -> bool:
        return self.name in metric.get("workloads", [self.name])

    def maker(self):
        mod = importlib.import_module(f"inputs.{self.config['inputs']}")
        return mod.Maker, mod.program_form

    def reader(self, metric: str):
        path = os.path.join(self.here, "metrics", metric + ".py")
        spec = importlib.util.spec_from_file_location("metric_" + re.sub(r"\W", "_", metric), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def metrics(self, record: dict, trace: bool) -> dict:
        out = {}
        for m in (self.per_layer if trace else self.end_to_end):
            value = self.reader(m["name"])(record)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out


FORBIDDEN = ("jax", "jaxlib", "flax", "starky_bn254_tpu")


def forbidden_modules(modules) -> list[str]:
    """Loaded modules whose top-level name (up to the first dot, compared
    whole) is JAX's, Flax's or the JAX package's."""
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)
