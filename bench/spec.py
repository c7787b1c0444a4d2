"""Where the benchmark finds its parts, by name, under one root (the root
of a checkout: BENCHMARK.json beside bench/):

    BENCHMARK.json                   cells, configurations, metrics
    bench/configs/<config>.json      one model configuration, as run
    bench/traffic/<mix>.json         one traffic mix; its "kind" names
    bench/generators/<kind>.py       the generator that reads it
    bench/cells/<cell>.json          a cell's own settings: the limits of
                                     its correctness check, engine overrides
    bench/metrics/<metric>.py        one per-layer metric's reader, read(ctx)

A new cell, configuration, mix or metric is a new file and a new entry;
nothing here changes."""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Bench:
    """BENCHMARK.json and the files it names, under `root`."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.dir = self.root / "bench"
        self.spec = _json(self.root / "BENCHMARK.json")

    def cell(self, name: str) -> dict:
        for c in self.spec["workloads"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no cell {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def mix(self, name: str) -> dict:
        return _json(self.dir / "traffic" / f"{name}.json")

    def cell_settings(self, name: str) -> dict:
        path = self.dir / "cells" / f"{name}.json"
        return _json(path) if path.is_file() else {}

    def generator(self, kind: str):
        return _module(self.dir / "generators" / f"{kind}.py",
                       f"bench_generator_{kind}")

    def metrics(self, cell: str, kind: str) -> list[dict]:
        """The metrics a cell reports: every entry of `kind` ("end_to_end"
        or "per_layer") that lists the cell or lists no cells."""
        return [m for m in self.spec[kind]
                if "workloads" not in m or cell in m["workloads"]]

    def reader(self, metric: str):
        path = self.dir / "metrics" / f"{metric}.py"
        return _module(path, "bench_metric_" + metric.replace(".", "_")
                       .replace("-", "_")).read


def reference_config(conf: dict) -> dict:
    """The reference's view of a configuration file: the published sizes
    under their published names, and the port's settings it serves with."""
    port = conf["port"]
    return dict(
        num_layers=conf["num_hidden_layers"], d_model=conf["hidden_size"],
        num_heads=conf["num_attention_heads"],
        num_kv_heads=conf["num_key_value_heads"],
        head_dim=conf["hidden_size"] // conf["num_attention_heads"],
        d_ff=conf["intermediate_size"], vocab_size=conf["vocab_size"],
        padded_vocab=port["padded_vocab"], rope_theta=conf["rope_theta"],
        num_experts=conf.get("num_local_experts", 0),
        experts_per_token=conf.get("num_experts_per_tok", 0),
        dtype=port["dtype"], hccs_mode=port["hccs_mode"], hccs=conf["hccs"])
