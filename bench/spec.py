"""Where the benchmark finds its parts, by name, under one root (the root
of a checkout: BENCHMARK.json beside bench/):

    BENCHMARK.json                   cells, configurations, metrics
    bench/configs/<config>.json      one model configuration, as run; its
                                     "model" names
    bench/models/<model>.py          all that is model-specific: the
                                     reference's view of the file, the
                                     program's config, weights and HCCS
                                     constants, the reference's logits, the
                                     CPU test sizes and the work counts
    bench/reference/<model>.py       its plain reference, which imports
                                     nothing of the program or the harness
    bench/traffic/<mix>.json         one traffic mix; its "kind" names
    bench/generators/<kind>.py       the generator that reads it
    bench/cells/<cell>.json          a cell's own settings: the limits of
                                     its correctness check, engine overrides
    bench/metrics/<metric>.py        one per-layer metric's reader, read(ctx)

A new cell, configuration, model, mix or metric is new files and a new
entry; nothing here changes."""
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

    def model(self, conf: dict):
        """The model module that the configuration file `conf` names under
        "model": bench/models/<model>.py."""
        if "model" not in conf:
            raise ValueError(f"configuration {conf.get('name')!r} has no "
                             f"key \"model\": it names the file under "
                             f"bench/models/ that runs it")
        name = conf["model"]
        return _module(self.dir / "models" / f"{name}.py",
                       "bench_model_" + name.replace(".", "_")
                       .replace("-", "_"))

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

