"""Each cell of BENCHMARK.json driven through the harness at a small size
on the CPU, through the program's plain kernel versions: the result line
has the contract's keys; a configuration, a model, a mix, a cell and a
per-layer metric added as new files and entries are found by name; and the
measuring path refuses to run without a card."""
import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from bench import harness, spec
from bench import run as run_py
from bench.tests import tiny

ROOT = spec.ROOT
BENCH = spec.Bench()
CELLS = [c["name"] for c in BENCH.spec["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(bench, cell, trace=False, seconds=1.0, seed=2 ** 31 + 11):
    res, lines = harness.run(bench, cell, seed, seconds, trace, "cpu",
                             time.perf_counter(), tiny.sizes(bench, cell))
    return json.loads(json.dumps(res)), lines


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_small(cell, capsys):
    res, lines = run(BENCH, cell)
    capsys.readouterr()
    run_py.emit(res, lines)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == res
    assert err.strip().splitlines()[-len(lines):] == lines
    assert all(k in res for k in KEYS)
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    want = {m["name"] for m in BENCH.metrics(cell, "end_to_end")}
    assert set(res["metrics"]) == want
    for m in res["metrics"].values():
        assert m["value"] > 0 and m["unit"]
    assert set(res["device"]) >= {"platform", "kind", "count",
                                  "memory_peak_bytes"}
    limits = BENCH.cell_settings(cell)["limits"]
    assert set(res["checks"]) == set(limits)
    assert lines == [f"check {k} {c['value']} limit {c['limit']}"
                     for k, c in res["checks"].items()]


def test_traced_run_small(monkeypatch):
    monkeypatch.setattr(harness, "STRETCH_S", 0.3)
    cell = CELLS[0]
    res, _ = run(BENCH, cell, trace=True, seconds=1.5)
    assert res["correct"] is True
    # host spans and counters read; device metrics need the card's trace
    assert {"dispatch_ms", "engine_host_ms", "lane_fill"} <= set(
        res["metrics"])
    assert 0 < res["metrics"]["lane_fill"]["value"] <= 100


def test_additions_are_found_by_name(tmp_path, monkeypatch):
    """A new configuration, mix, cell and per-layer metric: files and
    entries only, in a copy of the benchmark; no existing file changes."""
    monkeypatch.setattr(harness, "STRETCH_S", 0.3)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    b = tmp_path / "bench"
    conf = json.loads((b / "configs" / "granite-3-2b.json").read_text())
    conf["name"] = "granite-3-2b-copy"
    (b / "configs" / "granite-3-2b-copy.json").write_text(json.dumps(conf))
    mix = json.loads((b / "traffic" / "azure-code.json").read_text())
    mix["new_tokens"] = {"dist": "uniform", "low": 2, "high": 3}
    (b / "traffic" / "short-answers.json").write_text(json.dumps(mix))
    (b / "metrics" / "steps_counted.py").write_text(
        "def read(ctx):\n    return float(ctx.host['steps'])\n")
    cell = "granite-3-2b-copy.short-answers"
    (b / "cells" / f"{cell}.json").write_text(
        (b / "cells" / "granite-3-2b.azure-code.json").read_text())
    spec_ = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_["configs"].append(dict(spec_["configs"][0],
                                 name="granite-3-2b-copy",
                                 file="bench/configs/granite-3-2b-copy.json"))
    spec_["workloads"].append(dict(spec_["workloads"][0], name=cell,
                                   config="granite-3-2b-copy",
                                   traffic="short-answers"))
    spec_["per_layer"].append(dict(name="steps_counted", unit="steps",
                                   better="higher", source="program_counter",
                                   layer="engine host", moves="tok_s",
                                   workloads=[cell]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_))
    bench = spec.Bench(tmp_path)
    sizes = tiny.sizes(bench, cell)
    sizes["mix"].pop("new_tokens")
    res, _ = harness.run(bench, cell, 5, 1.5, True, "cpu",
                         time.perf_counter(), sizes)
    assert res["correct"] is True
    assert res["metrics"]["steps_counted"]["value"] > 0
    assert {"dispatch_ms", "lane_fill"} <= set(res["metrics"])
    assert all(p.read_bytes() == data for p, data in before.items())


# a second model module, added as a file: the decoder under another name,
# with its own copy of the plain reference, loaded from beside it
WIDE_HEAD = '''"""The decoder, through its own copy of the reference."""
import importlib.util
from pathlib import Path

from bench.models.decoder import *  # noqa: F401,F403

_at = Path(__file__).resolve().parents[1] / "reference" / "wide_head.py"
_spec = importlib.util.spec_from_file_location("wide_head_reference", _at)
reference = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(reference)


def logits_at(weights, hccs, seqs, rows, cfg, cast=None):
    with reference.full_float32():
        return reference.logits_at(weights, hccs, seqs, rows, cfg, cast)
'''


def test_a_model_is_added_as_files(tmp_path, monkeypatch):
    """A model module, its reference, a configuration naming it (head_dim
    stated: 32 at the small size, not hidden / heads = 16) and a cell:
    files and entries only, in a copy of the benchmark; a traced run is
    correct and reads its metrics; no existing file changes."""
    monkeypatch.setattr(harness, "STRETCH_S", 0.3)
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (tmp_path / "bench").rglob("*")
              if p.is_file()}
    b = tmp_path / "bench"
    (b / "models" / "wide_head.py").write_text(WIDE_HEAD)
    shutil.copy(b / "reference" / "decoder.py",
                b / "reference" / "wide_head.py")
    conf = json.loads((b / "configs" / "granite-3-2b.json").read_text())
    conf.update(name="wide-head", model="wide_head", head_dim=128)
    (b / "configs" / "wide-head.json").write_text(json.dumps(conf))
    cell = "wide-head.azure-code"
    (b / "cells" / f"{cell}.json").write_text(
        (b / "cells" / "granite-3-2b.azure-code.json").read_text())
    spec_ = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec_["configs"].append(dict(spec_["configs"][0], name="wide-head",
                                 file="bench/configs/wide-head.json"))
    spec_["workloads"].append(dict(spec_["workloads"][0], name=cell,
                                   config="wide-head"))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec_))
    bench = spec.Bench(tmp_path)
    sizes = tiny.sizes(bench, cell)
    assert (sizes["config"]["head_dim"], sizes["config"]["hidden_size"]
            // sizes["config"]["num_attention_heads"]) == (32, 16)
    res, _ = harness.run(bench, cell, 2 ** 31 + 5, 1.5, True, "cpu",
                         time.perf_counter(), sizes)
    assert res["correct"] is True, res["checks"]
    assert {"mfu", "lane_fill"} <= set(res["metrics"])
    assert all(p.read_bytes() == data for p, data in before.items())


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the refusal is not reachable")
    out = subprocess.run(
        [sys.executable, str(ROOT / "bench" / "run.py"), "--workload",
         CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert not out.stdout.strip()
    assert "CUDA" in out.stderr
