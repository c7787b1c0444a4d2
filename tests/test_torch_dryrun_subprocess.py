"""The port's dry-run and collective inspection as a user runs them, in
subprocesses over a fake (4, 2) process group (twin of the mini cells of
tests/test_dryrun_roofline.py): two mini dry-run cells at full depth and
inspect_hlo's collective breakdown. A subprocess keeps the fake process
group out of the test process; each runs one torch thread, as the test
processes do (tests/torch_threads.py).
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import roofline as RL

ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------- mini dry-runs --

# useful_flops_ratio = model_flops / (chips * FLOPs per device). The train
# cell's ceiling is 6/8: remat="full" recomputes the forward (2+2+4 N D per
# token against the model's 6 N D). Its floor: every matrix product
# replicated over the 2-way model axis (half the ceiling) and the experts'
# capacity factor 1.25 padding their products gives 0.30; 0.25 leaves room
# for the router's and attention's products, which 6 N D does not count
# (measured 0.4302). The decode cell has no backward: ceiling
# 1; floor 0.25 for the same replication and the attention and SSD state
# work beside 2 N D (measured 0.6026).
MINI_CELLS = [("granite-moe-1b-a400m", "train_4k", (0.25, 0.75)),
              ("mamba2-1.3b", "decode_32k", (0.25, 1.0))]


@pytest.mark.parametrize("cell", MINI_CELLS, ids=lambda c: c[0])
def test_mini_dryrun_subprocess(cell, tmp_path):
    """The port's dry-run on a fake (4, 2) mesh at full depth, in a
    subprocess so the fake process group cannot leak into this one; the
    cells JAX's twin cannot run (ROADMAP.md section C3). The train cell
    takes about 47 s here, the decode cell about 7 s."""
    arch, shape, (lo, hi) = cell
    env = dict(os.environ, REPRO_MESH="4,2", PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "pod", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    rec = json.load(open(tmp_path / f"{arch}_{shape}_pod.json"))
    assert rec["ok"], rec.get("error")
    assert rec["chips"] == 8 and rec["mesh_shape"] == [4, 2]
    assert rec["flops_per_dev"] > 0 and rec["bytes_per_dev"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert lo <= rec["useful_flops_ratio"] <= hi, rec["useful_flops_ratio"]
    assert rec["memory"]["argument_bytes"] > 0
    assert rec["memory"]["temp_bytes"] > 0


def test_inspect_hlo_prints_the_collective_breakdown():
    """inspect_hlo on a 1-layer granite decode cell of a fake (4, 2) mesh,
    in a subprocess: the header, the total and per-kind rows, then FLOPs,
    bytes and peak temporaries."""
    env = dict(os.environ, REPRO_MESH="4,2", PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.inspect_hlo", "--arch",
         "granite-3-2b", "--shape", "decode_32k", "--layers", "1",
         "--top", "4"], env=env, capture_output=True, text=True,
        timeout=300, cwd=str(ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    out = r.stdout
    assert "== granite-3-2b x decode_32k x pod (L=1, SP=on) ==" in out
    assert "total collective bytes (result shapes):" in out
    kinds = [line.split()[3] for line in out.splitlines()
             if " GiB  x" in line]
    assert kinds and set(kinds) <= set(RL.COLLECTIVES)
    assert "flops " in out and "temp " in out
