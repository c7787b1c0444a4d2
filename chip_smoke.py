#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py                 # every phase, one CUDA card
    python3 chip_smoke.py --phases 1,2,3,6,7,11,12,13   # the kernel checks
    python3 chip_smoke.py --phases 1,2,24,25,26,27       # calibrate, train
    python3 chip_smoke.py --phases 1,2,28,29,30          # MoE, SSM, encoder
    python3 chip_smoke.py --phases 1,31,32,33   # hot buffer, mesh, dry-run
    python3 chip_smoke.py --phases 1,2,34       # the four examples

Builds the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version on the card, drives the port's
serving paths — greedy serving of granite-3-2b at full width (40 layers,
bf16 weights from a seed) through the packed and the lockstep PagedEngine,
the ContinuousEngine and the wave ServeEngine, and of the MoE, SSM and
hybrid families; the encoder and embedding-input families' training — and
its standalone kernel
entry point `repro_torch.kernels` at granite's full attention width and the
paper's Table III shapes, and checks that each path really ran its kernels.
Phases, in order:

  1 device      the card's name and power limit; fails without CUDA
  2 build       nvcc build time, registers, spills and shared memory per
                kernel
  3 kernel      hccs_packed_prefill against hccs_packed_prefill_ref at
                granite's shapes, every width of the engine's ladder, every
                mode / static_max / pool dtype, exact and random inputs, and
                pools of 256-key blocks (split boundaries inside blocks);
                each case also bit for bit (output, q_int) against the
                split sweep run per token; times per call, device-only
                warm and L2-cold; the cells' packed steps (tiled) and
                all-decode steps (the split sweep, not slower than it)
  4 forward     one packed step of granite (2 layers, f32), card against CPU
  5 engine      packed PagedEngine: granite, 40 layers, bf16, 8 requests x 32
                new tokens, twice, then once profiled
  6 kernel      hccs_paged_decode against hccs_paged_decode_ref (8 slots,
                frontiers 0-2048 and at the split boundaries, f32/bf16/int8
                pools, a sentinel block inside a frontier); times as
                phase 3's
  7 kernel      hccs_decode against hccs_decode_ref (8 slots, frontiers
                0-2048, f32/bf16 arenas, an arena of odd length, frontiers
                at the split boundaries); times as phase 3's
  8 lockstep    lockstep PagedEngine on phase 5's requests, twice, then
                once profiled; its tokens held to phase 5's by the near-tie
                rule (ROADMAP C1: every request's first divergence must be
                a near tie of the model's logits and of both paths' own
                logits, tapped on the profiled runs)
  9 continuous  ContinuousEngine on phase 5's requests, the same way
 10 wave        ServeEngine on 8 requests of 512 prompt tokens, the same
                way, held to the packed engine on the same requests
 11 rows        hccs_rows against hccs_rows_ref, four modes: the paper's
                4096 x 32/64/128, granite's 65,536 x 2048 attention rows
                with per-head feasible theta, C = 2047, degenerate rows,
                and peaked rows over the i8 range; bit-identical
 12 softmax     softmax_bf16 against softmax_bf16_ref and torch.softmax,
                bf16 and f32, at the same shapes
 13 fused       hccs_mha_fused against hccs_mha_fused_ref (granite's full
                prefill attention, B 8 x 512, Tq != Tk, rows past the q_int
                cache so that both variants run, head dims 18-128; causal
                and not; f32 and bf16; exact and random), then against the
                served model's blockwise STE attention at full width
 14 table3      the entry point: Table III through repro_torch.kernels
                (softmax_reference bf16, hccs_softmax i16_div and i8_clb at
                4096 x 32/64/128 and 65,536 x 2048) and hccs_attention at
                granite's full prefill shape; launches counted; the times
                of phases 11-14 (per call, device only warm and L2-cold,
                plain versions, torch.softmax, the blockwise STE
                attention)
 15 fold        paged_quant_scatter_kv (the int8 pools' quantizing write,
                K and V in one launch) against paged_quant_scatter_kv_ref:
                f32/bf16 rows, writes of 8, 64 and 256 rows with the
                engine's pad lanes and fresh blocks, exact and random, in
                one call, split over three, with draft rows, K alone
                (paged_quant_scatter); 4096 rows, past one launch's shared
                memory (folded in slices by the one C call); a 40-layer
                replay in one launch; pools and scales bit-identical; times
                at 8/64/256 rows and the replay; one layer's kernels and
                aten ops at the engine's shapes
 16 sharing     the packed PagedEngine with int8 KV, prefix and decode
                sharing, two turns of 8 sessions on a 512-token system
                prefix: hits, COW, turn 2's skip rate, the int8/f32 byte
                ratio, 40 fold (K and V) and 40 packed launches a step;
                twice, once profiled (no kernel but the fold launched inside
                an int8 write); then sharing off and an f32 pool, each held
                to it
                by the near-tie rule (a later turn after a diverged history
                held to the sharing engine's serving of its own prompt)
 17 grid        the packed PagedEngine without the kernel (the per-slot STE
                grid) on phase 5's requests, profiled once, held to phase 5
                by the near-tie rule
 18 spec        speculative decoding on the packed PagedEngine (int8 KV,
                decode sharing, draft_len 4): phase 16's sessions over 3
                turns of 64 new tokens; drafting on twice, once profiled,
                off once, on with an f32 pool once. Gates: drafted =
                accepted + rejected, >= 1 verify step and rollback, 40
                packed and 40 in-step fold launches a step, 1 replay fold
                launch a verify step, drafting on against off (and f32
                against int8) by the near-tie rule, every request done, and
                one captured verify step's restore and replay byte-identical
                to the same restore and replay through the plain fold
 19 overload    the robust packed PagedEngine (preemption, graceful
                exhaustion, 3 priority classes, a bounded shedding queue,
                deadlines on a fake clock, int8, sharing, speculative) on a
                pool small enough that higher classes preempt lower ones;
                the invariants after every step, a drained pool, and every
                preempted request held to a never-preempted run by the
                near-tie rule
 20 chaos       ChaosMonkey(seed=0) over the same engine at full width, 16
                requests: invariants after every step, the pool drained,
                every request done or failed with a reason
 21 async       the pipelined async loop: phase 5's traffic on the packed
                PagedEngine with async_loop, twice, then once profiled
                (tokens identical to phase 5's, steps overlapped, no sync
                fallback, 40 packed launches a step; walls and idle share
                on against off); then phase 16's sessions (int8, sharing)
                the same way (40 fold and 40 packed launches a step), held
                to phase 16's tokens by the near-tie rule
 22 telemetry   Telemetry(enabled=True) on phase 5's traffic, sync and
                async: phase coverage >= 0.9, tokens identical to
                telemetry off, the Chrome trace parses line by line; each
                phase's total and share, TTFT / TPOT / E2E p50 and p95, the
                `device` phase against the profiled device busy time; then
                drive_open_loop at 2 requests/s
 23 sampling    phase 5's traffic at temperature 0.8 on the packed engine:
                every sampled batch landed and drawn again by the CPU path
                (the count of tokens that differ, each a tie on the CPU);
                an async run of it falls back to the sync step every step
                with identical tokens
 24 calibrate   offline per-head calibration at full width: granite
                with softmax captures its attention logits on 2 LM batches
                of 2 x 256 tokens, 64 rows a head, scales amax / 127,
                calibrate_heads(per_head, i16_div) over the 589 feasible
                theta through the hccs_rows kernel (launches counted);
                8 heads redone on the CPU must pick the card's theta (or
                tie its KL)
 25 train       QAT with theta frozen at full width: HCCS with the
                calibrated theta, remat on, 4 AdamW steps of 4 x 512 LM
                tokens through make_train_step and train_loop, then 2 with
                int8 gradient compression; finite losses, weights moved,
                theta unchanged bit for bit, peak memory; one step at 2
                layers against the CPU path (loss, gradients, update)
 26 checkpoint  at 2 layers: save at step 2, restore bit for bit, resume;
                the resumed losses equal the uninterrupted run's within
                the card's run-to-run spread
 27 serve       the trained, calibrated model serves 4 requests x 16 new
                tokens through the packed PagedEngine (40 packed launches
                a step)
 28 moe         granite-moe-1b-a400m at full width and depth (24 layers,
                32 experts top 8, capacity 1.25, bf16, seed 0) on phase
                5's traffic: the packed PagedEngine (twice, then profiled:
                busy, idle share, the share of busy inside apply_moe),
                the lockstep PagedEngine and the ContinuousEngine (twice
                each), 24 launches of the path's kernel a step, identical
                tokens run to run; drop-free (capacity 8.0) on phase 10's
                one wave, packed against wave by the near-tie rule
 29 ssm         mamba2-1.3b and hymba-1.5b at full width and depth through
                the wave ServeEngine (4 x 256 prompt tokens, 16 new, twice;
                no HCCS kernel: hymba's window blocks them); served tokens
                held to the teacher-forced forward by the near-tie rule,
                prefill + decode against the forward, layer 0's chunked
                SSD against its recurrent step
 30 encoder     bert-small calibrated per head on hccs_rows (counted), then
                12 QAT cls_loss steps (finite, falling, theta frozen);
                qwen2-vl-2b (M-RoPE over an image grid) and musicgen-large
                (embedding inputs) at full width cut to 4 layers: one
                forward and one train step each
 31 hot         granite-3-2b at full width on the wave ServeEngine, 8 x 512
                prompt tokens and 32 new, with a 32-row hot buffer and
                without it (both the STE attention, no kernel launched),
                held to each other by the near-tie rule
 32 mesh        a one-card (1, 1) DeviceMesh, NCCL at world size 1 (store
                on localhost): granite's bf16 weights distributed under
                DEFAULT_RULES, one prefill and 8 decode steps of 4 x 128
                tokens as DTensors; tokens equal to the unsharded run's,
                the largest logit difference printed
 33 dryrun      the dry-run of granite-3-2b x decode_32k on the (16, 16)
                mesh over a fake process group, on the host, without and
                with a 32-row hot buffer: roofline terms beside the card's
                name and power limit
 34 examples    the four examples (examples/torch_*.py) through their
                own main() at the JAX scripts' defaults: the calibration
                study (hccs_rows counted) against the same study through
                the plain versions on the host; quickstart (hccs_rows
                counted, its accuracy triple); train_lm at its defaults,
                then stopped at 100 and resumed to 150 (the resume logged,
                the loss below the run's start); serving (no decode
                kernel: the STE path; the wave and continuous engines'
                greedy tokens held to the paged engine's by the near-tie
                rule; tokens/s); then quickstart's stages on bert-small
                at full size (ClsTask at vocab 30522 and seq 128, 80
                float and 40 QAT steps at batch 32): Table I's baseline /
                no-retrain / retrained
 35 report      one JSON line per the kernel table
 36 hybrid      granite-4.0-h-micro's Mamba-2 scan (kernels/ssd.py) at full
                width against its plain version (fresh and continued
                segments of 1-130 tokens, an idle slot, pad lanes; f32
                and bf16) and timed at the benchmark cell's step; then the
                model at full depth on the packed PagedEngine: a profiled
                all-decode step at 4 and at 256 live slots launches as
                many kernels inside every `repro.ssm` range

The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero before it. `--phases` runs a subset (for bring-up).
"""
from __future__ import annotations

import argparse
import bisect
import collections
import contextlib
import dataclasses
import importlib.util
import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import kernels as KAPI  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.checkpoint.manager import _flatten as ckpt_flatten  # noqa
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.core.calibrate import _head_inputs as head_inputs  # noqa
from repro_torch.core.calibrate import _kl_for_grid as kl_for_grid  # noqa
from repro_torch.core.calibrate import (calibrate_heads,  # noqa: E402
                                        calibrate_rows,
                                        collect_attention_logits)
from repro_torch.core.constraints import (default_params,  # noqa: E402
                                          feasible_grid, validate_params)
from repro_torch.data import (ClsTask, ClsTaskConfig,  # noqa: E402
                              LMStream, LMStreamConfig,
                              make_embedding_batch)
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.attention import (fused_plan,  # noqa: E402
                                           fused_smem_bytes, hccs_mha_fused,
                                           hccs_mha_fused_ref, mha_qint)
from repro_torch.kernels.decode import (SPLIT_KEYS,  # noqa: E402
                                        SPLIT_SWEEP_TOKENS, TILE_ROWS,
                                        decode_qint, hccs_decode,
                                        hccs_decode_ref, hccs_packed_prefill,
                                        hccs_packed_prefill_ref,
                                        hccs_paged_decode,
                                        hccs_paged_decode_ref, packed_qint,
                                        paged_qint, split_count,
                                        split_smem_bytes, tile_tokens,
                                        tiled_smem_bytes, uses_tiles,
                                        workspace_bytes)
from repro_torch.kernels.hccs import hccs_rows, hccs_rows_ref  # noqa: E402
from repro_torch.kernels.kv_quant import (  # noqa: E402
    MAX_SMEM_BYTES, fold_smem_bytes, paged_quant_scatter,
    paged_quant_scatter_kv, paged_quant_scatter_kv_ref,
    paged_quant_scatter_ref)
from repro_torch.kernels.softmax_bf16 import (softmax_bf16,  # noqa: E402
                                              softmax_bf16_ref)
from repro_torch.kernels.ssd import (ssd_packed_scan,  # noqa: E402
                                     ssd_packed_scan_ref)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import moe as moe_module  # noqa: E402
from repro_torch.models import ssm as ssm_module  # noqa: E402
from repro_torch.models.attention import (  # noqa: E402
    _blockwise_attention, capture_attention_logits)
from repro_torch.optim import adamw  # noqa: E402
from repro_torch.serve import (AdmissionConfig,  # noqa: E402
                               ChaosMonkey, ContinuousEngine, ServeEngine,
                               Telemetry, assert_drained, check_invariants,
                               drive_open_loop, prng)
from repro_torch.serve import continuous as serve_continuous  # noqa: E402
from repro_torch.serve import engine as serve_engine  # noqa: E402
from repro_torch.serve import paged as serve_paged  # noqa: E402
from repro_torch.serve.engine import (kv_cache_byte_stats,  # noqa: E402
                                      sample_tokens)
from repro_torch.serve.paged import (PagedEngine, Request,  # noqa: E402
                                     pack_slot_ids, packed_write_positions,
                                     schedule_step_tokens)
from repro_torch.train import (make_train_step,  # noqa: E402
                               train_loop, train_state_from_params)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
# granite-3-2b attention geometry and the engine's smoke configuration
H, HKV, D, BS = 32, 8, 64, 32
# granite-moe-1b-a400m's heads (phase 28): a GQA group of 2 where granite
# has 4, held to the plain versions in phases 3, 6 and 7
MOE_HEADS = (16, 8)
MAX_BATCH, MAX_LEN = 8, 2048
NBLK = MAX_LEN // BS
WIDTHS = (8, 64, 128, 256)       # the engine's ladder at max_batch 8
# Gates, set from the first run on an H100 80GB HBM3 at 700 W (PR 11; see
# PERF.md): random inputs gave 0 flipped bins of up to 11.9M live logits
# and max |d| 4.8e-7; phase 4 gave max |dlogit| 1.2e-3 with top-1 agreeing
# on all 243 lanes. A flip is a legitimate outcome of the summation order,
# hence a small allowance; the float gates are ~10x the measurement.
RANDOM_MAX_ERR_NO_FLIP = 5e-6    # |out| difference on rows with no flip
RANDOM_FLIP_FRACTION = 1e-6      # flipped int8 bins / live logits
FWD_MAX_LOGIT_ERR = 1e-2         # phase 4, |logit| difference
FWD_TOP1_AGREE = 0.99            # phase 4, top-1 agreement over live lanes


CARD = "not read"                # nvidia-smi's name and power limit (phase 1)


def log(*a):
    print(*a, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    """The least time (ms) the card could take to move `nbytes` and do
    `ops` operations at the f32 CUDA-core rate, and which of the two
    bounds it."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_FLOPS * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


L2_FLUSH_BYTES = 128 << 20      # written before each L2-cold call (L2: 50 MB)


def graph_time_ms(fn, calls: int = 20, replays: int = 10) -> float:
    """Device time of one call of `fn`: `calls` calls captured in a CUDA
    graph, replayed `replays` times after one warm-up replay, timed with
    CUDA events. The host's per-call cost (argument checks, ctypes,
    dispatch), which cuda_time_ms includes, drops out."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (calls * replays)


def cold_time_ms(fn, calls: int = 20, replays: int = 5) -> float:
    """Device time of one call of `fn` that finds the L2 cache cold: CUDA
    graphs of `calls` x (write L2_FLUSH_BYTES, then fn) and of the writes
    alone, the difference per call. The writes evict every line fn would
    otherwise find in the 50 MB L2."""
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32,
                      device="cuda")

    def flush():
        buf.fill_(1.0)

    def both():
        flush()
        fn()
    return graph_time_ms(both, calls, replays) - graph_time_ms(
        flush, calls, replays)


# the split and tiled sweeps' kernels (csrc/hccs_split.cuh, hccs_tiled.cuh),
# one symbol per pass
SPLIT_PASSES = {"split_qk_kernel": "pass1", "split_pv_kernel": "pass2",
                "split_fused_kernel": "fused", "split_combine_kernel": "pass3",
                "tile_list_kernel": "tiles", "tiled_qk_kernel": "pass1",
                "tiled_pv_kernel": "pass2", "tiled_fused_kernel": "fused"}


def kernel_passes(fn, calls: int = 10) -> str:
    """The kernels one call of `fn` runs on the card and the mean device
    time of each (the split sweep's pass 1, pass 2 or fused pass, and pass
    3), by torch.profiler's CUDA events over `calls` calls. After a long
    profiled engine run the profiler may deliver only some of a short
    run's events; each mean is over the events it delivered, and the line
    says how many. (The gaps between kernels under the profiler are its
    own, not the call's: see device_ms.)"""
    times = pass_times(fn, calls)
    if not times:
        return "no device events: per-kernel times not measured"
    parts = [f"{name} {sum(us) / len(us):.1f} us" for name, us in
             times.items()]
    n = sum(len(us) for us in times.values())
    return (f"{len(times)} kernel(s) a call: {', '.join(parts)} ({n} "
            f"events of {calls} calls)")


def pass_times(fn, calls: int = 10) -> dict[str, list[float]]:
    """kernel_passes' device times (us) by kernel, in order of first
    launch: the passes by their SPLIT_PASSES names, the tiled ones with
    /narrow or /wide."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def short(name):
        narrow = ", true," in name or "Lb1E" in name
        name = name.replace("(anonymous namespace)::", "")
        name = name.replace("void ", "").split("<")[0].split("(")[0]
        name = name.split("::")[-1]
        tiled = name.startswith("tiled_")
        name = SPLIT_PASSES.get(name, name)
        return f"{name}/{'narrow' if narrow else 'wide'}" if tiled else name
    times: dict[str, list[float]] = {}
    for e in sorted(device_events(prof), key=lambda e: e.start):
        times.setdefault(short(e.name), []).append(e.end - e.start)
    return times


def kernel_times(fn, plain) -> dict:
    """A kernel wrapper's times at one shape: per call with the host path
    (CUDA events over back-to-back calls, K/V warm in L2), device only
    (CUDA graph), device only with L2 flushed before each call; the
    plain version's per-call time; and the kernels of a call."""
    return dict(ms=cuda_time_ms(fn), device_ms=graph_time_ms(fn),
                cold_ms=cold_time_ms(fn),
                plain_ms=cuda_time_ms(plain, iters=5),
                passes=kernel_passes(fn))


def times_text(tm) -> str:
    return (f"kernel {tm['ms']:.4f} ms per call, device {tm['device_ms']:.4f}"
            f" ms warm / {tm['cold_ms']:.4f} ms L2-cold, plain "
            f"{tm['plain_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms "
            f"({tm['bound_by']}: {tm['bytes'] / 1e6:.2f} MB, "
            f"{tm['flops'] / 1e9:.3f} GFLOP); {tm['passes']}")


# ---------------------------------------------------------------- phase 1 --

def phase_device():
    if not torch.cuda.is_available():
        raise PhaseFailed("torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    global CARD
    CARD = card
    log(card)
    log(f"[device] {torch.cuda.get_device_name(0)}, "
        f"{torch.cuda.device_count()} card(s), torch {torch.__version__}, "
        f"cuda {torch.version.cuda}; matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}")
    return card


# ---------------------------------------------------------------- phase 2 --

def phase_build():
    t0 = time.perf_counter()
    kbuild.load_library()
    dt = time.perf_counter() - t0
    log(f"[build] {dt:.2f}s (nvcc {kbuild.build_log['seconds']:.2f}s"
        f"{', cached' if kbuild.build_log['cached'] else ''})")
    fn, spill = "", ""
    for line in kbuild.build_log["ptxas"].splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            log(f"[build] {fn}: {line.split(':', 1)[-1].strip()}; {spill}")
    g = H // HKV
    split = [" / ".join(str(split_smem_bytes(g, D, e, static))
                        for e in (4, 2, 1)) for static in (False, True)]
    log(f"[build] dynamic shared memory per block at granite shapes, split "
        f"sweep (paged, arena), f32 / bf16 / int8 K/V: "
        f"{split[0]} B (passes 1-2), {split[1]} B (static_max pass); "
        f"tiled sweep (packed, any pool) {tiled_smem_bytes(D, False)} B "
        f"(passes 1-2), {tiled_smem_bytes(D, True)} B (static_max pass), "
        f"{TILE_ROWS} rows a tile ({tile_tokens(g)} tokens at granite, "
        f"{tile_tokens(MOE_HEADS[0] // MOE_HEADS[1])} at granite-moe); "
        f"{SPLIT_KEYS}-key splits, "
        f"{split_count(MAX_LEN)} a {MAX_LEN}-key row; workspace of a decode "
        f"step {workspace_bytes(MAX_BATCH, H, MAX_LEN, D, qint_scratch=True)}"
        f" B, of a width-256 packed step "
        f"{workspace_bytes(256, H, MAX_LEN, D, qint_scratch=True, tiles=True)}"
        f" B")
    # the fused kernel's shared memory: the Python mirror against the C
    # formula, and the variant each of phase 13's shapes runs
    lib = kbuild.load_library()
    for d in (1, 20, 32, 64, 96, 128):
        for elem in (4, 2):
            for nk in (1, 64, 65, 2048, 2752, 8192):
                for cache in (True, False):
                    c = lib.hccs_fused_smem_bytes(d, elem, nk, int(cache))
                    py = fused_smem_bytes(d, elem, nk, cache)
                    check(c == py, f"fused_smem_bytes({d}, {elem}, {nk}, "
                          f"{cache}): C {c} != Python {py}")
    plans = {f"Tq {tq} Tk {tk} {'causal' if causal else 'full'}":
             fused_plan(tq, tk, D, 4, causal)
             for tq, tk, causal in ((MAX_LEN, MAX_LEN, True),
                                    (FUSED_LONG[1], FUSED_LONG[2], True),
                                    (FUSED_LONG[1], FUSED_LONG[2], False),
                                    (FUSED_DEEP, FUSED_DEEP, True))}
    log("[build] fused kernel, f32, d 64: " + "; ".join(
        f"{k}: {'q_int cached' if c else 'QK recomputed'}, {b} B"
        for k, (c, b) in plans.items()) + " (C and Python formulas agree)")


# ---------------------------------------------------------------- phase 3 --

def make_case(width: int, pool_dtype, exact: bool, seed: int, bs: int = BS,
              heads: tuple[int, int] = (H, HKV)):
    """Granite-shaped kernel inputs on the card (`heads` = query heads, KV
    heads): 8 slots with frontiers from 1 to 2048 in a shuffled pool of
    `bs`-key blocks, one packed step of width `width` laid out by the
    engine's own scheduler (prefill chunks + decode lanes + pads), one
    sentinel entry inside a live frontier and sentinels past every
    frontier."""
    h, hkv = heads
    rng = np.random.default_rng(seed)
    fronts = np.array([2048, 1024, 777, 1500, 33, 100, 511, 1])
    remaining = {8: [0] * 8, 64: [50] + [0] * 7,
                 128: [60, 50] + [0] * 6,
                 256: [300, 100, 40] + [0] * 5}[width]
    t_valid = schedule_step_tokens(np.ones(8, bool), np.asarray(remaining),
                                   width, 4 * BS)
    sid, off = pack_slot_ids(t_valid, width)
    lens = np.zeros(width, np.int32)
    for s in range(8):
        tv = int(t_valid[s])
        lens[off[s]:off[s] + tv] = fronts[s] - tv + 1 + np.arange(tv)
    n_blocks = 1 + int(sum(-(-f // bs) for f in fronts))
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.full((MAX_BATCH, MAX_LEN // bs), -1, np.int32)
    c = 0
    for s, f in enumerate(fronts):
        nb = -(-f // bs)
        table[s, :nb] = perm[c:c + nb]
        c += nb
    table[3, 5] = -1                          # a sentinel inside a frontier
    shape = (n_blocks, hkv, bs, D)
    if exact:                                 # multiples of 2^-3: exact f32
        q = rng.integers(-8, 9, (width, h, D)) / 8.0
        k = rng.integers(-8, 9, shape) / 8.0
        v = rng.integers(-8, 9, shape) / 8.0
        scale = rng.uniform(0.007, 0.013, h)
    else:
        q = rng.normal(0, 1, (width, h, D))
        k = rng.normal(0, 1, shape)
        v = rng.normal(0, 1, shape)
        scale = rng.uniform(0.005, 0.02, h)
    theta = np.stack([rng.integers(120, 200, h), rng.integers(0, 2, h),
                      rng.integers(16, 100, h)], -1)     # s = B - S*d > 0
    dev = "cuda"
    ks = vs = None
    if pool_dtype == torch.int8:
        # int8 payload with per-(block, kv-head) scales; exact inputs use
        # power-of-two scales so the dequantized values stay exact
        kq = np.clip(np.round(k * 8), -127, 127)
        vq = np.clip(np.round(v * 8), -127, 127)
        sc = (np.full((n_blocks, hkv), 0.125) if exact
              else rng.uniform(0.05, 0.2, (n_blocks, hkv)))
        kp = torch.tensor(kq, dtype=torch.int8, device=dev)
        vp = torch.tensor(vq, dtype=torch.int8, device=dev)
        ks = torch.tensor(sc, dtype=torch.float32, device=dev)
        vs = torch.tensor(sc[::-1].copy(), dtype=torch.float32, device=dev)
    else:
        kp = torch.tensor(k, dtype=torch.float32, device=dev).to(pool_dtype)
        vp = torch.tensor(v, dtype=torch.float32, device=dev).to(pool_dtype)
    i32 = (lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev))
    return dict(q=torch.tensor(q, dtype=torch.float32, device=dev),
                k_pool=kp, v_pool=vp, block_table=i32(table),
                slot_ids=i32(sid), lengths=i32(lens),
                scale=torch.tensor(scale, dtype=torch.float32, device=dev),
                theta=i32(theta), k_scales=ks, v_scales=vs)


def bound_of(case) -> tuple[float, str, float, float]:
    """Least time the card could take for this call: each slot's live KV
    rows (up to the largest frontier among its tokens, allocated entries
    only), q and the output moved once, over the HBM rate; against the
    QK and PV flops of every token's live keys over the f32 rate."""
    table = case["block_table"].cpu().numpy()
    sid = case["slot_ids"].cpu().numpy()
    lens = case["lengths"].cpu().numpy()
    elem = case["k_pool"].element_size()
    bs = case["k_pool"].shape[2]
    t = sid.shape[0]
    kv_rows = 0
    live_keys = 0
    for s in np.unique(sid[sid >= 0]):
        top = int(lens[sid == s].max())
        cols = np.arange(top)
        kv_rows += int((table[s, cols // bs] >= 0).sum())
    for i in np.flatnonzero(sid >= 0):
        cols = np.arange(int(lens[i]))
        live_keys += int((table[sid[i], cols // bs] >= 0).sum())
    nbytes = (2 * kv_rows * HKV * D * elem + 2 * t * H * D * 4
              + table.nbytes + 2 * t * 4)
    flops = 2.0 * 2.0 * live_keys * H * D
    return (*bound(nbytes, flops), nbytes, flops)


# pools of 256-key blocks: every split boundary falls inside a block; at a
# width of the split sweep and at one of the tiled sweep (uses_tiles)
WIDE_BLOCKS = ((64, 256), (256, 256))


def per_token_rows(case):
    """hccs_paged_decode's rows for a packed case, one a token: its slot's
    block-table row and its own frontier (pad lanes at length 0)."""
    sid = case["slot_ids"].long()
    table = case["block_table"][sid.clamp(min=0)].contiguous()
    lens = torch.where(sid >= 0, case["lengths"],
                       torch.zeros_like(case["lengths"])).contiguous()
    return table, lens


def split_per_token(case, rows=None, qint_out=None, **kw):
    """The split sweep on a packed case: hccs_paged_decode with one row a
    token (`per_token_rows`, built here unless given), which is what
    hccs_packed_prefill ran at every width before its tiles."""
    table, lens = per_token_rows(case) if rows is None else rows
    return hccs_paged_decode(case["q"], case["k_pool"], case["v_pool"], table,
                             lens, case["scale"], case["theta"],
                             k_scales=case["k_scales"],
                             v_scales=case["v_scales"], qint_out=qint_out,
                             **kw)


def same_bits(a, b) -> bool:
    return a.shape == b.shape and bool(
        (a.contiguous().view(torch.int32) == b.contiguous().view(torch.int32))
        .all()) if a.dtype == torch.float32 else bool((a == b).all())


def check_against_split(case, got, qo, what: str, **kw):
    """The packed kernel's output and q_int (qo, prefilled with -128)
    equal the split sweep's run per token, bit for bit; pad lanes are
    zero."""
    qs = torch.full_like(qo, -128)
    want = split_per_token(case, qint_out=qs, **kw)
    check(same_bits(got, want), f"packed output differs from the split "
          f"sweep's at {what}: max |d| {float((got - want).abs().max())}")
    check(same_bits(qo, qs), f"packed q_int differs from the split sweep's "
          f"at {what}: {int((qo != qs).sum())} of {qo.numel()}")
    check(bool((got[case["slot_ids"] < 0] == 0).all()),
          f"pad lanes not zero at {what}")


def phase_kernel():
    rows = []
    timings = {}
    worst = 0.0
    dtypes = (torch.float32, torch.bfloat16, torch.float16, torch.int8)
    shapes = [(w, BS, d, (H, HKV)) for w in WIDTHS for d in dtypes]
    shapes += [(w, bs, torch.float32, (H, HKV)) for w, bs in WIDE_BLOCKS]
    shapes += [(w, BS, d, MOE_HEADS) for w in (WIDTHS[0], WIDTHS[-1])
               for d in dtypes]
    for width, bs, pool_dtype, heads in shapes:
        for exact in (True, False):
            case = make_case(width, pool_dtype, exact,
                             seed=width * 7 + int(exact)
                             + (heads != (H, HKV)) * 1000, bs=bs,
                             heads=heads)
            for mode in ("wide", "i16_div", "i16_clb"):
                for static_max in (False, True):
                    kw = dict(mode=mode, static_max=static_max)
                    t, h, _ = case["q"].shape
                    qo = torch.full((t, h, NBLK * BS), -128,
                                    dtype=torch.int8, device="cuda")
                    got = hccs_packed_prefill(**case, **kw, qint_out=qo)
                    want = hccs_packed_prefill_ref(**case, **kw)
                    qi, valid = packed_qint(
                        case["q"], case["k_pool"], case["block_table"],
                        case["slot_ids"], case["lengths"], case["scale"],
                        case["k_scales"])
                    torch.cuda.synchronize()
                    live = valid[:, None, :].expand_as(qi)
                    flips = int((qo.int() != qi)[live].sum())
                    n_live = int(live.sum())
                    err = (got - want).abs()
                    flip_rows = ((qo.int() != qi) & live).any(-1)
                    err_clean = float(err[~flip_rows].max()) \
                        if (~flip_rows).any() else 0.0
                    max_err = float(err.max())
                    worst = max(worst, max_err)
                    rel = float((err / want.abs().clamp(min=1e-30))
                                .max()) if exact else float("nan")
                    rows.append((width, bs,
                                 str(pool_dtype).split(".")[-1],
                                 mode, static_max, exact, flips, n_live,
                                 max_err, err_clean, heads))
                    at = f"width {width} bs {bs} heads {heads}"
                    pads = got[case["slot_ids"] < 0]
                    check(bool((pads == 0).all()),
                          f"pad lanes not zero at {at}")
                    check_against_split(case, got, qo, f"{at} {pool_dtype}"
                                        f" {mode} static={static_max} "
                                        f"exact={exact}", **kw)
                    if exact:
                        check(flips == 0 and (max_err == 0.0
                                              or rel <= 1e-6),
                              f"exact case differs: {at} "
                              f"{pool_dtype} {mode} static={static_max}"
                              f" flips={flips} max_err={max_err}")
                    else:
                        check(flips <= RANDOM_FLIP_FRACTION * n_live,
                              f"{flips} bin flips of {n_live} at "
                              f"{at} {pool_dtype} {mode}")
                        check(err_clean <= RANDOM_MAX_ERR_NO_FLIP,
                              f"max |d| {err_clean} on rows without "
                              f"flips, {at} {pool_dtype} {mode}")
                    if (pool_dtype == torch.float32 and mode == "wide"
                            and not static_max and not exact
                            and bs == BS and heads == (H, HKV)):
                        tm = kernel_times(
                            lambda: hccs_packed_prefill(**case, **kw),
                            lambda: hccs_packed_prefill_ref(**case,
                                                            **kw))
                        bound, by, nbytes, flops = bound_of(case)
                        timings[width] = dict(
                            tm, bound_ms=bound, bound_by=by,
                            bytes=nbytes, flops=flops,
                            max_abs_err=max_err)
    log("[kernel] width bs pool mode static exact flips/live max|d| "
        "max|d|(rows w/o flips) heads/kv-heads")
    for r in rows:
        log(f"[kernel] {r[0]:4d} {r[1]:3d} {r[2]:8s} {r[3]:7s} {int(r[4])} "
            f"{int(r[5])} {r[6]}/{r[7]} {r[8]:.3e} {r[9]:.3e} "
            f"{r[10][0]}/{r[10][1]}")
    for w, tm in timings.items():
        # each token reads its slot's live K and V rows: what the kernel
        # moves through L2 when no tile is shared between a slot's tokens
        reads = tm["flops"] / (4 * H * D) * 2 * HKV * D * 4
        log(f"[kernel] timing width {w}: {times_text(tm)}; the tokens' K/V "
            f"reads {reads / 1e6:.1f} MB, {reads / tm['device_ms'] / 1e9:.2f}"
            f" TB/s over the device time")
    log(f"[kernel] every case above: the packed kernel's output and q_int "
        f"(tiled past {SPLIT_SWEEP_TOKENS} lanes, the split sweep at and "
        f"below) bit-identical to the split sweep run per token "
        f"(hccs_paged_decode), pad lanes zero")
    tiled_cells()
    return timings, worst


# the benchmark cells' packed steps (bench/configs, bench/traffic
# azure-code): prompts log-uniform 750-3000, 64 / 128 slots, 2,048 / 4,096
# lanes; and each cell's all-decode step, one token a slot
CELL_STEPS = {"granite": ((H, HKV), 64, 2048),
              "moe": (MOE_HEADS, 128, 4096)}
CELL_PROMPTS = (750, 3000)
CELL_MAX_LEN = 4096          # the cells' max_len: 128 blocks of 32 a slot
TOP_RATE = 1979e12           # bench/counts.py PEAK_TOP, int8 OP/s
# the spread of an all-decode step's device time between calls on one
# H100 (granite's 64 lanes through the split sweep: 0.2168-0.2241 ms in
# five calls). At such a step the packed call runs the split sweep's
# passes, which differ from hccs_paged_decode's only in how a row finds
# its block-table row (through slot_ids, against a gathered per-token
# table): -0.2% (granite) to +1.5% (granite-moe) in one call
ALL_DECODE_SPREAD = 0.034


def cell_step(heads, slots: int, lanes: int, seed: int, decode_only=False):
    """A packed step shaped like a cell's: each slot prefilling (a prompt
    log-uniform over CELL_PROMPTS, a uniform share of it fed) or, with
    probability 0.3 (every slot with decode_only), decoding its 4-42th new
    token; lanes dealt by the engine's scheduler, random f32 inputs, the
    pool's blocks shuffled. Returns the case and the step's t_valid."""
    h, hkv = heads
    rng = np.random.default_rng(seed)
    lo, hi = np.log(CELL_PROMPTS[0]), np.log(CELL_PROMPTS[1] - 42)
    prompt = np.exp(rng.uniform(lo, hi, slots)).astype(np.int64)
    decoding = np.ones(slots, bool) if decode_only else rng.random(slots) < 0.3
    fed = np.where(decoding, prompt + rng.integers(3, 41, slots),
                   (prompt * rng.uniform(0, 1, slots)).astype(np.int64))
    remaining = np.where(decoding, 0, prompt - fed)
    t_valid = schedule_step_tokens(np.ones(slots, bool), remaining, lanes,
                                   4 * BS)     # the engine's chunk cap
    sid, off = pack_slot_ids(t_valid, lanes)
    lens = np.zeros(lanes, np.int32)
    for s in np.flatnonzero(t_valid):
        tv = int(t_valid[s])
        lens[off[s]:off[s] + tv] = fed[s] + 1 + np.arange(tv)
    need = -(-(fed + t_valid) // BS)
    n_blocks = 1 + int(need.sum())
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.full((slots, CELL_MAX_LEN // BS), -1, np.int32)
    c = 0
    for s in range(slots):
        table[s, :need[s]] = perm[c:c + need[s]]
        c += need[s]
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(seed)
    pool = (n_blocks, hkv, BS, D)
    i32 = (lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev))
    case = dict(
        q=torch.randn((lanes, h, D), generator=gen, device=dev),
        k_pool=torch.randn(pool, generator=gen, device=dev),
        v_pool=torch.randn(pool, generator=gen, device=dev),
        block_table=i32(table), slot_ids=i32(sid), lengths=i32(lens),
        scale=torch.tensor(rng.uniform(0.005, 0.02, h), dtype=torch.float32,
                           device=dev),
        theta=i32(np.stack([rng.integers(120, 200, h), rng.integers(0, 2, h),
                            rng.integers(16, 100, h)], -1)),
        k_scales=None, v_scales=None)
    return case, t_valid


def tile_fill(t_valid, width: int, group: int) -> float:
    """Valid rows over the rows of the tiles a step of `width` lanes is cut
    into (serve/paged.py tile_rows; 0 where it runs the split sweep)."""
    valid, total = serve_paged.tile_rows(t_valid, width, tile_tokens(group),
                                         group)
    return valid / max(total, 1)


def cell_bound(case, heads) -> tuple[float, float, float, float]:
    """(f32 CUDA-core bound ms, top-rate roofline ms, bytes, operations) of
    a packed call: each slot's live K/V rows once, q and the output once,
    bench/counts.py's operations (2 x 2 x d a live key and query head)."""
    h, hkv = heads
    sid = case["slot_ids"].cpu().numpy()
    lens = case["lengths"].cpu().numpy()
    live = sid >= 0
    keys = float(lens[live].sum())
    rows = sum(int(lens[sid == s].max()) for s in np.unique(sid[live]))
    nbytes = 2.0 * rows * hkv * D * 4 + 2.0 * int(live.sum()) * h * D * 4
    ops = 4.0 * h * D * keys
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (max(t_bytes, ops / F32_FLOPS * 1e3),
            max(t_bytes, ops / TOP_RATE * 1e3), nbytes, ops)


def tiled_cells():
    """Phase 3's cell-shaped cases: the packed kernel against the split
    sweep run per token, bit for bit (output and q_int; random inputs, f32
    pool, wide, and static_max), and both timed in turns (device time, CUDA
    graphs: packed, split, packed, split, packed, split; the per-token rows
    built before the graph) at each cell's packed step, where the packed
    kernel runs its tiles, and at each cell's all-decode step (64 / 128
    one-token segments), where a call of at most SPLIT_SWEEP_TOKENS tokens
    runs the split sweep's passes alone and may not be slower than it
    beyond its spread between calls (ALL_DECODE_SPREAD)."""
    steps = [(name, heads, slots, lanes, False)
             for name, (heads, slots, lanes) in CELL_STEPS.items()]
    steps += [(f"{name} all-decode", heads, slots, slots, True)
              for name, (heads, slots, _) in CELL_STEPS.items()]
    for n, (name, heads, slots, lanes, dec) in enumerate(steps):
        case, t_valid = cell_step(heads, slots, lanes, seed=2700 + n,
                                  decode_only=dec)
        group = heads[0] // heads[1]
        t, h, _ = case["q"].shape
        check(uses_tiles(t) != dec, f"{name}: {t} lanes, tiles "
              f"{uses_tiles(t)}")
        for static_max in (False, True):
            qo = torch.full((t, h, CELL_MAX_LEN), -128, dtype=torch.int8,
                            device="cuda")
            got = hccs_packed_prefill(**case, static_max=static_max,
                                      qint_out=qo)
            check_against_split(case, got, qo, f"{name} static="
                                f"{static_max}", static_max=static_max)
        rows = per_token_rows(case)
        packed = (lambda: hccs_packed_prefill(**case))
        split = (lambda: split_per_token(case, rows))
        times = {"packed": [], "split": []}
        for _ in range(3):
            times["packed"].append(graph_time_ms(packed))
            times["split"].append(graph_time_ms(split))
        bound_f32, bound_top, nbytes, ops = cell_bound(case, heads)
        med = {k: float(np.median(v)) for k, v in times.items()}
        segs = t_valid[t_valid > 0]
        log(f"[kernel] {name} step: {lanes} lanes ("
            f"{'tiled' if uses_tiles(t) else 'split sweep'}), {len(segs)} "
            f"segments ({int((segs == 1).sum())} of one token, longest "
            f"{int(segs.max())}), frontiers up to "
            f"{int(case['lengths'].max())}, heads {heads[0]}/{heads[1]}, "
            f"tile_fill {100 * tile_fill(t_valid, lanes, group):.2f}% "
            f"({tile_tokens(group)} tokens a tile); device ms packed "
            + " / ".join(f"{x:.4f}" for x in times["packed"])
            + ", split per token "
            + " / ".join(f"{x:.4f}" for x in times["split"])
            + f" (median {med['split'] / med['packed']:.2f}x); bound "
            f"{bound_f32:.4f} ms at the f32 CUDA-core rate, {bound_top:.4f}"
            f" ms at the top rate ({nbytes / 1e6:.1f} MB, "
            f"{ops / 1e9:.2f} GOP): roofline "
            f"{100 * bound_top / med['packed']:.2f}% packed, "
            f"{100 * bound_top / med['split']:.2f}% split; packed "
            f"{kernel_passes(packed)}; split {kernel_passes(split)}")
        if dec:
            ran = set(pass_times(packed))
            check(ran == {"pass1", "pass2", "pass3"},
                  f"{name} step: the packed call ran {sorted(ran)}, not "
                  f"the split sweep's three passes")
            check(med["packed"] <= med["split"] * (1 + ALL_DECODE_SPREAD),
                  f"{name} step slower packed ({times['packed']}) than the "
                  f"split sweep ({times['split']}) beyond its spread "
                  f"({100 * ALL_DECODE_SPREAD:.1f}%)")


# ---------------------------------------------------------------- phase 4 --

def phase_forward():
    """One packed step of granite-3-2b (2 layers, f32) on the card against
    the CPU, same weights (made on the CPU from a seed, copied over), same
    pools with a random KV history, mixed prefill chunks and decode lanes."""
    cfg = get_config("granite-3-2b").replace(
        num_layers=2, dtype="float32", decode_kernel="fused",
        cache_layout="paged")
    params_cpu = M.init_params(cfg, seed=1, device="cpu")
    params_gpu = M.params_to(params_cpu, "cuda")
    rng = np.random.default_rng(4)
    fronts = np.array([700, 400, 1200, 5, 300, 64, 2000, 129])
    remaining = np.array([200, 80, 0, 0, 30, 0, 0, 0])
    width = 256
    t_valid = schedule_step_tokens(np.ones(8, bool), remaining, width,
                                   4 * BS)
    sid, off = pack_slot_ids(t_valid, width)
    toks = rng.integers(0, cfg.vocab_size, width).astype(np.int32)
    pos = np.zeros(width, np.int32)
    for s in range(8):
        tv = int(t_valid[s])
        pos[off[s]:off[s] + tv] = fronts[s] - tv + np.arange(tv)
    n_blocks = 1 + int(sum(-(-f // BS) for f in fronts))
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.full((MAX_BATCH, NBLK), -1, np.int32)
    c = 0
    for s, f in enumerate(fronts):
        nb = -(-f // BS)
        table[s, :nb] = perm[c:c + nb]
        c += nb
    wp = np.zeros(width, np.int64) + np.arange(width) % BS
    for i in np.flatnonzero(sid >= 0):
        wp[i] = table[sid[i], pos[i] // BS] * BS + pos[i] % BS
    kv_len = np.where(sid >= 0, pos + 1, 0).astype(np.int32)
    hist = rng.standard_normal((2, cfg.num_layers, n_blocks, HKV, BS, D),
                               dtype=np.float32)
    outs = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        t32 = (lambda a: torch.tensor(a, dtype=torch.int32, device=dev))
        cache = {"layers": {"k": torch.tensor(hist[0], dtype=torch.float32,
                                              device=dev),
                            "v": torch.tensor(hist[1], dtype=torch.float32,
                                              device=dev)},
                 "block_table": t32(table),
                 "write_pos": t32(wp[None]), "kv_len": t32(kv_len),
                 "slot_ids": t32(sid)}
        with torch.inference_mode():
            x, _, _ = M.forward(params["weights"], params["hccs"],
                                {"tokens": t32(toks[None]),
                                 "positions": t32(pos[None])}, cfg,
                                cache)
            logits = M.logits_from_hidden(params["weights"], x, cfg)[0]
        outs[dev] = logits[torch.tensor(sid >= 0, device=dev)].float().cpu()
    d = (outs["cuda"] - outs["cpu"]).abs()
    top1 = float((outs["cuda"].argmax(-1) == outs["cpu"].argmax(-1))
                 .float().mean())
    max_err = float(d.max())
    log(f"[forward] granite-3-2b x2 layers f32, {int((sid >= 0).sum())} live "
        f"lanes of {width}: max |dlogit| {max_err:.3e}, top-1 agreement "
        f"{top1:.4f}")
    check(max_err <= FWD_MAX_LOGIT_ERR, f"max |dlogit| {max_err}")
    check(top1 >= FWD_TOP1_AGREE, f"top-1 agreement {top1}")
    return max_err, top1


# ---------------------------------------------------------------- phase 5 --

# one device event of a profiled run: its name, start and end in us
DevEvent = collections.namedtuple("DevEvent", "name start end")


WRITE_TAG = "int8_write"        # phase 16's span around each int8 write


def device_events(prof) -> list:
    """The CUDA events of a profiled run, read once from the profiler's raw
    (kineto) results: building `prof.events()` for a full-width engine run
    (150k-400k events with their host ops) takes minutes."""
    if not hasattr(prof, "device_events"):
        out = []
        for e in prof.profiler.kineto_results.events():
            if (not str(e.device_type()).endswith("CUDA")
                    or e.is_user_annotation() or e.name() == WRITE_TAG):
                continue                # a record_function span, no kernel
            start = e.start_ns() / 1e3
            out.append(DevEvent(e.name(), start, start + e.duration_ns()
                                / 1e3))
        prof.device_events = out
    return prof.device_events


def profile_summary(prof, wall: float, kernel: str = "PackedRows",
                    tag: str = "profile"):
    """Device time of a profiled run by kernel (torch.profiler's CUDA
    events): the HCCS wrapper's total (every kernel whose name holds
    `kernel`: all passes of a split-sweep wrapper), the top kernels, and
    the share of the wall time with no kernel on the card. Returns the
    number of those HCCS kernels that ran on the card, None where the
    profiler delivered no device events."""
    kern = device_events(prof)
    if not kern:
        log(f"[{tag}] no device events recorded: device times not measured")
        return None
    by_name: dict[str, float] = {}
    spans = []
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.end - e.start
        spans.append((e.start, e.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):                  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(by_name.values())
    hccs = sum(t for n, t in by_name.items() if kernel in n)
    n_hccs = sum(1 for e in kern if kernel in e.name)
    log(f"[{tag}] wall {wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms"
        f" (idle share {1 - busy / 1e6 / wall:.3f}), kernel time "
        f"{total / 1e3:.1f} ms over {len(kern)} device events; "
        f"{kernel} kernels {hccs / 1e3:.1f} ms ({hccs / total:.3f}) over "
        f"{n_hccs} launches")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[{tag}]   {t / 1e3:9.2f} ms  {t / total:.3f}  {name[:90]}")
    return n_hccs


def per_call(n_device, calls):
    """Kernels on the card per wrapper call of a profiled run, None where
    the profiler counted none."""
    return n_device / calls if n_device and calls else None


def engine_model():
    """granite-3-2b at full width and depth, bf16 weights from seed 0, the
    default f32 cache, the fused kernels on."""
    cfg = get_config("granite-3-2b").replace(decode_kernel="fused",
                                             cache_layout="paged")
    return cfg, M.init_params(cfg, seed=0, device="cuda")


def smoke_prompts(cfg):
    """Phase 5's traffic: 8 seeded prompts of 64-1000 tokens."""
    rng = np.random.default_rng(0)
    plens = rng.integers(64, 1001, MAX_BATCH)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32)
            for n in plens]


def phase_engine():
    """granite-3-2b at full width and depth, bf16, f32 cache, fused kernel,
    8 seeded requests (prompts 64..1000 tokens, 32 new tokens): two timed
    runs, then a third under torch.profiler for the device-time split."""
    cfg, params = engine_model()
    prompts = smoke_prompts(cfg)
    plens = [len(p) for p in prompts]
    runs, kernels_per_call, busy_ms, tap = [], None, None, None
    for rep in range(3):
        eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          block_size=BS, device="cuda")
        if rep == 2:                # the reference's own logits (C1)
            tap = LogitTap(eng)
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32))
        torch.cuda.synchronize()
        hccs_packed_prefill.launches = 0          # count the main path only
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if rep == 2
            else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = hccs_packed_prefill.launches
        if prof is not None:
            kernels_per_call = per_call(profile_summary(prof, wall), launches)
            busy_ms = prof_busy_ms(prof)
        steps = eng.occupancy_steps
        toks = {r.uid: list(r.out_tokens) for r in done}
        n_new = sum(len(t) for t in toks.values())
        check(len(done) == MAX_BATCH and all(
            len(t) == 32 for t in toks.values()), "not every request done")
        check(launches == cfg.num_layers * steps,
              f"launches {launches} != {cfg.num_layers} x {steps} steps")
        pad = eng.padding_stats()
        log(f"[engine] run {rep}{' (profiled)' if rep == 2 else ''}: "
            f"{steps} packed steps, {launches} kernel "
            f"launches, {n_new} tokens ({sum(plens)} prompt) in {wall:.3f}s"
            f" = {n_new / wall:.1f} new tok/s, "
            f"{(n_new + sum(plens)) / wall:.1f} tok/s incl. prefill; "
            f"lanes {pad['lanes_valid']}/{pad['lanes_total']}")
        runs.append((toks, launches, steps, wall))
    check(runs[0][0] == runs[1][0] == runs[2][0],
          "runs of the engine disagree")
    for toks in runs[0][0].values():
        check(all(0 <= t < cfg.vocab_size for t in toks), "token off vocab")
    return runs[0][1], runs[0][0], kernels_per_call, dict(
        busy_ms=busy_ms, walls=[r[3] for r in runs[:2]], own=tap.own)


# ----------------------------------------------------------- phases 6, 7 --

# 8 slots with frontiers 0-2048 (one empty row), as a decode step sees them
DECODE_FRONTS = (2048, 1024, 777, 1500, 33, 0, 511, 1)
# frontiers at and beside the split sweep's boundaries, one row whose live
# keys lie in one split, one empty
SPLIT_FRONTS = (SPLIT_KEYS - 1, SPLIT_KEYS, SPLIT_KEYS + 1, 2 * SPLIT_KEYS,
                33, 0, 3 * SPLIT_KEYS + 1, 1)


def kv_values(rng, q_shape, kv_shape, exact: bool):
    """q, k, v, per-head scales and theta (the heads are q_shape[1]).
    Exact inputs are multiples of 2^-3 (every dot product and s*v sum is
    exact in f32, in any order)."""
    h = q_shape[1]
    if exact:
        q = rng.integers(-8, 9, q_shape) / 8.0
        k = rng.integers(-8, 9, kv_shape) / 8.0
        v = rng.integers(-8, 9, kv_shape) / 8.0
        scale = rng.uniform(0.007, 0.013, h)
    else:
        q = rng.normal(0, 1, q_shape)
        k = rng.normal(0, 1, kv_shape)
        v = rng.normal(0, 1, kv_shape)
        scale = rng.uniform(0.005, 0.02, h)
    theta = np.stack([rng.integers(120, 200, h), rng.integers(0, 2, h),
                      rng.integers(16, 100, h)], -1)     # s = B - S*d > 0
    dev = "cuda"
    return (torch.tensor(q, dtype=torch.float32, device=dev), k, v,
            torch.tensor(scale, dtype=torch.float32, device=dev),
            torch.tensor(theta, dtype=torch.int32, device=dev))


def decode_case(kind: str, kv_dtype, exact: bool, seed: int,
                fronts=DECODE_FRONTS, tmax: int = MAX_LEN,
                heads: tuple[int, int] = (H, HKV)):
    """Kernel inputs of one decode step at granite's shapes (`heads` =
    query heads, KV heads): a paged pool (shuffled blocks, a sentinel
    inside a frontier, sentinels past every frontier, unowned blocks) or a
    (B, Hkv, tmax, d) arena whose rows past each frontier hold stale
    values."""
    h, hkv = heads
    rng = np.random.default_rng(seed)
    b = len(fronts)
    lengths = torch.tensor(fronts, dtype=torch.int32, device="cuda")
    if kind == "arena":
        q, k, v, scale, theta = kv_values(rng, (b, h, D), (b, hkv, tmax, D),
                                          exact)
        to = (lambda a: torch.tensor(a, dtype=torch.float32,
                                     device="cuda").to(kv_dtype))
        return dict(q=q, k=to(k), v=to(v), lengths=lengths, scale=scale,
                    theta=theta)
    n_blocks = 1 + int(sum(-(-f // BS) for f in fronts)) + 4
    q, k, v, scale, theta = kv_values(rng, (b, h, D), (n_blocks, hkv, BS, D),
                                      exact)
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.full((b, NBLK), -1, np.int32)
    c = 0
    for s, f in enumerate(fronts):
        nb = -(-f // BS)
        table[s, :nb] = perm[c:c + nb]
        c += nb
    table[3, 5] = -1                          # a sentinel inside a frontier
    case = dict(q=q, block_table=torch.tensor(table, device="cuda"),
                lengths=lengths, scale=scale, theta=theta, k_scales=None,
                v_scales=None)
    if kv_dtype == torch.int8:
        sc = (np.full((n_blocks, hkv), 0.125) if exact
              else rng.uniform(0.05, 0.2, (n_blocks, hkv)))
        case.update(
            k_pool=torch.tensor(np.clip(np.round(k * 8), -127, 127),
                                dtype=torch.int8, device="cuda"),
            v_pool=torch.tensor(np.clip(np.round(v * 8), -127, 127),
                                dtype=torch.int8, device="cuda"),
            k_scales=torch.tensor(sc, dtype=torch.float32, device="cuda"),
            v_scales=torch.tensor(sc[::-1].copy(), dtype=torch.float32,
                                  device="cuda"))
    else:
        case.update(k_pool=torch.tensor(k, dtype=torch.float32,
                                        device="cuda").to(kv_dtype),
                    v_pool=torch.tensor(v, dtype=torch.float32,
                                        device="cuda").to(kv_dtype))
    return case


def decode_bound(kind: str, case) -> tuple[float, str, float, float]:
    """Least time for one decode call: each slot's live K and V rows read
    once (allocated entries only), q, the output and the index arrays moved
    once, over the HBM rate; against the QK and PV flops of every slot's
    live keys over the f32 rate."""
    lens = case["lengths"].cpu().numpy()
    if kind == "arena":
        rows = int(lens.sum())
        elem = case["k"].element_size()
        extra = lens.nbytes
    else:
        table = case["block_table"].cpu().numpy()
        rows = sum(int((table[s, np.arange(int(n)) // BS] >= 0).sum())
                   for s, n in enumerate(lens))
        elem = case["k_pool"].element_size()
        extra = table.nbytes + lens.nbytes
    b = lens.shape[0]
    nbytes = 2 * rows * HKV * D * elem + 2 * b * H * D * 4 + extra
    flops = 2.0 * 2.0 * rows * H * D
    return (*bound(nbytes, flops), nbytes, flops)


def phase_decode_kernel(kind: str):
    """hccs_paged_decode (kind "paged") or hccs_decode ("arena") against
    its plain version on the card: every mode x static_max x K/V dtype,
    exact inputs bit-identical, random inputs with their int8 bin flips
    counted through qint_out; then kernel, plain and bound times."""
    if kind == "paged":
        fn, ref, tag = hccs_paged_decode, hccs_paged_decode_ref, "paged"
        dtypes = (torch.float32, torch.bfloat16, torch.int8)
        qint = (lambda c: paged_qint(c["q"], c["k_pool"], c["block_table"],
                                     c["lengths"], c["scale"],
                                     c["k_scales"]))
        # the engine's pool, and frontiers at the split boundaries
        shapes = [(DECODE_FRONTS, MAX_LEN, (H, HKV)),
                  (SPLIT_FRONTS, MAX_LEN, (H, HKV))]
    else:
        fn, ref, tag = hccs_decode, hccs_decode_ref, "arena"
        dtypes = (torch.float32, torch.bfloat16)
        qint = (lambda c: decode_qint(c["q"], c["k"], c["lengths"],
                                      c["scale"]))
        # the engine's arena (2048 rows), one whose length is no multiple
        # of the kernel's split, filled to its last row, and frontiers at
        # the split boundaries
        shapes = [(DECODE_FRONTS, MAX_LEN, (H, HKV)),
                  ((MAX_LEN - 1,) + DECODE_FRONTS[1:], MAX_LEN - 1, (H, HKV)),
                  (SPLIT_FRONTS, MAX_LEN, (H, HKV))]
    # granite-moe's group of 2: the engine's frontiers and the split
    # boundaries
    shapes += [(DECODE_FRONTS, MAX_LEN, MOE_HEADS),
               (SPLIT_FRONTS, MAX_LEN, MOE_HEADS)]
    rows, timing, worst = [], None, 0.0
    for fronts, tmax, heads in shapes:
        for kv_dtype in (dtypes if tmax == MAX_LEN else (torch.float32,)):
            for exact in (True, False):
                case = decode_case(kind, kv_dtype, exact,
                                   seed=tmax + 11 * len(rows) + int(exact),
                                   fronts=fronts, tmax=tmax, heads=heads)
                b = case["q"].shape[0]
                qi, valid = qint(case)
                live = valid[:, None, :].expand_as(qi)
                for mode in ("wide", "i16_div", "i16_clb"):
                    for static_max in (False, True):
                        kw = dict(mode=mode, static_max=static_max)
                        qo = torch.full(tuple(qi.shape), -128,
                                        dtype=torch.int8, device="cuda")
                        got = fn(**case, **kw, qint_out=qo)
                        want = ref(**case, **kw)
                        torch.cuda.synchronize()
                        flipped = (qo.int() != qi) & live
                        flips = int(flipped.sum())
                        n_live = int(live.sum())
                        err = (got - want).abs()
                        flip_rows = flipped.any(-1)
                        err_clean = float(err[~flip_rows].max()) \
                            if (~flip_rows).any() else 0.0
                        max_err = float(err.max())
                        worst = max(worst, max_err)
                        rows.append((tmax, "split" if fronts == SPLIT_FRONTS
                                     else "decode",
                                     str(kv_dtype).split(".")[-1],
                                     mode, static_max, exact, flips, n_live,
                                     max_err, err_clean, heads))
                        empty = [i for i in range(b) if fronts[i] == 0]
                        check(bool((got[empty] == 0).all()),
                              f"{tag}: a row of length 0 is not zero")
                        what = (f"{tag} tmax {tmax} fronts {fronts} heads "
                                f"{heads} {kv_dtype} {mode} "
                                f"static={static_max}")
                        if exact:
                            check(flips == 0 and max_err == 0.0,
                                  f"exact case differs: {what} flips="
                                  f"{flips} max_err={max_err}")
                        else:
                            check(flips <= RANDOM_FLIP_FRACTION * n_live,
                                  f"{flips} bin flips of {n_live}: {what}")
                            check(err_clean <= RANDOM_MAX_ERR_NO_FLIP,
                                  f"max |d| {err_clean} on rows without "
                                  f"flips: {what}")
                        if (fronts == DECODE_FRONTS and tmax == MAX_LEN
                                and heads == (H, HKV)
                                and kv_dtype == torch.float32
                                and mode == "wide" and not static_max
                                and not exact):
                            tm = kernel_times(lambda: fn(**case, **kw),
                                              lambda: ref(**case, **kw))
                            bound, by, nbytes, flops = decode_bound(kind,
                                                                    case)
                            timing = dict(tm, bound_ms=bound, bound_by=by,
                                          bytes=nbytes, flops=flops)
    log(f"[{tag}] tmax fronts kv mode static exact flips/live max|d| "
        f"max|d|(rows w/o flips) heads/kv-heads")
    for r in rows:
        log(f"[{tag}] {r[0]:4d} {r[1]} {r[2]:8s} {r[3]:7s} {int(r[4])} "
            f"{int(r[5])} {r[6]}/{r[7]} {r[8]:.3e} {r[9]:.3e} "
            f"{r[10][0]}/{r[10][1]}")
    log(f"[{tag}] timing B=8, fronts {DECODE_FRONTS}: {times_text(timing)}")
    timing["max_abs_err"] = worst
    return timing


# ------------------------------------------------------- phases 8, 9, 10 --

KERNELS = (hccs_packed_prefill, hccs_paged_decode, hccs_decode)
# the fold's counter: both its wrappers (a layer's K and V, the main path;
# one pool) count their C calls on paged_quant_scatter_kv
FOLD_KERNELS = (paged_quant_scatter_kv,)
# what the profiler's names of each wrapper's kernels hold: the split
# sweep's passes are instantiated on the wrapper's row type
KERNEL_SYMBOLS = {"hccs_packed_prefill": "PackedRows",
                  "hccs_paged_decode": "PagedRows",
                  "hccs_decode": "ArenaRows"}


# ROADMAP C1: two paths' greedy tokens may part where the model's top two
# tokens nearly tie, since bf16 projections at other row counts round
# differently. Each request's first divergent position is gated: the two
# paths' tokens there must lie within NEAR_TIE_GAP of each other in a
# reference forward of the common prefix (the model's logits, granite's
# bf16 weights, an f32 slot-arena prefill). Set from the first two runs
# with this rule on an H100 80GB HBM3 at 700 W (PERF.md section 6): 25 first
# divergences across the paths, gaps 0 to 0.0625 (bf16 logits), while the
# top-1/top-2 gap where paths agree has a median of 0.16-0.31; the gate is
# 4x the largest gap seen. A forced wrong token gave 1.78.
NEAR_TIE_GAP = 0.25

# Every path compared also holds each first divergence to the two paths'
# OWN logits (LogitTap on the PagedEngine, SampleTap on the slot-arena
# engines; phases 8-10, 16-19 and 21): at position k both paths saw the
# same context, so each one's
# margin between its token and the other's, in the numerics that chose
# it, must be a near tie (at most OWN_TIE_GAP). The f32-KV forward above
# measures that gap in a third model (f32 KV against the paths' int8 KV).
# Set from this rule's first run on an H100 80GB HBM3 at 700 W (PERF.md
# section 6): 19 first divergences between runs of one model (int8 KV,
# drafting on against off, preempted against not) had own margins of 0 to
# 0.0625, while the reference's own top-1/top-2 margin where the paths
# agreed had medians of 0.20-0.34; the gate is twice the largest margin
# seen, and a runner-up pick must fail it at most positions.
OWN_TIE_GAP = 0.125
TAP_K = 16                      # logits kept per sampled position


class LogitTap:
    """A PagedEngine's own logits at every token it samples: wraps its
    three device seams to keep the top TAP_K logits of each returned row
    (with the live slots' requests and token counts), its step() to file
    each request's new tokens, and its async commit (which lands a step
    dispatched one step earlier) likewise: own[(uid, k)] = (values, token
    ids) of the logits that chose token k (row (slot, i) of a verify step
    chose the slot's i-th new token). The rows stay on the card until
    `own` is first read, so the tap adds no host sync to the run."""

    def __init__(self, eng):
        self._filed, self._last, self._own = [], None, None
        for name in ("_step_fn", "_packed_fn", "_packed_spec_fn"):
            setattr(eng, name, self._seam(eng, getattr(eng, name)))
        step, commit = eng.step, eng._commit_pending_record

        def stepped():
            self._last = None
            out = step()
            if self._last is not None:
                self._file(*self._last)
            return out

        def committed(p):
            live = self._live(eng, p["live"] & ~p["dead"])
            v, i = self._top(p["logits"])
            out = commit(p)
            self._file(v, i, live)
            return out
        eng.step = stepped
        eng._commit_pending_record = committed

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    @staticmethod
    def _top(logits):
        rows = logits if logits.dim() == 3 else logits[:, None]
        return torch.topk(rows.float(), TAP_K, dim=-1)

    @staticmethod
    def _live(eng, live):
        return [(int(s), eng._slots[s], len(eng._slots[s].out_tokens))
                for s in np.flatnonzero(live) if eng._slots[s] is not None]

    def _file(self, v, i, live):
        self._filed.append((v, i, [(s, req, n0, len(req.out_tokens))
                                   for s, req, n0 in live]))

    def _seam(self, eng, fn):
        def wrapped(*args):
            logits, cache = fn(*args)
            self._last = (*self._top(logits), self._live(eng, eng._live))
            return logits, cache
        return wrapped

    @property
    def own(self):
        if self._own is None:
            self._own = {}
            for v, i, live in self._filed:
                v, i = v.cpu().numpy(), i.cpu().numpy()
                for s, req, n0, n1 in live:
                    for r in range(n1 - n0):
                        self._own[(req.uid, n0 + r)] = (v[s, r], i[s, r])
        return self._own


class SampleTap:
    """The own logits of the slot-arena engines (ContinuousEngine, wave
    ServeEngine), which sample every row through `sample_tokens`: stands in
    for it in serve/engine.py and serve/continuous.py during one run and
    keeps the top TAP_K logits of each row under (uid, generation index).
    The first row filed under a key wins: an empty slot's placeholder row
    reuses uid 0 and index 0 after request 0's own first token, and a
    finished wave row files under an index past its last token. The rows
    stay on the card until `own` is first read."""

    def __init__(self):
        self._rows, self._own, self._orig = [], None, None

    def __enter__(self):
        self._orig = serve_engine.sample_tokens
        serve_engine.sample_tokens = serve_continuous.sample_tokens = self
        return self

    def __exit__(self, *exc):
        serve_engine.sample_tokens = serve_continuous.sample_tokens = \
            self._orig
        return False

    def __call__(self, key, logits, temps, uids, gen_idx):
        v, i = torch.topk(logits.float(), TAP_K, dim=-1)
        self._rows.append((v, i, [int(u) for u in uids],
                           [int(g) for g in gen_idx]))
        return self._orig(key, logits, temps, uids, gen_idx)

    @property
    def own(self):
        if self._own is None:
            self._own = {}
            for v, i, uids, gens in self._rows:
                v, i = v.cpu().numpy(), i.cpu().numpy()
                for r, key in enumerate(zip(uids, gens)):
                    self._own.setdefault(key, (v[r], i[r]))
        return self._own


def own_margin(own, uid, k, mine, other) -> float:
    """In one path's own logits at (uid, k): the logit of its token `mine`
    (which must be its own argmax) minus that of the other path's token
    (inf if that one lies outside its top TAP_K)."""
    v, ids = own[(uid, k)]
    check(np.any((ids == mine) & (v == v[0])), f"request {uid} token {k}: "
          f"the path's token {mine} is not its own argmax")
    hit = v[ids == other]
    return float(v[0] - hit[0]) if hit.size else float("inf")


def first_divergence(a, b):
    """The first position where two token lists differ, None if neither
    differs within their common length."""
    return next((i for i, (x, y) in enumerate(zip(a, b)) if x != y), None)


def divergence(label, toks, ref, prompts, ref_prompts, params, cfg,
               own=None):
    """ROADMAP C1's rule: for each request whose tokens differ between two
    paths (`toks` against `ref`, {uid: tokens}), the first divergent
    position k, and one model forward of the common prefix (the prompt and
    ref[uid][:k]): the gap between the logits of the two paths' tokens at
    k, and for scale the forward's top-1/top-2 gaps at the positions where
    the paths agreed. Every first divergence must be a near tie (gap <=
    NEAR_TIE_GAP). A request whose prompt differs between the paths (a
    session turn after a diverged turn) continues an earlier divergence and
    is counted apart. With `own` (the two paths' tap records) each
    first divergence must also be a near tie in both paths' own logits
    (own_margin <= OWN_TIE_GAP), no request may be carried, and the
    reference's own top-1/top-2 margins where the paths agree give the
    share of positions at which a path that picked the runner-up would pass
    that rule, which must be under half. Returns the number of requests
    that diverge and the largest gap."""
    arena = cfg.replace(cache_layout="slot", kv_quant="none")
    w, hc = params["weights"], params["hccs"]
    gaps, agreed, carried, margins, owns = [], [], 0, [], []
    for uid in sorted(ref):
        if not np.array_equal(prompts[uid], ref_prompts[uid]):
            carried += 1
            continue
        k = first_divergence(toks[uid], ref[uid])
        if own is not None:
            for j in range(len(ref[uid]) if k is None else k):
                v = own[1][(uid, j)][0]
                margins.append(float(v[0] - v[1]))
        if k is None:
            continue
        if own is not None:
            owns.append((uid, own_margin(own[0], uid, k, toks[uid][k],
                                         ref[uid][k]),
                         own_margin(own[1], uid, k, ref[uid][k],
                                    toks[uid][k])))
        plen = len(prompts[uid])
        seq = np.concatenate([np.asarray(prompts[uid], np.int32),
                              np.asarray(ref[uid][:k], np.int32)])
        with torch.inference_mode():
            x, _, _ = M.forward(w, hc, {"tokens": torch.tensor(
                seq[None], device="cuda")}, arena,
                M.init_cache(arena, 1, len(seq), device="cuda"))
            lg = M.logits_from_hidden(w, x[:, plen - 1:], arena)[0].float()
        top = torch.topk(lg, 2).values
        agreed += (top[:-1, 0] - top[:-1, 1]).tolist()
        gap = abs(float(lg[-1, toks[uid][k]] - lg[-1, ref[uid][k]]))
        gaps.append((uid, k, gap, float(top[-1, 0] - top[-1, 1])))
    worst = max((g[2] for g in gaps), default=0.0)
    typical = (f"; the top-1/top-2 gap where the paths agree: median "
               f"{np.median(agreed):.4f}, 10th percentile "
               f"{np.percentile(agreed, 10):.4f} over {len(agreed)} tokens"
               if agreed else "")
    log(f"[{label}] {len(gaps)} of {len(ref)} requests diverge"
        f"{f', {carried} continue a diverged history' if carried else ''};"
        f" largest gap at a first divergence {worst:.4f} (near-tie "
        f"threshold {NEAR_TIE_GAP}){typical}")
    for uid, k, gap, top2 in gaps:
        log(f"[{label}]   request {uid}: first divergence at token {k} of "
            f"{len(ref[uid])}, the two tokens' logit gap {gap:.4f}, the "
            f"forward's top-1/top-2 gap {top2:.4f}")
    check(worst <= NEAR_TIE_GAP, f"{label}: a first divergence with logit "
          f"gap {worst:.4f} > {NEAR_TIE_GAP} is no near tie")
    if own is not None:
        check(not carried, f"{label}: {carried} requests not compared")
        worst_own = max((max(a, b) for _, a, b in owns), default=0.0)
        passes = np.mean(np.asarray(margins) <= OWN_TIE_GAP)
        log(f"[{label}] own logits: largest margin at a first divergence "
            f"{worst_own:.4f} (threshold {OWN_TIE_GAP}); the reference's "
            f"own top-1/top-2 margin where the paths agree: median "
            f"{np.median(margins):.4f}, 10th percentile "
            f"{np.percentile(margins, 10):.4f}, 90th "
            f"{np.percentile(margins, 90):.4f} over {len(margins)} tokens; "
            f"a runner-up pick would pass at {passes:.3f} of them")
        for uid, a, b in owns:
            log(f"[{label}]   request {uid}: own margins {a:.4f} (tested "
                f"path), {b:.4f} (reference)")
        check(worst_own <= OWN_TIE_GAP, f"{label}: a first divergence with "
              f"an own-logit margin {worst_own:.4f} > {OWN_TIE_GAP} is no "
              f"near tie")
        check(passes < 0.5, f"{label}: a runner-up pick would pass the "
              f"own-logit rule at {passes:.3f} of the positions")
    return len(gaps), worst


def phase_engine_path(label: str, make, prompts, kernel, steps_of, tap,
                      layers: int | None = None, vocab: int | None = None,
                      reps: int = 3, profile: bool = True):
    """Drive one serving path `reps` times on the same requests (32 new
    tokens each), the last under `tap(eng)` (the path's own logits; None:
    no tap) and, with `profile`, under torch.profiler: every request done,
    identical tokens in every run, and the path's kernel launched `layers`
    (granite-3-2b's 40 by default) times per decode step (once per layer)
    and the other kernels never. Returns (tokens, launches, (kernels on
    the card, wrapper calls, profiler) of the profiled run, own logits of
    the tapped run)."""
    layers = layers or M_LAYERS
    vocab = vocab or VOCAB
    runs, profiled, own = [], (None, 0, None), None
    for rep in range(reps):
        last = rep == reps - 1
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32))
        torch.cuda.synchronize()
        for k in KERNELS:                      # count the path's run only
            k.launches = 0
        profiled_rep = last and profile
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if profiled_rep
            else contextlib.nullcontext())
        with (tap(eng) if last and tap else contextlib.nullcontext()) as tp, \
                ctx as prof:
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if tp is not None:
            own = tp.own
        launches = kernel.launches
        if prof is not None:
            profiled = (profile_summary(
                prof, wall, KERNEL_SYMBOLS[kernel.__name__],
                f"{label} profile"), launches, prof)
        others = {k.__name__: k.launches for k in KERNELS if k is not kernel}
        steps = steps_of(eng)
        toks = {r.uid: list(r.out_tokens) for r in done}
        n_new = sum(len(t) for t in toks.values())
        n_prompt = sum(len(p) for p in prompts)
        log(f"[{label}] run {rep}{' (profiled)' if profiled_rep else ''}: "
            f"{getattr(eng, 'occupancy_steps', steps)} steps "
            f"({steps} decode steps), {kernel.__name__} launches "
            f"{launches}, other kernels {others}; {n_new} tokens "
            f"({n_prompt} prompt) in {wall:.3f}s = {n_new / wall:.1f} new "
            f"tok/s, {(n_new + n_prompt) / wall:.1f} tok/s incl. prefill")
        check(len(done) == len(prompts) and all(
            len(t) == 32 for t in toks.values()),
            f"{label}: not every request done")
        check(launches > 0 and launches == layers * steps,
              f"{label}: {kernel.__name__} launches {launches} != "
              f"{layers} x {steps} decode steps")
        check(not any(others.values()), f"{label}: other kernels ran "
              f"{others}")
        for t in toks.values():
            check(all(0 <= x < vocab for x in t), f"{label}: token off "
                  f"vocab")
        runs.append((toks, launches))
    check(all(r[0] == runs[0][0] for r in runs), f"{label}: the runs disagree")
    return runs[0] + (profiled, own)


M_LAYERS, VOCAB = 40, 49155       # granite-3-2b (checked in phase_paths)


def phase_paths(packed_tokens, packed_own, phases):
    """Phases 8-10: the lockstep PagedEngine, the ContinuousEngine and the
    wave ServeEngine on granite at full width. Returns the kernels' launch
    counts {kernel name: launches} summed over the paths that ran, and
    {kernel name: kernels on the card per wrapper call} of their profiled
    runs."""
    cfg, params = engine_model()
    check(cfg.num_layers == M_LAYERS and cfg.vocab_size == VOCAB,
          "granite-3-2b geometry changed")
    arena_cfg = cfg.replace(cache_layout="slot")
    prompts = smoke_prompts(cfg)
    launches, profiled = {}, {}

    def count(name, n, prof):
        launches[name] = launches.get(name, 0) + n
        dev, calls = profiled.get(name, (0, 0))
        if prof[0]:                            # the profiler saw the kernels
            profiled[name] = (dev + prof[0], calls + prof[1])
        else:
            profiled.setdefault(name, (0, 0))
    by_uid = dict(enumerate(prompts))
    if 8 in phases:
        toks, n, prof, own = phase_engine_path(
            "lockstep", lambda: PagedEngine(
                params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                block_size=BS, packed=False, device="cuda"),
            prompts, hccs_paged_decode, lambda e: e.decode_steps, LogitTap)
        count("hccs_paged_decode", n, prof)
        if packed_tokens is not None:
            divergence("lockstep", toks, packed_tokens, by_uid, by_uid,
                       params, cfg, own=(own, packed_own))
    if 9 in phases:
        toks, n, prof, own = phase_engine_path(
            "continuous", lambda: ContinuousEngine(
                params, arena_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                device="cuda"),
            prompts, hccs_decode, lambda e: e.occupancy_steps,
            lambda eng: SampleTap())
        count("hccs_decode", n, prof)
        if packed_tokens is not None:
            divergence("continuous", toks, packed_tokens, by_uid, by_uid,
                       params, cfg, own=(own, packed_own))
    if 10 in phases:
        # one prompt length, so the 8 requests form one wave; its prefill
        # attends over the 2048-row arena, which takes the blockwise path
        rng = np.random.default_rng(1)
        wave_prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
                        for _ in range(MAX_BATCH)]
        eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          block_size=BS, device="cuda")
        wave_tap = LogitTap(eng)
        for i, p in enumerate(wave_prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32))
        packed_wave = {r.uid: list(r.out_tokens) for r in eng.run()}
        toks, n, prof, own = phase_engine_path(
            "wave", lambda: ServeEngine(
                params, arena_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                device="cuda"),
            wave_prompts, hccs_decode, lambda e: e.decode_steps,
            lambda eng: SampleTap())
        count("hccs_decode", n, prof)
        wave_by_uid = dict(enumerate(wave_prompts))
        divergence("wave", toks, packed_wave, wave_by_uid, wave_by_uid,
                   params, cfg, own=(own, wave_tap.own))
    return launches, {k: per_call(*v) for k, v in profiled.items()}


# ------------------------------------------------- phases 11-14: kernels --

PAPER_ROWS, PAPER_NS = 4096, (32, 64, 128)     # the paper's Table III
G_ROWS, G_COLS = H * MAX_LEN, MAX_LEN          # granite's attention rows
ROW_MODES = ("i16_div", "i16_clb", "i8_div", "i8_clb")
# Gates of phases 12-14, set from the first run on an H100 80GB HBM3 at
# 700 W (see PERF.md): softmax_bf16 against its plain version gave
# at most 1 bf16 ulp (927 of 134M elements) and in f32 a relative 4.3e-7;
# hccs_mha_fused gave 0 flipped bins and max |d| 0 on random inputs too
# (its random cases keep the decode phases' gates), and 2.4e-7 against the
# blockwise STE attention. The float gates are ~5-10x the measurement.
SOFTMAX_MAX_ULP_BF16 = 1
SOFTMAX_RTOL_F32 = 2e-6
BLOCKWISE_ATOL = 2.5e-6          # kernel against the model's blockwise path
# The i8 modes at granite's 2048 columns: every feasible theta has a score
# floor of 1 (Z >= 2048) and B <= 15, so an i8 output is 0 or 1
# (255 * 15 / 2048 < 2); a row spreads only where a few keys near its max
# carry enough of Z. The first run spread 1,522 (i8_div) and 10,240
# (i8_clb) of the 65,536 rows; the gate asks for 1% of them. The i8 range
# itself is held by the "range" case (peaked rows, theta from the whole
# feasible grid at 32 columns), whose i8 outputs must take 64 or more
# levels (the plain version gives 102 and 122 on these inputs).
I8_MIN_SPREAD_ROWS = 0.01
I8_MIN_LEVELS = 64


def row_theta(n: int, rows_per_head: int) -> np.ndarray:
    """Per-head theta from the feasible grid at row length n with S > 0
    (default_params(2048) has S = 0, and the model's n-128 calibration
    breaks n * B <= 32767 at 2048 columns), one per head, broadcast to
    H * rows_per_head rows (row r belongs to head r // rows_per_head)."""
    grid = feasible_grid(n)
    grid = grid[grid[:, 1] > 0]
    th = grid[np.arange(H) % len(grid)]
    validate_params(th[:, 0], th[:, 1], th[:, 2], n)
    return np.repeat(th, rows_per_head, axis=0)


def range_rows(rng, rows: int, n: int):
    """(x, theta) that take the i8 modes over their range: theta per row
    from the whole feasible grid at n, and logits peaked at 127 with
    exponential distances of a per-row mean, so that some rows put most of
    Z on a few keys."""
    grid = feasible_grid(n)
    theta = grid[rng.integers(0, len(grid), rows)]
    mean = rng.uniform(1, 128, (rows, 1))
    x = np.clip(127 - np.floor(rng.exponential(mean, (rows, n))), -128, 127)
    return x.astype(np.int8), theta


def row_cases():
    """(label, x int8, theta int32) on the card: the paper's shapes with
    default_params(n), granite's attention rows, an odd width, the three
    degenerate rows of tests/test_attention_modes.py, and the i8 range."""
    rng = np.random.default_rng(11)
    dev = "cuda"
    i8 = (lambda a: torch.tensor(a, dtype=torch.int8, device=dev))
    i32 = (lambda a: torch.tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev))
    cases = []
    for n in PAPER_NS:
        cases.append((f"{PAPER_ROWS}x{n}", i8(rng.integers(
            -128, 128, (PAPER_ROWS, n))), i32(np.tile(default_params(n),
                                                      (PAPER_ROWS, 1)))))
    cases.append((f"{G_ROWS}x{G_COLS}", torch.randint(
        -128, 128, (G_ROWS, G_COLS), dtype=torch.int8, device=dev,
        generator=torch.Generator(dev).manual_seed(12)),
        i32(row_theta(G_COLS, MAX_LEN))))
    cases.append(("1024x2047", i8(rng.integers(-128, 128, (H * 32, 2047))),
                  i32(row_theta(2047, 32))))
    n = 64
    cases.append(("degenerate", i8(np.stack([
        np.full(n, -128), np.full(n, 127),
        np.concatenate([[127], np.full(n - 1, -128)])])),
        i32(np.tile(default_params(n), (3, 1)))))
    x, theta = range_rows(np.random.default_rng(15), PAPER_ROWS, 32)
    cases.append(("range", i8(x), i32(theta)))
    return cases


def phase_rows():
    """hccs_rows against hccs_rows_ref on the card, every case x mode:
    bit-identical; granite's rows non-zero and spread; the range case's i8
    outputs over many levels."""
    for label, x, theta in row_cases():
        for mode in ROW_MODES:
            got = hccs_rows(x, theta, mode=mode)
            want = hccs_rows_ref(x, theta, mode)
            torch.cuda.synchronize()
            differ = int((got != want).sum())
            spread = int((got.max(-1).values > got.min(-1).values).sum())
            levels = int(torch.unique(got).numel())
            log(f"[rows] {label:10s} {mode:7s} differing {differ}/"
                f"{got.numel()}, rows non-uniform {spread}/{got.shape[0]}, "
                f"levels {levels}, max {int(got.max())}")
            check(differ == 0, f"hccs_rows {label} {mode}: {differ} "
                  f"elements differ from the plain version")
            if label == f"{G_ROWS}x{G_COLS}":
                need = got.shape[0] * (1.0 if mode.startswith("i16")
                                       else I8_MIN_SPREAD_ROWS)
                check(bool(got.any()) and spread >= need,
                      f"hccs_rows {label} {mode}: zero output or {spread} "
                      f"rows non-uniform, fewer than {need:.0f}")
            if label == "range" and mode.startswith("i8"):
                check(levels >= I8_MIN_LEVELS, f"hccs_rows range {mode}: "
                      f"{levels} output levels < {I8_MIN_LEVELS}")


def ulp_bf16(a, b) -> torch.Tensor:
    """Distance in bf16 ulps of two non-negative bf16 tensors."""
    return (a.view(torch.int16).int() - b.view(torch.int16).int()).abs()


def phase_softmax():
    """softmax_bf16 against softmax_bf16_ref and torch.softmax on the card:
    bf16 within 1 ulp of the plain version, f32 within a relative bound."""
    gen = torch.Generator("cuda").manual_seed(13)
    for rows, n in [(PAPER_ROWS, c) for c in PAPER_NS] + [(G_ROWS, G_COLS)]:
        x32 = torch.randn((rows, n), generator=gen, device="cuda") * 2.0
        for dtype in (torch.bfloat16, torch.float32):
            x = x32.to(dtype)
            got = softmax_bf16(x)
            for name, want in (("plain", softmax_bf16_ref(x)),
                               ("torch.softmax", torch.softmax(x, -1))):
                torch.cuda.synchronize()
                if dtype == torch.bfloat16:
                    ulps = ulp_bf16(got, want)
                    worst, differ = int(ulps.max()), int((ulps > 0).sum())
                    ok = worst <= SOFTMAX_MAX_ULP_BF16
                    what = f"max {worst} ulp"
                else:
                    rel = (got - want).abs() / want.abs().clamp(min=1e-30)
                    worst, differ = float(rel.max()), int((got != want).sum())
                    ok = worst <= SOFTMAX_RTOL_F32
                    what = f"max rel {worst:.3e}"
                log(f"[softmax] {rows}x{n} {str(dtype)[6:]:8s} vs {name}: "
                    f"{what}, differing {differ}/{got.numel()}")
                if name == "plain":
                    check(ok, f"softmax_bf16 {rows}x{n} {dtype}: {what}")
            check(bool(torch.isfinite(got).all()), "softmax not finite")


# phase 13's rows past the fused kernel's q_int cache (fused_plan): a long
# row (B, Tq, Tk), cached under causal (its rows see 128 keys) and
# recomputed without; and a causal prefill of FUSED_DEEP tokens
FUSED_LONG = (1, 128, 8192)
FUSED_DEEP = 2880
FUSED_DIMS = (18, 32, 96, 128)


def fused_case(b, tq, tk, dtype, exact: bool, seed: int):
    """Granite-headed attention inputs (H 32 over Hkv 8, d 64) on the card,
    the decode phases' value ranges and theta."""
    rng = np.random.default_rng(seed)
    q, k, v, scale, theta = kv_values(rng, (b, H, tq, D), (b, HKV, tk, D),
                                      exact)
    to = (lambda a: torch.tensor(a, dtype=torch.float32,
                                 device="cuda").to(dtype))
    return dict(q=q.to(dtype), k=to(k), v=to(v), scale=scale, theta=theta)


def live_pairs(b, tq, tk, causal: bool) -> int:
    per_head = (sum(min(t + 1, tk) for t in range(tq)) if causal
                else tq * tk)
    return b * H * per_head


def fused_bound(case, causal: bool):
    """Least time for one call: q, k, v and the output moved once over the
    HBM rate, against the function's one QK and one PV product (4 d flops
    per live (row, key)) over the f32 rate. The kernel's second QK pass
    (it recomputes the logits rather than keep them) is its own choice and
    is not counted."""
    b, h, tq, d = case["q"].shape
    tk = case["k"].shape[2]
    elem = case["q"].element_size()
    nbytes = (2 * case["q"].numel() + 2 * case["k"].numel()) * elem
    flops = 4.0 * d * live_pairs(b, tq, tk, causal)
    return (*bound(nbytes, flops), nbytes, flops)


def check_fused(case, causal: bool, what: str):
    """One hccs_mha_fused call against hccs_mha_fused_ref: exact inputs
    bit-identical, random inputs with their int8 bin flips counted through
    qint_out within the decode phases' gates. Returns the kernel's output."""
    b, h, tq, _ = case["q"].shape
    tk = case["k"].shape[2]
    qo = torch.full((b, h, tq, tk), -128, dtype=torch.int8, device="cuda")
    got = hccs_mha_fused(**case, causal=causal, qint_out=qo)
    want = hccs_mha_fused_ref(**case, causal=causal)
    qi, valid = mha_qint(case["q"], case["k"], case["scale"], causal)
    torch.cuda.synchronize()
    flipped = (qo.int() != qi) & valid
    flips = int(flipped.sum())
    n_live = int(valid.sum()) * b * h
    err = (got.float() - want.float()).abs()
    flip_rows = flipped.any(-1)
    err_clean = float(err[~flip_rows].max()) if (~flip_rows).any() else 0.0
    max_err = float(err.max())
    log(f"[fused] {what}: flips {flips}/{n_live}, max|d| {max_err:.3e}, "
        f"rows w/o flips {err_clean:.3e}")
    check(bool(torch.isfinite(got).all()), f"fused output not finite: {what}")
    if "exact" in what:
        check(flips == 0 and max_err == 0.0, f"exact case differs: {what}")
    else:
        check(flips <= RANDOM_FLIP_FRACTION * n_live,
              f"{flips} bin flips of {n_live}: {what}")
        check(err_clean <= RANDOM_MAX_ERR_NO_FLIP,
              f"max |d| {err_clean} on rows without flips: {what}")
    return got


def other_dims_case(d, dtype, exact: bool, seed: int):
    """Attention inputs at head_dim d: B 1, 8 heads over 4 kv heads, T 200,
    the decode phases' value ranges."""
    rng = np.random.default_rng(seed)
    h, hkv, t = 8, 4, 200
    if exact:
        q, k, v = (rng.integers(-8, 9, (1, n, t, d)) / 8.0
                   for n in (h, hkv, hkv))
        scale = rng.uniform(0.007, 0.013, h) * np.sqrt(d / D)
    else:
        q, k, v = (rng.normal(0, 1, (1, n, t, d)) for n in (h, hkv, hkv))
        scale = rng.uniform(0.005, 0.02, h)
    theta = np.stack([rng.integers(120, 200, h), rng.integers(0, 2, h),
                      rng.integers(16, 100, h)], -1)
    to = (lambda a: torch.tensor(a, dtype=torch.float32,
                                 device="cuda").to(dtype))
    return dict(q=to(q), k=to(k), v=to(v),
                scale=torch.tensor(scale, dtype=torch.float32, device="cuda"),
                theta=torch.tensor(theta, dtype=torch.int32, device="cuda"))


def phase_fused():
    """hccs_mha_fused against hccs_mha_fused_ref on the card (check_fused)
    at granite's heads: its full prefill, B 8 x 512, Tq != Tk, a long row
    past the q_int cache (FUSED_LONG) and a causal prefill past it
    (FUSED_DEEP), so that both variants run; then other head dims (the
    second column group at d 96 and 128, the element path at d 18); then
    against the served model's blockwise STE attention at granite's full
    width."""
    shapes = [(1, MAX_LEN, MAX_LEN), (8, 512, 512), (1, 300, 1000),
              FUSED_LONG, (1, FUSED_DEEP, FUSED_DEEP)]
    seed = 0
    variants = set()
    for b, tq, tk in shapes:
        full = (b, tq, tk) == shapes[0]
        both = full or tq != tk
        for dtype in ((torch.float32, torch.bfloat16) if both
                      else (torch.float32,)):
            for exact in (True, False):
                seed += 1
                case = fused_case(b, tq, tk, dtype, exact, seed)
                for causal in ((True, False) if both else (True,)):
                    cache = fused_plan(tq, tk, D, case["q"].element_size(),
                                       causal)[0]
                    variants.add(cache)
                    got = check_fused(case, causal, (
                        f"B {b} Tq {tq} Tk {tk} {str(dtype)[6:]} "
                        f"{'exact' if exact else 'random'} "
                        f"{'causal' if causal else 'full'} "
                        f"({'q_int cached' if cache else 'QK recomputed'})"))
                    if (full and dtype == torch.float32 and causal
                            and not exact):
                        with torch.inference_mode():
                            model = blockwise_run(case)()
                        torch.cuda.synchronize()
                        err = float((got - model).abs().max())
                        log(f"[fused] against the blockwise STE attention "
                            f"(granite cfg, block_k 512): max|d| {err:.3e}")
                        check(err <= BLOCKWISE_ATOL, f"fused kernel against "
                              f"the blockwise attention: max |d| {err}")
    check(variants == {True, False}, f"fused variants run: {variants}")
    for d in FUSED_DIMS:
        for dtype in (torch.float32, torch.bfloat16):
            for exact in (True, False):
                seed += 1
                case = other_dims_case(d, dtype, exact, seed)
                for causal in (True, False):
                    check_fused(case, causal, (
                        f"d {d} H 8 Hkv 4 T 200 {str(dtype)[6:]} "
                        f"{'exact' if exact else 'random'} "
                        f"{'causal' if causal else 'full'}"))


def blockwise_run(case):
    """A call of `models/attention.py` _blockwise_attention on a fused
    case (granite's full prefill, causal) with granite's cfg (hccs, mode
    wide, block_k 512) and the case's per-head params: what the served
    model runs for that attention today."""
    cfg = get_config("granite-3-2b")
    check(cfg.attention_prob == "hccs" and cfg.hccs_mode == "wide"
          and cfg.block_k == 512, "granite-3-2b attention config changed")
    th = case["theta"]
    hc = {"B": th[:, 0].contiguous(), "S": th[:, 1].contiguous(),
          "D": th[:, 2].contiguous(), "scale": case["scale"]}
    b, _, t, _ = case["q"].shape
    pos = torch.arange(t, device="cuda")[None].expand(b, t)
    return (lambda: _blockwise_attention(case["q"], case["k"], case["v"],
                                         pos, None, cfg, hc))


NEW_KERNELS = (hccs_rows, softmax_bf16, hccs_mha_fused)


def phase_table3():
    """The entry point, and the one place phases 11-14 time. The main
    path: the paper's Table III through repro_torch.kernels
    (softmax_reference in bf16, hccs_softmax in i16_div and i8_clb) at
    4096 x 32/64/128 and granite's 65,536 x 2048 rows, and hccs_attention
    at granite's full prefill shape, each timed per call (CUDA events over
    back-to-back calls, host dispatch included). Every launch counter is
    set to 0 before that run and read after it; each must equal the calls
    made. Then, outside the count: the same calls' device time (captured in
    CUDA graphs and replayed), the plain versions', torch.softmax's and the
    blockwise STE attention's times at granite's shapes, and the outputs
    against the plain versions. Returns the launch counts and the report
    entries {kernel name: timing} at granite's shapes."""
    gen = torch.Generator("cuda").manual_seed(14)
    inputs = []
    for rows, n in [(PAPER_ROWS, c) for c in PAPER_NS] + [(G_ROWS, G_COLS)]:
        xf = (torch.randn((rows, n), generator=gen, device="cuda") * 2.0)
        xi = torch.randint(-128, 128, (rows, n), dtype=torch.int8,
                           device="cuda", generator=gen)
        theta = torch.tensor(np.tile(default_params(n), (rows, 1)) if
                             rows == PAPER_ROWS else row_theta(n, MAX_LEN),
                             dtype=torch.int32, device="cuda")
        inputs.append((rows, n, xf.to(torch.bfloat16), xi, theta))
    attn = fused_case(1, MAX_LEN, MAX_LEN, torch.float32, False, 99)
    calls = {k.__name__: 0 for k in NEW_KERNELS}
    outs = {}

    def call(name, key, fn):
        def run():
            calls[name] += 1
            outs[key] = fn()
        return run

    def table_fns(rows, n, xb, xi, theta):
        return [call("softmax_bf16", (rows, n, "softmax"),
                     lambda: KAPI.softmax_reference(xb)),
                call("hccs_rows", (rows, n, "i16_div"),
                     lambda: KAPI.hccs_softmax(xi, theta, "i16_div")),
                call("hccs_rows", (rows, n, "i8_clb"),
                     lambda: KAPI.hccs_softmax(xi, theta, "i8_clb"))]

    attn_fn = call("hccs_mha_fused", "attention", lambda: KAPI.hccs_attention(
        attn["q"], attn["k"], attn["v"], attn["scale"], attn["theta"]))
    torch.cuda.synchronize()
    for k in KERNELS + NEW_KERNELS:             # count the path's run only
        k.launches = 0
    per_call = {inp[:2]: [cuda_time_ms(f) for f in table_fns(*inp)]
                for inp in inputs}
    t_attn = cuda_time_ms(attn_fn, iters=10, warmup=1)
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in NEW_KERNELS}
    others = {k.__name__: k.launches for k in KERNELS}
    log(f"[table3] launches {launches}, calls {calls}, decode kernels "
        f"{others}")
    check(launches == calls and all(launches.values()),
          f"launches {launches} != calls {calls}")
    check(not any(others.values()), f"decode kernels ran: {others}")

    device = {inp[:2]: [graph_time_ms(f) for f in table_fns(*inp)]
              for inp in inputs}                # not counted: CUDA graphs
    log("[table3] rows x n, per call (host dispatch included) | device "
        "only (CUDA graph): ms, elements/s, speedup over softmax bf16")
    for rows, n in per_call:
        for tag, ts in (("call", per_call[rows, n]),
                        ("device", device[rows, n])):
            el = rows * n
            cols = [f"{name} {t:.4f} ms ({el / t * 1e3:.3e}/s, "
                    f"{ts[0] / t:.2f}x)" for name, t in
                    zip(("softmax bf16", "hccs i16_div", "hccs i8_clb"), ts)]
            log(f"[table3] {rows} x {n} {tag:6s}: " + "; ".join(cols))

    for rows, n, xb, xi, theta in inputs:      # what came out is right
        sm = outs[rows, n, "softmax"]
        check(sm.shape == (rows, n) and sm.dtype == torch.bfloat16
              and int(ulp_bf16(sm, softmax_bf16_ref(xb)).max())
              <= SOFTMAX_MAX_ULP_BF16, f"softmax_reference {rows}x{n}")
        check(torch.equal(outs[rows, n, "i16_div"],
                          hccs_rows_ref(xi, theta, "i16_div"))
              and torch.equal(outs[rows, n, "i8_clb"],
                              hccs_rows_ref(xi, theta, "i8_clb")),
              f"hccs_softmax {rows}x{n}")
    got = outs["attention"]
    attn_err = float((got - hccs_mha_fused_ref(**attn)).abs().max())
    check(got.shape == attn["q"].shape and bool(torch.isfinite(got).all())
          and attn_err <= BLOCKWISE_ATOL, f"hccs_attention: max |d| "
          f"{attn_err}")
    _, _, xb, xi, theta = inputs[-1]            # granite's rows
    sm_err = float((outs[G_ROWS, G_COLS, "softmax"].float()
                    - softmax_bf16_ref(xb).float()).abs().max())
    log(f"[table3] outputs against the plain versions: softmax <= "
        f"{SOFTMAX_MAX_ULP_BF16} ulp (max |d| {sm_err:.3e} at granite's "
        f"rows), hccs_softmax identical, hccs_attention max |d| "
        f"{attn_err:.3e}")

    def entry(ms, fn, plain, library, nbytes, ops, err):
        b, by = bound(nbytes, ops)
        return dict(ms=ms, device_ms=graph_time_ms(fn),
                    cold_ms=cold_time_ms(fn), plain_ms=plain,
                    library_ms=library, bound_ms=b, bound_by=by,
                    max_abs_err=err, bytes=nbytes, ops=ops)

    with torch.inference_mode():
        blockwise_ms = cuda_time_ms(blockwise_run(attn), iters=3, warmup=1)
    g = (G_ROWS, G_COLS)
    _, _, fused_bytes, fused_flops = fused_bound(attn, True)
    timings = {
        "hccs_rows": entry(
            per_call[g][1], lambda: KAPI.hccs_softmax(xi, theta, "i16_div"),
            cuda_time_ms(lambda: hccs_rows_ref(xi, theta, "i16_div"),
                         iters=5), None,
            xi.numel() * 5 + theta.numel() * 4, 10.0 * xi.numel(), 0.0),
        "softmax_bf16": entry(
            per_call[g][0], lambda: KAPI.softmax_reference(xb),
            cuda_time_ms(lambda: softmax_bf16_ref(xb), iters=5),
            cuda_time_ms(lambda: torch.softmax(xb, -1)),
            2 * xb.numel() * xb.element_size(), 5.0 * xb.numel(), sm_err),
        "hccs_mha_fused": entry(
            t_attn, lambda: KAPI.hccs_attention(
                attn["q"], attn["k"], attn["v"], attn["scale"],
                attn["theta"]),
            cuda_time_ms(lambda: hccs_mha_fused_ref(**attn), iters=5), None,
            fused_bytes, fused_flops, attn_err)}
    for name, tm in timings.items():
        lib = (f", torch.softmax {tm['library_ms']:.4f} ms"
               if tm["library_ms"] is not None else "")
        log(f"[table3] timing {name} at granite's shape: kernel "
            f"{tm['ms']:.4f} ms per call, device {tm['device_ms']:.4f} ms "
            f"warm / {tm['cold_ms']:.4f} ms L2-cold, plain "
            f"{tm['plain_ms']:.4f} ms{lib}, bound "
            f"{tm['bound_ms']:.4f} ms ({tm['bound_by']}: "
            f"{tm['bytes'] / 1e6:.2f} MB, {tm['ops'] / 1e9:.3f} G ops)")
    log(f"[table3] the blockwise STE attention on hccs_attention's inputs: "
        f"{blockwise_ms:.4f} ms")
    return launches, timings


# ------------------------------------------------------------ phase 15 --

FOLD_ROWS = (8, 64, 256)        # a decode step, a mixed step, a prefill step


FOLD_FRONTS = np.array([700, 400, 1200, 5, 300, 64, 2000, 129])
FOLD_REPLAY_W = 64              # the commonest verify-step width (phase 18)
FOLD_WIDE_ROWS = 4096           # a --token-budget 4096 step: two launches


def fold_layout(rng, t_valid, width: int):
    """The engine's host layout of one packed step at granite's shapes: 8
    slots at FOLD_FRONTS in a shuffled pool, their `t_valid` lanes packed
    into `width` (pad lanes steered into the trash block 0), and one block
    allocated that no row reaches yet. Returns (n_blocks, stale scales
    (n_blocks, HKV), write targets (width,), the slots' lane offsets, the
    fresh blocks: the ones the step opens and the unreached one)."""
    sid, off = pack_slot_ids(t_valid, width)
    n_blocks = 2 + int(sum(-(-(f + tv) // BS) for f, tv in
                           zip(FOLD_FRONTS, t_valid)))
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.full((MAX_BATCH, NBLK), -1, np.int32)
    scales = rng.uniform(0.005, 0.05, (n_blocks, HKV))
    fresh, c = [int(perm[-1])], 0
    for s, (f, tv) in enumerate(zip(FOLD_FRONTS, t_valid)):
        nb = -(-(f + int(tv)) // BS)
        table[s, :nb] = perm[c:c + nb]
        fresh.extend(int(x) for x in table[s, -(-f // BS):nb])
        c += nb
    wp = packed_write_positions(t_valid, off, table, FOLD_FRONTS, BS, width)
    return n_blocks, scales, wp, off, np.asarray(fresh, np.int32)


def fold_rows(rng, shape, exact: bool, row_dtype):
    """Exact rows are multiples of 2^-3; random rows vary in magnitude row
    by row, so scales grow mid-block."""
    if exact:
        rows = rng.integers(-32, 33, shape) / 8.0
    else:
        rows = (rng.normal(0, 1, shape)
                * rng.choice([0.05, 1.0, 6.0],
                             (*shape[:-3], 1, shape[-2], 1)))
    return torch.tensor(rows, dtype=torch.float32, device="cuda").to(
        row_dtype)


def fold_case(n_rows: int, row_dtype, exact: bool, seed: int, draft: bool):
    """One layer's K and V write of a packed step at granite's shapes, laid
    out by the engine's host code (fold_layout): prefill chunks and decode
    lanes scheduled into n_rows lanes. Every block holds stale bytes and a
    stale scale; `fresh_blocks` lists the blocks the step opens and one it
    does not reach, padded with the trash block to 24 entries, as the
    engine lists them (more where the step opens more: the wide write,
    whose chunks are not capped). K is a contiguous (1, Hkv, T, d) tensor, as apply_rope
    leaves it, V the transposed (1, T, Hkv, d) projection; their rows and
    pools are distinct."""
    rng = np.random.default_rng(seed)
    remaining = {8: [0] * 8, 64: [40] + [0] * 7,
                 256: [150, 60, 0, 30, 0, 0, 0, 0],
                 FOLD_WIDE_ROWS: [1300, 1600, 0, 1000, 0, 0, 0, 0]}[n_rows]
    t_valid = schedule_step_tokens(
        np.ones(MAX_BATCH, bool), np.asarray(remaining), n_rows,
        4 * BS if n_rows <= FOLD_ROWS[-1] else None)
    n_blocks, scales, wp, _, fresh = fold_layout(rng, t_valid, n_rows)
    dev = "cuda"

    def pool(sc, rows):
        return dict(pool=torch.tensor(
            rng.integers(-128, 128, (n_blocks, HKV, BS, D)),
            dtype=torch.int8, device=dev),
            scales=torch.tensor(sc, dtype=torch.float32, device=dev),
            rows=rows)
    k = pool(scales, fold_rows(rng, (1, HKV, n_rows, D), exact, row_dtype))
    v = pool(rng.uniform(0.005, 0.05, scales.shape), fold_rows(
        rng, (1, n_rows, HKV, D), exact, row_dtype).transpose(1, 2))
    return dict(
        k=k, v=v, write_pos=torch.tensor(wp[None], dtype=torch.int32,
                                         device=dev),
        draft_rows=(torch.tensor(rng.random((1, n_rows)) < 0.25, device=dev)
                    if draft else None),
        fresh_blocks=torch.tensor(
            np.pad(fresh, (0, max(0, 24 - len(fresh)))), device=dev))


def fold_replay_case(seed: int, layers: int = 1):
    """One verify step's replay at granite's shapes (serve/paged.py
    _restore_and_replay, after the restore): 8 decoding slots with
    DRAFT_LEN draft lanes each in a width-FOLD_REPLAY_W packed step, 1 to 5
    of each slot's lanes committed, every other lane steered into the trash
    block, the blocks the step opened at scale 0; K and V rows staged f32
    (L, 1, Hkv, W, d), pools (L, N, Hkv, bs, d) for `layers` > 1, one
    layer's shapes (no layer axis) for 1."""
    rng = np.random.default_rng(seed)
    t_valid = schedule_step_tokens(
        np.ones(MAX_BATCH, bool), np.zeros(MAX_BATCH, np.int64),
        FOLD_REPLAY_W, 4 * BS, drafts=np.full(MAX_BATCH, DRAFT_LEN))
    n_blocks, scales, wp, off, fresh = fold_layout(rng, t_valid,
                                                   FOLD_REPLAY_W)
    scales[fresh] = 0.0
    keep = np.zeros(FOLD_REPLAY_W, bool)
    for s, tv in enumerate(t_valid):
        keep[off[s]:off[s] + int(rng.integers(1, tv + 1))] = True
    pos = np.where(keep, wp, np.arange(FOLD_REPLAY_W) % BS).astype(np.int32)
    lead = (layers,) if layers > 1 else ()
    dev = "cuda"

    def pool():
        return dict(
            pool=torch.tensor(rng.integers(-128, 128,
                                           (*lead, n_blocks, HKV, BS, D)),
                              dtype=torch.int8, device=dev),
            scales=torch.tensor(np.broadcast_to(scales,
                                                (*lead, *scales.shape)),
                                dtype=torch.float32, device=dev).contiguous(),
            rows=fold_rows(rng, (*lead, 1, HKV, FOLD_REPLAY_W, D), False,
                           torch.float32))
    return dict(k=pool(), v=pool(), write_pos=torch.tensor(pos[None],
                                                           device=dev),
                draft_rows=None, fresh_blocks=None,
                committed=int(keep.sum()))


def fold_args(case, state=None) -> tuple:
    """paged_quant_scatter_kv's arguments for `case`, on `state`'s pools
    and scales (fold_state) where given."""
    st = state or {n: (case[n]["pool"], case[n]["scales"]) for n in "kv"}
    return (*st["k"], case["k"]["rows"], *st["v"], case["v"]["rows"],
            case["write_pos"], case["draft_rows"], case["fresh_blocks"])


def fold_state(case) -> dict:
    """Copies of the case's pools and scales, {"k": (pool, scales), "v":
    ...}."""
    return {n: (case[n]["pool"].clone(), case[n]["scales"].clone())
            for n in "kv"}


def fold_work(case) -> tuple[float, str, float, float]:
    """Least time for one fold call: the rows and targets read once, each
    distinct (layer, pool, block, kv head) payload and scale the step
    touches read and written once, each unreached fresh block's scale
    written, over the HBM rate; against its operations (per row value the
    abs, max, division and rounding; per scale growth a requant of the
    block's payload, replayed here from the data) over the f32 rate."""
    wp = case["write_pos"].cpu().numpy().reshape(-1)
    blocks = wp // BS
    r, m = wp.shape[0], np.unique(blocks).shape[0]
    fresh = (set() if case["fresh_blocks"] is None else
             set(case["fresh_blocks"].cpu().numpy().tolist()))
    nbytes = r * 4 + 4 * len(fresh - set(blocks.tolist())) * HKV * 2
    ops = 0.0
    for name in "kv":
        rows_all = case[name]["rows"].float().cpu().numpy()
        sc_all = case[name]["scales"].cpu().numpy()
        if rows_all.ndim == 4:
            rows_all, sc_all = rows_all[None], sc_all[None]
        for rows, sc in zip(rows_all, sc_all):
            rows = rows[0].transpose(1, 0, 2)
            sc = sc.copy()
            sc[sorted(fresh)] = 0.0
            grows = 0
            for i, blk in enumerate(blocks):     # the scale chain of the data
                cand = (np.maximum(np.abs(rows[i]).max(-1), np.float32(1e-6))
                        .astype(np.float32) * np.float32(1.0 / 127.0))
                s_new = np.maximum(sc[blk], cand)
                grows += int((s_new != sc[blk]).sum())
                sc[blk] = s_new
            nbytes += (r * HKV * D * case[name]["rows"].element_size()
                       + 2 * m * HKV * BS * D + 2 * m * HKV * 4)
            ops += 6.0 * r * HKV * D + 5.0 * grows * BS * D
    return (*bound(nbytes, ops), nbytes, ops)


def phase_fold():
    """paged_quant_scatter_kv against paged_quant_scatter_kv_ref on the
    card: f32 and bf16 rows, writes of 8, 64 and 256 rows with the
    engine's pad lanes and fresh blocks, exact and random values, distinct
    K and V rows in one launch: in one call, split over three, with draft
    rows, and K alone through paged_quant_scatter; a write of
    FOLD_WIDE_ROWS rows, more than one launch's shared memory holds; then a
    speculative replay of all 40 layers in one launch. Gate: pools and
    scales bit-identical. Then the times at 8/64/256 rows and the
    replay."""
    lib = kbuild.load_library()
    for r in (0, 1, 8, 16, 17, 256, 4096):
        for bs in (16, BS):
            c = lib.paged_quant_scatter_kv_smem_bytes(r, bs)
            py = fold_smem_bytes(r, bs)
            check(c == py, f"fold_smem_bytes({r}, {bs}): C {c} != Python "
                  f"{py}")
    n_cases = 0
    for n_rows in FOLD_ROWS:
        for row_dtype in (torch.float32, torch.bfloat16):
            for exact in (True, False):
                for variant in ("one call", "split", "draft", "K alone"):
                    case = fold_case(n_rows, row_dtype, exact,
                                     seed=n_rows + 3 * n_cases,
                                     draft=variant == "draft")
                    want, got = fold_state(case), fold_state(case)
                    if variant == "K alone":
                        for st in (want, got):
                            st["k"][1][case["fresh_blocks"].long()] = 0.0
                        paged_quant_scatter_ref(*want["k"], case["k"]["rows"],
                                                case["write_pos"])
                        paged_quant_scatter(*got["k"], case["k"]["rows"],
                                            case["write_pos"])
                    else:
                        paged_quant_scatter_kv_ref(*fold_args(case, want))
                        cuts = ((0, n_rows) if variant != "split" else
                                (0, n_rows // 3, n_rows // 2, n_rows))
                        for a, b in zip(cuts[:-1], cuts[1:]):
                            dr = case["draft_rows"]
                            paged_quant_scatter_kv(
                                *got["k"], case["k"]["rows"][:, :, a:b],
                                *got["v"], case["v"]["rows"][:, :, a:b],
                                case["write_pos"][:, a:b],
                                None if dr is None else dr[:, a:b],
                                case["fresh_blocks"] if a == 0 else None)
                    torch.cuda.synchronize()
                    what = (f"{n_rows} rows {row_dtype} "
                            f"{'exact' if exact else 'random'} {variant}")
                    check_fold(got, want, what)
                    n_cases += 1
    check(fold_smem_bytes(FOLD_WIDE_ROWS, BS) > MAX_SMEM_BYTES,
          f"{FOLD_WIDE_ROWS} rows fit one launch's shared memory")
    for variant in ("one call", "draft"):
        case = fold_case(FOLD_WIDE_ROWS, torch.bfloat16, False, seed=29,
                         draft=variant == "draft")
        want, got = fold_state(case), fold_state(case)
        paged_quant_scatter_kv_ref(*fold_args(case, want))
        paged_quant_scatter_kv(*fold_args(case, got))
        torch.cuda.synchronize()
        check_fold(got, want, f"{FOLD_WIDE_ROWS} rows bf16 random {variant}")
        n_cases += 1
    replay = {n: fold_replay_case(seed=17 + n, layers=n) for n in (1, M_LAYERS)}
    for layers, case in replay.items():
        want, got = fold_state(case), fold_state(case)
        paged_quant_scatter_kv_ref(*fold_args(case, want))
        paged_quant_scatter_kv(*fold_args(case, got))
        torch.cuda.synchronize()
        check_fold(got, want, f"replay of {layers} layer(s)")
        n_cases += 1
    log(f"[fold] {n_cases} cases (rows {FOLD_ROWS}, f32 and bf16, exact and "
        f"random, K and V in one launch in one call / split over three "
        f"calls / with draft rows, K alone; {FOLD_WIDE_ROWS} rows in slices; "
        f"the replay at W "
        f"{FOLD_REPLAY_W} of 1 and {M_LAYERS} layers in one launch): pools "
        f"and scales bit-identical to the plain version; card {CARD}")
    timing = {}
    for n_rows in FOLD_ROWS:
        case = fold_case(n_rows, torch.bfloat16, False, seed=5 + n_rows,
                         draft=False)
        timing[f"{n_rows} bf16 rows, K+V"] = fold_times(case)
    timing[f"replay, {M_LAYERS} layers, W {FOLD_REPLAY_W} f32, K+V"] = \
        fold_times(replay[M_LAYERS], plain_iters=2)
    for what, tm in timing.items():
        log(f"[fold] timing {what}: kernel {tm['ms']:.4f} ms per call, "
            f"device {tm['device_ms']:.4f} ms warm / {tm['cold_ms']:.4f} ms "
            f"L2-cold, plain {tm['plain_ms']:.4f} ms, bound "
            f"{tm['bound_ms']:.5f} ms ({tm['bound_by']}: "
            f"{tm['bytes'] / 1e6:.3f} MB, {tm['flops'] / 1e6:.2f} M ops); "
            f"{tm['passes']}; card {CARD}")
    log(f"[fold] one layer's int8 write at the engine's shapes (64 lanes): "
        f"{fold_call_counts()}")
    return dict(timing[f"{FOLD_ROWS[-1]} bf16 rows, K+V"], max_abs_err=0.0,
                timing=timing)


def check_fold(got, want, what: str):
    for n in "kv":
        check(torch.equal(got[n][0], want[n][0]),
              f"fold {n} pool differs: {what}, "
              f"{int((got[n][0] != want[n][0]).sum())} bytes")
        check(torch.equal(got[n][1], want[n][1]),
              f"fold {n} scales differ: {what}")


def fold_times(case, plain_iters: int = 5) -> dict:
    """The K+V fold's times at one case: the pools and scales are restored
    before each call (the fold is in place), and the restore's own time is
    taken off every number."""
    saved = fold_state(case)
    live = {n: (case[n]["pool"], case[n]["scales"]) for n in "kv"}

    def restore():
        for n in "kv":
            for dst, src in zip(live[n], saved[n]):
                dst.copy_(src)

    def kernel():
        restore()
        paged_quant_scatter_kv(*fold_args(case))

    def plain():
        restore()
        paged_quant_scatter_kv_ref(*fold_args(case))
    base = (cuda_time_ms(restore), graph_time_ms(restore),
            cold_time_ms(restore))
    bound_ms, by, nbytes, ops = fold_work(case)
    out = dict(ms=cuda_time_ms(kernel) - base[0],
               device_ms=graph_time_ms(kernel) - base[1],
               cold_ms=cold_time_ms(kernel) - base[2],
               plain_ms=cuda_time_ms(plain, iters=plain_iters,
                                     warmup=1) - base[0],
               passes=kernel_passes(
                   lambda: paged_quant_scatter_kv(*fold_args(case))),
               bound_ms=bound_ms, bound_by=by, bytes=nbytes, flops=ops)
    restore()
    return out


def host_profile(prof, tag: str) -> dict:
    """The host side of a profiled run, read once from its kineto events:
    aten ops (nested ones counted), device kernels, and the device kernels
    launched inside the `tag` ranges (record_function), matched to their
    runtime launch by correlation id, by kernel name."""
    ranges, launch_at, kern, aten = [], {}, [], 0
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not (e.is_user_annotation() or name == tag):
                kern.append((e.correlation_id(), name))
        elif name == tag:
            ranges.append((e.start_ns(), e.end_ns()))
        elif name.startswith("aten::"):
            aten += 1
        elif name.startswith(("cudaLaunch", "cuLaunch")):
            launch_at[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [a for a, _ in ranges]
    inside = collections.Counter()
    for corr, name in kern:
        t = launch_at.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            inside[name] += 1
    return dict(aten=aten, kernels=len(kern), tag_calls=len(ranges),
                matched=sum(1 for c, _ in kern if c in launch_at),
                inside=inside)


@contextlib.contextmanager
def tagged(module, name: str, tag: str):
    """`module.name` wrapped in torch.profiler.record_function(tag) for the
    duration: host_profile then finds the kernels each call launched."""
    fn = getattr(module, name)

    def wrapped(*a, **kw):
        with torch.profiler.record_function(tag):
            return fn(*a, **kw)
    setattr(module, name, wrapped)
    try:
        yield
    finally:
        setattr(module, name, fn)


def short_name(name: str) -> str:
    """A kernel's name without its namespace, template and arguments."""
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("<")[0].split("(")[0].split("::")[-1].strip()[:60]


def fold_call_counts(calls: int = 20) -> str:
    """What one layer's int8 write (models/attention.py _quant_write) costs
    the host and the card at the engine's call shapes: a 64-lane packed
    step's K and V (fold_case), with the fresh-block list, without and with
    draft rows; profiled over `calls` layers: aten ops and device kernels a
    layer, by kernel name."""
    case = fold_case(64, torch.bfloat16, False, seed=11, draft=True)
    parts = []
    for dr in (None, case["draft_rows"]):
        cache = dict(k=case["k"]["pool"], v=case["v"]["pool"],
                     k_scale=case["k"]["scales"],
                     v_scale=case["v"]["scales"],
                     write_pos=case["write_pos"],
                     fresh_blocks=case["fresh_blocks"])
        if dr is not None:
            cache["draft_rows"] = dr

        def layer(cache=cache):
            A._quant_write(cache, case["k"]["rows"], case["v"]["rows"])
        layer()
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                layer()
            torch.cuda.synchronize()
        hp = host_profile(prof, "")
        by = collections.Counter()
        for e in device_events(prof):
            by[short_name(e.name)] += 1
        parts.append(
            f"{'verify' if dr is not None else 'plain'} step: "
            f"{hp['aten'] / calls:.1f} aten ops a layer; device kernels by "
            f"name: " + ", ".join(f"{n} {c}" for n, c in by.most_common())
            + f" ({hp['kernels']} events delivered of {calls} layers)")
    return "; ".join(parts)

# ------------------------------------------------------------ phase 16 --

SYSTEM_LEN = 512                # the sessions' shared system prefix
TURN2_LEN = 64                  # each session's second message


def session_traffic(cfg):
    """Phase 16's traffic, seeded: one system prefix, 8 user parts of
    32-480 tokens, 8 second-turn messages (the one later turn)."""
    rng = np.random.default_rng(2)
    system = rng.integers(0, cfg.vocab_size, SYSTEM_LEN).astype(np.int32)
    users = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
             for n in rng.integers(32, 481, MAX_BATCH)]
    turn2 = [rng.integers(0, cfg.vocab_size, TURN2_LEN).astype(np.int32)
             for _ in range(MAX_BATCH)]
    return system, users, [turn2]


def serve_sessions(params, cfg, traffic, profiled=False, new_tokens=32,
                   on_engine=None, **kw):
    """The sessions of `traffic` through the packed PagedEngine. Turn 1:
    session 0 alone until its prefill is done, then sessions 1-7 and one
    request whose prompt is exactly the system prefix (a block-aligned full
    hit: its re-fed last token forces a COW). Each later turn: every
    session sends its next message (uids 100 t + session). `new_tokens` a
    request. `on_engine(eng)` runs before the first request. The kernels'
    counts are set to 0 just before and read just after. Returns the run's
    record."""
    system, users, later = traffic
    eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      block_size=BS, device="cuda", **kw)
    if on_engine is not None:
        on_engine(eng)
    reqs = {}

    def submit(uid, prompt, session=None):
        reqs[uid] = Request(uid=uid, prompt=prompt.copy(),
                            max_new_tokens=new_tokens)
        eng.submit(reqs[uid], session=session)
    torch.cuda.synchronize()
    for k in KERNELS + FOLD_KERNELS:
        k.launches = 0
    ctx = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profiled
        else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        submit(0, np.concatenate([system, users[0]]), "s0")
        while not prefill_dispatched(eng, reqs[0]):
            eng.step()
        for s in range(1, MAX_BATCH):
            submit(s, np.concatenate([system, users[s]]), f"s{s}")
        submit(MAX_BATCH, system)
        eng.run()
        turn1 = eng.prefix_stats()
        for t, msgs in enumerate(later):
            for s in range(MAX_BATCH):
                submit(100 * (t + 1) + s, msgs[s], f"s{s}")
            eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for r in reqs.values():
        check(r.done and len(r.out_tokens) == new_tokens,
              f"request {r.uid} not done")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              "token off vocab")
    return dict(eng=eng, wall=wall, prof=prof, turn1=turn1,
                stats=eng.prefix_stats(), steps=eng.occupancy_steps,
                toks={u: list(r.out_tokens) for u, r in reqs.items()},
                prompts={u: np.asarray(r.prompt) for u, r in reqs.items()},
                launches={k.__name__: k.launches
                          for k in KERNELS + FOLD_KERNELS})


def prefill_dispatched(eng, req) -> bool:
    """True once every prompt token of `req` has gone into a step: the
    step that samples its first token in the sync loop, the dispatch of
    that step in the async loop (whose token lands a step later)."""
    if req.out_tokens or req.done:
        return True
    for s, r in enumerate(eng._slots):
        if r is req:
            return eng._prompt_pos[s] >= len(eng._feeds[s])
    return False


def span_kernels(prof, tag: str) -> list:
    """(name, device ms) of each kernel (copies and fills included)
    launched inside the `tag` ranges (record_function) of a profiled run,
    matched to its runtime call by correlation id."""
    ranges, launch_at, kern = [], {}, []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA"):
            if not (e.is_user_annotation() or name == tag):
                kern.append((e.correlation_id(), name, e.duration_ns()))
        elif name == tag:
            ranges.append((e.start_ns(), e.end_ns()))
        elif name.startswith(("cudaLaunch", "cuLaunch", "cudaMemcpy",
                              "cudaMemset")):
            launch_at[e.correlation_id()] = e.start_ns()
    ranges.sort()
    starts = [a for a, _ in ranges]
    out = []
    for corr, name, dur in kern:
        t = launch_at.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            out.append((name, dur / 1e6))
    return out


def is_gemm(name: str) -> bool:
    """A cuBLAS / CUTLASS matrix-product kernel, by its name (cuBLAS 12.8
    names its Hopper kernels nvjet_*)."""
    return any(k in name.lower() for k in ("gemm", "xmma", "cutlass",
                                           "nvjet"))


def moe_split(prof, busy: float) -> dict:
    """The device time launched inside models/moe.py apply_moe ("moe"),
    split into the router and queue ranks (`route`, "moe_route"), the
    experts' products (the matrix-product kernels of apply_moe outside
    route) and dispatch and combine (the rest: gathers, masks, the gate
    product and the sum), each in ms and as a share of device busy."""
    moe = span_kernels(prof, "moe")
    route = sum(d for _, d in span_kernels(prof, "moe_route"))
    total = sum(d for _, d in moe)
    gemm = sum(d for n, d in moe if is_gemm(n))
    route_gemm = sum(d for n, d in span_kernels(prof, "moe_route")
                     if is_gemm(n))
    experts = gemm - route_gemm
    parts = dict(moe=total, router=route, experts=experts,
                 dispatch_combine=total - route - experts)
    log("[moe profile] device time inside apply_moe: " + ", ".join(
        f"{k} {v:.1f} ms ({v / busy:.3f} of busy)" for k, v in parts.items())
        + f"; {len(moe)} kernels; device busy {busy:.1f} ms")
    return parts


def kernel_total(prof, symbol: str) -> tuple[float, int]:
    """Device ms and count of the profiled kernels whose name holds
    `symbol`."""
    ev = [e for e in device_events(prof) if symbol in e.name]
    return sum(e.end - e.start for e in ev) / 1e3, len(ev)


def phase_sharing():
    """The packed PagedEngine with int8 KV, prefix and decode sharing,
    serving two turns of 8 sessions (serve_sessions): twice unprofiled, once
    profiled; the same traffic with sharing off and with an f32 pool, each
    held to the sharing run by ROADMAP C1's rule. Gates: turn 1 hits >= 7,
    COW copies >= 1, turn 2's skip rate >= 0.75, the int8/f32 pool bytes
    0.25 + 1/(block_size * head_dim), the fold launched 40 and the packed
    kernel 40 times a step, identical tokens in the three sharing runs."""
    cfg, params = engine_model()
    q8 = cfg.replace(kv_quant="int8")
    traffic = session_traffic(cfg)
    share = dict(prefix_sharing=True, decode_sharing=True)
    taps = []
    runs = []
    for rep in range(3):
        with (tagged(A, "_quant_write", WRITE_TAG) if rep == 2
              else contextlib.nullcontext()):
            runs.append(serve_sessions(
                params, q8, traffic, profiled=rep == 2,
                on_engine=(lambda e: taps.append(LogitTap(e)))
                if rep == 2 else None, **share))
    main = dict(runs[0], tap=taps[0])
    for rep, run in enumerate(runs):
        steps, la = run["steps"], run["launches"]
        n_new = sum(len(t) for t in run["toks"].values())
        log(f"[sharing] run {rep}{' (profiled)' if rep == 2 else ''}: "
            f"{steps} packed steps, paged_quant_scatter_kv launches "
            f"{la['paged_quant_scatter_kv']}, hccs_packed_prefill launches "
            f"{la['hccs_packed_prefill']}; {n_new} tokens in "
            f"{run['wall']:.3f}s = {n_new / run['wall']:.1f} new tok/s")
        check(la["paged_quant_scatter_kv"] == M_LAYERS * steps,
              f"fold launches {la['paged_quant_scatter_kv']} != {M_LAYERS} "
              f"x {steps} steps")
        check(la["hccs_packed_prefill"] == M_LAYERS * steps,
              f"packed launches {la['hccs_packed_prefill']} != "
              f"{M_LAYERS} x {steps} steps")
        check(not la["hccs_paged_decode"] and not la["hccs_decode"],
              "other kernels ran")
        check(run["toks"] == main["toks"], "the sharing runs disagree")
    t1, st = main["turn1"], main["stats"]
    log(f"[sharing] turn 1: {t1['hits']}/{t1['lookups']} hits, "
        f"{t1['prefill_tokens_skipped']}/{t1['prefill_tokens']} prefill "
        f"tokens skipped, {t1['cow_copies']} COW copies; both turns: "
        f"{st['hits']}/{st['lookups']} hits ({st['decode_hits']} "
        f"decode-block), turn 2 skips {st['followup_tokens_skipped']}/"
        f"{st['followup_prefill_tokens']} = {st['followup_skip_rate']:.4f} "
        f"of its prefill tokens, {st['evictions']} evictions, "
        f"{st['cached_blocks']} blocks cached")
    check(t1["hits"] >= 7, f"turn 1 hits {t1['hits']} < 7")
    check(st["cow_copies"] >= 1, "no COW copy")
    check(st["followup_skip_rate"] >= 0.75,
          f"turn 2 skip rate {st['followup_skip_rate']} < 0.75")
    prof = runs[2]["prof"]
    n_packed = profile_summary(prof, runs[2]["wall"], "PackedRows",
                               "sharing profile")
    fold_ms, n_fold = kernel_total(prof, "paged_quant_scatter")
    busy = prof_busy_ms(prof)
    hp, steps = host_profile(prof, WRITE_TAG), runs[2]["steps"]
    log(f"[sharing] profiled run, per step: {hp['aten'] / steps:.1f} aten "
        f"ops, {hp['kernels'] / steps:.1f} device kernels; "
        f"{hp['tag_calls']} int8 writes (models/attention.py _quant_write, "
        f"one a layer), the kernels launched inside them: " + ", ".join(
            f"{short_name(n)} {c}" for n, c in hp["inside"].most_common())
        + f" ({hp['matched']} of {hp['kernels']} kernels matched to their "
        f"launch); fold {fold_ms / busy:.3f} of device busy {busy:.1f} ms; "
        f"card {CARD}")
    folds = sum(c for n, c in hp["inside"].items()
                if "paged_quant_scatter" in n)
    check(hp["tag_calls"] == M_LAYERS * steps and folds == hp["tag_calls"]
          and sum(hp["inside"].values()) == folds,
          f"sharing: {hp['tag_calls']} int8 writes launched {folds} folds "
          f"and {sum(hp['inside'].values()) - folds} other kernels (a copy "
          f"or a conversion beside the fold)")
    log(f"[sharing] fold kernels {fold_ms:.1f} ms over {n_fold} launches; "
        f"idle share of the unprofiled walls "
        f"{1 - busy / 1e3 / runs[0]['wall']:.3f}, "
        f"{1 - busy / 1e3 / runs[1]['wall']:.3f}")
    plain = tapped_sessions(params, q8, traffic)
    f32 = tapped_sessions(params, cfg, traffic, **share)
    ratio = (kv_cache_byte_stats(main["eng"]._cache, q8)["cache_bytes_logical"]
             / kv_cache_byte_stats(f32["eng"]._cache, cfg)
             ["cache_bytes_logical"])
    want = 0.25 + 1 / (BS * cfg.head_dim)
    log(f"[sharing] int8 / f32 pool bytes {ratio:.7f} (0.25 + 1/({BS} x "
        f"{cfg.head_dim}) = {want:.7f}); sharing off: "
        f"{plain['steps']} steps in {plain['wall']:.3f}s; f32 pool: "
        f"{f32['steps']} steps in {f32['wall']:.3f}s")
    check(ratio == want, f"int8/f32 byte ratio {ratio}")
    check(f32["launches"]["paged_quant_scatter_kv"] == 0,
          "the f32 pool launched the fold")
    for label, run in (("sharing off", plain), ("f32 pool", f32)):
        held_to_sessions(label, run, main, params, q8, cfg, share)
    return (main["launches"]["paged_quant_scatter_kv"],
            per_call(n_fold, runs[2]["launches"]["paged_quant_scatter_kv"]),
            dict(toks=main["toks"], prompts=main["prompts"], tap=main["tap"],
                 walls=[runs[0]["wall"], runs[1]["wall"]], busy_ms=busy))


def tapped_sessions(params, cfg, traffic, **kw):
    """serve_sessions with the engine's own logits tapped (run["tap"])."""
    taps = []
    run = serve_sessions(params, cfg, traffic,
                         on_engine=lambda e: taps.append(LogitTap(e)), **kw)
    return dict(run, tap=taps[0])


def held_to_sessions(label, run, ref, params, ref_cfg, cfg, share):
    """ROADMAP C1's rule for a sessions run against phase 16's reference
    run (both tapped): a later turn whose history diverged is held to the
    reference engine's serving of its own prompt, history included (plain
    requests, `share` on), instead of the reference's turn."""
    later = {uid: prompt for uid, prompt in run["prompts"].items()
             if not np.array_equal(prompt, ref["prompts"][uid])}
    again = serve_prompts(params, ref_cfg, later, 32, **share)
    log(f"[{label}] {len(later)} later turns after a diverged history "
        f"re-served by the reference engine")
    ref_toks, ref_prompts, ref_own = against(run, ref, again)
    divergence(label, run["toks"], ref_toks, run["prompts"], ref_prompts,
               params, cfg, own=(run["tap"].own, ref_own))


def prof_busy_ms(prof) -> float:
    """Device busy time (ms) of a profiled run: the union of its kernels'
    intervals."""
    spans = sorted((e.start, e.end) for e in device_events(prof))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy / 1e3


# ------------------------------------------------------------ phase 17 --

def phase_grid(packed_tokens, packed_own):
    """The packed PagedEngine with decode_kernel="none" (the per-slot STE
    grid) on phase 5's traffic, once, profiled: its wall and device busy
    time, no HCCS kernel launched, and its tokens held to phase 5's by
    ROADMAP C1's rule."""
    cfg, params = engine_model()
    grid_cfg = cfg.replace(decode_kernel="none")
    prompts = smoke_prompts(cfg)
    eng = PagedEngine(params, grid_cfg, max_batch=MAX_BATCH,
                      max_len=MAX_LEN, block_size=BS, device="cuda")
    tap = LogitTap(eng)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32))
    torch.cuda.synchronize()
    for k in KERNELS + FOLD_KERNELS:
        k.launches = 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    toks = {r.uid: list(r.out_tokens) for r in done}
    check(len(done) == MAX_BATCH and all(len(t) == 32 for t in toks.values()),
          "grid: not every request done")
    launched = {k.__name__: k.launches
                for k in KERNELS + FOLD_KERNELS}
    check(not any(launched.values()), f"grid: kernels ran {launched}")
    log(f"[grid] {eng.occupancy_steps} packed steps, wall {wall:.3f}s "
        f"(profiled), device busy {prof_busy_ms(prof):.1f} ms")
    profile_summary(prof, wall, "PackedRows", "grid profile")
    if packed_tokens is not None:
        by_uid = dict(enumerate(prompts))
        divergence("grid", toks, packed_tokens, by_uid, by_uid, params, cfg,
                   own=(tap.own, packed_own))


# ------------------------------------------------------------ phase 18 --

SPEC_NEW = 64                   # new tokens a request in phases 18-19
DRAFT_LEN = 4
POOL_KEYS = ("k", "v", "k_scale", "v_scale")


def spec_traffic(cfg):
    """Phase 18's traffic: phase 16's sessions and a third turn of
    TURN2_LEN tokens a session (seeded)."""
    system, users, later = session_traffic(cfg)
    rng = np.random.default_rng(3)
    turn3 = [rng.integers(0, cfg.vocab_size, TURN2_LEN).astype(np.int32)
             for _ in range(MAX_BATCH)]
    return system, users, later + [turn3]


def record_widths(eng):
    """Wrap the engine's two packed device seams to count the width of
    every packed step, verify steps apart. Returns the two Counters."""
    widths = {"_packed_fn": collections.Counter(),
              "_packed_spec_fn": collections.Counter()}
    for name, hist in widths.items():
        fn = getattr(eng, name)

        def wrapped(tokens, *args, _fn=fn, _hist=hist):
            _hist[int(tokens.shape[1])] += 1
            return _fn(tokens, *args)
        setattr(eng, name, wrapped)
    return widths["_packed_fn"], widths["_packed_spec_fn"]


class ReplayProbe:
    """Stands in for serve/paged.py's _restore_and_replay during one run:
    counts its calls and the fold launches they make (the replay's, apart
    from the in-step folds), and captures one call for the direct check
    (the first, replaced by the first of a pure-decode verify step whose
    fresh-block mask is set): the pools before and after, and its
    arguments."""

    def __init__(self, capture: bool):
        self.calls = 0
        self.replay_idx = []        # the run's fold launches that replayed
        self.capture = capture
        self.captured = None
        self.orig = serve_paged._restore_and_replay

    @property
    def launches(self) -> int:
        return len(self.replay_idx)

    def __enter__(self):
        serve_paged._restore_and_replay = self
        return self

    def __exit__(self, *exc):
        serve_paged._restore_and_replay = self.orig

    def __call__(self, layers, snap, blocks, fresh_mask, staged_k, staged_v,
                 replay_pos):
        ideal = (replay_pos.numel() <= 2 * MAX_BATCH
                 and bool(fresh_mask.any()))
        take = self.capture and (self.captured is None or (
            ideal and not self.captured["ideal"]))
        pre = {n: layers[n].clone() for n in POOL_KEYS} if take else None
        before = paged_quant_scatter_kv.launches
        out = self.orig(layers, snap, blocks, fresh_mask, staged_k, staged_v,
                        replay_pos)
        self.replay_idx.extend(range(before, paged_quant_scatter_kv.launches))
        self.calls += 1
        if take:
            self.captured = dict(
                pre=pre, post={n: layers[n].clone() for n in POOL_KEYS},
                args=(snap, blocks, fresh_mask, staged_k, staged_v,
                      replay_pos), fresh=bool(fresh_mask.any()),
                ideal=ideal, rows=int(replay_pos.numel()), call=self.calls)
        return out


def replay_matches_plain(probe) -> str:
    """The captured verify step's restore and replay done again from the
    same pre-call pools, snapshot and staged rows with the plain fold
    (paged_quant_scatter_kv_ref): every pool byte and scale must equal the
    card's. Returns a description of the step."""
    cap = probe.captured
    check(cap is not None, "spec: no verify step was captured")
    layers = {n: t.clone() for n, t in cap["pre"].items()}
    serve_paged.paged_quant_scatter_kv = paged_quant_scatter_kv_ref
    try:
        with torch.inference_mode():
            probe.orig(layers, *cap["args"])
    finally:
        serve_paged.paged_quant_scatter_kv = paged_quant_scatter_kv
    torch.cuda.synchronize()
    for n in POOL_KEYS:
        check(torch.equal(layers[n], cap["post"][n]),
              f"spec: restore and replay on the card differs from the plain "
              f"fold in {n}")
    return (f"verify step {cap['call']} ({cap['rows']} lanes, fresh blocks "
            f"{'re-zeroed' if cap['fresh'] else 'none'})")


def replay_fold_ms(prof, probe, launches: int) -> tuple[float, float]:
    """Device ms of a profiled run's fold kernels, (in-step, replay): one
    kernel a wrapper call on one stream, so the i-th fold kernel on the
    card's timeline is the run's i-th launch, and the probe's launch
    indices pick out the replay's."""
    ev = sorted((e for e in device_events(prof)
                 if "paged_quant_scatter" in e.name), key=lambda e: e.start)
    check(len(ev) == launches, f"spec: {len(ev)} fold kernels profiled, "
          f"{launches} launched")
    dur = np.asarray([e.end - e.start for e in ev]) / 1e3
    replay = np.zeros(len(ev), bool)
    replay[probe.replay_idx] = True
    return float(dur[~replay].sum()), float(dur[replay].sum())


def serve_prompts(params, cfg, prompts: dict, new_tokens: int, **kw):
    """Each of `prompts` ({key: prompt}) as one plain request through a
    fresh, tapped PagedEngine; returns ({key: tokens}, {(key, k): own
    logits})."""
    if not prompts:
        return {}, {}
    eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      block_size=BS, device="cuda", **kw)
    tap = LogitTap(eng)
    keys = list(prompts)
    reqs = [Request(uid=i, prompt=np.asarray(prompts[key]).copy(),
                    max_new_tokens=new_tokens) for i, key in enumerate(keys)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    check(all(r.done and len(r.out_tokens) == new_tokens for r in reqs),
          "a re-served request is not done")
    return ({key: list(r.out_tokens) for key, r in zip(keys, reqs)},
            {(keys[u], k): v for (u, k), v in tap.own.items()})


def against(run, ref, again):
    """The reference `ref` for the tested `run`, each request whose prompt
    differs between the two (a later turn after a diverged one) replaced
    by `again`'s serving of the tested run's own prompt (keyed by uid):
    (tokens, prompts, own logits)."""
    toks, prompts = dict(ref["toks"]), dict(ref["prompts"])
    own = dict(ref["tap"].own)
    for uid, again_toks in again[0].items():
        toks[uid], prompts[uid] = again_toks, run["prompts"][uid]
        for k in range(len(again_toks)):
            own[(uid, k)] = again[1][(uid, k)]
    return toks, prompts, own


def phase_spec():
    """Speculative decoding on the packed PagedEngine with int8 KV and
    decode sharing, draft_len 4, over phase 16's sessions with a third turn
    and 64 new tokens a request: drafting on twice unprofiled and once
    profiled (the replay's fold time apart), off once, with an f32 pool on
    once and off once. The first drafting run and the f32 pool's are held
    to the never-drafted run of their pool by the near-tie rule in the
    f32-KV forward and in both runs' own logits; a later turn whose
    history diverged is held to a never-drafted serving of its own prompt
    instead. Returns the launches of the first drafting run {name: n} with
    the fold split in-step / replay."""
    cfg, params = engine_model()
    q8 = cfg.replace(kv_quant="int8")
    traffic = spec_traffic(cfg)
    share = dict(prefix_sharing=True, decode_sharing=True,
                 draft_len=DRAFT_LEN)
    log(f"[spec] card: {CARD}")

    def drafted(run_cfg, profiled=False, capture=False, tap=False):
        hists = {}

        def hook(eng):
            hists["plain"], hists["verify"] = record_widths(eng)
            if tap:
                hists["tap"] = LogitTap(eng)
        with ReplayProbe(capture) as probe:
            run = serve_sessions(params, run_cfg, traffic, profiled=profiled,
                                 new_tokens=SPEC_NEW, on_engine=hook,
                                 speculative=True, **share)
        run.update(probe=probe, **hists)
        return run

    runs = [drafted(q8, capture=True, tap=True), drafted(q8),
            drafted(q8, profiled=True)]
    main = runs[0]
    for rep, run in enumerate(runs):
        steps, la, st = run["steps"], run["launches"], run["stats"]
        probe, verify = run["probe"], run["verify"]
        n_verify = sum(verify.values())
        fold = la["paged_quant_scatter_kv"]
        n_new = sum(len(t) for t in run["toks"].values())
        log(f"[spec] run {rep}{' (profiled)' if rep == 2 else ''}: {steps} "
            f"packed steps ({n_verify} verify steps), wall "
            f"{run['wall']:.3f}s = {n_new / run['wall']:.1f} new tok/s; "
            f"acceptance {st['acceptance_rate']:.4f}: "
            f"{st['tokens_drafted']} drafted, {st['tokens_accepted']} "
            f"accepted, {st['tokens_rejected']} rejected over "
            f"{st['spec_steps']} slot verifies, {st['spec_rollbacks']} "
            f"rollback steps; hccs_packed_prefill launches "
            f"{la['hccs_packed_prefill']}, fold launches {fold} "
            f"({fold - probe.launches} in-step, {probe.launches} replay over "
            f"{probe.calls} replays); card {CARD}")
        check(st["tokens_drafted"] == st["tokens_accepted"]
              + st["tokens_rejected"], "spec: drafted != accepted + rejected")
        check(n_verify >= 1 and st["spec_rollbacks"] >= 1,
              "spec: no verify step or no rollback")
        check(la["hccs_packed_prefill"] == M_LAYERS * steps,
              f"spec: packed launches {la['hccs_packed_prefill']} != "
              f"{M_LAYERS} x {steps} steps")
        check(fold - probe.launches == M_LAYERS * steps,
              f"spec: in-step fold launches {fold - probe.launches} != "
              f"{M_LAYERS} x {steps} steps")
        check(probe.calls == n_verify and probe.launches == n_verify,
              f"spec: {probe.launches} replay launches over {probe.calls} "
              f"replays, {n_verify} verify steps")
        check(not la["hccs_paged_decode"] and not la["hccs_decode"],
              "spec: other kernels ran")
        check(run["toks"] == main["toks"], "spec: the drafting runs disagree")
    log(f"[spec] verify-step widths {dict(sorted(main['verify'].items()))}, "
        f"other packed steps {dict(sorted(main['plain'].items()))}")
    log(f"[spec] direct check: {replay_matches_plain(main['probe'])} "
        f"restored and replayed on the card byte-identical to the plain fold")
    prof = runs[2]["prof"]
    profile_summary(prof, runs[2]["wall"], "PackedRows", "spec profile")
    fold_ms, n_fold = kernel_total(prof, "paged_quant_scatter")
    in_step_ms, replay_ms = replay_fold_ms(
        prof, runs[2]["probe"], runs[2]["launches"]["paged_quant_scatter_kv"])
    n_replay = runs[2]["probe"].launches
    busy = prof_busy_ms(prof)
    log(f"[spec] fold kernels {fold_ms:.1f} ms over {n_fold} launches: "
        f"in-step {in_step_ms:.1f} ms over {n_fold - n_replay}, replay "
        f"{replay_ms:.1f} ms over {n_replay} ({replay_ms / fold_ms:.3f} of "
        f"the fold time); device busy {busy:.1f} ms, idle share of the "
        f"unprofiled walls {1 - busy / 1e3 / runs[0]['wall']:.3f}, "
        f"{1 - busy / 1e3 / runs[1]['wall']:.3f}; card {CARD}")

    def never_drafted(run_cfg):
        taps = []
        run = serve_sessions(params, run_cfg, traffic, new_tokens=SPEC_NEW,
                             speculative=False,
                             on_engine=lambda e: taps.append(LogitTap(e)),
                             **share)
        check(run["stats"]["tokens_drafted"] == 0,
              "spec: drafting off drafted")
        return dict(run, tap=taps[0])
    off = never_drafted(q8)
    f32, f32_off = drafted(cfg, tap=True), never_drafted(cfg)
    n_new = sum(len(t) for t in off["toks"].values())
    log(f"[spec] drafting off: {off['steps']} steps in {off['wall']:.3f}s = "
        f"{n_new / off['wall']:.1f} new tok/s; f32 pool: drafting on "
        f"{f32['steps']} steps in {f32['wall']:.3f}s, acceptance "
        f"{f32['stats']['acceptance_rate']:.4f}, off {f32_off['steps']} "
        f"steps in {f32_off['wall']:.3f}s; card {CARD}")
    check(f32["launches"]["paged_quant_scatter_kv"] == 0
          and f32_off["launches"]["paged_quant_scatter_kv"] == 0,
          "spec: the f32 pool launched the fold")
    for tag, run, ref, run_cfg in (("int8", main, off, q8),
                                   ("f32", f32, f32_off, cfg)):
        # a later turn whose history diverged is held to a never-drafted
        # serving of its own prompt, history included
        later = {uid: prompt for uid, prompt in run["prompts"].items()
                 if not np.array_equal(prompt, ref["prompts"][uid])}
        again = serve_prompts(params, run_cfg, later, SPEC_NEW,
                              speculative=False, **share)
        log(f"[spec {tag} pool] {len(later)} later turns after a diverged "
            f"history re-served never drafted")
        ref_toks, ref_prompts, ref_own = against(run, ref, again)
        divergence(f"spec {tag} pool on vs off", run["toks"], ref_toks,
                   run["prompts"], ref_prompts, params, cfg,
                   own=(run["tap"].own, ref_own))
    fold = main["launches"]["paged_quant_scatter_kv"]
    return dict(packed=main["launches"]["hccs_packed_prefill"],
                fold_in_step=fold - main["probe"].launches,
                fold_replay=main["probe"].launches)


# ------------------------------------------------------------ phase 19 --

# 30 requests: six class-0 requests fill the pool, then four bursts of six
# mixed classes: the first at step 6, each later one once every class-2
# request of the bursts before it has ended, so that it finds class-0
# requests live again and its three class-2 requests preempt several
OVERLOAD_PRIO = (0, 0, 0, 0, 0, 0, 2, 1, 2, 1, 0, 2) + (2, 2, 2, 0, 0, 0) * 3
OVERLOAD_BURSTS = tuple(range(u, u + 6) for u in range(6, 30, 6))
OVERLOAD_PREEMPTED = 4          # preempted requests that finish, at least
OVERLOAD_FIRST = 6              # the first burst's step
OVERLOAD_NEW = 48               # new tokens a request
OVERLOAD_BLOCKS = 40            # pool: the shared prefix and 3-4 requests
OVERLOAD_QUEUE = 9              # queued requests before the lowest is shed
OVERLOAD_DEADLINE = 20.0        # class 1's E2E deadline, fake-clock seconds
OVERLOAD_REASONS = {"shed", "cancelled", "deadline_ttft", "deadline_e2e"}


def overload_requests(cfg):
    """Phase 19's traffic, seeded: 30 requests of the sessions' 512-token
    system prefix plus a 64-256-token user part, OVERLOAD_NEW new tokens,
    classes OVERLOAD_PRIO; class 1 carries an E2E deadline."""
    system = session_traffic(cfg)[0]
    rng = np.random.default_rng(4)
    return [dict(uid=i, prompt=np.concatenate(
        [system, rng.integers(0, cfg.vocab_size, int(rng.integers(
            64, 257))).astype(np.int32)]), max_new_tokens=OVERLOAD_NEW,
        priority=p, deadline_e2e=OVERLOAD_DEADLINE if p == 1 else None)
        for i, p in enumerate(OVERLOAD_PRIO)]


def slice_engine(params, cfg, num_blocks=None, admission=None):
    """The slice's engine: int8 KV, decode sharing, speculative decoding."""
    return PagedEngine(
        params, cfg.replace(kv_quant="int8"), max_batch=MAX_BATCH,
        max_len=MAX_LEN, block_size=BS, num_blocks=num_blocks,
        prefix_sharing=True, decode_sharing=True, speculative=True,
        draft_len=DRAFT_LEN, device="cuda", admission=admission)


def robust_engine(params, cfg, max_queue, clock=None, num_blocks=None):
    """The slice's engine with the robustness layer: preemption, graceful
    exhaustion, a bounded queue that sheds the lowest class."""
    return slice_engine(params, cfg, num_blocks, AdmissionConfig(
        max_queue=max_queue, backpressure="shed-lowest-priority",
        preemption=True, graceful_exhaustion=True, clock=clock))


def phase_overload():
    """A pool of OVERLOAD_BLOCKS blocks under the robust engine: request 0
    alone until its prefill registers the prefix, then 1-5 at once and the
    four bursts of OVERLOAD_BURSTS, the fake clock one second a step, the
    newest live request cancelled at step 4. The invariants after every
    step; then a drained pool, no device retry, no failure but a shed, a
    cancel or a deadline, and every preempted request that finished held
    to a never-preempted run (same engine, no admission layer, the default
    pool) by the near-tie rule, in the f32-KV forward and in both runs' own
    logits."""
    cfg, params = engine_model()
    specs = overload_requests(cfg)
    fake = [0.0]
    eng = robust_engine(params, cfg, OVERLOAD_QUEUE, clock=lambda: fake[0],
                        num_blocks=OVERLOAD_BLOCKS)
    tap = LogitTap(eng)
    reqs = [Request(**{**r, "prompt": r["prompt"].copy()}) for r in specs]
    torch.cuda.synchronize()
    for k in KERNELS + FOLD_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    eng.submit(reqs[0])
    while not reqs[0].out_tokens:
        eng.step()
        fake[0] += 1.0
    for r in reqs[1:OVERLOAD_BURSTS[0][0]]:
        eng.submit(r)
    steps, bursts, arrived = 0, list(OVERLOAD_BURSTS), []
    while bursts or eng.busy:
        if bursts and steps >= OVERLOAD_FIRST and all(
                reqs[u].done or reqs[u].failed for u in arrived
                if reqs[u].priority == 2):
            for uid in bursts.pop(0):
                eng.submit(reqs[uid])
                arrived.append(uid)
            log(f"[overload] a burst arrives at step {steps}")
        if steps == 4:
            live = [eng._slots[s].uid for s in np.flatnonzero(eng._live)]
            if live:
                eng.cancel(max(live))
        eng.step()
        fake[0] += 1.0
        steps += 1
        check_invariants(eng)
        check(steps < 5000, "overload: the run did not drain")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches
                for k in KERNELS + FOLD_KERNELS}
    rb = eng.robust_counters.snapshot()
    assert_drained(eng)
    reasons = collections.Counter(r.fail_reason for r in reqs if r.failed)
    check(all(r.done or (r.failed and r.fail_reason) for r in reqs),
          "overload: a request neither finished nor failed with a reason")
    log(f"[overload] {eng.occupancy_steps} steps in {wall:.3f}s, "
        f"{len([r for r in reqs if r.done])} of {len(reqs)} requests done, "
        f"failed {dict(reasons)}; {rb['preemptions']} preemptions "
        f"({rb['exhaustion_events']} exhaustion events), {rb['shed']} "
        f"shed, {rb['cancelled']} cancelled, deadline misses "
        f"{rb['deadline_misses']}; device retries {rb['device_retries']}; "
        f"re-prefill {rb['reprefill']['skipped']}/"
        f"{rb['reprefill']['tokens']} tokens skipped = "
        f"{rb['reprefill']['skip_rate']:.4f}; launches {launches}; "
        f"card {CARD}")
    for p, c in sorted(rb["per_class"].items(), key=lambda kv: -int(kv[0])):
        log(f"[overload]   class {p}: {c}")
    # nothing is injected here: a retry or a device_error / nan_logits
    # failure would be a fault of the path itself
    check(rb["device_retries"] == 0, "overload: a device step was retried")
    check(set(reasons) <= OVERLOAD_REASONS,
          f"overload: failures {dict(reasons)} beyond {OVERLOAD_REASONS}")
    check(rb["preemptions"] >= 1, "overload: nothing was preempted")
    # a step that hit BlockPoolExhausted unwound before its device half
    ran = eng.occupancy_steps - rb["exhaustion_events"]
    check(launches["hccs_packed_prefill"] == M_LAYERS * ran,
          f"overload: packed launches {launches['hccs_packed_prefill']} != "
          f"{M_LAYERS} x {ran} steps that ran")
    ref = slice_engine(params, cfg)          # the plain FIFO, never preempts
    ref_tap = LogitTap(ref)
    for r in specs:
        ref.submit(Request(uid=r["uid"], prompt=r["prompt"].copy(),
                           max_new_tokens=r["max_new_tokens"]))
    alone = {r.uid: list(r.out_tokens) for r in ref.run()}
    check(not ref.robust_counters.preemptions, "overload: the reference "
          "preempted")
    preempted = [r for r in reqs if r.preemptions and r.done]
    check(len(preempted) >= OVERLOAD_PREEMPTED, f"overload: "
          f"{len(preempted)} preempted requests finished, fewer than "
          f"{OVERLOAD_PREEMPTED}")
    toks = {r.uid: list(r.out_tokens) for r in preempted}
    prompts = {r.uid: np.asarray(r.prompt) for r in preempted}
    divergence("overload", toks, {u: alone[u] for u in toks}, prompts,
               prompts, params, cfg, own=(tap.own, ref_tap.own))
    return dict(launches=launches, preempted=len(preempted),
                skip=rb["reprefill"]["skip_rate"])


# ------------------------------------------------------------ phase 20 --

CHAOS_BLOCKS = 96


def phase_chaos():
    """ChaosMonkey(seed=0) over the robust engine at full width: 16
    requests of a system-prefix slice (0-512 tokens) plus a 16-256-token
    user part, 4-32 new tokens, classes 0-2. The monkey asserts the
    invariants after every step and a drained pool at the end. The
    engine's own seams are wrapped inside the monkey's, to count what they
    raise, and outside, to count the failed device calls: none may fail
    inside a seam (only the monkey's faults, raised before the seam runs,
    are retried), the failed calls must equal the engine's device retries,
    and a device_error or nan_logits failure needs its injected fault."""
    cfg, params = engine_model()
    system = session_traffic(cfg)[0]
    eng = robust_engine(params, cfg, 8, num_blocks=CHAOS_BLOCKS)
    rng = np.random.default_rng(5)

    def make(i):
        head = system[:int(rng.integers(0, SYSTEM_LEN // BS + 1)) * BS]
        user = rng.integers(0, cfg.vocab_size,
                            int(rng.integers(16, 257))).astype(np.int32)
        return Request(uid=i, prompt=np.concatenate([head, user]),
                       max_new_tokens=int(rng.integers(4, 33)),
                       priority=int(rng.integers(0, 3)))
    raised = collections.Counter()

    def counted(fn, where):
        def wrapped(*args):
            try:
                return fn(*args)
            except Exception:
                raised[where] += 1
                raise
        return wrapped
    seams = ("_step_fn", "_packed_fn", "_packed_spec_fn")
    for name in seams:
        setattr(eng, name, counted(getattr(eng, name), "inside"))
    monkey = ChaosMonkey(eng, seed=0, make_request=make, n_requests=16)
    for name in seams:
        setattr(eng, name, counted(getattr(eng, name), "failed calls"))
    torch.cuda.synchronize()
    for k in KERNELS + FOLD_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    report = monkey.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches
                for k in KERNELS + FOLD_KERNELS}
    rb = report["robustness"]
    every = report["finished"] + report["failed"]
    check(len(every) == report["submitted"] and all(
        r.done or (r.failed and r.fail_reason) for r in every),
        "chaos: a request neither finished nor failed with a reason")
    reasons = collections.Counter(r.fail_reason for r in report["failed"])
    log(f"[chaos] {report['steps']} steps in {wall:.3f}s, "
        f"{report['submitted']} submitted, {len(report['finished'])} "
        f"finished, failed {dict(reasons)}; faults {report['faults']}; "
        f"device retries {rb['device_retries']} ({raised['failed calls']} "
        f"failed device calls, {raised['inside']} raised inside a seam), "
        f"{rb['preemptions']} "
        f"preemptions ({rb['exhaustion_events']} exhaustion events), "
        f"{eng.spec_steps} slot verifies; launches {launches}; invariants "
        f"held after every step, pool drained; card {CARD}")
    check(launches["hccs_packed_prefill"] > 0
          and launches["paged_quant_scatter_kv"] > 0, "chaos: kernels idle")
    check(not raised["inside"], "chaos: a device seam raised by itself")
    check(raised["failed calls"] == rb["device_retries"],
          f"chaos: {raised['failed calls']} failed device calls, "
          f"{rb['device_retries']} retries counted")
    fault_of = {"device_error": "device_error", "nan_logits": "nan"}
    check(set(reasons) <= OVERLOAD_REASONS | set(fault_of) and all(
        report["faults"].get(fault_of[r]) for r in reasons if r in fault_of),
        f"chaos: failures {dict(reasons)} beyond the faults injected, "
        f"{report['faults']}")
    return dict(launches=launches)


# ------------------------------------------------------------ phase 21 --

ROOT = Path(__file__).resolve().parent
HOT_TEMP = 0.8                  # phase 23's temperature
ARRIVAL_RATE = 2.0              # phase 22's open-loop requests a second


def serve_mixed(params, cfg, prompts, profiled=False, temperature=0.0,
                **kw):
    """Phase 5's traffic (`prompts`, 32 new tokens each) through a fresh
    packed PagedEngine (kw: async_loop, telemetry). The kernels' counts are
    set to 0 just before the run and read just after. Returns the run's
    record."""
    eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      block_size=BS, device="cuda", **kw)
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32,
                           temperature=temperature))
    torch.cuda.synchronize()
    for k in KERNELS + FOLD_KERNELS:
        k.launches = 0
    ctx = (torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA]) if profiled
        else contextlib.nullcontext())
    with ctx as prof:
        t0 = time.perf_counter()
        done = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches
                for k in KERNELS + FOLD_KERNELS}
    toks = {r.uid: list(r.out_tokens) for r in done}
    check(len(done) == len(prompts) and all(
        len(t) == 32 for t in toks.values()), "not every request done")
    for t in toks.values():
        check(all(0 <= x < VOCAB for x in t), "token off vocab")
    return dict(eng=eng, wall=wall, prof=prof, toks=toks,
                steps=eng.occupancy_steps, launches=launches)


def check_packed_launches(label, run):
    """40 packed launches a step (one a layer) and no other decode
    kernel."""
    la, steps = run["launches"], run["steps"]
    check(la["hccs_packed_prefill"] == M_LAYERS * steps,
          f"{label}: packed launches {la['hccs_packed_prefill']} != "
          f"{M_LAYERS} x {steps} steps")
    check(not la["hccs_paged_decode"] and not la["hccs_decode"],
          f"{label}: other kernels ran {la}")


def phase_async(packed_tokens, sync_ref, sharing_ref):
    """The pipelined async loop on phase 5's traffic: twice unprofiled and
    once profiled, each with its tokens identical to phase 5's (the same
    forward at the same shapes, greedy, no EOS), steps overlapped, no sync
    fallback, 40 packed launches a step; the walls and idle share against
    phase 5's. Then phase 16's sessions (int8, prefix and decode sharing)
    with the loop on: 40 fold and 40 packed launches a step, held to phase
    16's tokens: identical where the schedule is, near ties where the
    ninth turn-1 request (queued for a slot) is admitted a step later
    (the async loop frees a finished slot at its commit, one step late).
    Returns the launch counts."""
    cfg, params = engine_model()
    prompts = smoke_prompts(cfg)
    runs = [serve_mixed(params, cfg, prompts, profiled=rep == 2,
                        async_loop=True) for rep in range(3)]
    for rep, run in enumerate(runs):
        eng = run["eng"]
        n_new = sum(len(t) for t in run["toks"].values())
        log(f"[async] run {rep}{' (profiled)' if rep == 2 else ''}: "
            f"{run['steps']} packed steps ({eng.async_overlapped_steps} "
            f"overlapped, {eng.async_sync_fallbacks} sync fallbacks), "
            f"hccs_packed_prefill launches "
            f"{run['launches']['hccs_packed_prefill']}; {n_new} tokens in "
            f"{run['wall']:.3f}s = {n_new / run['wall']:.1f} new tok/s")
        check_packed_launches("async", run)
        check(eng.async_overlapped_steps > 0
              and eng.async_sync_fallbacks == 0,
              f"async: {eng.async_overlapped_steps} overlapped, "
              f"{eng.async_sync_fallbacks} fallbacks")
        check(run["toks"] == runs[0]["toks"], "async: the runs disagree")
    if packed_tokens is not None:
        same = sum(runs[0]["toks"][u] == packed_tokens[u]
                   for u in packed_tokens)
        log(f"[async] tokens identical to phase 5's (sync loop) for "
            f"{same} of {len(packed_tokens)} requests")
        check(runs[0]["toks"] == packed_tokens,
              "async: tokens differ from the sync loop's")
    prof = runs[2]["prof"]
    profile_summary(prof, runs[2]["wall"], "PackedRows", "async profile")
    busy = prof_busy_ms(prof)
    on = [r["wall"] for r in runs[:2]]
    line = (f"[async] walls on {on[0]:.3f}, {on[1]:.3f} s, idle share "
            f"{1 - busy / 1e3 / on[0]:.3f}, {1 - busy / 1e3 / on[1]:.3f} "
            f"(device busy {busy:.1f} ms)")
    if sync_ref is not None:
        off = sync_ref["walls"]
        line += (f"; off (phase 5) {off[0]:.3f}, {off[1]:.3f} s, idle share "
                 f"{1 - sync_ref['busy_ms'] / 1e3 / off[0]:.3f}, "
                 f"{1 - sync_ref['busy_ms'] / 1e3 / off[1]:.3f} (device "
                 f"busy {sync_ref['busy_ms']:.1f} ms)")
    log(line)
    q8 = cfg.replace(kv_quant="int8")
    share = dict(prefix_sharing=True, decode_sharing=True)
    sess = tapped_sessions(params, q8, session_traffic(cfg), async_loop=True,
                           **share)
    eng, la, steps = sess["eng"], sess["launches"], sess["steps"]
    n_new = sum(len(t) for t in sess["toks"].values())
    log(f"[async] sessions: {steps} packed steps "
        f"({eng.async_overlapped_steps} overlapped, "
        f"{eng.async_sync_fallbacks} sync fallbacks), fold launches "
        f"{la['paged_quant_scatter_kv']}, packed launches "
        f"{la['hccs_packed_prefill']}; {n_new} tokens in {sess['wall']:.3f}s"
        f" = {n_new / sess['wall']:.1f} new tok/s"
        + (f" (phase 16, sync: {sharing_ref['walls'][0]:.3f}, "
           f"{sharing_ref['walls'][1]:.3f} s)" if sharing_ref else ""))
    check(la["paged_quant_scatter_kv"] == M_LAYERS * steps,
          f"async sessions: fold launches {la['paged_quant_scatter_kv']} != "
          f"{M_LAYERS} x {steps} steps")
    check(la["hccs_packed_prefill"] == M_LAYERS * steps,
          f"async sessions: packed launches {la['hccs_packed_prefill']} != "
          f"{M_LAYERS} x {steps} steps")
    check(eng.async_overlapped_steps > 0 and eng.async_sync_fallbacks == 0,
          "async sessions: no overlap, or a sync fallback")
    if sharing_ref is not None:
        held_to_sessions("async sessions", sess, sharing_ref, params, q8,
                         cfg, share)
    return dict(packed=runs[0]["launches"]["hccs_packed_prefill"],
                sessions_packed=la["hccs_packed_prefill"],
                sessions_fold=la["paged_quant_scatter_kv"], busy_ms=busy)


# ------------------------------------------------------------ phase 22 --

def log_snapshot(label, snap, busy_ms=None):
    """A telemetry snapshot's phases (total, share of step time, count),
    coverage and TTFT/TPOT/E2E p50/p95; with `busy_ms`, the device phase
    against a profiled run's device busy time."""
    ph, lat = snap["phases"], snap["latency"]
    log(f"[{label}] {ph['steps']} steps, {ph['step_seconds']:.4f} s of "
        f"step time, coverage {ph['coverage']:.4f}")
    for name, p in sorted(ph["phases"].items(),
                          key=lambda kv: -kv[1]["seconds"]):
        log(f"[{label}]   {name:<10} {p['seconds'] * 1e3:9.2f} ms  "
            f"{p['share_of_step']:.4f}  (n={p['count']})")
    for name in ("ttft", "tpot", "e2e", "queue_wait"):
        d = lat[name]
        if d["count"]:
            log(f"[{label}]   {name:<10} p50 {d['p50'] * 1e3:9.3f} ms  p95 "
                f"{d['p95'] * 1e3:9.3f} ms  (n={d['count']})")
    if busy_ms is not None and "device" in ph["phases"]:
        dev = ph["phases"]["device"]["seconds"] * 1e3
        log(f"[{label}] device phase {dev:.1f} ms against {busy_ms:.1f} ms "
            f"of device busy time (profiled run of the same traffic): "
            f"{dev - busy_ms:.1f} ms of it is the host dispatching the "
            f"forward")


def phase_telemetry(packed_tokens, busy):
    """Telemetry(enabled=True) on phase 5's traffic, the sync and the async
    loop: coverage >= 0.9, tokens identical to telemetry off (phase 5), a
    Chrome trace that parses line by line, the phase split and latency
    percentiles, the device phase against the device busy time of the
    same traffic profiled (phase 5 sync, phase 21 async). Then the mixed
    prompts through drive_open_loop at ARRIVAL_RATE requests a second.
    Returns the launch counts."""
    cfg, params = engine_model()
    prompts = smoke_prompts(cfg)
    out = {}
    for label, kw in (("sync", {}), ("async", dict(async_loop=True))):
        tel = Telemetry(enabled=True)
        run = serve_mixed(params, cfg, prompts, telemetry=tel, **kw)
        check_packed_launches(f"telemetry {label}", run)
        snap = run["eng"].snapshot()
        log(f"[telemetry {label}] wall {run['wall']:.3f}s (profiler "
            f"fencing the device phase), {run['steps']} steps")
        log_snapshot(f"telemetry {label}", snap, busy.get(label))
        check(snap["phases"]["coverage"] >= 0.9,
              f"telemetry {label}: coverage {snap['phases']['coverage']}")
        if packed_tokens is not None:
            check(run["toks"] == packed_tokens,
                  f"telemetry {label}: tokens differ from telemetry off")
        path = ROOT / "build" / f"smoke_trace_{label}.jsonl"
        path.parent.mkdir(parents=True, exist_ok=True)
        n = tel.profiler.write_chrome_trace(str(path))
        events = [json.loads(ln) for ln in path.read_text().splitlines()]
        check(n == len(events) > 0 and all(
            e["ph"] == "X" and e["cat"] in ("step", "phase")
            for e in events), f"telemetry {label}: bad Chrome trace")
        log(f"[telemetry {label}] Chrome trace: {n} events, each line "
            f"parses")
        out[label] = run["launches"]["hccs_packed_prefill"]
    tel = Telemetry(enabled=True)
    eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      block_size=BS, device="cuda", telemetry=tel)
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=32)
            for i, p in enumerate(prompts)]
    arrivals = np.cumsum(np.random.default_rng(4).exponential(
        1.0 / ARRIVAL_RATE, len(reqs)))
    torch.cuda.synchronize()
    for k in KERNELS + FOLD_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    done = drive_open_loop(eng, reqs, arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(launches={k.__name__: k.launches
                         for k in KERNELS + FOLD_KERNELS},
               steps=eng.occupancy_steps)
    check_packed_launches("open loop", run)
    check(len(done) == len(reqs) and all(
        r.done and len(r.out_tokens) == 32 for r in reqs),
        "open loop: not every request done")
    log(f"[open loop] {len(reqs)} requests at {ARRIVAL_RATE:g}/s (arrivals "
        f"over {arrivals[-1]:.3f} s): {eng.occupancy_steps} steps in "
        f"{wall:.3f}s")
    log_snapshot("open loop", eng.snapshot())
    out["open_loop"] = run["launches"]["hccs_packed_prefill"]
    return out


# ------------------------------------------------------------ phase 23 --

class SampleProbe:
    """Stands in for serve/paged.py's sample_tokens during one run: lands
    each call's inputs and the tokens the card drew."""

    def __init__(self):
        self.calls = []
        self.orig = serve_paged.sample_tokens

    def __enter__(self):
        serve_paged.sample_tokens = self
        return self

    def __exit__(self, *exc):
        serve_paged.sample_tokens = self.orig

    def __call__(self, key, logits, temps, uids, gen_idx):
        out = self.orig(key, logits, temps, uids, gen_idx)
        self.calls.append((key, logits.cpu(), np.array(temps),
                           np.array(uids), np.array(gen_idx), out))
        return out


def phase_sampling():
    """Phase 5's traffic at temperature HOT_TEMP on the packed engine: every
    sampled batch's logits landed and drawn again by the CPU path (the same
    threefry keys, Gumbel noise from torch's CPU log): the count of hot
    tokens that differ, each of which must be a tie on the CPU (its two
    candidates within 2 bf16 ulps). Then the same traffic with the async
    loop: every step a sync fallback, tokens identical. Returns the launch
    counts."""
    cfg, params = engine_model()
    prompts = smoke_prompts(cfg)
    with SampleProbe() as probe:
        hot = serve_mixed(params, cfg, prompts, temperature=HOT_TEMP)
    check_packed_launches("sampling", hot)
    n_hot, differ = 0, []
    for key, logits, temps, uids, gen, out in probe.calls:
        again = sample_tokens(key, logits, temps, uids, gen)
        rows = np.flatnonzero(temps > 0)
        n_hot += len(rows)
        for r in rows[again[rows] != out[rows]]:
            k = torch.tensor([prng.fold_in(prng.fold_in(key, int(uids[r])),
                                           int(gen[r]))])
            z = (prng.gumbel(k, logits.shape[-1], logits.dtype)[0]
                 + logits[r] / torch.tensor(temps[r], dtype=logits.dtype))
            z = z.float()
            gap = float(z[int(again[r])] - z[int(out[r])])
            differ.append((int(uids[r]), int(gen[r]), gap,
                           float(z.abs().max())))
    log(f"[sampling] {hot['steps']} steps, {len(probe.calls)} sampled "
        f"batches; {len(differ)} of {n_hot} hot tokens drawn on the card "
        f"differ from the CPU path's draw on the same logits (T = "
        f"{HOT_TEMP})")
    for uid, g, gap, top in differ:
        log(f"[sampling]   request {uid} token {g}: CPU gap {gap:.6f} "
            f"(|z| up to {top:.3f})")
        check(gap <= 2 * top * 2.0 ** -8, f"sampling: request {uid} token "
              f"{g} differs by {gap}, no tie")
    ahot = serve_mixed(params, cfg, prompts, temperature=HOT_TEMP,
                       async_loop=True)
    eng = ahot["eng"]
    log(f"[sampling] async: {ahot['steps']} steps, "
        f"{eng.async_sync_fallbacks} sync fallbacks, "
        f"{eng.async_overlapped_steps} overlapped; wall {ahot['wall']:.3f}s "
        f"(sync {hot['wall']:.3f}s)")
    check_packed_launches("sampling async", ahot)
    check(eng.async_sync_fallbacks == ahot["steps"]
          and eng.async_overlapped_steps == 0,
          "sampling async: a hot step did not fall back")
    check(ahot["toks"] == hot["toks"], "sampling: async tokens differ")
    return dict(sync=hot["launches"]["hccs_packed_prefill"],
                async_=ahot["launches"]["hccs_packed_prefill"])


# ------------------------------------------------------ phases 24-27 --

CAL_BATCHES, CAL_BATCH, CAL_SEQ = 2, 2, 256     # the capture's LM batches
CAL_ROWS = 64                   # calibration rows per head
CAL_MODE = "i16_div"            # the paper's int16 objective
CAL_CHECK_HEADS = 8             # heads calibrated again on the CPU
CAL_KL_TIE = 1e-6               # a different theta within this KL (rel.)
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS, INT8_STEPS = 4, 2
TRAIN_LR = 3e-4                 # one warmup step: the first update moves
CHECK_BATCH, CHECK_SEQ = 1, 128  # phase 25's 2-layer card-vs-CPU step
SERVE_REQUESTS, SERVE_NEW = 4, 16


def granite_params(**kw):
    """granite-3-2b at full width (depth and options from `kw`), bf16
    weights from seed 0 on the card."""
    cfg = get_config("granite-3-2b").replace(**kw)
    return cfg, M.init_params(cfg, seed=0, device="cuda")


def lm_batches(cfg, batch: int, seq: int):
    """batch_at(step, device) of the seeded synthetic LM stream at the
    model's vocab (labels -100 past each row's last token)."""
    stream = LMStream(LMStreamConfig(vocab_size=cfg.vocab_size,
                                     seq_len=seq, global_batch=batch))
    return lambda step, device="cuda": {
        k: torch.from_numpy(v).to(device)
        for k, v in stream.batch_at(step).items()}


def phase_calibrate():
    """Offline per-head calibration at full width (paper section III-C):
    granite with softmax attention captures its attention logits
    (capture_attention_logits) on 2 LM batches of 2 x 256 tokens; 64 rows
    a head are drawn as the JAX package draws them; the scales are
    amax / 127; calibrate_heads(per_head, i16_div) searches the 589
    feasible theta at n = 256 for all 1280 heads through the hccs_rows
    kernel (counted). Eight heads are calibrated again on the CPU: the
    card's theta must be the CPU's, or within CAL_KL_TIE of its KL (a
    tie). Returns the calibrated hccs tree (L, H) and the counts."""
    cfg, params = granite_params(attention_prob="softmax")
    batch_at = lm_batches(cfg, CAL_BATCH, CAL_SEQ)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    captured = []
    for step in range(CAL_BATCHES):
        with torch.no_grad(), capture_attention_logits() as cap:
            M.forward(params["weights"], params["hccs"],
                      {"tokens": batch_at(step)["tokens"]}, cfg)
        check(len(cap) == cfg.num_layers, f"calibrate: {len(cap)} layers "
              f"captured")
        captured.append(torch.stack(cap).transpose(1, 2))  # (L,H,B,T,T)
    torch.cuda.synchronize()
    t_capture = time.perf_counter() - t0
    rows = collect_attention_logits(captured, max_rows_per_head=CAL_ROWS)
    del captured, cap, params
    torch.cuda.empty_cache()
    L, H, R, n = rows.shape
    check((L, H, R, n) == (M_LAYERS, cfg.num_heads, CAL_ROWS, CAL_SEQ)
          and np.isfinite(rows).all(), f"calibrate: rows {rows.shape}")
    scale = np.abs(rows).max(axis=(2, 3)) / 127.0
    grid = feasible_grid(n)
    hccs_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    theta, kl = calibrate_heads(rows, scale, n, "per_head", CAL_MODE,
                                device="cuda")
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t0
    launches = hccs_rows.launches
    evals = L * H * len(grid) * R * n
    log(f"[calibrate] captured {CAL_BATCHES} x {CAL_BATCH} x {CAL_SEQ} "
        f"tokens in {t_capture:.3f}s; rows {rows.shape}; per-head grid "
        f"{L * H} heads x {len(grid)} theta x {R} x {n} = {evals:.3e} "
        f"integer evaluations in {t_cal:.3f}s ({evals / t_cal:.3e}/s), "
        f"hccs_rows launches {launches}; card {CARD}")
    check(launches > 0, "calibrate: hccs_rows never launched")
    B, S, Dmax = (t.cpu().numpy() for t in theta.astuple())
    validate_params(B, S, Dmax, n)
    t0 = time.perf_counter()
    for f in np.linspace(0, L * H - 1, CAL_CHECK_HEADS).round().astype(int):
        l, h = divmod(int(f), H)
        cpu_theta, cpu_kl = calibrate_rows(rows[l, h], float(scale[l, h]), n,
                                           CAL_MODE, grid, device="cpu")
        card = (int(B[l, h]), int(S[l, h]), int(Dmax[l, h]))
        xq, pref = head_inputs(rows[l, h], float(scale[l, h]), "cpu")
        card_kl = float(kl_for_grid(xq, pref, torch.tensor(
            [card], dtype=torch.int32), CAL_MODE)[0])
        rel = abs(card_kl - cpu_kl) / cpu_kl
        log(f"[calibrate]   head ({l}, {h}): card theta {card} KL "
            f"{kl[l, h]:.6f}, CPU theta {cpu_theta} KL {cpu_kl:.6f}; the "
            f"card's theta on the CPU: KL {card_kl:.6f} (rel. {rel:.2e})")
        check(card == cpu_theta or rel <= CAL_KL_TIE, f"calibrate: head "
              f"({l}, {h}) card theta {card} != CPU {cpu_theta}, no tie")
    t_check = time.perf_counter() - t0
    triples = set(zip(B.ravel().tolist(), S.ravel().tolist(),
                      Dmax.ravel().tolist()))
    log(f"[calibrate] {CAL_CHECK_HEADS} heads redone on the CPU in "
        f"{t_check:.3f}s; KL per layer (mean over heads): "
        + ", ".join(f"{v:.4f}" for v in kl.mean(1)))
    log(f"[calibrate] theta spread: {len(triples)} distinct triples over "
        f"{L * H} heads; B {B.min()}-{B.max()}, S {S.min()}-{S.max()}, D "
        f"{Dmax.min()}-{Dmax.max()}; KL {kl.min():.4f}-{kl.max():.4f} "
        f"(mean {kl.mean():.4f}); scales {scale.min():.5f}-"
        f"{scale.max():.5f}")
    hccs = {"B": theta.B, "S": theta.S, "D": theta.D,
            "scale": torch.tensor(scale, dtype=torch.float32, device="cuda")}
    return dict(hccs=hccs, launches=launches, seconds=t_cal)


def weight_probe(weights) -> dict:
    """Copies of a few slices of the weights: embedding rows and two
    layers' projections (the norms' scales sit at 1.0, where a bf16 ulp is
    26x an update of lr 3e-4, so they may not move in a few steps)."""
    lay = weights["layers"]
    return {"embed": weights["embed"]["table"][:2048].clone(),
            "wq[0]": lay["attn"]["wq"][0, :256].clone(),
            "w_in[-1]": lay["mlp"]["w_in"][-1, :256].clone()}


def loss_and_grads(params, batch, cfg):
    """lm_loss and its gradients w.r.t. every weight (as the train step
    takes them)."""
    flat = {k: v.detach().requires_grad_()
            for k, v in M.flatten_tree(params["weights"]).items()}
    with torch.enable_grad():
        loss, _ = M.lm_loss(M.unflatten_tree(flat), params["hccs"], batch,
                            cfg)
        grads = torch.autograd.grad(loss, list(flat.values()))
    return loss.detach(), dict(zip(flat, grads))


# Gates of phase 25's 2-layer step, card against the CPU path (bf16
# weights and gradients; the card's matmuls and reductions round
# elsewhere), set from the first run on an H100 80GB HBM3 at 700 W
# (PERF.md section 6): loss 5.1e-5 relative; gradient leaves 1.5e-2
# (median) to 2.4e-2 (layers.attn.wk) in relative norm, a few bf16 ulps;
# 1.0e-2 of the bf16 weights differ after the update. The gates
# are 2-4x the readings.
CHECK_LOSS_RTOL = 2e-4
CHECK_GRAD_REL = 5e-2           # ||g_card - g_cpu|| / ||g_cpu||, worst leaf
CHECK_PARAM_SHARE = 3e-2        # bf16 weights that differ after the step


def step_against_cpu(cal, tcfg):
    """One step at 2 layers and full width on the card and on the CPU, on
    the same weights (the card's, copied) and batch: the loss, each
    gradient leaf's relative difference, and the share of weights that
    differ after the same AdamW update."""
    cfg, params = granite_params(num_layers=2)
    params["hccs"] = {k: v[:2].clone() for k, v in cal["hccs"].items()}
    host = M.params_to(params, "cpu")
    batch_at = lm_batches(cfg, CHECK_BATCH, CHECK_SEQ)
    t0 = time.perf_counter()
    loss_c, g_c = loss_and_grads(params, batch_at(0), cfg)
    loss_h, g_h = loss_and_grads(host, batch_at(0, "cpu"), cfg)
    rel = {k: float(torch.linalg.vector_norm(g_c[k].float().cpu()
                                             - g_h[k].float())
                    / torch.linalg.vector_norm(g_h[k].float()))
           for k in g_h}
    worst = max(rel, key=rel.get)
    dloss = abs(float(loss_c) - float(loss_h)) / abs(float(loss_h))
    new = {}
    for side, p, g in (("card", params, g_c), ("host", host, g_h)):
        w, _, stats = adamw.apply_updates(
            p["weights"], M.unflatten_tree(g), adamw.init(p["weights"]),
            tcfg)
        new[side] = (M.flatten_tree(w), float(stats["grad_norm"]))
    differ = sum(int((a.cpu() != new["host"][0][k]).sum())
                 for k, a in new["card"][0].items())
    total = sum(a.numel() for a in new["host"][0].values())
    log(f"[train] 2 layers, card against the CPU ({CHECK_BATCH} x "
        f"{CHECK_SEQ} tokens, {time.perf_counter() - t0:.1f}s): loss "
        f"{float(loss_c):.6f} / {float(loss_h):.6f} (rel. {dloss:.2e}); "
        f"gradient leaves' relative difference: worst {worst} {rel[worst]:.3e}"
        f", median {np.median(list(rel.values())):.3e}; grad_norm "
        f"{new['card'][1]:.6f} / {new['host'][1]:.6f}; after one AdamW "
        f"update {differ} of {total} bf16 weights differ "
        f"({differ / total:.2e})")
    check(dloss <= CHECK_LOSS_RTOL, f"train: 2-layer loss differs {dloss}")
    check(rel[worst] <= CHECK_GRAD_REL, f"train: gradient {worst} differs "
          f"{rel[worst]}")
    check(differ / total <= CHECK_PARAM_SHARE, f"train: {differ} weights "
          f"differ after one update")


def phase_train(cal):
    """QAT with theta frozen (paper section V-B) at full width: granite with
    HCCS attention, the calibrated theta and scales, remat on, AdamW at
    lr 3e-4 after one warmup step; 4 steps of 4 x 512 tokens through
    make_train_step and train_loop, then 2 more with int8 gradient
    compression (error feedback, JAX's noise streams). Gates: finite
    losses, the weights moved, theta and the scales unchanged bit for bit;
    then one step at 2 layers against the CPU path. Returns the trained
    params (weights and the calibrated hccs)."""
    torch.cuda.empty_cache()
    cfg, params = granite_params()
    check(cfg.remat != "none", "train: remat off")
    params["hccs"] = {k: v.clone() for k, v in cal["hccs"].items()}
    frozen = {k: v.clone() for k, v in params["hccs"].items()}
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                       total_steps=TRAIN_STEPS + INT8_STEPS)
    before = weight_probe(params["weights"])
    n_params = sum(v.numel() for v in M.flatten_tree(
        params["weights"]).values())
    state = train_state_from_params(params, tcfg)
    batch_at = lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state, hist = train_loop(state, make_train_step(cfg, tcfg), batch_at,
                             total_steps=TRAIN_STEPS, log_every=1,
                             log_fn=lambda m: log(f"[train] {m}"))
    peak = torch.cuda.max_memory_allocated()
    t8 = dataclasses.replace(tcfg, grad_compression="int8")
    state["ef_error"] = adamw.tree_map(
        lambda p: torch.zeros_like(p, dtype=torch.float32),
        state["params"]["weights"])
    torch.cuda.reset_peak_memory_stats()
    state, hist8 = train_loop(state, make_train_step(cfg, t8),
                              lambda s: batch_at(TRAIN_STEPS + s),
                              total_steps=INT8_STEPS, log_every=1,
                              log_fn=lambda m: log(f"[train int8] {m}"))
    peak8 = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist + hist8]
    toks = TRAIN_BATCH * TRAIN_SEQ
    dts = [h["dt"] for h in hist]
    log(f"[train] {n_params / 1e9:.3f}B params; {TRAIN_STEPS} steps of "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: losses "
        + ", ".join(f"{v:.4f}" for v in losses[:TRAIN_STEPS])
        + f"; step times " + ", ".join(f"{d:.3f}" for d in dts)
        + f" s (after the first: {np.mean(dts[1:]):.3f} s = "
        f"{toks / np.mean(dts[1:]):.0f} tokens/s); peak memory "
        f"{peak / 2**30:.2f} GiB; card {CARD}")
    log(f"[train int8] {INT8_STEPS} steps: losses "
        + ", ".join(f"{v:.4f}" for v in losses[TRAIN_STEPS:])
        + "; step times " + ", ".join(f"{h['dt']:.3f}" for h in hist8)
        + f" s; peak memory {peak8 / 2**30:.2f} GiB (error feedback "
        f"{4 * n_params / 2**30:.2f} GiB); card {CARD}")
    check(len(losses) == TRAIN_STEPS + INT8_STEPS
          and np.isfinite(losses).all(), f"train: losses {losses}")
    check(int(state["opt"].step) == TRAIN_STEPS + INT8_STEPS,
          "train: optimizer step count")
    after = weight_probe(state["params"]["weights"])
    moved = {k: float((after[k] != v).float().mean())
             for k, v in before.items()}
    log(f"[train] share of probed weights changed: "
        + ", ".join(f"{k} {v:.3f}" for k, v in moved.items()))
    check(all(v > 0 for v in moved.values()), f"train: weights unmoved "
          f"{moved}")
    check(all(torch.equal(state["params"]["hccs"][k], v)
              for k, v in frozen.items()), "train: theta or scales moved")
    trained = state["params"]
    del state
    torch.cuda.empty_cache()
    step_against_cpu(cal, tcfg)
    return dict(params=trained, losses=losses, peak=peak, peak8=peak8,
                step_s=float(np.mean(dts[1:])))


def phase_checkpoint(cal):
    """Checkpoint and resume at 2 layers and full width: three
    uninterrupted 4-step runs give the card's run-to-run spread of the
    loss; a run saves at step 2 (train_loop's final save), the checkpoint
    restores bit for bit into a fresh state, and a fresh train_loop
    resumes from it: its steps 2-3 must equal the uninterrupted losses
    within twice that spread (the embedding's backward accumulates with
    atomics). Written under build/ and removed."""
    cfg = get_config("granite-3-2b").replace(num_layers=2)
    tcfg = TrainConfig(learning_rate=TRAIN_LR, warmup_steps=1,
                       total_steps=4)
    hccs = {k: v[:2].clone() for k, v in cal["hccs"].items()}

    def fresh(seed=0):
        p = M.init_params(cfg, seed=seed, device="cuda")
        p["hccs"] = {k: v.clone() for k, v in hccs.items()}
        return train_state_from_params(p, tcfg)
    batch_at = lm_batches(cfg, TRAIN_BATCH, TRAIN_SEQ)
    step = make_train_step(cfg, tcfg)
    whole = [[h["loss"] for h in train_loop(fresh(), step, batch_at,
                                            total_steps=4, log_every=0)[1]]
             for _ in range(3)]
    spread = max(abs(a - b) for r in whole[1:] for a, b in zip(whole[0], r))
    ckdir = ROOT / "build" / "smoke_checkpoint"
    shutil.rmtree(ckdir, ignore_errors=True)
    try:
        t0 = time.perf_counter()
        saved, first = train_loop(fresh(), step, batch_at, total_steps=2,
                                  ckpt_dir=str(ckdir), cfg=cfg, log_every=0)
        t_save = time.perf_counter() - t0
        nbytes = sum(f.stat().st_size for f in ckdir.rglob("*")
                     if f.is_file())
        t0 = time.perf_counter()
        restored, manifest = CheckpointManager(str(ckdir)).restore(
            fresh(seed=1), cfg=cfg)
        torch.cuda.synchronize()
        t_restore = time.perf_counter() - t0
        a, b = ckpt_flatten(saved), ckpt_flatten(restored)
        check(manifest["step"] == 2 and a.keys() == b.keys()
              and all(torch.equal(a[k], b[k]) for k in a),
              "checkpoint: the restored state differs from the saved one")
        del restored
        resumed, rest = train_loop(fresh(seed=1), step, batch_at,
                                   total_steps=4, ckpt_dir=str(ckdir),
                                   cfg=cfg, log_every=0,
                                   log_fn=lambda m: log(f"[checkpoint] {m}"))
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    got = [h["loss"] for h in first + rest]
    check([h["step"] for h in first + rest] == [0, 1, 2, 3],
          "checkpoint: steps run")
    delta = max(abs(x - y) for x, y in zip(got, whole[0]))
    gate = 2 * spread if spread else 1e-6 * abs(whole[0][-1])
    log(f"[checkpoint] {len(a)} leaves, {nbytes / 1e9:.3f} GB; train and "
        f"save to step 2 {t_save:.2f}s, restore {t_restore:.2f}s; "
        f"uninterrupted losses {whole[0]}, run-to-run spread {spread:.3e}; "
        f"saved-and-resumed losses {got}, largest difference {delta:.3e} "
        f"(gate {gate:.3e}); card {CARD}")
    check(delta <= gate, f"checkpoint: resumed losses differ by {delta}")
    return dict(seconds_save=t_save, seconds_restore=t_restore,
                bytes=nbytes, spread=spread, delta=delta)


def phase_serve_trained(trained):
    """The trained, calibrated model served: 4 seeded requests of 64-512
    prompt tokens, 16 new tokens each, through the packed PagedEngine with
    the fused kernel (40 hccs_packed_prefill launches a step, no other
    decode kernel). Returns the launches."""
    cfg = get_config("granite-3-2b").replace(decode_kernel="fused",
                                             cache_layout="paged")
    params = trained["params"]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(64, 513, SERVE_REQUESTS)]
    eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                      block_size=BS, device="cuda")
    reqs = [Request(uid=i, prompt=p.copy(), max_new_tokens=SERVE_NEW)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    for k in KERNELS + FOLD_KERNELS:
        k.launches = 0
    t0 = time.perf_counter()
    eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    run = dict(launches={k.__name__: k.launches
                         for k in KERNELS + FOLD_KERNELS},
               steps=eng.occupancy_steps)
    n_new = sum(len(r.out_tokens) for r in reqs)
    log(f"[serve trained] {len(reqs)} requests ({sum(map(len, prompts))} "
        f"prompt tokens), {run['steps']} packed steps, "
        f"hccs_packed_prefill launches "
        f"{run['launches']['hccs_packed_prefill']}; {n_new} tokens in "
        f"{wall:.3f}s; first request's tokens {reqs[0].out_tokens}")
    check(all(r.done and len(r.out_tokens) == SERVE_NEW for r in reqs),
          "serve trained: not every request done")
    check(all(0 <= t < VOCAB for r in reqs for t in r.out_tokens),
          "serve trained: token off vocab")
    check_packed_launches("serve trained", run)
    return run["launches"]["hccs_packed_prefill"]


# ------------------------------------------------------------ phase 28 --

MOE_ARCH = "granite-moe-1b-a400m"
MOE_DROP_FREE = 8.0             # tests/test_arch_smoke.py's drop-free capacity


def moe_model():
    """granite-moe-1b-a400m at full width and depth (24 layers, d 1024, 16
    query heads over 8 KV heads of 64, 32 experts top 8, capacity 1.25),
    bf16 weights from seed 0, the fused kernels on."""
    cfg = get_config(MOE_ARCH).replace(decode_kernel="fused",
                                       cache_layout="paged")
    check((cfg.num_layers, cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
           cfg.head_dim, cfg.num_experts, cfg.experts_per_token)
          == (24, 1024, 16, 8, 64, 32, 8), f"{MOE_ARCH} geometry changed")
    return cfg, M.init_params(cfg, seed=0, device="cuda")


def phase_moe():
    """MoE serving at full width: phase 5's mixed traffic through the
    packed PagedEngine (twice, then profiled: device busy, idle share, and
    the share of busy launched inside models/moe.py apply_moe: router,
    dispatch, experts and combine), the lockstep PagedEngine and the
    ContinuousEngine (twice each; every path's kernel launched once a layer
    a step, identical tokens run to run). Capacity drops make a request's
    tokens depend on its batch (ROADMAP C3), so these paths are not held to
    each other; a drop-free run (capacity 8.0) of phase 10's one wave on
    the packed and the wave engines is, by the near-tie rule. Returns the
    launches of each path."""
    cfg, params = moe_model()
    L, V = cfg.num_layers, cfg.vocab_size
    arena_cfg = cfg.replace(cache_layout="slot")
    prompts = smoke_prompts(cfg)
    out = {}
    # the MoE layer's spans, read in the profiled (last) run
    with tagged(moe_module, "apply_moe", "moe"), \
            tagged(moe_module, "route", "moe_route"):
        _, n, prof, _ = phase_engine_path(
            "moe packed", lambda: PagedEngine(
                params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                block_size=BS, device="cuda"),
            prompts, hccs_packed_prefill, lambda e: e.occupancy_steps, None,
            layers=L, vocab=V)
    out["packed"], out["packed_per_call"] = n, per_call(*prof[:2])
    busy = prof_busy_ms(prof[2]) if prof[2] is not None else 0.0
    if busy:
        moe_split(prof[2], busy)
    _, out["lockstep"], _, _ = phase_engine_path(
        "moe lockstep", lambda: PagedEngine(
            params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
            block_size=BS, packed=False, device="cuda"),
        prompts, hccs_paged_decode, lambda e: e.decode_steps, None,
        layers=L, vocab=V, reps=2, profile=False)
    _, out["continuous"], _, _ = phase_engine_path(
        "moe continuous", lambda: ContinuousEngine(
            params, arena_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
            device="cuda"),
        prompts, hccs_decode, lambda e: e.occupancy_steps, None,
        layers=L, vocab=V, reps=2, profile=False)
    # drop-free: routing no longer depends on the batch
    free = cfg.replace(moe_capacity_factor=MOE_DROP_FREE)
    rng = np.random.default_rng(1)
    wave_prompts = [rng.integers(0, V, 512).astype(np.int32)
                    for _ in range(MAX_BATCH)]
    ref, n, _, ref_own = phase_engine_path(
        "moe drop-free packed", lambda: PagedEngine(
            params, free, max_batch=MAX_BATCH, max_len=MAX_LEN,
            block_size=BS, device="cuda"),
        wave_prompts, hccs_packed_prefill, lambda e: e.occupancy_steps,
        LogitTap, layers=L, vocab=V, reps=1, profile=False)
    out["drop_free_packed"] = n
    toks, n, _, own = phase_engine_path(
        "moe drop-free wave", lambda: ServeEngine(
            params, free.replace(cache_layout="slot"), max_batch=MAX_BATCH,
            max_len=MAX_LEN, device="cuda"),
        wave_prompts, hccs_decode, lambda e: e.decode_steps,
        lambda eng: SampleTap(), layers=L, vocab=V, reps=2, profile=False)
    out["drop_free_wave"] = n
    by_uid = dict(enumerate(wave_prompts))
    divergence("moe drop-free wave", toks, ref, by_uid, by_uid, params, free,
               own=(own, ref_own))
    return out


# ------------------------------------------------------------ phase 29 --

SSM_ARCHS = ("mamba2-1.3b", "hymba-1.5b")
SSM_BATCH, SSM_PROMPT, SSM_NEW = 4, 256, 16
SSM_SCAN_T = 64                 # tokens of the chunked-vs-recurrent check
# The numeric checks run on the same weights in f32: with bf16 weights one
# rounding that differs between the chunked and the recurrent SSD (or
# between row counts of a projection) grows through the random-weight
# layers to logit differences of order 1 (on the card: mamba2 2.29 at the
# decode row, 54 of 64 served tokens not the forward's argmax; hymba
# 1.17). The JAX package grows such a difference alike with depth
# (tests/test_torch_families_bf16.py), so bf16 is served
# here for identity run to run only.
# Gates, set from the first f32 run on an H100 80GB HBM3 at 700 W (PERF.md
# section 6), about 4x the largest measurement: prefill + decode
# against the forward 0.0250 (mamba2; hymba 0.0013), chunked against
# recurrent SSD 1.43e-4 in |y| (hymba 2.1e-5), final states 1.26e-6
# relative.
SSM_DECODE_ATOL = 0.1           # |logit| prefill + decode against forward
SSD_SCAN_ATOL = 6e-4            # |y| chunked against recurrent, layer 0
SSD_STATE_RTOL = 5e-6           # final state, relative to its largest


def ssm_serve(params, cfg, prompts, label):
    """The wave ServeEngine on `prompts` (SSM_NEW new tokens each): tokens
    and wall; no HCCS kernel may launch."""
    eng = ServeEngine(params, cfg, max_batch=len(prompts),
                      max_len=SSM_PROMPT + SSM_NEW + 1, device="cuda")
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=SSM_NEW))
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    toks = {r.uid: list(r.out_tokens) for r in done}
    n_new = sum(map(len, toks.values()))
    log(f"[{label}] {eng.decode_steps} decode steps, {n_new} tokens in "
        f"{wall:.3f}s = {n_new / wall:.1f} new tok/s; HCCS kernel launches "
        f"{ {k.__name__: k.launches for k in KERNELS} }")
    check(len(done) == len(prompts) and all(
        len(t) == SSM_NEW for t in toks.values()),
        f"{label}: not every request done")
    check(not any(k.launches for k in KERNELS), f"{label}: an HCCS kernel "
          f"ran")
    return toks, wall


def ssm_against_forward(params, cfg, prompts, toks, label):
    """Served tokens against the teacher-forced forward (each the forward's
    argmax or a near tie of it) and prefill + one decode step against the
    forward. Returns the largest |dlogit|."""
    w, hc = params["weights"], params["hccs"]
    seq = torch.tensor(np.stack([np.concatenate(
        [prompts[u], np.asarray(toks[u][:-1], np.int32)])
        for u in range(len(prompts))]), device="cuda")
    t = SSM_PROMPT
    with torch.inference_mode():
        x, _, _ = M.forward(w, hc, {"tokens": seq}, cfg)
        full = M.logits_from_hidden(w, x, cfg).float()
        gen = full[:, t - 1:]                               # (B, NEW, V)
        served = torch.tensor([toks[u] for u in range(len(prompts))],
                              device="cuda")
        gap = (gen.max(-1).values - torch.gather(
            gen, -1, served[..., None])[..., 0])
        lg_p, cache = M.prefill(w, hc, {"tokens": seq[:, :t - 1]}, cfg,
                                max_len=t)
        lg_d, _ = M.decode_step(w, hc, seq[:, t - 1:t], cache, cfg)
    d_pre = float((lg_p.float() - full[:, t - 2]).abs().max())
    d_dec = float((lg_d.float() - full[:, t - 1]).abs().max())
    log(f"[{label}] served tokens against the teacher-forced forward: "
        f"{int((gap == 0).sum())} of {gap.numel()} its argmax, largest gap "
        f"{float(gap.max()):.4f}; prefill + decode against the forward: "
        f"max |dlogit| {d_pre:.5f} (prefill row), {d_dec:.5f} (decode "
        f"row), logits up to "
        f"{float(full[..., :cfg.vocab_size].abs().max()):.2f} (gates "
        f"{NEAR_TIE_GAP}, {SSM_DECODE_ATOL})")
    check(float(gap.max()) <= NEAR_TIE_GAP, f"{label}: a served token is "
          f"no near tie of the forward's argmax")
    check(max(d_pre, d_dec) <= SSM_DECODE_ATOL, f"{label}: prefill + "
          f"decode differs from the forward by {max(d_pre, d_dec)}")
    return max(d_pre, d_dec)


def phase_ssm():
    """mamba2-1.3b and hymba-1.5b at full width and depth (weights from
    seed 0) through the wave ServeEngine, 4 requests of 256 prompt tokens
    and 16 new each. bf16: twice, identical tokens, no HCCS kernel launched
    (mamba2 has no attention; hymba's window blocks the kernels and it runs
    the STE attention). The same weights in f32: every served token is the
    teacher-forced forward's argmax or a near tie of it, prefill + one
    decode step equals the forward, and layer 0's chunked SSD equals its
    recurrent step at full width (64 tokens). Returns the bf16 walls."""
    walls = {}
    for arch in SSM_ARCHS:
        cfg = get_config(arch)
        params = M.init_params(cfg, seed=0, device="cuda")
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, cfg.vocab_size, SSM_PROMPT).astype(
            np.int32) for _ in range(SSM_BATCH)]
        runs = []
        for rep in range(2):
            toks, wall = ssm_serve(params, cfg, prompts,
                                   f"{arch} wave bf16 run {rep}")
            runs.append(toks)
            walls.setdefault(arch, []).append(wall)
        check(runs[0] == runs[1], f"{arch}: the runs disagree")
        cfg32 = cfg.replace(dtype="float32")
        params = {"hccs": params["hccs"], "weights": M.unflatten_tree(
            {k: v.float() for k, v in
             M.flatten_tree(params["weights"]).items()})}
        toks, _ = ssm_serve(params, cfg32, prompts, f"{arch} wave f32")
        ssm_against_forward(params, cfg32, prompts, toks, f"{arch} f32")
        lp = M._layer(params["weights"]["layers"], 0)["ssm"]
        xs = torch.randn((2, SSM_SCAN_T, cfg.d_model), device="cuda",
                         generator=torch.Generator("cuda").manual_seed(3))
        with torch.inference_mode():
            y, st = ssm_module.apply_ssd(lp, xs, cfg32)
            state = torch.zeros_like(st)
            ys = []
            for i in range(SSM_SCAN_T):
                y_i, state = ssm_module.apply_ssd_step(lp, xs[:, i:i + 1],
                                                       cfg32, state)
                ys.append(y_i)
            y_rec = torch.cat(ys, 1)
        dy = float((y - y_rec).abs().max())
        ds = float((st - state).abs().max() / state.abs().max())
        log(f"[{arch}] chunked SSD (chunk {cfg.ssm_chunk}) against "
            f"{SSM_SCAN_T} recurrent steps at {cfg.ssm_heads} heads x "
            f"{cfg.ssm_head_dim} x state {cfg.ssm_state}, f32: max |dy| "
            f"{dy:.2e} (|y| up to {float(y.abs().max()):.3f}; gate "
            f"{SSD_SCAN_ATOL}), final state relative {ds:.2e} (gate "
            f"{SSD_STATE_RTOL})")
        check(dy <= SSD_SCAN_ATOL and ds <= SSD_STATE_RTOL,
              f"{arch}: chunked and recurrent SSD disagree")
        del params, lp
        torch.cuda.empty_cache()
    return walls


# ------------------------------------------------------------ phase 30 --

ENC_ARCH = "bert-small"
ENC_BATCH, ENC_SEQ = 16, 128
ENC_CAL_BATCHES = 2
ENC_STEPS, ENC_LR = 12, 1e-3
EMB_ARCHS = ("qwen2-vl-2b", "musicgen-large")
EMB_LAYERS = 4                  # depth cut: full width, 4 layers
EMB_BATCH, EMB_SEQ = 2, 256
EMB_GRID = 8                    # an 8 x 8 image patch grid leads the input


def mrope_positions(batch: int, seq: int, grid: int) -> np.ndarray:
    """(3, B, T) M-RoPE (t, h, w) ids: a grid x grid image (t 0, h and w
    its row and column), then text whose three ids all advance from the
    image's largest id + 1, as qwen2-vl lays them out."""
    n_img = grid * grid
    i = np.arange(n_img)
    img = np.stack([np.zeros(n_img, np.int64), i // grid, i % grid])
    txt = np.arange(seq - n_img) + grid
    pos = np.concatenate([img, np.stack([txt] * 3)], axis=1)
    return np.broadcast_to(pos[:, None], (3, batch, seq)).astype(np.int32)


def phase_encoder():
    """bert-small (the paper's own model) calibrated at its full size: with
    softmax attention it captures its logits on 2 classification batches of
    16 x 128, 64 rows a head, and calibrate_heads(per_head, i16_div) picks
    theta through hccs_rows (counted); then QAT with theta frozen, 12
    cls_loss steps of 16 x 128 (the default loss of a classification
    model): finite losses that fall, theta unchanged. Then qwen2-vl-2b
    (embedding inputs, M-RoPE over an image grid and text) and
    musicgen-large (embedding inputs, learned-free decoder) at full width,
    cut to 4 layers: one forward and one train step each. Returns the
    hccs_rows launches."""
    cfg = get_config(ENC_ARCH)
    task = ClsTask(ClsTaskConfig(vocab_size=cfg.vocab_size, seq_len=ENC_SEQ,
                                 num_classes=cfg.num_classes))
    batch_at = (lambda step: {k: torch.from_numpy(v).to("cuda") for k, v in
                              task.batch_at(step, ENC_BATCH).items()})
    soft = cfg.replace(attention_prob="softmax")
    params = M.init_params(soft, seed=0, device="cuda")
    captured = []
    for step in range(ENC_CAL_BATCHES):
        with torch.no_grad(), capture_attention_logits() as cap:
            M.forward(params["weights"], {}, {"tokens": batch_at(
                100 + step)["tokens"]}, soft)
        captured.append(torch.stack(cap).transpose(1, 2))
    rows = collect_attention_logits(captured, max_rows_per_head=CAL_ROWS)
    scale = np.abs(rows).max(axis=(2, 3)) / 127.0
    hccs_rows.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    theta, kl = calibrate_heads(rows, scale, ENC_SEQ, "per_head", CAL_MODE,
                                device="cuda")
    torch.cuda.synchronize()
    launches = hccs_rows.launches
    log(f"[encoder] {ENC_ARCH}: rows {rows.shape}, per-head calibration in "
        f"{time.perf_counter() - t0:.3f}s, hccs_rows launches {launches}; "
        f"KL {kl.min():.4f}-{kl.max():.4f} (mean {kl.mean():.4f})")
    check(launches > 0, "encoder: hccs_rows never launched")
    hccs = {"B": theta.B, "S": theta.S, "D": theta.D,
            "scale": torch.tensor(scale, dtype=torch.float32, device="cuda")}
    before = {k: v.clone() for k, v in hccs.items()}
    tcfg = TrainConfig(learning_rate=ENC_LR, warmup_steps=1,
                       total_steps=ENC_STEPS)
    state = train_state_from_params({"weights": params["weights"],
                                     "hccs": hccs}, tcfg)
    step_fn = make_train_step(cfg, tcfg)
    losses, accs = [], []
    t0 = time.perf_counter()
    for step in range(ENC_STEPS):
        state, m = step_fn(state, batch_at(step))
        losses.append(float(m["loss"]))
        accs.append(float(m["acc"]))
    torch.cuda.synchronize()
    log(f"[encoder] QAT {ENC_STEPS} cls_loss steps in "
        f"{time.perf_counter() - t0:.3f}s: loss "
        + ", ".join(f"{v:.4f}" for v in losses) + "; accuracy "
        + ", ".join(f"{v:.2f}" for v in accs))
    check(all(np.isfinite(losses)), "encoder: a loss is not finite")
    check(np.mean(losses[-3:]) < np.mean(losses[:3]),
          "encoder: the QAT loss did not fall")
    check(all(torch.equal(state["params"]["hccs"][k], v)
              for k, v in before.items()), "encoder: theta moved")
    del state, params, captured
    torch.cuda.empty_cache()
    for arch in EMB_ARCHS:
        ecfg = get_config(arch).replace(num_layers=EMB_LAYERS)
        eparams = M.init_params(ecfg, seed=0, device="cuda")
        b = make_embedding_batch(np.random.default_rng(4), EMB_BATCH,
                                 EMB_SEQ, ecfg.d_model, ecfg.vocab_size)
        if ecfg.rope == "mrope":
            b["mrope_positions"] = mrope_positions(EMB_BATCH, EMB_SEQ,
                                                   EMB_GRID)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to("cuda")
                 for k, v in b.items()}
        with torch.inference_mode():
            x, _, _ = M.forward(eparams["weights"], eparams["hccs"], batch,
                                ecfg)
            logits = M.logits_from_hidden(eparams["weights"], x, ecfg)
            note = ""
            if ecfg.rope == "mrope":
                plain = {k: v for k, v in batch.items()
                         if k != "mrope_positions"}
                x1, _, _ = M.forward(eparams["weights"], eparams["hccs"],
                                     plain, ecfg)
                note = (f"; without the image grid's position streams the "
                        f"hidden state moves by up to "
                        f"{float((x1 - x).abs().max()):.3f}")
                check(not torch.equal(x1, x), f"{arch}: M-RoPE streams "
                      f"change nothing")
        check(x.shape == (EMB_BATCH, EMB_SEQ, ecfg.d_model) and
              logits.shape[-1] == ecfg.padded_vocab and
              bool(torch.isfinite(x).all()), f"{arch}: forward")
        tcfg = TrainConfig(warmup_steps=1, total_steps=2)
        state = train_state_from_params(eparams, tcfg)
        t0 = time.perf_counter()
        state, m = make_train_step(ecfg, tcfg)(state, batch)
        torch.cuda.synchronize()
        loss, gn = float(m["loss"]), float(m["grad_norm"])
        log(f"[embeddings] {arch} at full width, {EMB_LAYERS} of "
            f"{get_config(arch).num_layers} layers: forward finite, "
            f"{EMB_BATCH} x {EMB_SEQ} embeddings; one train step in "
            f"{time.perf_counter() - t0:.3f}s, loss {loss:.4f}, grad norm "
            f"{gn:.4f}{note}")
        check(np.isfinite(loss) and np.isfinite(gn) and gn > 0,
              f"{arch}: train step")
        del state, eparams
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------- phases 31-33 --

HOT_ROWS = 32                   # phase 31's hot buffer: every decoded row
MESH_BATCH, MESH_PROMPT, MESH_STEPS = 4, 128, 8     # phase 32
DRYRUN_CELL = ("granite-3-2b", "decode_32k")        # phase 33


def phase_hot():
    """Phase 31: granite-3-2b at full width and depth on the wave
    ServeEngine, 8 requests of 512 prompt tokens and 32 new, with a
    32-row hot buffer (decoded rows appended there, the prompt and hot
    segments merged against a shared max) and without it (run twice, the
    first warming the card up), both on the STE attention (hot buffers
    block the kernels): no kernel launched, every
    request done, the hot run held to the classic one by the near-tie rule
    in the model's and both runs' own logits (SampleTap). Returns the two
    walls."""
    cfg, params = engine_model()
    ref_cfg = cfg.replace(cache_layout="slot", decode_kernel="none")
    hot_cfg = ref_cfg.replace(hot_buffer=HOT_ROWS)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
               for _ in range(MAX_BATCH)]
    runs = {}
    # the first run also warms the card up: classic twice, the second kept
    for label, c in (("warm-up", ref_cfg), ("classic", ref_cfg),
                     ("hot", hot_cfg)):
        eng = ServeEngine(params, c, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          device="cuda")
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32))
        for k in KERNELS:
            k.launches = 0
        torch.cuda.synchronize()
        with SampleTap() as tap:
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        toks = {r.uid: list(r.out_tokens) for r in done}
        launched = {k.__name__: k.launches for k in KERNELS}
        cache = M.init_cache(c, MAX_BATCH, MAX_LEN, device="meta")
        log(f"[hot] {label}: {eng.decode_steps} decode steps in "
            f"{wall:.3f}s, kernels {launched}, KV bytes "
            f"{serve_engine.kv_cache_bytes(cache)}")
        check(len(done) == MAX_BATCH and all(
            len(t) == 32 and all(0 <= x < VOCAB for x in t)
            for t in toks.values()), f"hot {label}: not every request done")
        check(not any(launched.values()), f"hot {label}: a kernel ran on "
              f"the STE path")
        runs[label] = (toks, tap.own, wall)
    by_uid = dict(enumerate(prompts))
    divergence("hot", runs["hot"][0], runs["classic"][0], by_uid, by_uid,
               params, ref_cfg, own=(runs["hot"][1], runs["classic"][1]))
    return {label: runs[label][2] for label in ("classic", "hot")}


def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def phase_mesh():
    """Phase 32: a (1, 1) DeviceMesh over ("data", "model") on the card,
    NCCL at world size 1 with its store on localhost. granite-3-2b's bf16
    weights (seed 0) distributed under DEFAULT_RULES, the cache and the
    prompts under the dry-run's layouts, then one prefill and 8 greedy
    decode steps of 4 x 128 prompt tokens under use_rules (the model's
    constrain calls redistribute); the same weights unsharded give the
    reference. Tokens must be equal; the largest logit difference is
    printed."""
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import _batch_shardings, _cache_shardings
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.parallel import sharding as SH
    cfg = get_config("granite-3-2b").replace(decode_kernel="none",
                                             cache_layout="slot")
    params = M.init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(4)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (
        MESH_BATCH, MESH_PROMPT)), dtype=torch.int32, device="cuda")
    max_len = MESH_PROMPT + MESH_STEPS + 1

    def serve(w, hccs, batch_of, cache, gather):
        out, logits = [], []
        with torch.no_grad():
            lg, cache = M.prefill(w, hccs, batch_of(toks), cfg,
                                  max_len=max_len, cache=cache)
            for step in range(MESH_STEPS + 1):
                lg = gather(lg).float()
                logits.append(lg)
                nxt = torch.argmax(lg, -1)[:, None].to(torch.int32)
                out.append(nxt[:, 0].tolist())
                if step < MESH_STEPS:
                    lg, cache = M.decode_step(w, hccs, batch_of(nxt)[
                        "tokens"], cache, cfg)
        return out, logits

    t0 = time.perf_counter()
    ref, ref_logits = serve(params["weights"], params["hccs"],
                            lambda t: {"tokens": t},
                            M.init_cache(cfg, MESH_BATCH, max_len,
                                         device="cuda"), lambda x: x)
    torch.cuda.synchronize()
    ref_wall = time.perf_counter() - t0
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{free_port()}", rank=0, world_size=1)
    try:
        mesh = make_debug_mesh(data=1, model=1)
        check(mesh.device_type == "cuda" and tuple(mesh.mesh.shape) == (
            1, 1), f"mesh {mesh}")
        with SH.use_rules(mesh), implicit_replication():
            shard = SH.named_sharding_tree(params["weights"], mesh)
            flat_sh = M.flatten_tree(shard)
            w = M.unflatten_tree({
                k: distribute_tensor(v, mesh, list(flat_sh[k].placements))
                for k, v in M.flatten_tree(params["weights"]).items()})
            hccs = {k: distribute_tensor(v, mesh, [Replicate()] * 2)
                    for k, v in params["hccs"].items()}
            cache0 = M.init_cache(cfg, MESH_BATCH, max_len, device="cuda")
            csh = _cache_shardings(cache0, mesh, True)
            cache = {"layers": {k: distribute_tensor(
                v, mesh, csh["layers"][k]) for k, v in
                cache0["layers"].items()},
                "length": distribute_tensor(cache0["length"], mesh,
                                            csh["length"])}
            spec = _batch_shardings({"tokens": toks}, mesh, True)["tokens"]
            sharded_specs = {k: str(flat_sh[k].placements) for k in (
                "layers.attn.wq", "embed.table", "layers.mlp.w_out")}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            got, logits = serve(w, hccs, lambda t: {
                "tokens": distribute_tensor(t, mesh, spec)}, cache,
                lambda x: x.full_tensor())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            kinds = {type(w["layers"]["attn"]["wq"]).__name__,
                     type(cache["layers"]["k"]).__name__}
    finally:
        dist.destroy_process_group()
    diff = max(float((a - b).abs().max()) for a, b in zip(logits,
                                                          ref_logits))
    log(f"[mesh] {CARD}: (1, 1) mesh over (data, model), NCCL world 1; "
        f"placements {sharded_specs}; leaves {sorted(kinds)}; prefill + "
        f"{MESH_STEPS} decode steps of {MESH_BATCH} x {MESH_PROMPT} in "
        f"{wall:.3f}s sharded, {ref_wall:.3f}s unsharded; tokens "
        f"{'equal' if got == ref else 'DIFFER'}; largest logit difference "
        f"{diff:.3e}")
    check(kinds == {"DTensor"}, f"mesh: leaves not distributed: {kinds}")
    check(got == ref, "mesh: the sharded run's tokens differ from the "
          "unsharded run's")
    return dict(wall=wall, ref_wall=ref_wall, max_logit_diff=diff)


def phase_dryrun():
    """Phase 33: the dry-run of granite-3-2b x decode_32k on the (16, 16)
    mesh over a fake process group of 256 ranks, on the host (two
    subprocesses side by side that cannot see the card), without and with
    a 32-row hot buffer; their roofline terms beside the card's name and
    power limit."""
    arch, shape = DRYRUN_CELL
    out = Path(__file__).resolve().parent / "build" / "smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    env = {k: v for k, v in os.environ.items() if k != "REPRO_MESH"}
    env.update(CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=str(Path(__file__).resolve().parent / "src"))
    recs = {}
    t0 = time.perf_counter()
    # the two cells run side by side, one process each
    procs = {tag: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
         "--shape", shape, "--mesh", "pod", "--out", str(out)] + extra,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for tag, extra in (("", []), ("hot", [
            "--hot-buffer", str(HOT_ROWS), "--tag", "hot"]))}
    for tag, proc in procs.items():
        try:
            _, err = proc.communicate(timeout=300)
        finally:
            proc.kill()
        wall = time.perf_counter() - t0
        check(proc.returncode == 0, f"dry-run {tag or 'classic'} failed: "
              f"{err[-1500:]}")
        name = f"{arch}_{shape}_pod{'_' + tag if tag else ''}.json"
        rec = json.loads((out / name).read_text())
        check(rec["ok"] and rec["chips"] == 256 and rec["mesh_shape"] == [
            16, 16] and rec["flops_per_dev"] > 0, f"dry-run record {rec}")
        rf = rec["roofline"]
        log(f"[dryrun] {CARD}: {arch} x {shape} x (16, 16), hot buffer "
            f"{rec['hot_buffer']}, {rec['num_layers']} layers, done "
            f"{wall:.1f}s after the start on the host: FLOPs/dev {rec['flops_per_dev']:.4e}, bytes/dev "
            f"{rec['bytes_per_dev']:.4e}, collective bytes/dev "
            f"{rec['collectives']['total_bytes']:.4e}; compute "
            f"{rf['compute_s']:.4e}s, memory {rf['memory_s']:.4e}s, "
            f"collective {rf['collective_s']:.4e}s, dominant "
            f"{rf['dominant']}, bound {rf['step_s_lower_bound']:.4e}s; "
            f"useful FLOPs {rec['useful_flops_ratio']:.4f}; memory "
            f"{rec['memory']}")
        recs[tag or "classic"] = rec
    shutil.rmtree(out, ignore_errors=True)
    return recs


# ---------------------------------------------------------------- phase 34 --

EXAMPLES = ("calibration_study", "quickstart", "train_lm", "serving")
BERT_SEQ, BERT_BATCH = 128, 32  # quickstart on bert-small: ClsTask shapes
TRAIN_LM_RUNS = (100, 150)      # train_lm: stopped at 100, resumed to 150


def load_example(name: str):
    """examples/torch_<name>.py as a module (its main() runs nothing until
    called)."""
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def check_theta(label, theta, n):
    B, S, D = (t.cpu().numpy() for t in theta.astuple())
    try:
        validate_params(B, S, D, n)
    except (AssertionError, ValueError) as e:
        raise PhaseFailed(f"{label}: infeasible theta: {e}") from e


def study_against_cpu(ex, card):
    """The study's theta at each granularity on the card against the same
    study through the plain versions on the host: equal, or the card's
    theta within CAL_KL_TIE of the CPU's KL on the same rows (a tie)."""
    rows, scales, _ = ex.make_rows()
    L, H, R, n = rows.shape
    t0 = time.perf_counter()
    cpu = ex.study(rows, scales, device="cpu", log=lambda *a: None)
    groups = {"global": lambda l, h: (rows.reshape(-1, n),
                                      float(scales.mean())),
              "per_layer": lambda l, h: (rows[l].reshape(-1, n),
                                         float(scales[l].mean())),
              "per_head": lambda l, h: (rows[l, h], float(scales[l, h]))}
    ties = 0
    for gran, (theta, kl) in card.items():
        check_theta(f"study {gran}", theta, n)
        ctheta, ckl = cpu[gran]
        for l in range(L):
            for h in range(H):
                mine = tuple(int(t[l, h]) for t in theta.astuple())
                ref = tuple(int(t[l, h]) for t in ctheta.astuple())
                if mine == ref:
                    continue
                xr, sc = groups[gran](l, h)
                xq, pref = head_inputs(xr, sc, "cpu")
                kl_mine = float(kl_for_grid(xq, pref, torch.tensor(
                    [mine], dtype=torch.int32), CAL_MODE)[0])
                rel = abs(kl_mine - ckl[l, h]) / ckl[l, h]
                log(f"[examples]   study {gran} ({l}, {h}): card {mine}, "
                    f"CPU {ref}; the card's theta on the CPU: KL "
                    f"{kl_mine:.6f} against {ckl[l, h]:.6f} (rel. "
                    f"{rel:.2e})")
                check(rel <= CAL_KL_TIE, f"study {gran} ({l}, {h}): card "
                      f"theta {mine} != CPU {ref}, no tie")
                ties += 1
        log(f"[examples] study {gran}: mean KL card {kl.mean():.6f}, CPU "
            f"{ckl.mean():.6f}; per-head KL "
            + ", ".join(f"{v:.4f}" for v in kl.ravel()))
    log(f"[examples] study against the CPU in "
        f"{time.perf_counter() - t0:.3f}s: {ties} near ties, every other "
        f"theta equal")


def phase_examples():
    """Phase 34: the four examples, each through its own functions and, at
    the JAX scripts' defaults, its main() on the card. The calibration
    study (hccs_rows counted) against the same study through the plain
    versions on the host; quickstart (hccs_rows counted); train_lm at its
    defaults (150 steps, int8 compression; the script's loss-decrease
    assertion), then --steps 100 into a directory under build/ and the
    script's train stage to 150 from there, which must resume at step 100
    with the loss below that run's step 0 (the script's own assertion
    would compare steps 100 and 149 alone, where the loss sits at log V
    and rises in both packages: PERF.md section 6);
    serving (no decode kernel: the STE path, as in the JAX script), the
    three engines' greedy tokens held to the paged engine's by the
    near-tie rule; then quickstart's stages on bert-small at full size
    (ClsTask at vocab 30522 and seq 128, 80 float steps and 40 QAT steps
    at batch 32): Table I's accuracy triple. Returns the hccs_rows launches
    and what was measured."""
    ex = {name: load_example(name) for name in EXAMPLES}
    out, launches, walls = {}, {}, {}

    hccs_rows.launches = 0
    t0 = time.perf_counter()
    card_study = ex["calibration_study"].main([])
    torch.cuda.synchronize()
    walls["calibration_study"] = time.perf_counter() - t0
    launches["calibration_study"] = hccs_rows.launches
    check(launches["calibration_study"] > 0,
          "study: hccs_rows never launched")
    study_against_cpu(ex["calibration_study"], card_study)

    hccs_rows.launches = 0
    t0 = time.perf_counter()
    qs = ex["quickstart"].main([])
    torch.cuda.synchronize()
    walls["quickstart"] = time.perf_counter() - t0
    launches["quickstart"] = hccs_rows.launches
    check(launches["quickstart"] > 0, "quickstart: hccs_rows never launched")
    check(all(np.isfinite(qs["float_losses"] + qs["qat_losses"])),
          "quickstart: a loss is not finite")
    check_theta("quickstart", qs["theta"], ex["quickstart"].SEQ)
    out["quickstart"] = {k: qs[k] for k in ("acc_base", "acc_nr",
                                            "acc_qat")}

    ckdir = ROOT / "build" / "smoke_train_lm"
    shutil.rmtree(ckdir, ignore_errors=True)
    tl = ex["train_lm"]
    first, second = TRAIN_LM_RUNS
    lines = []

    def keep(line):
        lines.append(line)
        log(line)
    t0 = time.perf_counter()
    try:
        _, full = tl.main(["--steps", str(second), "--ckpt-dir",
                           str(ckdir / "defaults")])
        _, head = tl.main(["--steps", str(first), "--ckpt-dir",
                           str(ckdir / "resumed")])
        cfg, batch, seq = tl.model_config(False)
        _, tail = tl.train(cfg, tl.train_config(second, "int8"), batch, seq,
                           ckpt_dir=str(ckdir / "resumed"), device="cuda",
                           log_fn=keep)
    finally:
        shutil.rmtree(ckdir, ignore_errors=True)
    torch.cuda.synchronize()
    walls["train_lm"] = time.perf_counter() - t0
    check(any(line.startswith(f"[resume] restored step {first}")
              for line in lines),
          f"train_lm: the second run did not resume at step {first}")
    check([h["step"] for h in full] == list(range(second)) and
          [h["step"] for h in head + tail] == list(range(second)),
          "train_lm: the runs' steps")
    losses = [h["loss"] for h in full + head + tail]
    check(all(np.isfinite(losses)), "train_lm: a loss is not finite")
    joined = [h["loss"] for h in head + tail]
    check(joined[-1] < joined[0], "train_lm: the resumed run's loss did "
          "not fall from its step 0")
    out["train_lm"] = dict(full=(full[0]["loss"], full[-1]["loss"]),
                           resumed=(joined[0], tail[0]["loss"], joined[-1]))
    log(f"[examples] train_lm at its defaults ({second} steps, int8): loss "
        f"{full[0]['loss']:.4f} -> {full[-1]['loss']:.4f}; {first} steps, "
        f"then resumed at step {first} to {second}: {joined[0]:.4f} -> "
        f"{tail[0]['loss']:.4f} at the resume -> {joined[-1]:.4f}; "
        f"{walls['train_lm']:.3f}s")

    decode = (hccs_packed_prefill, hccs_paged_decode, hccs_decode)
    for k in decode:
        k.launches = 0
    t0 = time.perf_counter()
    sv = ex["serving"].main([])
    torch.cuda.synchronize()
    walls["serving"] = time.perf_counter() - t0
    check(all(k.launches == 0 for k in decode),
          "serving: a decode kernel launched on the STE path")
    check(all(np.isfinite(h["loss"]) for h in sv["history"]),
          "serving: a pre-train loss is not finite")
    greedy = {name: {r.uid: list(r.out_tokens) for r in done
                     if r.temperature == 0.0}
              for name, (done, _, _) in sv["served"].items()}
    prompts = {r.uid: r.prompt for r in sv["served"]["paged"][0]}
    params, scfg = sv["state"]["params"], ex["serving"].cfg
    for name in ("wave", "continuous"):
        divergence(f"examples serving {name}", greedy[name],
                   greedy["paged"], prompts, prompts, params, scfg)
    out["serving"] = {name: tokens / dt for name, (_, tokens, dt)
                      in sv["served"].items()}
    stats = sv["prefix_stats"]
    check(stats["decode_hits"] > 0, "serving: no decode-block hit")
    log("[examples] serving: " + ", ".join(
        f"{name} {v:.1f} tok/s" for name, v in out["serving"].items())
        + f"; chat {stats['decode_hits']} decode-block hits, follow-up "
        f"skip rate {stats['followup_skip_rate']:.4f}; "
        f"{walls['serving']:.3f}s")

    cfg = get_config(ENC_ARCH).replace(attention_prob="softmax")
    task = ClsTask(ClsTaskConfig(vocab_size=cfg.vocab_size, seq_len=BERT_SEQ,
                                 num_classes=cfg.num_classes))
    hccs_rows.launches = 0
    t0 = time.perf_counter()
    bert = ex["quickstart"].run(cfg, task=task, steps=ex["quickstart"].STEPS,
                                batch=BERT_BATCH, device="cuda", log=log)
    torch.cuda.synchronize()
    walls["bert_small"] = time.perf_counter() - t0
    launches["bert_small"] = hccs_rows.launches
    check(launches["bert_small"] > 0, "bert-small: hccs_rows never launched")
    check(all(np.isfinite(bert["float_losses"] + bert["qat_losses"])),
          "bert-small: a loss is not finite")
    check_theta("bert-small", bert["theta"], BERT_SEQ)
    out["bert_small"] = {k: bert[k] for k in ("acc_base", "acc_nr",
                                              "acc_qat")}
    del bert, qs, sv
    torch.cuda.empty_cache()
    for name in ("quickstart", "bert_small"):
        a = out[name]
        log(f"[examples] {name} Table I triple on {CARD}: baseline "
            f"{a['acc_base']:.4f}, no-retrain {a['acc_nr']:.4f}, retrained "
            f"{a['acc_qat']:.4f}")
    log("[examples] hccs_rows launches: " + ", ".join(
        f"{k} {v}" for k, v in launches.items()) + "; walls " + ", ".join(
        f"{k} {v:.3f}s" for k, v in walls.items()))
    return dict(launches=launches, walls=walls, **out)


def kernel_entry(name, source, replaces, launches, tm, shape,
                 library_ms=None, headers=(), kernels_per_call=None):
    """One kernel of phase 35's line. `launches` counts wrapper calls on
    the main path; `kernels_per_call` is the kernels on the card per
    wrapper call in the path's profiled run (None where not profiled).
    `device_ms` / `cold_ms`: device-only time with K/V warm in L2 / with
    L2 flushed, where measured."""
    csrc = "src/repro_torch/kernels/csrc/"
    return {"name": name, "route": "cuda", "source": csrc + source,
            "headers": [csrc + h for h in headers],
            "replaces": replaces, "launches": launches,
            "kernels_per_call": kernels_per_call,
            "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
            "kernel_ms": tm["ms"], "device_ms": tm.get("device_ms"),
            "cold_ms": tm.get("cold_ms"), "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": library_ms, "shape": shape}


# ------------------------------------------------------------ phase 36 --

HYB_ARCH = "granite-4.0-h-micro"
# the kernel check's slots: (tokens, position of the first) each; 0 tokens:
# no segment; position 0: the segment starts from zero state
HYB_SEGMENTS = ((1, 0), (2, 700), (3, 5), (37, 0), (130, 1200), (0, 0),
                (1, 2047), (64, 64))
HYB_PADS = 5
# the benchmark cell's step (granite-4.0-h-micro.short-chat): 256 slots,
# 243 one-token decode lanes and 13 prefill chunks of 128, at the 2048 rung
HYB_CELL = dict(slots=256, decode=243, chunks=13, chunk=128, width=2048)
# gates, far above a run's readings on an H100 80GB HBM3 at 700 W (y
# 1.5e-6 in f32 and 2.8e-4 in bf16, state 7.9e-7): y against the plain
# version relative to its largest |y|, the f32 state relative to its
# largest entry; the conv window is a copy and must be equal
HYB_Y_RTOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
HYB_STATE_RTOL = 1e-4


def hybrid_scan_case(slots_spec, pads, dtype, seed, cfg):
    """Inputs of one ssd_packed_scan call: a packed row of the given
    segments (in slot order, pad lanes at the tail), random stored state
    and window, the layer's weights drawn as the benchmark draws them."""
    g = torch.Generator("cuda").manual_seed(seed)
    di, nh, n, hp = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    c, k = di + 2 * n, cfg.ssm_conv
    lens = [t for t, _ in slots_spec]
    width = sum(lens) + pads
    sid = np.full(width, -1, np.int32)
    pos = np.zeros(width, np.int32)
    o = 0
    for b, (t, p0) in enumerate(slots_spec):
        sid[o:o + t] = b
        pos[o:o + t] = p0 + np.arange(t)
        o += t

    def rn(*shape, std=1.0, dt=dtype):
        return (torch.randn(shape, generator=g, device="cuda") * std).to(dt)
    dt0 = torch.exp(math.log(1e-3) + (math.log(0.1) - math.log(1e-3))
                    * torch.rand(nh, generator=g, device="cuda"))
    case = dict(
        zxbcdt=rn(width, di + c + nh), conv_w=rn(c, k, std=0.5),
        conv_b=rn(c, std=0.5), conv_state=rn(len(lens), k - 1, c),
        ssm_state=rn(len(lens), nh, n, hp, std=0.1, dt=torch.float32),
        A_log=torch.log(1 + 15 * torch.rand(nh, generator=g, device="cuda")),
        dt_bias=dt0 + torch.log(-torch.expm1(-dt0)),
        D=torch.ones(nh, device="cuda"))
    sid_t = torch.tensor(sid, device="cuda")
    case["segments"] = ssm_module.packed_segments(
        sid_t, torch.tensor(pos, device="cuda"), len(lens))
    case["slot_ids"] = sid_t
    return case


def hybrid_scan(case, cfg, fn):
    args = {k: (v.clone() if k in ("conv_state", "ssm_state") else v)
            for k, v in case.items()}
    y = fn(args["zxbcdt"], args["conv_w"], args["conv_b"],
           args["conv_state"], args["ssm_state"], args["A_log"],
           args["dt_bias"], args["D"], args["segments"], args["slot_ids"],
           d_inner=cfg.d_inner, state=cfg.ssm_state,
           head_dim=cfg.ssm_head_dim, groups=cfg.ssm_groups,
           chunk=cfg.ssm_chunk)
    return y, args["ssm_state"], args["conv_state"]


def hybrid_launches(prof, ranges=("repro.ssm",)) -> dict:
    """Kernel launches (runtime launch calls) inside each `ranges` range of
    a profile: {name: [launches of each range]}."""
    evs = [(e.name(), e.start_ns(), e.end_ns())
           for e in prof.profiler.kineto_results.events()
           if not str(e.device_type()).endswith("CUDA")]
    calls = sorted(s for n, s, _ in evs
                   if n.startswith(("cudaLaunch", "cuLaunch")))
    out = {}
    for name in ranges:
        spans = sorted((s, e) for n, s, e in evs if n == name)
        out[name] = [bisect.bisect_right(calls, e) - bisect.bisect_left(
            calls, s) for s, e in spans]
    return out


def hybrid_check(case, cfg, dtype, what) -> float:
    """One ssd_packed_scan call against its plain version on the same
    inputs (each on its own copy of the stored state): y, the f32 state,
    the conv window, y = 0 on the pad lanes and every idle slot's state
    untouched. Fails the phase past the HYB_* gates; returns y's error
    relative to its largest |y|."""
    n0 = ssd_packed_scan.launches
    with torch.inference_mode():
        got = hybrid_scan(case, cfg, ssd_packed_scan)
        torch.cuda.synchronize()
        want = hybrid_scan(case, cfg, ssd_packed_scan_ref)
    check(ssd_packed_scan.launches == n0 + 1, "ssd_packed_scan did not "
          "launch")
    dy = float((got[0].float() - want[0].float()).abs().max()
               / want[0].float().abs().max())
    ds = float((got[1] - want[1]).abs().max() / want[1].abs().max())
    dw = bool(torch.equal(got[2], want[2]))
    pads = case["slot_ids"] < 0
    pad = float(got[0][pads].float().abs().max()) if bool(pads.any()) else 0.0
    idle = case["segments"][1] == 0
    untouched = bool(torch.equal(got[1][idle], case["ssm_state"][idle])
                     and torch.equal(got[2][idle], case["conv_state"][idle]))
    log(f"[hybrid] scan {what}, {dtype}: y rel {dy:.2e} (gate "
        f"{HYB_Y_RTOL[dtype]}), state rel {ds:.2e} (gate {HYB_STATE_RTOL}), "
        f"window equal {dw}, pad |y| {pad}, {int(idle.sum())} idle slots "
        f"untouched {untouched}")
    check(dy <= HYB_Y_RTOL[dtype] and ds <= HYB_STATE_RTOL and dw
          and pad == 0.0 and untouched, f"ssd_packed_scan {what} {dtype} "
          "differs from its plain version")
    return dy


def phase_hybrid():
    """granite-4.0-h-micro's Mamba-2 scan (kernels/ssd.py, csrc/
    ssd_packed.cu) at full width: against its plain version on a packed
    row of fresh and continued segments of 1-130 tokens, an idle slot and
    pad lanes, in f32 and bf16 (y, the f32 state, the conv window); then
    at the benchmark cell's step (and its decode lanes and its chunks
    alone), checked the same way and then timed beside its bound. Then the
    model at full width and depth on the packed PagedEngine: one
    all-decode step at 4 and at 256 live slots, profiled, must launch as
    many kernels inside every `repro.ssm` range, and the kernel once a
    Mamba-2 layer. Returns phase 35's timing and launches."""
    cfg = get_config(HYB_ARCH)
    kernel = ssd_packed_scan
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        hybrid_check(hybrid_scan_case(HYB_SEGMENTS, HYB_PADS, dtype, 5, cfg),
                     cfg, dtype, "mixed segments")
    hc = HYB_CELL
    decode = [(1, 900 + b) for b in range(hc["decode"])]
    chunks = [(hc["chunk"], 0 if b % 2 else 512) for b in range(hc["chunks"])]
    nh, n, hp = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    c = cfg.d_inner + 2 * n
    state = nh * n * hp * 4 + (cfg.ssm_conv - 1) * c * 2
    out["scan"] = {}
    for what, spec in (("cell", decode + chunks), ("decode", decode),
                       ("chunks", chunks)):
        spec = spec + [(0, 0)] * (hc["slots"] - len(spec))
        toks = sum(t for t, _ in spec)
        pads = (hc["width"] if what == "cell" else toks) - toks
        case = hybrid_scan_case(spec, pads, torch.bfloat16, 6, cfg)
        err = hybrid_check(case, cfg, torch.bfloat16, what)
        args = (case["zxbcdt"], case["conv_w"], case["conv_b"],
                case["conv_state"], case["ssm_state"], case["A_log"],
                case["dt_bias"], case["D"], case["segments"],
                case["slot_ids"])
        kw = dict(d_inner=cfg.d_inner, state=n, head_dim=hp, groups=1,
                  chunk=cfg.ssm_chunk)

        def call():
            kernel(*args, **kw)
        with torch.inference_mode():
            ms, dev_ms = cuda_time_ms(call), graph_time_ms(call)
            plain_ms = (cuda_time_ms(lambda: ssd_packed_scan_ref(*args, **kw),
                                     iters=2, warmup=1)
                        if what == "cell" else None)
        nbytes = (sum(state * (2 if p0 else 1) for t, p0 in spec if t)
                  + toks * (c + nh + cfg.d_inner) * 2)
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"[hybrid] scan, {what} ({sum(1 for t, _ in spec if t)} "
            f"segments, {toks} tokens, width {toks + pads}, "
            f"{hc['slots']} slots, bf16): {ms:.4f} ms a call, device "
            f"{dev_ms:.4f} ms, plain {plain_ms} ms, bound {bound_ms:.4f} ms "
            f"({nbytes / 1e6:.1f} MB), {100 * bound_ms / dev_ms:.1f}% of "
            f"the roofline ({CARD})")
        out["scan"][what] = dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                                 bound_ms=bound_ms, bound_by="bytes",
                                 max_abs_err=err, nbytes=nbytes)

    params = M.init_params(cfg, seed=0, device="cuda")
    counts = {}
    for live in (4, 256):
        eng = PagedEngine(params, cfg, max_batch=256, max_len=64,
                          block_size=32, num_blocks=2 * 256 + 2,
                          token_budget=4096, device="cuda")
        rng = np.random.default_rng(live)
        for i in range(live):
            eng.submit(Request(uid=i, prompt=rng.integers(
                0, cfg.vocab_size, 16).astype(np.int32), max_new_tokens=8))
        eng.step()                               # every prompt in one step
        eng.step()
        torch.cuda.synchronize()
        kernel.launches = 0
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            eng.step()                           # every lane a decode lane
            torch.cuda.synchronize()
        calls = kernel.launches
        got = hybrid_launches(prof, ("repro.ssm", "repro.ssm.scan"))
        counts[live] = got
        on_card = sum(1 for e in device_events(prof)
                      if "ssd_scan_kernel" in e.name
                      or "ssd_window_kernel" in e.name)
        log(f"[hybrid] {live} live slots, one decode step: launches a "
            f"repro.ssm range {sorted(set(got['repro.ssm']))} over "
            f"{len(got['repro.ssm'])} ranges, a repro.ssm.scan range "
            f"{sorted(set(got['repro.ssm.scan']))}; ssd_packed_scan called "
            f"{calls} times, {on_card} of its kernels on the card")
        check(len(got["repro.ssm"]) == cfg.layers_of("mamba")
              and len(set(got["repro.ssm"])) == 1,
              f"{live} slots: the Mamba-2 layers launch unevenly")
        check(calls == cfg.layers_of("mamba"), f"{live} slots: "
              f"ssd_packed_scan called {calls} times in a step, not once a "
              f"Mamba-2 layer")
        check(on_card in (0, 2 * calls), f"{live} slots: {on_card} scan "
              f"and window kernels on the card for {calls} calls, not 2 a "
              f"call")
        out["launches"] = calls
        out["kernels_per_call"] = per_call(on_card, calls)
        del eng
        torch.cuda.empty_cache()
    check(counts[4] == counts[256], "the Mamba-2 layer's launches grow "
          "with the live slots")
    out["launches_per_mixer"] = counts[4]["repro.ssm"][0]
    return out



def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases",
                    default=",".join(str(p) for p in range(1, 37)),
                    help="comma-separated subset of phases to run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    t_start = time.perf_counter()

    def mark(n):
        log(f"[time] phase {n} done, {time.perf_counter() - t_start:.1f}s "
            f"since the start")
    phase_device()
    if 2 in phases:
        phase_build()
        mark(2)
    timings, worst = ({}, None)
    if 3 in phases:
        timings, worst = phase_kernel()
        mark(3)
    if 4 in phases:
        phase_forward()
        mark(4)
    launches, packed_tokens, packed_per_call, sync_ref = (None,) * 4
    if 5 in phases:
        launches, packed_tokens, packed_per_call, sync_ref = phase_engine()
        mark(5)
    decode_timings = {}
    if 6 in phases:
        decode_timings["paged"] = phase_decode_kernel("paged")
        mark(6)
    if 7 in phases:
        decode_timings["arena"] = phase_decode_kernel("arena")
        mark(7)
    path_launches, path_per_call = {}, {}
    if phases & {8, 9, 10}:
        path_launches, path_per_call = phase_paths(
            packed_tokens, sync_ref and sync_ref["own"], phases)
        mark("8-10")
    if 11 in phases:
        phase_rows()
        mark(11)
    if 12 in phases:
        phase_softmax()
        mark(12)
    if 13 in phases:
        phase_fused()
        mark(13)
    table3_launches, kernel_t = None, None
    if 14 in phases:
        table3_launches, kernel_t = phase_table3()
        mark(14)
    fold_t = fold_launches = fold_per_call = sharing_ref = None
    if 15 in phases:
        fold_t = phase_fold()
        mark(15)
    if 16 in phases:
        fold_launches, fold_per_call, sharing_ref = phase_sharing()
        mark(16)
    if 17 in phases:
        phase_grid(packed_tokens, sync_ref and sync_ref["own"])
        mark(17)
    spec = overload = chaos = None
    if 18 in phases:
        spec = phase_spec()
        mark(18)
    if 19 in phases:
        overload = phase_overload()
        mark(19)
    if 20 in phases:
        chaos = phase_chaos()
        mark(20)
    asynch = tele = sampling = None
    if 21 in phases:
        asynch = phase_async(packed_tokens, sync_ref, sharing_ref)
        mark(21)
    if 22 in phases:
        busy = {}
        if sync_ref is not None:
            busy["sync"] = sync_ref["busy_ms"]
        if asynch is not None:
            busy["async"] = asynch["busy_ms"]
        tele = phase_telemetry(packed_tokens, busy)
        mark(22)
    if 23 in phases:
        sampling = phase_sampling()
        mark(23)
    cal = trained = ckpt = served = None
    if 24 in phases:
        cal = phase_calibrate()
        mark(24)
    if 25 in phases:
        check(cal is not None, "phase 25 needs phase 24's theta")
        trained = phase_train(cal)
        mark(25)
    if 26 in phases:
        check(cal is not None, "phase 26 needs phase 24's theta")
        ckpt = phase_checkpoint(cal)
        mark(26)
    if 27 in phases:
        check(trained is not None, "phase 27 needs phase 25's weights")
        served = phase_serve_trained(trained)
        mark(27)
    moe = ssm_walls = enc_launches = None
    if 28 in phases:
        moe = phase_moe()
        mark(28)
    if 29 in phases:
        ssm_walls = phase_ssm()
        mark(29)
    if 30 in phases:
        enc_launches = phase_encoder()
        mark(30)
    if 31 in phases:
        phase_hot()
        mark(31)
    if 32 in phases:
        phase_mesh()
        mark(32)
    if 33 in phases:
        phase_dryrun()
        mark(33)
    examples = None
    if 34 in phases:
        examples = phase_examples()
        mark(34)
    hybrid = None
    if 36 in phases:
        hybrid = phase_hybrid()
        mark(36)
    if 35 in phases:
        check(launches and timings and len(decode_timings) == 2
              and len(path_launches) == 2 and {11, 12, 13, 17} <= phases
              and table3_launches and fold_t and fold_launches and spec
              and overload and chaos and asynch and tele and sampling
              and cal and ckpt and served and moe and ssm_walls
              and enc_launches and examples and hybrid,
              "phase 35 needs phases 3, 5 to 30, 34 and 36")
        slice_launches = {
            "hccs_packed_prefill": dict(
                spec=spec["packed"],
                overload=overload["launches"]["hccs_packed_prefill"],
                chaos=chaos["launches"]["hccs_packed_prefill"],
                async_mixed=asynch["packed"],
                async_sessions=asynch["sessions_packed"],
                telemetry_sync=tele["sync"], telemetry_async=tele["async"],
                open_loop=tele["open_loop"], sampling=sampling["sync"],
                sampling_async=sampling["async_"], trained=served,
                moe=moe["packed"], moe_drop_free=moe["drop_free_packed"]),
            "hccs_paged_decode": dict(moe=moe["lockstep"]),
            "hccs_decode": dict(
                moe_continuous=moe["continuous"],
                moe_drop_free_wave=moe["drop_free_wave"]),
            "paged_quant_scatter_kv": dict(
                spec_in_step=spec["fold_in_step"],
                spec_replay=spec["fold_replay"],
                overload=overload["launches"]["paged_quant_scatter_kv"],
                chaos=chaos["launches"]["paged_quant_scatter_kv"],
                async_sessions=asynch["sessions_fold"])}
        tm = dict(timings[max(timings)], max_abs_err=worst)
        geo = f"granite H={H} Hkv={HKV} d={D}"
        split_headers = ("hccs_split.cuh", "hccs_common.cuh")
        log(json.dumps({"kernels": [
            dict(kernel_entry("hccs_packed_prefill", "hccs_packed.cu",
                              "src/repro/kernels/decode.py:400", launches,
                              tm, f"width {max(timings)}, {geo} bs={BS}, "
                              f"f32 pool, mode wide", headers=split_headers,
                              kernels_per_call=packed_per_call),
                 slice_launches=slice_launches["hccs_packed_prefill"]),
            dict(kernel_entry("hccs_paged_decode", "hccs_paged.cu",
                              "src/repro/kernels/decode.py:316",
                              path_launches["hccs_paged_decode"],
                              decode_timings["paged"],
                              f"B=8, {geo} bs={BS}, f32 pool, mode wide",
                              headers=split_headers,
                              kernels_per_call=path_per_call[
                                  "hccs_paged_decode"]),
                 slice_launches=slice_launches["hccs_paged_decode"]),
            dict(kernel_entry("hccs_decode", "hccs_arena.cu",
                              "src/repro/kernels/decode.py:254",
                              path_launches["hccs_decode"],
                              decode_timings["arena"],
                              f"B=8, {geo} Tmax={MAX_LEN}, f32 arena, mode "
                              f"wide", headers=split_headers,
                              kernels_per_call=path_per_call["hccs_decode"]),
                 slice_launches=slice_launches["hccs_decode"]),
            dict(kernel_entry("hccs_rows", "hccs_rows.cu",
                              "src/repro/kernels/hccs.py:79",
                              table3_launches["hccs_rows"],
                              kernel_t["hccs_rows"],
                              f"{G_ROWS} x {G_COLS} int8, per-head theta, "
                              f"i16_div"),
                 slice_launches=dict(
                     calibration=cal["launches"],
                     encoder_calibration=enc_launches,
                     examples=examples["launches"]["calibration_study"]
                     + examples["launches"]["quickstart"],
                     examples_bert_small=examples["launches"][
                         "bert_small"])),
            kernel_entry("softmax_bf16", "softmax_bf16.cu",
                         "src/repro/kernels/softmax_bf16.py:32",
                         table3_launches["softmax_bf16"],
                         kernel_t["softmax_bf16"],
                         f"{G_ROWS} x {G_COLS} bf16",
                         kernel_t["softmax_bf16"]["library_ms"]),
            kernel_entry("hccs_mha_fused", "hccs_fused.cu",
                         "src/repro/kernels/attention.py:95",
                         table3_launches["hccs_mha_fused"],
                         kernel_t["hccs_mha_fused"],
                         f"B=1, {geo} T={MAX_LEN}, f32, causal",
                         headers=("hccs_common.cuh",)),
            dict(kernel_entry("paged_quant_scatter_kv", "kv_quant.cu",
                              "src/repro/models/attention.py:178",
                              fold_launches, fold_t,
                              f"{FOLD_ROWS[-1]} bf16 rows, K and V in one "
                              f"launch, Hkv={HKV} bs={BS} d={D}, int8 pools "
                              f"(XLA in the JAX package, no Pallas kernel)",
                              headers=("hccs_common.cuh",),
                              kernels_per_call=fold_per_call),
                 slice_launches=slice_launches["paged_quant_scatter_kv"],
                 shapes={what: {k: tm[k] for k in (
                     "ms", "device_ms", "cold_ms", "plain_ms", "bound_ms",
                     "bound_by")} for what, tm in fold_t["timing"].items()}),
            kernel_entry("ssd_packed_scan", "ssd_packed.cu",
                         "none (the JAX package serves no SSM on its paged "
                         "engine)", hybrid["launches"],
                         hybrid["scan"]["cell"],
                         f"{HYB_ARCH}: {HYB_CELL['slots']} slots, "
                         f"{HYB_CELL['decode']} one-token and "
                         f"{HYB_CELL['chunks']} x {HYB_CELL['chunk']}-token "
                         f"segments, width {HYB_CELL['width']}, bf16",
                         kernels_per_call=hybrid["kernels_per_call"])
        ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
