#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (`src/repro_torch`).

    python3 chip_smoke.py                 # every phase, one CUDA card
    python3 chip_smoke.py --phases 1,2,3,6,7   # the kernel phases only

Builds the CUDA kernels from the sources in this checkout, holds every
kernel against its plain PyTorch version on the card, drives the port's
serving paths — greedy serving of granite-3-2b at full width (40 layers,
bf16 weights from a seed) through the packed and the lockstep PagedEngine,
the ContinuousEngine and the wave ServeEngine — and checks that each path
really ran its kernel. Phases, in order:

  1 device      the card's name and power limit; fails without CUDA
  2 build       nvcc build time, registers and shared memory per kernel
  3 kernel      hccs_packed_prefill against hccs_packed_prefill_ref at
                granite's shapes, every width of the engine's ladder, every
                mode / static_max / pool dtype, exact and random inputs; times
  4 forward     one packed step of granite (2 layers, f32), card against CPU
  5 engine      packed PagedEngine: granite, 40 layers, bf16, 8 requests x 32
                new tokens, twice, then once profiled
  6 kernel      hccs_paged_decode against hccs_paged_decode_ref (8 slots,
                frontiers 0-2048, f32/bf16/int8 pools); times
  7 kernel      hccs_decode against hccs_decode_ref (8 slots, frontiers
                0-2048, f32/bf16 arenas, and an arena of odd length); times
  8 lockstep    lockstep PagedEngine on phase 5's requests, twice, then
                once profiled
  9 continuous  ContinuousEngine on phase 5's requests, the same way
 10 wave        ServeEngine on 8 requests of 512 prompt tokens, the same
                way, and the packed engine on the same requests
 11 report      one JSON line per the kernel table

The last line is {"ok": true, "device": {...}}; any failed phase exits
non-zero before it. `--phases` runs a subset (for bring-up).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import build as kbuild  # noqa: E402
from repro_torch.kernels.decode import (ARENA_TILE,  # noqa: E402
                                        decode_qint, hccs_decode,
                                        hccs_decode_ref, hccs_packed_prefill,
                                        hccs_packed_prefill_ref,
                                        hccs_paged_decode,
                                        hccs_paged_decode_ref, packed_qint,
                                        paged_qint, smem_bytes)
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serve import (ContinuousEngine, ServeEngine)  # noqa: E402
from repro_torch.serve.paged import (PagedEngine, Request,  # noqa: E402
                                     pack_slot_ids, schedule_step_tokens)

HBM_BYTES_PER_S = 3.35e12        # H100 SXM, NVIDIA data sheet
F32_FLOPS = 67e12                # H100 SXM, f32 outside the tensor cores
# granite-3-2b attention geometry and the engine's smoke configuration
H, HKV, D, BS = 32, 8, 64, 32
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


def log(*a):
    print(*a, flush=True)


class PhaseFailed(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


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
    fn = ""
    for line in kbuild.build_log["ptxas"].splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "registers" in line:
            log(f"[build] {fn}: {line.split(':', 1)[-1].strip()}")
    log(f"[build] dynamic shared memory per block at granite shapes: "
        f"{smem_bytes(H // HKV, D, BS, MAX_LEN)} B (packed, paged), "
        f"{smem_bytes(H // HKV, D, ARENA_TILE, MAX_LEN)} B (arena)")


# ---------------------------------------------------------------- phase 3 --

def make_case(width: int, pool_dtype, exact: bool, seed: int):
    """Granite-shaped kernel inputs on the card: 8 slots with frontiers from
    1 to 2048 in a shuffled pool, one packed step of width `width` laid out
    by the engine's own scheduler (prefill chunks + decode lanes + pads),
    one sentinel entry inside a live frontier and sentinels past every
    frontier."""
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
    n_blocks = 1 + int(sum(-(-f // BS) for f in fronts))
    perm = rng.permutation(np.arange(1, n_blocks))
    table = np.full((MAX_BATCH, NBLK), -1, np.int32)
    c = 0
    for s, f in enumerate(fronts):
        nb = -(-f // BS)
        table[s, :nb] = perm[c:c + nb]
        c += nb
    table[3, 5] = -1                          # a sentinel inside a frontier
    shape = (n_blocks, HKV, BS, D)
    if exact:                                 # multiples of 2^-3: exact f32
        q = rng.integers(-8, 9, (width, H, D)) / 8.0
        k = rng.integers(-8, 9, shape) / 8.0
        v = rng.integers(-8, 9, shape) / 8.0
        scale = rng.uniform(0.007, 0.013, H)
    else:
        q = rng.normal(0, 1, (width, H, D))
        k = rng.normal(0, 1, shape)
        v = rng.normal(0, 1, shape)
        scale = rng.uniform(0.005, 0.02, H)
    theta = np.stack([rng.integers(120, 200, H), rng.integers(0, 2, H),
                      rng.integers(16, 100, H)], -1)     # s = B - S*d > 0
    dev = "cuda"
    ks = vs = None
    if pool_dtype == torch.int8:
        # int8 payload with per-(block, kv-head) scales; exact inputs use
        # power-of-two scales so the dequantized values stay exact
        kq = np.clip(np.round(k * 8), -127, 127)
        vq = np.clip(np.round(v * 8), -127, 127)
        sc = (np.full((n_blocks, HKV), 0.125) if exact
              else rng.uniform(0.05, 0.2, (n_blocks, HKV)))
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
    t = sid.shape[0]
    kv_rows = 0
    live_keys = 0
    for s in np.unique(sid[sid >= 0]):
        top = int(lens[sid == s].max())
        cols = np.arange(top)
        kv_rows += int((table[s, cols // BS] >= 0).sum())
    for i in np.flatnonzero(sid >= 0):
        cols = np.arange(int(lens[i]))
        live_keys += int((table[sid[i], cols // BS] >= 0).sum())
    nbytes = (2 * kv_rows * HKV * D * elem + 2 * t * H * D * 4
              + table.nbytes + 2 * t * 4)
    flops = 2.0 * 2.0 * live_keys * H * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops
            else "operations", nbytes, flops)


def phase_kernel():
    rows = []
    timings = {}
    worst = 0.0
    for width in WIDTHS:
        for pool_dtype in (torch.float32, torch.bfloat16, torch.int8):
            for exact in (True, False):
                case = make_case(width, pool_dtype, exact,
                                 seed=width * 7 + int(exact))
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
                        rows.append((width, str(pool_dtype).split(".")[-1],
                                     mode, static_max, exact, flips, n_live,
                                     max_err, err_clean))
                        pads = got[case["slot_ids"] < 0]
                        check(bool((pads == 0).all()),
                              f"pad lanes not zero at width {width}")
                        if exact:
                            check(flips == 0 and (max_err == 0.0
                                                  or rel <= 1e-6),
                                  f"exact case differs: width {width} "
                                  f"{pool_dtype} {mode} static={static_max}"
                                  f" flips={flips} max_err={max_err}")
                        else:
                            check(flips <= RANDOM_FLIP_FRACTION * n_live,
                                  f"{flips} bin flips of {n_live} at width "
                                  f"{width} {pool_dtype} {mode}")
                            check(err_clean <= RANDOM_MAX_ERR_NO_FLIP,
                                  f"max |d| {err_clean} on rows without "
                                  f"flips, width {width} {pool_dtype} {mode}")
                        if (pool_dtype == torch.float32 and mode == "wide"
                                and not static_max and not exact):
                            ms = cuda_time_ms(
                                lambda: hccs_packed_prefill(**case, **kw))
                            plain = cuda_time_ms(
                                lambda: hccs_packed_prefill_ref(**case, **kw),
                                iters=5)
                            bound, by, nbytes, flops = bound_of(case)
                            timings[width] = dict(
                                ms=ms, plain_ms=plain, bound_ms=bound,
                                bound_by=by, bytes=nbytes, flops=flops,
                                max_abs_err=max_err)
    log("[kernel] width pool mode static exact flips/live max|d| "
        "max|d|(rows w/o flips)")
    for r in rows:
        log(f"[kernel] {r[0]:4d} {r[1]:8s} {r[2]:7s} {int(r[3])} {int(r[4])} "
            f"{r[5]}/{r[6]} {r[7]:.3e} {r[8]:.3e}")
    for w, tm in timings.items():
        log(f"[kernel] timing width {w}: kernel {tm['ms']:.4f} ms, plain "
            f"{tm['plain_ms']:.4f} ms, bound {tm['bound_ms']:.4f} ms "
            f"({tm['bound_by']}: {tm['bytes'] / 1e6:.2f} MB, "
            f"{tm['flops'] / 1e9:.3f} GFLOP)")
    return timings, worst


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

def profile_summary(prof, wall: float, kernel: str = "hccs_packed_kernel",
                    tag: str = "profile"):
    """Device time of a profiled run by kernel (torch.profiler's CUDA
    events): the HCCS kernel's total, the top kernels, and the share of the
    wall time with no kernel on the card."""
    kern = [e for e in prof.events() if str(e.device_type).endswith("CUDA")]
    if not kern:
        log(f"[{tag}] no device events recorded: device times not measured")
        return
    by_name: dict[str, float] = {}
    spans = []
    for e in kern:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):                  # union of kernel intervals
        if b > end:
            busy += b - max(a, end)
            end = b
    total = sum(by_name.values())
    hccs = sum(t for n, t in by_name.items() if kernel in n)
    log(f"[{tag}] wall {wall * 1e3:.1f} ms, device busy {busy / 1e3:.1f} ms"
        f" (idle share {1 - busy / 1e6 / wall:.3f}), kernel time "
        f"{total / 1e3:.1f} ms over {len(kern)} device events; "
        f"{kernel} {hccs / 1e3:.1f} ms ({hccs / total:.3f})")
    for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
        log(f"[{tag}]   {t / 1e3:9.2f} ms  {t / total:.3f}  {name[:90]}")
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
    runs = []
    for rep in range(3):
        eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          block_size=BS, device="cuda")
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
        if prof is not None:
            profile_summary(prof, wall)
        launches = hccs_packed_prefill.launches
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
    return runs[0][1], runs[0][0]


# ----------------------------------------------------------- phases 6, 7 --

# 8 slots with frontiers 0-2048 (one empty row), as a decode step sees them
DECODE_FRONTS = (2048, 1024, 777, 1500, 33, 0, 511, 1)


def kv_values(rng, q_shape, kv_shape, exact: bool):
    """q, k, v, per-head scales and theta. Exact inputs are multiples of
    2^-3 (every dot product and s*v sum is exact in f32, in any order)."""
    if exact:
        q = rng.integers(-8, 9, q_shape) / 8.0
        k = rng.integers(-8, 9, kv_shape) / 8.0
        v = rng.integers(-8, 9, kv_shape) / 8.0
        scale = rng.uniform(0.007, 0.013, H)
    else:
        q = rng.normal(0, 1, q_shape)
        k = rng.normal(0, 1, kv_shape)
        v = rng.normal(0, 1, kv_shape)
        scale = rng.uniform(0.005, 0.02, H)
    theta = np.stack([rng.integers(120, 200, H), rng.integers(0, 2, H),
                      rng.integers(16, 100, H)], -1)     # s = B - S*d > 0
    dev = "cuda"
    return (torch.tensor(q, dtype=torch.float32, device=dev), k, v,
            torch.tensor(scale, dtype=torch.float32, device=dev),
            torch.tensor(theta, dtype=torch.int32, device=dev))


def decode_case(kind: str, kv_dtype, exact: bool, seed: int,
                fronts=DECODE_FRONTS, tmax: int = MAX_LEN):
    """Kernel inputs of one decode step at granite's shapes: a paged pool
    (shuffled blocks, a sentinel inside a frontier, sentinels past every
    frontier, unowned blocks) or a (B, Hkv, tmax, d) arena whose rows past
    each frontier hold stale values."""
    rng = np.random.default_rng(seed)
    b = len(fronts)
    lengths = torch.tensor(fronts, dtype=torch.int32, device="cuda")
    if kind == "arena":
        q, k, v, scale, theta = kv_values(rng, (b, H, D), (b, HKV, tmax, D),
                                          exact)
        to = (lambda a: torch.tensor(a, dtype=torch.float32,
                                     device="cuda").to(kv_dtype))
        return dict(q=q, k=to(k), v=to(v), lengths=lengths, scale=scale,
                    theta=theta)
    n_blocks = 1 + int(sum(-(-f // BS) for f in fronts)) + 4
    q, k, v, scale, theta = kv_values(rng, (b, H, D), (n_blocks, HKV, BS, D),
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
        sc = (np.full((n_blocks, HKV), 0.125) if exact
              else rng.uniform(0.05, 0.2, (n_blocks, HKV)))
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
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / F32_FLOPS * 1e3
    return (max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops
            else "operations", nbytes, flops)


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
        shapes = [(DECODE_FRONTS, MAX_LEN)]
    else:
        fn, ref, tag = hccs_decode, hccs_decode_ref, "arena"
        dtypes = (torch.float32, torch.bfloat16)
        qint = (lambda c: decode_qint(c["q"], c["k"], c["lengths"],
                                      c["scale"]))
        # the engine's arena (2048 rows) and one whose length is no
        # multiple of the kernel's tile, filled to its last row
        shapes = [(DECODE_FRONTS, MAX_LEN),
                  ((MAX_LEN - 1,) + DECODE_FRONTS[1:], MAX_LEN - 1)]
    rows, timing, worst = [], None, 0.0
    for fronts, tmax in shapes:
        for kv_dtype in (dtypes if tmax == MAX_LEN else (torch.float32,)):
            for exact in (True, False):
                case = decode_case(kind, kv_dtype, exact,
                                   seed=tmax + 11 * len(rows) + int(exact),
                                   fronts=fronts, tmax=tmax)
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
                        rows.append((tmax, str(kv_dtype).split(".")[-1],
                                     mode, static_max, exact, flips, n_live,
                                     max_err, err_clean))
                        empty = [i for i in range(b) if fronts[i] == 0]
                        check(bool((got[empty] == 0).all()),
                              f"{tag}: a row of length 0 is not zero")
                        what = (f"{tag} tmax {tmax} {kv_dtype} {mode} "
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
                        if (tmax == MAX_LEN and kv_dtype == torch.float32
                                and mode == "wide" and not static_max
                                and not exact):
                            ms = cuda_time_ms(lambda: fn(**case, **kw))
                            plain = cuda_time_ms(lambda: ref(**case, **kw),
                                                 iters=5)
                            bound, by, nbytes, flops = decode_bound(kind,
                                                                    case)
                            timing = dict(ms=ms, plain_ms=plain,
                                          bound_ms=bound, bound_by=by,
                                          bytes=nbytes, flops=flops)
    log(f"[{tag}] tmax kv mode static exact flips/live max|d| "
        f"max|d|(rows w/o flips)")
    for r in rows:
        log(f"[{tag}] {r[0]:4d} {r[1]:8s} {r[2]:7s} {int(r[3])} {int(r[4])} "
            f"{r[5]}/{r[6]} {r[7]:.3e} {r[8]:.3e}")
    log(f"[{tag}] timing B=8: kernel {timing['ms']:.4f} ms, plain "
        f"{timing['plain_ms']:.4f} ms, bound {timing['bound_ms']:.4f} ms "
        f"({timing['bound_by']}: {timing['bytes'] / 1e6:.2f} MB, "
        f"{timing['flops'] / 1e9:.3f} GFLOP)")
    timing["max_abs_err"] = worst
    return timing


# ------------------------------------------------------- phases 8, 9, 10 --

KERNELS = (hccs_packed_prefill, hccs_paged_decode, hccs_decode)
# each wrapper's kernel, as the profiler names it
KERNEL_SYMBOLS = {"hccs_packed_prefill": "hccs_packed_kernel",
                  "hccs_paged_decode": "hccs_paged_kernel",
                  "hccs_decode": "hccs_arena_kernel"}


def agreement(toks, ref) -> tuple[int, int]:
    """Tokens equal at the same (request, position), of all tokens."""
    same = sum(int(a == b) for uid in ref
               for a, b in zip(toks[uid], ref[uid]))
    return same, sum(len(t) for t in ref.values())


def phase_engine_path(label: str, make, prompts, kernel, steps_of,
                      reference=None):
    """Drive one serving path three times on the same requests (32 new
    tokens each), the third under torch.profiler: every request done,
    identical tokens in every run, and the path's kernel launched 40 times
    per decode step (once per layer) and the other kernels never. Returns
    (tokens, launches)."""
    runs = []
    for rep in range(3):
        eng = make()
        for i, p in enumerate(prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32))
        torch.cuda.synchronize()
        for k in KERNELS:                      # count the path's run only
            k.launches = 0
        ctx = (torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) if rep == 2
            else contextlib.nullcontext())
        with ctx as prof:
            t0 = time.perf_counter()
            done = eng.run()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        if prof is not None:
            profile_summary(prof, wall, KERNEL_SYMBOLS[kernel.__name__],
                            f"{label} profile")
        launches = kernel.launches
        others = {k.__name__: k.launches for k in KERNELS if k is not kernel}
        steps = steps_of(eng)
        toks = {r.uid: list(r.out_tokens) for r in done}
        n_new = sum(len(t) for t in toks.values())
        n_prompt = sum(len(p) for p in prompts)
        log(f"[{label}] run {rep}{' (profiled)' if rep == 2 else ''}: "
            f"{getattr(eng, 'occupancy_steps', steps)} steps "
            f"({steps} decode steps), {kernel.__name__} launches "
            f"{launches}, other kernels {others}; {n_new} tokens "
            f"({n_prompt} prompt) in {wall:.3f}s = {n_new / wall:.1f} new "
            f"tok/s, {(n_new + n_prompt) / wall:.1f} tok/s incl. prefill")
        check(len(done) == len(prompts) and all(
            len(t) == 32 for t in toks.values()),
            f"{label}: not every request done")
        check(launches > 0 and launches == M_LAYERS * steps,
              f"{label}: {kernel.__name__} launches {launches} != "
              f"{M_LAYERS} x {steps} decode steps")
        check(not any(others.values()), f"{label}: other kernels ran "
              f"{others}")
        for t in toks.values():
            check(all(0 <= x < VOCAB for x in t), f"{label}: token off "
                  f"vocab")
        runs.append((toks, launches))
    check(runs[0][0] == runs[1][0] == runs[2][0],
          f"{label}: the runs disagree")
    if reference is not None:
        same, total = agreement(runs[0][0], reference)
        log(f"[{label}] tokens equal to the packed engine's: {same}/{total}")
    return runs[0]


M_LAYERS, VOCAB = 40, 49155       # granite-3-2b (checked in phase_paths)


def phase_paths(packed_tokens, phases):
    """Phases 8-10: the lockstep PagedEngine, the ContinuousEngine and the
    wave ServeEngine on granite at full width. Returns the kernels' launch
    counts {kernel name: launches} summed over the paths that ran."""
    cfg, params = engine_model()
    check(cfg.num_layers == M_LAYERS and cfg.vocab_size == VOCAB,
          "granite-3-2b geometry changed")
    arena_cfg = cfg.replace(cache_layout="slot")
    prompts = smoke_prompts(cfg)
    launches = {}
    if 8 in phases:
        _, n = phase_engine_path(
            "lockstep", lambda: PagedEngine(
                params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                block_size=BS, packed=False, device="cuda"),
            prompts, hccs_paged_decode, lambda e: e.decode_steps,
            packed_tokens)
        launches["hccs_paged_decode"] = n
    if 9 in phases:
        _, n = phase_engine_path(
            "continuous", lambda: ContinuousEngine(
                params, arena_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                device="cuda"),
            prompts, hccs_decode, lambda e: e.occupancy_steps, packed_tokens)
        launches["hccs_decode"] = n
    if 10 in phases:
        # one prompt length, so the 8 requests form one wave; its prefill
        # attends over the 2048-row arena, which takes the blockwise path
        rng = np.random.default_rng(1)
        wave_prompts = [rng.integers(0, cfg.vocab_size, 512).astype(np.int32)
                        for _ in range(MAX_BATCH)]
        eng = PagedEngine(params, cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                          block_size=BS, device="cuda")
        for i, p in enumerate(wave_prompts):
            eng.submit(Request(uid=i, prompt=p.copy(), max_new_tokens=32))
        packed_wave = {r.uid: list(r.out_tokens) for r in eng.run()}
        _, n = phase_engine_path(
            "wave", lambda: ServeEngine(
                params, arena_cfg, max_batch=MAX_BATCH, max_len=MAX_LEN,
                device="cuda"),
            wave_prompts, hccs_decode, lambda e: e.decode_steps, packed_wave)
        launches["hccs_decode"] = launches.get("hccs_decode", 0) + n
    return launches


def kernel_entry(name, source, replaces, launches, tm, shape):
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": tm["max_abs_err"], "ms": tm["ms"],
            "kernel_ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": None, "shape": shape}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11",
                    help="comma-separated subset of phases to run")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    phase_device()
    if 2 in phases:
        phase_build()
    timings, worst = ({}, None)
    if 3 in phases:
        timings, worst = phase_kernel()
    if 4 in phases:
        phase_forward()
    launches, packed_tokens = None, None
    if 5 in phases:
        launches, packed_tokens = phase_engine()
    decode_timings = {}
    if 6 in phases:
        decode_timings["paged"] = phase_decode_kernel("paged")
    if 7 in phases:
        decode_timings["arena"] = phase_decode_kernel("arena")
    path_launches = {}
    if phases & {8, 9, 10}:
        path_launches = phase_paths(packed_tokens, phases)
    if 11 in phases:
        check(launches and timings and len(decode_timings) == 2
              and len(path_launches) == 2,
              "phase 11 needs phases 3 and 5 to 10")
        tm = dict(timings[max(timings)], max_abs_err=worst)
        geo = f"granite H={H} Hkv={HKV} d={D}"
        log(json.dumps({"kernels": [
            kernel_entry("hccs_packed_prefill", "hccs_packed.cu",
                         "src/repro/kernels/decode.py:400", launches, tm,
                         f"width {max(timings)}, {geo} bs={BS}, f32 pool, "
                         f"mode wide"),
            kernel_entry("hccs_paged_decode", "hccs_paged.cu",
                         "src/repro/kernels/decode.py:316",
                         path_launches["hccs_paged_decode"],
                         decode_timings["paged"],
                         f"B=8, {geo} bs={BS}, f32 pool, mode wide"),
            kernel_entry("hccs_decode", "hccs_arena.cu",
                         "src/repro/kernels/decode.py:254",
                         path_launches["hccs_decode"],
                         decode_timings["arena"],
                         f"B=8, {geo} Tmax={MAX_LEN}, f32 arena, mode "
                         f"wide")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    except PhaseFailed as e:
        print(f"FAILED: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
