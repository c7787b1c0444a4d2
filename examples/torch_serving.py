"""End-to-end demo (the paper is an inference paper) on the PyTorch port:
serve a small LM with batched requests through the continuous-batching slot
engine, HCCS integer attention end to end, and compare against the wave
scheduler.

Trains a small model briefly first (so generations aren't pure noise), then
serves a mixed queue of requests and reports throughput for the wave, the
continuous and the paged engine, and finally drives a multi-turn CHAT
SESSION through the paged engine with decode-block sharing: follow-up turns
prefix-match the prior turns' KV — prompt and generated tokens alike —
instead of re-prefilling the conversation.

    python examples/torch_serving.py                # on the card
    python examples/torch_serving.py --device cpu
"""
import argparse
import copy
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.data import LMStream, LMStreamConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.serve import (ContinuousEngine, PagedEngine,  # noqa: E402
                               Request, ServeEngine)
from repro_torch.train import (make_train_state,  # noqa: E402
                               make_train_step, train_loop)

VOCAB, SEQ = 512, 64

cfg = ModelConfig(
    name="serve-demo", family="dense", num_layers=4, d_model=128,
    num_heads=4, num_kv_heads=2, d_ff=512, vocab_size=VOCAB,
    vocab_pad_multiple=1, attention_prob="hccs", hccs_mode="i16_div",
    attention_impl="dense")


def pretrain(cfg, steps=60, *, state=None, device=None, log_fn=print):
    """A short LM pre-train on the planted bigrams; a fresh state from seed 0
    unless one is given. Returns (state, history)."""
    device = resolve_device(device)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=6, learning_rate=3e-3)
    state = state or make_train_state(0, cfg, tcfg, device=device)
    step = make_train_step(cfg, tcfg)
    stream = LMStream(LMStreamConfig(vocab_size=VOCAB, seq_len=SEQ,
                                     global_batch=8))
    return train_loop(
        state, step, lambda s: {k: torch.from_numpy(v).to(device)
                                for k, v in stream.batch_at(s).items()},
        total_steps=steps, log_every=20, log_fn=log_fn)


def mixed_queue(rng, n=16):
    """Mixed prompt lengths and budgets; odd uids sample at temperature 0.7."""
    reqs = []
    for i in range(n):
        plen = int(rng.choice([6, 8, 12, 16, 24]))     # mixed lengths
        reqs.append(Request(uid=i,
                            prompt=rng.integers(0, VOCAB, plen).astype(
                                np.int32),
                            max_new_tokens=int(rng.choice([8, 16, 24])),
                            temperature=0.7 if i % 2 else 0.0))
    return reqs


def engines(params, cfg, device=None):
    """The three engines of the comparison, by name."""
    return [
        ("wave", ServeEngine(params, cfg, max_batch=8, max_len=128,
                             device=device)),
        ("continuous", ContinuousEngine(params, cfg, max_batch=8,
                                        max_len=128, device=device)),
        ("paged", PagedEngine(params, cfg, max_batch=8, max_len=128,
                              block_size=16, device=device)),
    ]


def serve_queue(params, cfg, reqs, *, device=None, log=print):
    """Each engine serves the queue twice, warm then timed. Returns
    {name: (finished requests of the timed pass, tokens, seconds)}."""
    # all engines use the STE decode path so the comparison isolates the
    # SCHEDULER; cfg.replace(decode_kernel="fused") switches decode
    # attention to the hand-written kernels. The paged engine serves the
    # same queue from a block pool half the size of the continuous
    # engine's slot arena (see serve/paged.py).
    out = {}
    for name, eng in engines(params, cfg, resolve_device(device)):
        # warm the SAME engine instance first so the timed pass measures
        # scheduling, not first-call allocation
        for r in copy.deepcopy(reqs):
            eng.submit(r)
        eng.run()
        work = copy.deepcopy(reqs)
        for r in work:
            eng.submit(r)
        t0 = time.perf_counter()
        done = eng.run()
        dt = time.perf_counter() - t0
        tokens = sum(len(r.out_tokens) for r in done)
        log(f"{name:>11}: served {len(done)} requests / {tokens} tokens "
            f"in {dt:.2f}s ({tokens / dt:.1f} tok/s)")
        out[name] = (done, tokens, dt)
    return out


def chat(params, cfg, rng, *, turns=3, sessions=2, device=None, log=print):
    """Multi-turn sessions on the paged engine with decode-block sharing.
    Returns ({uid: tokens}, prefix_stats())."""
    # submit(..., session=) prepends the stored history to each turn's
    # message; decode_sharing caches generated blocks as they fill, so
    # follow-up turns skip the prefill for everything already in the
    # conversation
    eng = PagedEngine(params, cfg, max_batch=4, max_len=256, block_size=16,
                      decode_sharing=True, device=resolve_device(device))
    out = {}
    for turn in range(turns):
        for s in range(sessions):
            eng.submit(Request(uid=10 * s + turn,
                               prompt=rng.integers(0, VOCAB, 24).astype(
                                   np.int32),
                               max_new_tokens=12),
                       session=f"user-{s}")
        for r in sorted(eng.run(), key=lambda r: r.uid):
            log(f"  turn {turn}, session user-{r.uid // 10}: "
                f"-> {r.out_tokens[:8]}...")
            out[r.uid] = list(r.out_tokens)
    return out, eng.prefix_stats()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    print("[1/3] quick pre-train so generations follow the planted "
          "bigrams ...")
    state, hist = pretrain(cfg, device=device)

    print("[2/3] serving a mixed-length queue (HCCS i16+div attention) ...")
    rng = np.random.default_rng(0)
    reqs = mixed_queue(rng)
    served = serve_queue(state["params"], cfg, reqs, device=device)
    done = served["paged"][0]
    sample = min(done, key=lambda r: r.uid)
    print(f"sample request {sample.uid}: prompt={sample.prompt[:6].tolist()}"
          f"... -> {sample.out_tokens[:12]}...")

    print("[3/3] multi-turn chat sessions (paged + decode-block sharing) ...")
    _, stats = chat(state["params"], cfg, rng, device=device)
    print(f"decode-block sharing: {stats['decode_hits']} decode-block hits, "
          f"{100 * stats['followup_skip_rate']:.0f}% of follow-up-turn "
          f"prefill tokens skipped, {stats['cached_decode_blocks']} "
          f"generated blocks cached")
    return {"state": state, "history": hist, "served": served,
            "prefix_stats": stats}


if __name__ == "__main__":
    main()
