"""Quickstart on the PyTorch port: the paper in miniature.

1. train a tiny BERT-style encoder with float softmax attention;
2. capture per-head attention logits and grid-search HCCS calibration (the
   grid runs through the `hccs_rows` kernel on the card);
3. swap in HCCS directly (no retrain) — accuracy drops;
4. quantization-aware retrain with frozen theta — accuracy recovers.

    python examples/torch_quickstart.py                # on the card
    python examples/torch_quickstart.py --device cpu   # a few minutes
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.core.calibrate import (calibrate_heads,  # noqa: E402
                                        collect_attention_logits)
from repro_torch.data import ClsTask, ClsTaskConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.models import blocks  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models.attention import capture_attention_logits  # noqa
from repro_torch.models.layers import embed_tokens  # noqa: E402
from repro_torch.train import make_train_state, make_train_step  # noqa: E402

SEQ, BATCH, STEPS = 48, 32, 80

cfg_float = ModelConfig(
    name="quickstart-encoder", family="encoder", num_layers=2, d_model=96,
    num_heads=3, num_kv_heads=3, d_ff=256, vocab_size=2048,
    vocab_pad_multiple=1, activation="gelu", norm="layernorm",
    rope="learned", causal=False, num_classes=2, max_position=SEQ,
    attention_prob="softmax", attention_impl="dense", tie_embeddings=False)

task = ClsTask(ClsTaskConfig(vocab_size=2048, seq_len=SEQ, num_classes=2))


def to_device(batch, device):
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def train(cfg, steps, state=None, lr=3e-4, seed=0, *, task=task,
          batch=BATCH, device=None):
    """`steps` cls_loss steps on task.batch_at(s, batch); a fresh state from
    `seed` unless one is given. Returns (state, per-step losses)."""
    device = resolve_device(device)
    tcfg = TrainConfig(total_steps=steps, warmup_steps=8, learning_rate=lr)
    state = state or make_train_state(seed, cfg, tcfg, device=device)
    step = make_train_step(cfg, tcfg, loss_fn=M.cls_loss)
    losses = []
    for s in range(steps):
        state, m = step(state, to_device(task.batch_at(s, batch), device))
        losses.append(float(m["loss"]))
    return state, losses


def accuracy(params, cfg, *, task=task, batches=6, batch=64, device=None):
    """Mean accuracy over `batches` validation batches from step 9000."""
    device = resolve_device(device)
    accs = []
    with torch.no_grad():
        for s in range(batches):
            b = to_device(task.batch_at(9000 + s, batch, split="val"),
                          device)
            _, m = M.cls_loss(params["weights"], params["hccs"], b, cfg)
            accs.append(float(m["acc"]))
    return float(np.mean(accs))


def layer_slice(tree, l):
    """Layer l's params out of the stacked (L, ...) leaves."""
    return {k: layer_slice(v, l) if isinstance(v, dict) else v[l]
            for k, v in tree.items()}


def capture(weights, cfg, *, task=task, batches=2, batch=32, device=None):
    """Each layer's attention logits on `batches` batches from step 7000,
    layer by layer through apply_block: a list of (L, H, B, T, T) float32
    arrays, one a batch."""
    device = resolve_device(device)
    cap_batches = []
    with torch.no_grad():
        for s in range(batches):
            toks = torch.from_numpy(
                task.batch_at(7000 + s, batch)["tokens"]).to(device)
            x = embed_tokens(weights["embed"], toks, cfg)
            pos = torch.arange(toks.shape[1], device=device)[None].expand(
                toks.shape)
            x = x + weights["pos_embed"][pos]
            per_layer = []
            for l in range(cfg.num_layers):
                lp = layer_slice(weights["layers"], l)
                with capture_attention_logits() as cap:
                    x, _, _ = blocks.apply_block(lp, x, cfg, positions=pos)
                per_layer.append(cap[0].cpu().numpy())
            cap_batches.append(np.moveaxis(np.stack(per_layer), 2, 1))
    return cap_batches


def calibrate(cap_batches, n, *, max_rows_per_head=64, device=None):
    """Per-head calibration of the captured rows: (theta, kl, scales)."""
    rows = collect_attention_logits(cap_batches,
                                    max_rows_per_head=max_rows_per_head)
    scales = np.abs(rows).max(axis=(2, 3)) / 127.0
    theta, kl = calibrate_heads(rows, scales, n, granularity="per_head",
                                device=device)
    return theta, kl, scales


def hccs_params(weights, theta, scales, device=None):
    """The float model's weights with the calibrated theta and scales."""
    hccs = {"B": theta.B, "S": theta.S, "D": theta.D,
            "scale": torch.tensor(scales, dtype=torch.float32,
                                  device=resolve_device(device))}
    return {"weights": weights, "hccs": hccs}


def run(cfg=cfg_float, *, task=task, steps=STEPS, batch=BATCH, device=None,
        log=print):
    """The four stages; returns the accuracies, theta and the losses."""
    device = resolve_device(device)
    n = task.cfg.seq_len
    log("[1/4] training float32 baseline ...")
    state, float_losses = train(cfg, steps, task=task, batch=batch,
                                device=device)
    acc_base = accuracy(state["params"], cfg, task=task, device=device)
    log(f"      baseline accuracy: {acc_base:.3f}")

    log("[2/4] calibrating HCCS per head (grid search over (B, S, D)) ...")
    w = state["params"]["weights"]
    theta, kl, scales = calibrate(
        capture(w, cfg, task=task, device=device), n, device=device)
    log(f"      mean calibration KL: {kl.mean():.3f} "
        f"(paper reports ~0.1-0.3)")

    log("[3/4] direct HCCS substitution (no retrain) ...")
    cfg_hccs = cfg.replace(attention_prob="hccs", hccs_mode="i16_div")
    params_h = hccs_params(w, theta, scales, device)
    acc_nr = accuracy(params_h, cfg_hccs, task=task, device=device)
    log(f"      no-retrain accuracy: {acc_nr:.3f} "
        f"(drop {acc_base - acc_nr:+.3f})")

    log("[4/4] QAT with frozen theta ...")
    state_q, qat_losses = train(cfg_hccs, steps // 2,
                                state={**state, "params": params_h},
                                lr=1e-4, task=task, batch=batch,
                                device=device)
    acc_qat = accuracy(state_q["params"], cfg_hccs, task=task,
                       device=device)
    log(f"      retrained accuracy: {acc_qat:.3f} "
        f"(delta vs baseline {acc_qat - acc_base:+.3f})")
    log("\nTable-I-style summary:")
    log(f"  baseline={acc_base:.3f}  no-retrain={acc_nr:.3f}  "
        f"retrained={acc_qat:.3f}")
    return {"acc_base": acc_base, "acc_nr": acc_nr, "acc_qat": acc_qat,
            "theta": theta, "float_losses": float_losses,
            "qat_losses": qat_losses}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
