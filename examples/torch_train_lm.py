"""Train a decoder LM with HCCS attention end to end on the synthetic stream,
with checkpointing, resume and the fault-tolerance loop, on the PyTorch port.

Defaults are small; --big selects a ~100M-parameter model (12L x 768 + 32k
vocab). Checkpoints are in the JAX package's layout, but the default
directory is the port's own, so the two scripts do not resume each other's
runs.

    python examples/torch_train_lm.py [--steps 150] [--big]   # on the card
    python examples/torch_train_lm.py --device cpu
"""
import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.configs.base import ModelConfig, TrainConfig  # noqa: E402
from repro_torch.data import LMStream, LMStreamConfig  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.train import (make_train_state,  # noqa: E402
                               make_train_step, train_loop)


def model_config(big: bool):
    """(cfg, batch, seq): the ~100M model or the small demo."""
    if big:     # ~100M params (12L x 768 + 32k vocab)
        cfg = ModelConfig(name="lm-100m", family="dense", num_layers=12,
                          d_model=768, num_heads=12, num_kv_heads=4,
                          d_ff=3072, vocab_size=32768, vocab_pad_multiple=1,
                          attention_prob="hccs")
        return cfg, 8, 512
    cfg = ModelConfig(name="lm-demo", family="dense", num_layers=4,
                      d_model=192, num_heads=6, num_kv_heads=2, d_ff=768,
                      vocab_size=2048, vocab_pad_multiple=1,
                      attention_prob="hccs")
    return cfg, 8, 128


def train_config(steps: int, grad_compression: str) -> TrainConfig:
    return TrainConfig(total_steps=steps, warmup_steps=steps // 10,
                       learning_rate=1e-3, grad_compression=grad_compression)


def train(cfg, tcfg, batch, seq, *, steps=None, ckpt_dir=None, state=None,
          device=None, log_fn=print):
    """train_loop over the LM stream up to step `steps` (default
    tcfg.total_steps; checkpoints every 50 steps, resume from ckpt_dir's
    latest, SIGTERM/SIGINT save and stop); a fresh state from seed 0 unless
    one is given. Returns (state, history)."""
    device = resolve_device(device)
    state = state or make_train_state(0, cfg, tcfg, device=device)
    step = make_train_step(cfg, tcfg)
    stream = LMStream(LMStreamConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                     global_batch=batch))
    return train_loop(
        state, step,
        lambda s: {k: torch.from_numpy(v).to(device)
                   for k, v in stream.batch_at(s).items()},
        total_steps=steps or tcfg.total_steps, ckpt_dir=ckpt_dir,
        ckpt_every=50, cfg=cfg, log_every=10, log_fn=log_fn,
        install_signal_handlers=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--ckpt-dir", default="/tmp/repro_torch_train_lm")
    ap.add_argument("--grad-compression", default="int8",
                    choices=["none", "int8"])
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg, batch, seq = model_config(args.big)
    n_params = (cfg.num_layers * (4 * cfg.d_model * cfg.d_model // 1 +
                                  3 * cfg.d_model * cfg.d_ff) +
                cfg.vocab_size * cfg.d_model)
    print(f"model ~{n_params/1e6:.0f}M params, HCCS attention "
          f"(mode={cfg.hccs_mode}), grad compression={args.grad_compression}")

    tcfg = train_config(args.steps, args.grad_compression)
    state, hist = train(cfg, tcfg, batch, seq, ckpt_dir=args.ckpt_dir,
                        device=device)

    losses = [h["loss"] for h in hist]
    print(f"\nloss: start {losses[0]:.3f} -> end {losses[-1]:.3f} "
          f"({len(losses)} steps). Checkpoints in {args.ckpt_dir}; rerun this "
          "script to resume from the latest checkpoint.")
    assert losses[-1] < losses[0], \
        "loss should decrease on the planted bigrams"
    return state, hist


if __name__ == "__main__":
    main()
