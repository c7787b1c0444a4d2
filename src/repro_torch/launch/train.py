"""Training launcher — the port of `repro/launch/train.py`: trains an LM on
the synthetic token stream on one device.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --steps 200 --batch 8 --seq 256              # the full config, CUDA
    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --device cpu --steps 20 --batch 4 --seq 32

--reduced uses the smoke-scale config; without it the full config is used.
The JAX launcher's TPU overlap flags have no counterpart. The device is
CUDA unless --device names another; without a card the launcher raises.
Embedding-input models (the audio / VLM stubs) train on seeded random
embeddings (`make_embedding_batch`, seed 1000 + step), as in the JAX
launcher. A classification model (the BERT encoders, `cls_loss`) is
refused: the JAX launcher feeds it the LM stream, which carries no
`cls_labels`, so it cannot train one either.
"""
from __future__ import annotations

import argparse


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--prob", default=None, choices=[None, "hccs", "softmax"])
    ap.add_argument("--grad-compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--data", default="data")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' runs the plain "
                         "PyTorch versions of the kernels)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch.configs import get_config, reduced_config
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data import LMStream, LMStreamConfig, \
        make_embedding_batch
    from repro_torch.device import resolve_device
    from repro_torch.train import make_train_state, make_train_step, \
        train_loop

    device = resolve_device(args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.num_classes:
        ap.error(f"{args.arch} is a classification model: the launcher "
                 f"trains on the LM stream, which has no cls_labels")
    if args.prob and cfg.num_heads:
        cfg = cfg.replace(attention_prob=args.prob)
    tcfg = TrainConfig(total_steps=args.steps, learning_rate=args.lr,
                       warmup_steps=max(args.steps // 10, 1),
                       grad_compression=args.grad_compression)

    state = make_train_state(tcfg.seed, cfg, tcfg, device=device)
    step = make_train_step(cfg, tcfg)
    if cfg.input_mode == "embeddings":
        def batch_np(s):
            return make_embedding_batch(np.random.default_rng(1000 + s),
                                        args.batch, args.seq, cfg.d_model,
                                        cfg.vocab_size)
    else:
        stream = LMStream(LMStreamConfig(vocab_size=cfg.vocab_size,
                                         seq_len=args.seq,
                                         global_batch=args.batch,
                                         seed=tcfg.seed))
        batch_np = stream.batch_at

    def batch_fn(s):
        return {k: torch.from_numpy(v).to(device)
                for k, v in batch_np(s).items()}

    state, history = train_loop(
        state, step, batch_fn, total_steps=args.steps,
        ckpt_dir=args.ckpt_dir, cfg=cfg, log_every=10,
        install_signal_handlers=True)
    print(f"final loss {history[-1]['loss']:.4f} "
          f"(start {history[0]['loss']:.4f}) over {len(history)} steps")
    return state, history


if __name__ == "__main__":
    main()
