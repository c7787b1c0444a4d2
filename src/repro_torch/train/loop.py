"""Fault-tolerant training loop — the port of `repro/train/loop.py`.

  * checkpoint cadence + async save, atomic LATEST pointer;
  * resume-from-latest on (re)start — the data pipeline is stateless in
    (seed, step), so restarts are exactly repeatable;
  * preemption handling: SIGTERM/SIGINT trigger a final synchronous save;
  * straggler/step-time monitor: EWMA + k-sigma flagging, logged with the
    step index;
  * NaN-loss circuit breaker: aborts and leaves the last good checkpoint.

`float(metrics["loss"])` is the step's one host sync.
"""
from __future__ import annotations

import signal
import time
from dataclasses import dataclass, field

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager


@dataclass
class StepTimeMonitor:
    alpha: float = 0.1
    k_sigma: float = 3.0
    mean: float = 0.0
    var: float = 0.0
    n: int = 0
    stragglers: list = field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self.n += 1
        if self.n <= 3:  # warmup: first steps (allocation, builds) are outliers
            self.mean = dt
            self.var = 0.0
            return False
        slow = (self.var > 0 and
                dt > self.mean + self.k_sigma * np.sqrt(self.var) + 1e-4)
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        if slow:
            self.stragglers.append((step, dt))
        return slow


def train_loop(state, train_step, batch_fn, *, total_steps: int,
               ckpt_dir: str | None = None, ckpt_every: int = 50,
               cfg=None, log_every: int = 10, log_fn=print,
               install_signal_handlers: bool = False):
    """Run (or resume) training. batch_fn(step) -> device-ready batch.

    Returns (state, history). Restartable: if ckpt_dir holds a checkpoint the
    loop resumes from it (including the optimizer step), and a preemption
    signal causes a final blocking save before returning.
    """
    mgr = CheckpointManager(ckpt_dir) if ckpt_dir else None
    start_step = 0
    if mgr is not None and mgr.latest_step() is not None:
        restored, manifest = mgr.restore(state, cfg=cfg)
        state = restored
        start_step = manifest["step"]
        log_fn(f"[resume] restored step {start_step} from {ckpt_dir}")

    preempted = {"flag": False}

    def _handler(signum, frame):
        preempted["flag"] = True
        log_fn(f"[preempt] signal {signum} received; will checkpoint and exit")

    old_handlers = {}
    if install_signal_handlers:
        for sig in (signal.SIGTERM, signal.SIGINT):
            old_handlers[sig] = signal.signal(sig, _handler)

    monitor = StepTimeMonitor()
    history = []
    step = start_step
    try:
        for step in range(start_step, total_steps):
            t0 = time.perf_counter()
            batch = batch_fn(step)
            state, metrics = train_step(state, batch)
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if monitor.observe(step, dt):
                log_fn(f"[straggler] step {step} took {dt*1e3:.1f}ms "
                       f"(mean {monitor.mean*1e3:.1f}ms)")
            history.append({"step": step, "loss": loss, "dt": dt})
            if not np.isfinite(loss):
                log_fn(f"[abort] non-finite loss at step {step}")
                break
            if log_every and step % log_every == 0:
                log_fn(f"step {step:5d} loss {loss:.4f} "
                       f"({dt*1e3:.1f} ms/step)")
            if mgr is not None and (step + 1) % ckpt_every == 0:
                mgr.save_async(step + 1, state, cfg=cfg)
            if preempted["flag"]:
                break
    finally:
        if mgr is not None:
            mgr.wait()
            mgr.save(step + 1, state, cfg=cfg, blocking=True)
        for sig, h in old_handlers.items():
            signal.signal(sig, h)
    return state, history
