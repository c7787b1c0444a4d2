"""Request type, admission bound and greedy sampling shared by the port's
engines — the part of `repro/serve/engine.py` the paged engine needs.

Temperature sampling is not ported yet: the JAX engines fold (uid,
generation index) into threefry keys, a stream torch cannot reproduce
(ROADMAP.md item A5). A request with temperature > 0 is refused at submit.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Request:
    """One serving request: `done` is set when it completes."""
    uid: int
    prompt: np.ndarray            # (t,) int32
    max_new_tokens: int = 32
    temperature: float = 0.0
    out_tokens: list = dataclasses.field(default_factory=list)
    done: bool = False


def validate_prompt(prompt, max_len: int):
    """Shared admission bound: the prompt must fit the cache with room for at
    least one generated token."""
    if len(prompt) < 1 or len(prompt) > max_len - 1:
        raise ValueError(
            f"prompt length {len(prompt)} not in [1, {max_len - 1}]")


def check_greedy(req: Request):
    if req.temperature > 0:
        raise NotImplementedError(
            "temperature sampling is not ported yet (per-request threefry "
            "streams): ROADMAP.md item A5")


def sample_tokens(logits: torch.Tensor) -> np.ndarray:
    """Greedy per-row sampling: (B, V) logits -> (B,) np.int64 tokens. The
    argmax takes the FIRST maximal index on ties, as jnp.argmax does; only
    the B indices leave the device."""
    return torch.argmax(logits, dim=-1).cpu().numpy().astype(np.int64)
