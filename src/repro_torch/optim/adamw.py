"""AdamW with decoupled weight decay, cosine schedule and global-norm
clipping — the port of `repro/optim/adamw.py`.

Functional over nested dicts of tensors. Optimizer state keeps f32 moments
regardless of param dtype; non-float leaves (and None) are passed through
untouched. The schedule, the clip and the bias corrections are f32 tensor
arithmetic, as JAX computes them from its int32 step with weak-typed Python
floats (Python float64 arithmetic would move their last bits).

`apply_updates` writes the new params, moments and step into the given
tensors (the JAX train step donates its state to XLA for the same effect),
a slice of the leading axis at a time, so a (40, 2048, 8192) leaf needs no
f32 temporaries of its whole size; each element is the JAX expression.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# elements per slice of an in-place update (and of a global-norm term)
SLICE_ELEMS = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWState:
    step: torch.Tensor          # int32 scalar
    mu: Any
    nu: Any


def _is_float(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_floating_point()


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts (None and any non-dict value is a
    leaf), the other trees read at the same keys."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    """The non-None leaves of nested dicts in JAX's flatten order (keys
    sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [] if tree is None else [tree]


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device)
                    if _is_float(p) else None, params)


def init(params) -> AdamWState:
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=_zeros_like_tree(params),
                      nu=_zeros_like_tree(params))


def _f32(v, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def cosine_lr(step: torch.Tensor, base_lr, warmup, total) -> torch.Tensor:
    """Linear warmup then cosine decay, f32, from an int32 step tensor."""
    warm = _f32(base_lr, step) * (step + 1).float() / _f32(max(warmup, 1),
                                                           step)
    t = torch.clamp((step - warmup).float() / _f32(max(total - warmup, 1),
                                                   step), 0.0, 1.0)
    cos = _f32(base_lr * 0.5, step) * (1 + torch.cos(_f32(math.pi, step) * t))
    return torch.where(step < warmup, warm, cos)


def _slices(t: torch.Tensor):
    """Views of `t` along its leading axis of at most SLICE_ELEMS elements
    each (the whole tensor when it is small or 0-d)."""
    if t.dim() == 0 or t.numel() <= SLICE_ELEMS:
        return [t]
    per = max(1, SLICE_ELEMS // max(t[0].numel(), 1))
    return list(torch.split(t, per))


def global_norm(tree) -> torch.Tensor:
    total = None
    for x in tree_leaves(tree):
        for part in _slices(x):
            term = torch.sum(torch.square(part.float()))
            total = term if total is None else total + term
    return torch.sqrt(total)


def apply_updates(params, grads, state: AdamWState,
                  tcfg) -> tuple[Any, AdamWState, dict]:
    """One AdamW step. tcfg: TrainConfig. Overwrites the params, moments
    and step count given and returns them: (params, state, stats)."""
    step = state.step
    lr = cosine_lr(step, tcfg.learning_rate, tcfg.warmup_steps,
                   tcfg.total_steps)
    gnorm = global_norm(grads)
    clip = torch.minimum(_f32(1.0, gnorm),
                         _f32(tcfg.grad_clip, gnorm) / (gnorm + 1e-9))
    b1, b2, eps, wd = tcfg.beta1, tcfg.beta2, tcfg.eps, tcfg.weight_decay
    n = (step + 1).float()
    bc1 = 1 - torch.pow(_f32(b1, step), n)
    bc2 = 1 - torch.pow(_f32(b2, step), n)

    def upd(p, g, mu, nu):
        g = g.float() * clip
        mu = b1 * mu + (1 - b1) * g
        nu = b2 * nu + (1 - b2) * torch.square(g)
        mu_hat = mu / bc1
        nu_hat = nu / bc2
        delta = mu_hat / (torch.sqrt(nu_hat) + eps) + wd * p.float()
        return (p.float() - lr * delta).to(p.dtype), mu, nu

    def leaf(p, g, mu, nu):
        if g is None or not _is_float(p):
            return p, mu, nu
        for ps, gs, ms, ns in zip(_slices(p), _slices(g), _slices(mu),
                                  _slices(nu)):
            new_p, new_mu, new_nu = upd(ps, gs, ms, ns)
            ps.copy_(new_p)
            ms.copy_(new_mu)
            ns.copy_(new_nu)
        return p, mu, nu

    tree_map(leaf, params, grads, state.mu, state.nu)
    step.add_(1)
    return params, state, {"lr": lr, "grad_norm": gnorm}
