"""train_step / eval_step factories — the port of `repro/train/steps.py`:
loss -> autograd -> (optional int8 grad compression) -> AdamW.

The state is the JAX package's tree, as dicts of tensors:
    {"params": {"weights", "hccs"}, "opt": AdamWState(step, mu, nu),
     "rng": (2,) uint32 key (0, tcfg.seed), "ef_error"?: f32 residuals}
so checkpoints carry across packages. `rng` lives on the host: each step
splits it as the JAX step does (`jax.random.split`, rebuilt in
`serve/prng.py`), the second key seeding the compression noise.

The step consumes its state: params, moments, the step count and the error
feedback are updated in place and returned in the new state (the JAX
launcher donates the state to XLA for the same effect). `hccs` (theta and
the logit scales) is never updated: the forward detaches it and the
optimizer only sees `weights`.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models import model as M
from repro_torch.optim import adamw, compression
from repro_torch.serve import prng


def train_state_from_params(params, tcfg):
    """A fresh train state around `params` (on their device); the rng is
    `jax.random.PRNGKey(tcfg.seed)` as a (2,) uint32 tensor on the host."""
    state = {"params": params, "opt": adamw.init(params["weights"]),
             "rng": torch.tensor(prng.prng_key(tcfg.seed),
                                 dtype=torch.uint32)}
    if tcfg.grad_compression == "int8":
        state["ef_error"] = adamw.tree_map(
            lambda p: torch.zeros_like(p, dtype=torch.float32)
            if p.is_floating_point() else None, params["weights"])
    return state


def make_train_state(seed: int, cfg, tcfg, device=None):
    """Weights from a torch generator seeded with `seed` (the JAX init's
    distributions, not its numbers: the tests carry JAX's weights across
    with `models.model.params_from_jax` and `train_state_from_params`).
    CUDA unless the caller names another device."""
    device = resolve_device(device)
    return train_state_from_params(M.init_params(cfg, seed=seed,
                                                 device=device), tcfg)


def _loss_fn(cfg, loss_fn):
    """The given loss, else cls_loss for a classification head and
    lm_loss otherwise (the JAX package's default)."""
    return loss_fn or (M.cls_loss if cfg.num_classes else M.lm_loss)


def make_train_step(cfg, tcfg, loss_fn: Callable | None = None):
    """Returns train_step(state, batch) -> (state, metrics): metrics holds
    the loss function's keys plus loss, lr and grad_norm (0-d tensors on
    the device), as the JAX step's. A MoE model's loss adds
    tcfg.moe_aux_weight times the load-balance aux loss."""
    loss_fn = _loss_fn(cfg, loss_fn)

    def train_step(state, batch):
        params = state["params"]
        weights = params["weights"]
        names = [k for k, v in M.flatten_tree(weights).items()
                 if v.is_floating_point()]
        flat = M.flatten_tree(weights)
        leaves = {k: (v.detach().requires_grad_() if k in names else v)
                  for k, v in flat.items()}
        with torch.enable_grad():
            loss, metrics = loss_fn(M.unflatten_tree(leaves),
                                    params["hccs"], batch, cfg)
            if cfg.is_moe:
                loss = loss + tcfg.moe_aux_weight * metrics["aux_loss"]
            # a leaf the loss does not reach (the token table of an
            # embedding-input model) gets a zero gradient, as under JAX
            grads = torch.autograd.grad(loss, [leaves[k] for k in names],
                                        materialize_grads=True)
        grads = M.unflatten_tree(dict(zip(names, grads)))
        rng, sub = prng.split(state["rng"])
        new_state = dict(state, rng=torch.tensor(rng, dtype=torch.uint32))
        with torch.no_grad():
            if tcfg.grad_compression == "int8":
                grads, new_err = compression.compress_grads(
                    grads, state["ef_error"], sub)
                new_state["ef_error"] = new_err
            new_w, new_opt, stats = adamw.apply_updates(
                weights, grads, state["opt"], tcfg)
        new_state["params"] = {"weights": new_w, "hccs": params["hccs"]}
        new_state["opt"] = new_opt
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics = dict(metrics, loss=loss.detach(), **stats)
        return new_state, metrics

    return train_step


def make_eval_step(cfg, loss_fn: Callable | None = None):
    loss_fn = _loss_fn(cfg, loss_fn)

    def eval_step(params, batch):
        with torch.no_grad():
            _, metrics = loss_fn(params["weights"], params["hccs"], batch,
                                 cfg)
        return metrics

    return eval_step
