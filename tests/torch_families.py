"""Shared substrate of the family twins (tests/test_torch_families_*.py):
reduced models of one architecture in both packages on the same weights
(made by `repro.models.model.init_params`, carried across by
`params_from_jax`), seeded traffic, and both packages' engines on it.

The models and the JAX engines' tokens are memoized per process: pytest-xdist
runs a file's tests on one worker, and several parametrised cases serve the
same JAX engine on the same weights and traffic.
"""
import dataclasses

import jax
import numpy as np

from repro.configs import reduced_config
from repro.models import model as JM
from repro.serve import ContinuousEngine as JContinuous
from repro.serve import PagedEngine as JPaged
from repro.serve import Request as JRequest
from repro.serve import ServeEngine as JWave
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import (ContinuousEngine, PagedEngine, Request,
                               ServeEngine)

CPU = "cpu"
# three prompts of 11, 23 and 5 tokens (6 new each) whose packed steps drop
# tokens at capacity 1.25
DROP_TRAFFIC = (11, 23, 5)
ENGINES = {"wave": (JWave, ServeEngine, {}),
           "continuous": (JContinuous, ContinuousEngine, {}),
           "packed": (JPaged, PagedEngine, dict(block_size=8)),
           "lockstep": (JPaged, PagedEngine, dict(block_size=8,
                                                  packed=False))}

_MODELS: dict = {}
_JAX_TOKENS: dict = {}


def models(arch, **kw):
    """(cfg, params, pcfg, pparams) of the reduced `arch` with `kw`;
    memoized (the port's engines never write their params)."""
    key = (arch, tuple(sorted(kw.items())))
    if key not in _MODELS:
        cfg = reduced_config(arch).replace(**kw)
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device=CPU)
        _MODELS[key] = (cfg, params, pcfg, pparams)
    return _MODELS[key]


def requests(cfg, lens, max_new=6, seed=0):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, cfg.vocab_size, n).astype(np.int32),
             max_new) for i, n in enumerate(lens)]


def serve(engine, reqs, cls=Request):
    for uid, prompt, m in reqs:
        engine.submit(cls(uid=uid, prompt=prompt.copy(), max_new_tokens=m))
    return {r.uid: list(r.out_tokens) for r in engine.run()}


def both(engine, models, reqs, max_batch=4, max_len=64):
    """(the port's tokens, the JAX engine's tokens) of `engine` on `reqs`;
    the JAX engine's run once per models, engine, traffic and sizes."""
    cfg, params, pcfg, pparams = models
    jcls, pcls, kw = ENGINES[engine]
    key = (id(models), engine, max_batch, max_len,
           tuple((u, p.tobytes(), m) for u, p, m in reqs))
    if key not in _JAX_TOKENS:
        _JAX_TOKENS[key] = serve(jcls(params, cfg, max_batch=max_batch,
                                      max_len=max_len, **kw), reqs, JRequest)
    got = serve(pcls(pparams, pcfg, max_batch=max_batch, max_len=max_len,
                     device=CPU, **kw), reqs)
    return got, _JAX_TOKENS[key]
