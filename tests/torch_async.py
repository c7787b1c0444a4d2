"""Shared substrate of the async-loop twins (tests/test_torch_async_*.py):
a tiny HCCS model in both packages on the same weights (JAX's init, carried
across by `params_from_jax`), memoized per pool dtype, and seeded mixed
traffic.
"""
import dataclasses

import jax
import numpy as np

from repro.models import model as JM
from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.serve import Request


_MODELS: dict = {}


def models(tiny_cfg, quant="none"):
    if quant not in _MODELS:
        cfg = tiny_cfg(attention_prob="hccs", hccs_mode="i16_div",
                       kv_quant=quant)
        params = JM.init_params(jax.random.PRNGKey(0), cfg)
        pcfg = ModelConfig(**dataclasses.asdict(cfg))
        pparams = M.params_from_jax(jax.tree.map(np.asarray, params), pcfg,
                                    device="cpu")
        _MODELS[quant] = (cfg, params, pcfg, pparams)
    return _MODELS[quant]


def requests(seed=7, n=10, shared_len=32, temps=None, cls=Request):
    """Mixed traffic: odd uids share a 2-block prompt prefix (so the
    sharing legs actually hit the trie), prompt/budget lengths seeded."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, shared_len).astype(np.int32)
    reqs = []
    for i in range(n):
        tail = rng.integers(0, 256, int(rng.integers(3, 24))).astype(np.int32)
        prompt = np.concatenate([shared, tail]) if i % 2 else tail
        reqs.append(cls(uid=i, prompt=prompt,
                        max_new_tokens=int(rng.integers(2, 12)),
                        temperature=(0.0 if temps is None
                                     else float(temps[i % len(temps)]))))
    return reqs


def run(eng, reqs):
    for req in reqs:
        eng.submit(req)
    done = eng.run()
    return {r.uid: [int(t) for t in r.out_tokens] for r in done}, eng
