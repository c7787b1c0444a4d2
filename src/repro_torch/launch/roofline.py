"""Roofline terms from a dry-run's trace of one step; the port of
`repro/launch/roofline.py`.

Hardware model: one NVIDIA H100 SXM5 80GB at its 700 W power limit, from
the data sheet:
    peak bf16 dense compute : 989 TFLOP/s
    HBM3 bandwidth          : 3.35 TB/s
    NVLink bandwidth        : 450 GB/s each way
A card set below 700 W runs slower under load. A mesh axis that spans more
than one host of 8 cards crosses the hosts' network, far slower than
NVLink, which this model does not price.

Terms per (arch, shape, mesh), from per-device quantities:
    compute_s    = FLOPs / peak
    memory_s     = bytes / hbm_bw
    collective_s = collective bytes / link_bw

torch has no HLO. `TraceCounter` is a TorchDispatchMode that sees every
op a DTensor step runs on its local shards (it hands DTensor ops on to
DTensor's dispatch, whose local ops then come back to it; the sharding
propagator's shape inference on global shapes is not counted). FLOPs are
the matrix products' (torch.utils.flop_counter's formulas) on the local
operands; bytes the sum of each non-view local op's operand and result
bytes, an unfused upper bound and not XLA's "bytes accessed"; collectives
the functional collectives DTensor runs, by kind, with their result
bytes (`collective_bytes`).
"""
from __future__ import annotations

import collections
import weakref

import torch

PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
LINK_BW = 450e9

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# functional-collective op name prefixes -> the JAX package's kinds (DTensor
# changes a shard dim with its own `_dtensor.shard_dim_alltoall`)
_KIND_OF = (("all_gather", "all-gather"), ("all_reduce", "all-reduce"),
            ("reduce_scatter", "reduce-scatter"),
            ("all_to_all", "all-to-all"), ("shard_dim_alltoall", "all-to-all"),
            ("permute", "collective-permute"))


def collective_kind(op_name: str) -> str | None:
    """The kind of a `_c10d_functional` or `_dtensor` collective op (None
    for other ops and for wait_tensor, which moves nothing)."""
    if not op_name.startswith(("_c10d_functional.", "_dtensor.")):
        return None
    base = op_name.split(".")[1]
    for prefix, kind in _KIND_OF:
        if base.startswith(prefix):
            return kind
    return None


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def collective_bytes(records) -> dict:
    """Per-kind result-byte totals and counts, from (kind, bytes, ...)
    records of a trace (`TraceCounter.collectives`)."""
    out = {k: {"bytes": 0, "count": 0} for k in COLLECTIVES}
    for kind, nbytes, *_ in records:
        out[kind]["bytes"] += nbytes
        out[kind]["count"] += 1
    out["total_bytes"] = sum(v["bytes"] for v in out.values()
                             if isinstance(v, dict))
    return out


class TraceCounter:
    """Counts one step's local work. Use as a context manager; then read
    `flops`, `bytes`, `collectives` ((kind, result bytes, dtype+shape) per
    launch) and `peak_temp_bytes` (the peak of live bytes of the storages
    created inside)."""

    def __init__(self):
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.collectives: list = []
        self.live_bytes = 0
        self.peak_temp_bytes = 0
        self._refs: dict = collections.Counter()
        self._in_propagation = 0
        self._mode = None
        self._patch = None

    # -- storage lifetimes -------------------------------------------------
    def _track(self, t: torch.Tensor):
        key = t.untyped_storage()._cdata
        if self._refs[key] == 0:
            self.live_bytes += t.untyped_storage().nbytes()
            self.peak_temp_bytes = max(self.peak_temp_bytes, self.live_bytes)
        self._refs[key] += 1
        weakref.finalize(t, self._release, key,
                         t.untyped_storage().nbytes())

    def _release(self, key, nbytes):
        self._refs[key] -= 1
        if self._refs[key] == 0:
            del self._refs[key]
            self.live_bytes -= nbytes

    # -- the dispatch hook -------------------------------------------------
    def _on_op(self, func, args, kwargs, out):
        if self._in_propagation:
            return
        name = str(func)
        kind = collective_kind(name)
        outs = list(_tensors(out))
        if kind is not None:
            for o in outs:
                self.collectives.append(
                    (kind, _nbytes(o),
                     f"{str(o.dtype).removeprefix('torch.')}{list(o.shape)}"))
            return
        packet = func.overloadpacket
        if packet in self._flop_registry:
            self.flops += self._flop_registry[packet](*args, **kwargs,
                                                      out_val=out)
        if not func.is_view:
            self.bytes += (sum(_nbytes(a) for a in _tensors(args))
                           + sum(_nbytes(a) for a in _tensors(kwargs))
                           + sum(_nbytes(o) for o in outs))
        known = {a.untyped_storage()._cdata for a in _tensors(args)}
        for o in outs:
            if o.untyped_storage()._cdata not in known:
                self._track(o)

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    # DTensor's dispatch runs the local ops, which come
                    # back here as plain tensors
                    return NotImplemented
                out = func(*args, **kwargs)
                counter._on_op(func, args, kwargs, out)
                return out

        # the propagator infers output shapes by running each op on fake
        # global-shape tensors: not work any device does
        orig = ShardingPropagator._propagate_tensor_meta_non_cached

        def propagate(prop, *a, **kw):
            counter._in_propagation += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                counter._in_propagation -= 1
        ShardingPropagator._propagate_tensor_meta_non_cached = propagate
        self._patch = (ShardingPropagator, orig)
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        cls, orig = self._patch
        cls._propagate_tensor_meta_non_cached = orig
        return False


def roofline_terms(flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float) -> dict:
    """All inputs are PER-DEVICE quantities."""
    compute_s = flops_per_dev / PEAK_FLOPS
    memory_s = bytes_per_dev / HBM_BW
    collective_s = coll_bytes_per_dev / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    bound_s = terms[dom]
    terms.update(dominant=dom.replace("_s", ""),
                 step_s_lower_bound=bound_s,
                 roofline_fraction=(compute_s / bound_s if bound_s > 0
                                    else 0.0))
    return terms


def model_flops(cfg, n_params: float, n_active: float, tokens: int,
                kind: str) -> float:
    """6*N*D for training, 2*N*D forward-only (prefill/decode), active
    params for MoE."""
    n = n_active if cfg.is_moe else n_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def _leaves_with_path(tree, path=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}/{k}")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def count_params(weights_shapes) -> float:
    return float(sum(t.numel() for _, t in _leaves_with_path(weights_shapes)))


def count_active_params(cfg, weights_shapes) -> float:
    """MoE: experts contribute k/E of their params per token."""
    total = 0.0
    for name, leaf in _leaves_with_path(weights_shapes):
        if "experts" in name and cfg.is_moe:
            total += leaf.numel() * cfg.experts_per_token / cfg.num_experts
        else:
            total += leaf.numel()
    return float(total)
