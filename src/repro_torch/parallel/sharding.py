"""Logical-axis sharding rules -> specs -> DTensor placements; the port of
`repro/parallel/sharding.py`.

Model code annotates activations with `constrain(x, 'batch', None, 'model')`
using *logical* names; the mapping to the axes of a
`torch.distributed.device_mesh.DeviceMesh` is set per launch via
`use_rules(mesh)`. Outside any rules context, or on a tensor that is not a
DTensor, the calls return their argument itself, so the same model code runs
on one device unchanged and adds no operation there.

A spec is a plain tuple with one entry per tensor dim: None, a mesh axis
name, or a tuple of axis names (the dim sharded over several mesh axes,
major to minor) — what a jax PartitionSpec holds. `to_placements` turns it
into DTensor placements, one per MESH dim: Shard(d) on every mesh axis that
tensor dim d names, Replicate() on the rest. DTensor splits a dim sharded
over several mesh dims in mesh-dim order (the first mesh dim outermost), so
a tuple entry must list its axes in the mesh's order, as every rule here
does; `to_placements` raises otherwise.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Any

import torch

# logical axis -> physical mesh axis (or tuple of axes)
DEFAULT_RULES: dict[str, Any] = {
    "batch": ("pod", "data"),
    "seq": None,
    "seq_sp": "data",        # sequence parallelism (long-context variants)
    "embed": None,
    "model": "model",        # tensor parallel
    "kv_model": "model",
    "vocab": "model",
    "expert": "model",       # expert parallel (EP == TP axis)
    "expert_cap": "data",    # MoE capacity dim sharded with the token shards
    "ffn": "model",
    "fsdp": "data",          # FSDP/ZeRO-3: weights sharded over the DP axis
    "seq_act": None,         # sequence parallelism on the residual stream
                             # (the dry-run maps it to "model" for
                             # train/prefill)
    "attn_seq": None,        # sequence sharding inside attention (serve_sp)
    "ssd_chunk": "model",    # SSD intra-chunk tensors shard their chunk dim
                             # over the TP axis
    "moe_group": ("pod", "data"),  # MoE dispatch groups live with the token
                                   # shards
    "moe_embed": "model",    # inside dispatch/combine the embedding dim
                             # shards over the TP axis
    "layers": None,
}

_CTX: contextvars.ContextVar = contextvars.ContextVar("sharding_ctx",
                                                      default=None)


@contextlib.contextmanager
def use_rules(mesh, rules: dict[str, Any] | None = None):
    rules = dict(DEFAULT_RULES, **(rules or {}))
    token = _CTX.set((mesh, rules))
    try:
        yield
    finally:
        _CTX.reset(token)


def _axis_names(mesh) -> tuple:
    return tuple(mesh.mesh_dim_names or ())


def _resolve(mesh, rules: dict, logical: tuple) -> tuple:
    """Two rules, as in JAX: a mesh axis an earlier dim claimed is dropped
    from later dims, and mesh axes the mesh does not have are ignored."""
    names = _axis_names(mesh)
    axes = []
    used: set = set()
    for name in logical:
        if name is None:
            axes.append(None)
            continue
        phys = rules.get(name, None)
        if phys is None:
            axes.append(None)
        elif isinstance(phys, tuple):
            present = tuple(a for a in phys if a in names and a not in used)
            used.update(present)
            # a PartitionSpec holds a one-axis tuple as the bare name
            axes.append(present[0] if len(present) == 1 else
                        (present or None))
        elif phys in names and phys not in used:
            used.add(phys)
            axes.append(phys)
        else:  # earlier dim already claimed this mesh axis, or it is absent
            axes.append(None)
    return tuple(axes)


def spec(*logical) -> tuple:
    """Resolve logical axes to a spec tuple under the active rules."""
    ctx = _CTX.get()
    if ctx is None:
        return (None,) * len(logical)
    mesh, rules = ctx
    return _resolve(mesh, rules, logical)


def to_placements(spec_: tuple, mesh) -> list:
    """DTensor placements (one per mesh dim) for a spec tuple."""
    from torch.distributed.tensor import Replicate, Shard
    names = _axis_names(mesh)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec_):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in group]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry} is not in the mesh's axis "
                             f"order {names}: DTensor cannot lay it out")
        for i in idx:
            out[i] = Shard(dim)
    return out


def is_dtensor(x) -> bool:
    if type(x) is torch.Tensor:     # the one-device paths: no import
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x: torch.Tensor, *logical) -> torch.Tensor:
    """x.redistribute to the resolved placements under the active rules;
    `x` itself outside them or when x is not a DTensor."""
    ctx = _CTX.get()
    if ctx is None or not is_dtensor(x):
        return x
    mesh, rules = ctx
    return x.redistribute(x.device_mesh,
                          to_placements(_resolve(mesh, rules, logical), mesh))


def unflatten(x: torch.Tensor, dim: int, sizes: tuple) -> torch.Tensor:
    """x.unflatten(dim, sizes). DTensor cannot split a sharded dim whose
    shard count does not divide the leading size (8 KV heads over a
    16-way model axis); such a DTensor is first gathered on that dim, the
    resharding XLA inserts there. A plain tensor is only viewed."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        d = dim % x.dim()
        mesh = x.device_mesh
        n = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == d:
                n *= mesh.size(i)
        if sizes[0] % n:
            x = x.redistribute(mesh, [
                Replicate() if isinstance(p, Shard) and p.dim == d else p
                for p in x.placements])
    return x.unflatten(dim, sizes)


def einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum of two operands. On DTensors the product runs on the
    local shards, with the placements worked out here rather than by
    DTensor's propagation, which cannot flatten two sharded dims into one
    batch dim of the underlying bmm (the GQA products shard batch and
    heads). On each mesh dim the first operand's sharded letter (else the
    second's) is the one both operands shard there (the other operand is
    redistributed to match, or to Replicate where it lacks the letter);
    the output is sharded on that letter, or Partial(sum) where the letter
    is contracted. A plain operand beside a DTensor counts as replicated.
    Equations with '...' are not supported on DTensors."""
    if not (is_dtensor(a) or is_dtensor(b)):
        return torch.einsum(eq, a, b)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = (a if is_dtensor(a) else b).device_mesh
    a, b = (x if is_dtensor(x) else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False) for x in (a, b))
    ins, out = eq.replace(" ", "").split("->")
    la, lb = ins.split(",")

    def sharded_letter(x, letters, i):
        p = x.placements[i]
        return letters[p.dim] if isinstance(p, Shard) else None
    pa, pb, po = [], [], []
    for i in range(mesh.ndim):
        target = sharded_letter(a, la, i) or sharded_letter(b, lb, i) or ""
        pa.append(Shard(la.index(target)) if target and target in la
                  else Replicate())
        pb.append(Shard(lb.index(target)) if target and target in lb
                  else Replicate())
        po.append(Replicate() if not target else
                  Shard(out.index(target)) if target in out else Partial())
    a, b = a.redistribute(mesh, pa), b.redistribute(mesh, pb)
    local = torch.einsum(eq, a.to_local(), b.to_local())
    sizes = dict(zip(la, a.shape)) | dict(zip(lb, b.shape))
    shape = torch.Size(sizes[c] for c in out)
    return DTensor.from_local(local, mesh, po, run_check=False, shape=shape,
                              stride=contiguous_strides(shape))


def contiguous_strides(shape) -> tuple:
    """The strides of a contiguous tensor of `shape`."""
    strides, n = [], 1
    for size in reversed(tuple(shape)):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


# ---------------------------------------------------------------------------
# Parameter specs, by path-name pattern
# ---------------------------------------------------------------------------

# Ordered (regex, logical axes *excluding* the stacked-layer leading dim).
# TP ("model") on the head/ffn/vocab dim + FSDP ("fsdp" -> data axis) on the
# other dim.
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"embed/table",            ("vocab", "fsdp")),
    (r"pos_embed",              (None, "fsdp")),
    (r"lm_head",                ("fsdp", "vocab")),
    (r"(wq|wk|wv)$",            ("fsdp", "model")),
    (r"wo$",                    ("model", "fsdp")),
    (r"experts/(w_in|w_gate)",  ("expert", "fsdp", None)),
    (r"experts/w_out",          ("expert", None, "fsdp")),
    (r"(w_in|w_gate)$",         ("fsdp", "ffn")),
    (r"w_out$",                 ("ffn", "fsdp")),
    (r"router",                 ("fsdp", None)),
    (r"ssm/in_proj",            ("fsdp", None)),   # not TP-divisible (hymba)
    (r"ssm/out_proj",           ("model", "fsdp")),
    (r"ssm/(A_log|dt_bias|D)",  (None,)),
    (r"(norm|scale|bias|ln)",   (None,)),
    (r"hccs",                   (None,)),
    (r"cls_head",               ("fsdp", None)),
]


def _path_str(path) -> str:
    """'/'-joined keys of a path (a tuple of dict keys or list indices)."""
    return "/".join(str(p) for p in path)


def _tree_map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def leaf_spec(name: str, ndim: int, stacked_prefix: str = "layers") -> tuple:
    """The spec of the leaf at path `name` under the param rules; leaves
    under `stacked_prefix` get a leading None for the stacked layer dim."""
    stacked = f"{stacked_prefix}/" in name
    for pat, logical in _PARAM_RULES:
        if re.search(pat, name):
            rank = ndim - (1 if stacked else 0)
            ax = list(logical)[:rank]
            ax += [None] * (rank - len(ax))
            return spec(*([None] if stacked else []) + ax)
    return spec(*([None] * ndim))


def param_spec_tree(params, stacked_prefix: str = "layers"):
    """The spec tree of a params tree (nested dicts of tensors)."""
    return _tree_map_with_path(
        lambda path, leaf: leaf_spec(_path_str(path), leaf.dim(),
                                     stacked_prefix), params)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the DTensor placements of one tensor on it: the port's
    counterpart of jax.sharding.NamedSharding."""
    mesh: Any
    placements: tuple

    @classmethod
    def from_spec(cls, mesh, spec_: tuple) -> "NamedSharding":
        return cls(mesh, tuple(to_placements(spec_, mesh)))


def named_sharding_tree(params, mesh, stacked_prefix: str = "layers"):
    """The NamedSharding tree of a params tree on `mesh`."""
    return _tree_map_with_path(
        lambda path, leaf: NamedSharding.from_spec(
            mesh, leaf_spec(_path_str(path), leaf.dim(), stacked_prefix)),
        params)


def bytes_per_device(params, mesh) -> float:
    """Rough parameter bytes per device under the param sharding rules."""
    sizes = dict(zip(_axis_names(mesh), mesh.mesh.shape))
    total = 0.0

    def one(path, leaf):
        nonlocal total
        shard = 1
        for ax in leaf_spec(_path_str(path), leaf.dim()):
            for a in (ax if isinstance(ax, tuple) else (ax,)):
                if a is not None:
                    shard *= sizes.get(a, 1)
        total += leaf.numel() * leaf.element_size() / shard
    _tree_map_with_path(one, params)
    return total
