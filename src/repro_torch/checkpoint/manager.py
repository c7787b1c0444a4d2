"""Fault-tolerant checkpointing: npz + manifest, async save, atomic LATEST —
the port of `repro/checkpoint/manager.py`, in its layout, so a checkpoint
written by either package restores in the other:

    <dir>/step_000123/
        manifest.json       step, flat key list, config hash
        arrays.npz          flat {key: np.ndarray} (host-gathered)
    <dir>/LATEST            atomic pointer file

Keys are JAX's `keystr` of the tree's paths: `['k']` for a dict key, `.f`
for a dataclass field (the AdamW state's `.step`, `.mu`, `.nu`), in the
npz with "/" written as "|". None leaves vanish. bf16 leaves are stored as
JAX stores them (np.savez of an ml_dtypes array writes raw 2-byte void
words) and read back as those words viewed as torch.bfloat16, without
ml_dtypes. The rng key is a uint32 leaf in both packages.

Writes are atomic (tmp dir + rename) so a preemption mid-save never
corrupts LATEST, and `save_async` runs serialization off the training
thread (the leaves are copied to the host before it starts). `restore`
with `shardings` places each leaf on a mesh as a DTensor: every rank
slices its own shard out of the array it read, so no collective runs.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.parallel.sharding import NamedSharding, contiguous_strides

BF16_WORDS = np.dtype("V2")


def _flatten(tree, prefix: str = "", is_leaf=None) -> dict:
    """Flat {keystr: leaf} of nested dicts and dataclasses, in JAX's
    order (dict keys sorted, dataclass fields declared); `is_leaf(x)`
    stops the walk at x."""
    if is_leaf is not None and is_leaf(tree):
        return {prefix: tree}
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}[{k!r}]", is_leaf))
        return out
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        out = {}
        for f in dataclasses.fields(tree):
            out.update(_flatten(getattr(tree, f.name), f"{prefix}.{f.name}",
                                is_leaf))
        return out
    return {} if tree is None else {prefix: tree}


def _unflatten_into(template, flat, prefix: str = ""):
    if isinstance(template, dict):
        return {k: _unflatten_into(v, flat, f"{prefix}[{k!r}]")
                for k, v in template.items()}
    if dataclasses.is_dataclass(template) and not isinstance(template, type):
        return dataclasses.replace(template, **{
            f.name: _unflatten_into(getattr(template, f.name), flat,
                                    f"{prefix}.{f.name}")
            for f in dataclasses.fields(template)})
    return None if template is None else flat[prefix]


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A leaf as the array the JAX package writes: bf16 as raw 2-byte
    words."""
    # a copy: the train step updates the state in place while an async
    # save is still writing
    t = t.detach().cpu() if t.is_cuda else t.detach().clone()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(BF16_WORDS)
    return t.numpy()


def from_numpy(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """An array read back as a tensor of `like`'s dtype and device; raises
    on a shape or dtype mismatch."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        t = torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(a))
    if tuple(t.shape) != tuple(like.shape) or t.dtype != like.dtype:
        raise ValueError(f"checkpoint leaf {tuple(t.shape)} {t.dtype} does "
                         f"not fit {tuple(like.shape)} {like.dtype}")
    return t.to(like.device)


def _shard(a: np.ndarray, like, sharding):
    """This rank's DTensor of array `a` under `sharding` (a NamedSharding):
    the local shard is sliced out of `a` on the host and moved to the
    mesh's device type, so no collective runs."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    mesh, placements = sharding.mesh, list(sharding.placements)
    if tuple(a.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf {tuple(a.shape)} does not fit "
                         f"{tuple(like.shape)}")
    shape, offset = compute_local_shape_and_global_offset(
        a.shape, mesh, placements)
    local = a[tuple(slice(o, o + n) for o, n in zip(offset, shape))]
    dev = mesh.device_type
    if dev == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    t = from_numpy(np.ascontiguousarray(local),
                   torch.empty(shape, dtype=like.dtype, device=dev))
    return DTensor.from_local(t, mesh, placements, run_check=False,
                              shape=torch.Size(a.shape),
                              stride=contiguous_strides(a.shape))


def config_hash(cfg) -> str:
    """The JAX package's hash: the port's configs repr as the JAX
    package's, field for field."""
    return hashlib.sha256(repr(cfg).encode()).hexdigest()[:16]


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------- save ---

    def save(self, step: int, tree, cfg=None, blocking: bool = True):
        host = {k: to_numpy(v) for k, v in _flatten(tree).items()}
        manifest = {
            "step": int(step),
            "time": time.time(),
            "keys": sorted(host.keys()),
            "config_hash": config_hash(cfg) if cfg is not None else None,
        }
        if blocking:
            self._write(step, host, manifest)
        else:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, manifest), daemon=True)
            self._thread.start()

    def save_async(self, step: int, tree, cfg=None):
        self.save(step, tree, cfg, blocking=False)

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step, host, manifest):
        name = f"step_{step:09d}"
        tmp = os.path.join(self.dir, f".tmp_{name}")
        final = os.path.join(self.dir, name)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        np.savez(os.path.join(tmp, "arrays.npz"),
                 **{k.replace("/", "|"): v for k, v in host.items()})
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        latest_tmp = os.path.join(self.dir, ".LATEST.tmp")
        with open(latest_tmp, "w") as f:
            f.write(name)
        os.replace(latest_tmp, os.path.join(self.dir, "LATEST"))
        self._gc()

    def _gc(self):
        steps = sorted(d for d in os.listdir(self.dir) if d.startswith("step_"))
        for d in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.dir, d), ignore_errors=True)

    # ---------------------------------------------------------- restore ---

    def latest_step(self) -> int | None:
        path = os.path.join(self.dir, "LATEST")
        if not os.path.exists(path):
            return None
        with open(path) as f:
            name = f.read().strip()
        if not os.path.isdir(os.path.join(self.dir, name)):
            return None
        return int(name.split("_")[1])

    def restore(self, template, step: int | None = None, shardings=None,
                cfg=None):
        """Restore into `template`'s structure, each leaf with its template
        leaf's dtype. shardings: None (each leaf on its template leaf's
        device), or a tree of the template's structure whose leaves are
        `parallel.sharding.NamedSharding`s (a DTensor on that mesh, on the
        mesh's device type) or None (that leaf as without shardings), for
        elastic placement on a new mesh. Returns (tree, manifest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.dir}")
        name = f"step_{step:09d}"
        with open(os.path.join(self.dir, name, "manifest.json")) as f:
            manifest = json.load(f)
        if cfg is not None and manifest.get("config_hash") not in (
                None, config_hash(cfg)):
            raise ValueError("checkpoint/config mismatch (config_hash differs)")
        place = ({} if shardings is None else _flatten(
            shardings, is_leaf=lambda x: isinstance(x, NamedSharding)))
        with np.load(os.path.join(self.dir, name, "arrays.npz")) as data:
            want = _flatten(template)
            flat = {}
            for k, like in want.items():
                arr = data[k.replace("/", "|")]
                flat[k] = (_shard(arr, like, place[k]) if place.get(k)
                           is not None else from_numpy(arr, like))
        return _unflatten_into(template, flat), manifest
