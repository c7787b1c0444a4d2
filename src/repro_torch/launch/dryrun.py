"""Multi-pod dry-run: run one train step, prefill or decode step of every
(arch x shape x mesh) cell on meta DTensors and extract roofline terms;
the port of `repro/launch/dryrun.py`. Nothing is allocated: parameters,
optimizer state, caches and inputs are DTensors whose local shards are
meta tensors, laid out on a `DeviceMesh` over a fake process group of the
mesh's size (the backend "fake" of torch's distributed test utilities; its
collectives move nothing). Only this module, `inspect_hlo` and the tests
start that group; the serving and training entry points never do.

    python -m repro_torch.launch.dryrun --arch granite-3-2b \
        --shape decode_32k --mesh pod
    python -m repro_torch.launch.dryrun --all --mesh both

Writes one JSON record per cell under --out (default experiments/dryrun/).

The port runs every layer (there is no lax.scan whose body XLA's cost
analysis counts once), so no 1-/2-layer extrapolation is needed and each
record's numbers are the whole step's, per device, from
`roofline.TraceCounter`: FLOPs of the local matrix products, bytes as the
sum of every local op's operand and result bytes (an unfused upper bound,
not XLA's "bytes accessed"), collective result bytes by kind, and memory
as the argument bytes (the local shards of the step's inputs), the output
bytes, the bytes of outputs that alias an argument (the step updates its
state and cache in place) and the peak of live temporaries. Attention runs
the STE path (decode_kernel="none"), as in the JAX dry-run.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import time
import traceback

import numpy as np
import torch

from repro_torch.configs import SHAPES, get_config, input_specs, iter_cells
from repro_torch.configs.base import TrainConfig
from repro_torch.launch import roofline as RL
from repro_torch.launch.mesh import (make_production_mesh,
                                     production_mesh_shape)
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWState
from repro_torch.parallel import sharding as SH
from repro_torch.serve import prng
from repro_torch.train import steps as TS


# the dry-run's meshes name the card's device type, so DTensor runs the
# collectives NCCL runs (on a "cpu" mesh it turns all-to-all into
# all-gather + chunk, as gloo has no all-to-all); the local shards stay meta
MESH_DEVICE = "cuda"


def init_fake_process_group(world_size: int):
    """The fake process group the dry-run lays its mesh over (rank 0 of
    `world_size`); a group already initialized is kept."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=world_size)


def _map_with_path(fn, tree):
    """fn(name, leaf) over a tree of dicts, name the '/'-joined path."""
    return SH._tree_map_with_path(
        lambda path, leaf: fn(SH._path_str(path), leaf), tree)


def _leaf_spec(name, leaf, stacked_token="layers"):
    return SH.leaf_spec(name, leaf.dim(), stacked_token)


def _tree_shardings(tree, mesh, stacked_token="layers"):
    """Placements tree via the path-regex param rules (the optimizer
    moments mirror the weights' paths)."""
    return _map_with_path(
        lambda name, leaf: SH.to_placements(
            _leaf_spec(name, leaf, stacked_token), mesh), tree)


def _batch_shardings(batch_specs, mesh, batch_divisible):
    def one(name, leaf):
        if name == "mrope_positions":
            ax = [None, "batch" if batch_divisible else None] + \
                 [None] * (leaf.dim() - 2)
        else:
            ax = ["batch" if batch_divisible else None] + \
                 [None] * (leaf.dim() - 1)
        return SH.to_placements(SH.spec(*ax), mesh)
    return _map_with_path(one, batch_specs)


def _cache_shardings(cache_shapes, mesh, batch_divisible):
    """(L,B,hkv,T,hd) attn caches / (L,B,nh,N,P) ssm states / scalars."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))

    def one(name, leaf):
        if "hot_" in name:   # replicated hot buffer (small, static writes)
            ax = (None, "batch") + (None,) * (leaf.dim() - 2)
        elif leaf.dim() == 5 and ("/k" in name or "/v" in name):
            if batch_divisible:
                ax = (None, "batch", None, "cache_seq", None)
            else:
                ax = (None, None, None, "seq_kv_joint", None)
        elif leaf.dim() == 5:  # ssm state: heads over model iff divisible
            if batch_divisible:
                ax = (None, "batch", None, None, None)
            elif leaf.shape[2] % sizes.get("model", 1) == 0:
                ax = (None, None, "ssm_heads", None, None)
            else:  # e.g. hymba's 50 SSM heads on a 16-way TP axis
                ax = (None,) * 5
        else:
            ax = (None,) * leaf.dim()
        return SH.to_placements(SH.spec(*ax), mesh)
    return _map_with_path(one, cache_shapes)


# extra logical axes used only by the cache layouts above
_EXTRA_RULES = {
    "seq_kv_joint": ("data", "model"),   # long-context: shard cache T jointly
    "cache_seq": "model",                # KV-cache seq dim
    "ssm_heads": "model",
}

# sharding profiles, as in the JAX dry-run:
#   default  — TP(model) + FSDP(data) weights, SP residual
#   serve_sp — weights replicated, activations sequence-sharded over model
#   train_sp_attn — sequence-sharded q inside attention in training
#   serve_tp — TP weights without the FSDP sharding over data
PROFILES = {
    "default": {},
    "serve_sp": {"fsdp": None, "model": None, "ffn": None, "vocab": None,
                 "kv_model": None, "seq_act": "model", "attn_seq": "model",
                 "seq_kv_joint": "model"},
    "train_sp_attn": {"attn_seq": "model", "kv_model": None},
    "serve_tp": {"fsdp": None},
}


def _mesh_batch(mesh):
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return sizes.get("pod", 1) * sizes.get("data", 1)


def _distribute(tree, placements, mesh):
    """Meta DTensors: each meta leaf split into this rank's local shard."""
    from torch.distributed.tensor import distribute_tensor

    def one(name, leaf):
        node = placements
        for part in name.split("/"):
            node = node[part]
        return distribute_tensor(leaf, mesh, node, src_data_rank=None)
    return _map_with_path(one, tree)


def _replicated(tree, mesh):
    from torch.distributed.tensor import Replicate
    return _distribute(tree, _map_with_path(
        lambda n, leaf: [Replicate()] * mesh.ndim, tree), mesh)


def _local_leaves(tree):
    from torch.distributed.tensor import DTensor
    for t in RL._tensors(tree):
        yield t.to_local() if isinstance(t, DTensor) else t


def _memory(args, outs) -> dict:
    arg_locals = list(_local_leaves(args))
    arg_ids = {t.untyped_storage()._cdata for t in arg_locals}
    out_locals = list(_local_leaves(outs))
    return dict(
        argument_bytes=sum(RL._nbytes(t) for t in arg_locals),
        output_bytes=sum(RL._nbytes(t) for t in out_locals),
        alias_bytes=sum(RL._nbytes(t) for t in out_locals
                        if t.untyped_storage()._cdata in arg_ids))


def build_cell(arch: str, shape_name: str, mesh, prob: str | None = None,
               hccs_router: bool = False, remat: str | None = None,
               num_layers: int | None = None, seq_parallel: bool = True,
               extra_rules: dict | None = None, hot_buffer: int = 0):
    """Returns (run_fn, meta): run_fn() builds the cell's meta DTensors and
    runs its step under a TraceCounter, returning
    (counter, weight shapes, memory dict)."""
    cfg = get_config(arch)
    if hot_buffer:
        cfg = cfg.replace(hot_buffer=hot_buffer)
    if prob and cfg.num_heads:
        cfg = cfg.replace(attention_prob=prob)
    if hccs_router and cfg.is_moe:
        cfg = cfg.replace(hccs_router=True)
    cfg = cfg.replace(remat=remat or "full", decode_kernel="none")
    if num_layers:
        cfg = cfg.replace(num_layers=num_layers)
    shape = SHAPES[shape_name]
    tcfg = TrainConfig()
    nb = _mesh_batch(mesh)
    batch_div = shape.global_batch % nb == 0
    rules = dict(_EXTRA_RULES)
    if seq_parallel and shape.kind in ("train", "prefill"):
        # sequence parallelism on the residual stream and seq-sharded q
        # inside attention, as the JAX dry-run sets them
        rules["seq_act"] = "model"
        rules["attn_seq"] = "model"
        rules["kv_model"] = None
    if not batch_div:
        rules["batch"] = None
    if extra_rules:
        rules.update(extra_rules)
    if shape.kind == "decode":
        rules["seq_act"] = None     # decode steps have t=1

    batch_specs = input_specs(cfg, shape)

    def run():
        from torch.distributed.tensor.experimental import implicit_replication
        with SH.use_rules(mesh, rules), implicit_replication():
            batch = _distribute(batch_specs, _batch_shardings(
                batch_specs, mesh, batch_div), mesh)
            shapes = M.param_shapes(cfg)
            weights = _distribute(shapes["weights"], _tree_shardings(
                shapes["weights"], mesh), mesh)
            hccs = _replicated(shapes["hccs"], mesh)
            if shape.kind == "train":
                f32 = _map_with_path(
                    lambda n, t: torch.empty(t.shape, dtype=torch.float32,
                                             device="meta"),
                    shapes["weights"])
                opt_sh = _tree_shardings(f32, mesh)
                opt = AdamWState(
                    step=_replicated({"s": torch.empty(
                        (), dtype=torch.int32, device="meta")}, mesh)["s"],
                    mu=_distribute(f32, opt_sh, mesh),
                    nu=_distribute(f32, opt_sh, mesh))
                state = {"params": {"weights": weights, "hccs": hccs},
                         "opt": opt,
                         "rng": torch.tensor(prng.prng_key(tcfg.seed),
                                             dtype=torch.uint32)}
                step = TS.make_train_step(cfg, tcfg)
                args = (state["params"], opt.mu, opt.nu, opt.step, batch)
                with RL.TraceCounter() as c:
                    new_state, metrics = step(state, batch)
                outs = (new_state["params"], new_state["opt"].mu,
                        new_state["opt"].nu, new_state["opt"].step, metrics)
                return c, shapes["weights"], _memory(args, outs)

            cache_shapes = M.init_cache(cfg, shape.global_batch,
                                        shape.seq_len, device="meta")
            cache = _distribute(cache_shapes, _cache_shardings(
                cache_shapes, mesh, batch_div), mesh)
            args = (weights, hccs, batch, cache)
            with RL.TraceCounter() as c:
                if shape.kind == "prefill":
                    logits, new_cache = M.prefill(
                        weights, hccs, batch, cfg, max_len=shape.seq_len,
                        cache=cache)
                else:   # decode: one new token against a seq_len cache
                    logits, new_cache = M.decode_step(
                        weights, hccs, batch.get("tokens"), cache, cfg,
                        embeddings=batch.get("embeddings"))
            return c, shapes["weights"], _memory(args, (logits, new_cache))

    return run, dict(cfg=cfg, shape=shape, tcfg=tcfg)


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             prob: str | None = None, tag: str = "", remat: str | None = None,
             hccs_router: bool = False, seq_parallel: bool = True,
             extra_rules: dict | None = None, profile: str = "default",
             hot_buffer: int = 0, num_layers: int | None = None) -> dict:
    multi_pod = mesh_kind == "multipod"
    init_fake_process_group(int(np.prod(production_mesh_shape(multi_pod)[0])))
    mesh = make_production_mesh(multi_pod=multi_pod, device_type=MESH_DEVICE)
    chips = int(mesh.size())
    rules = dict(PROFILES[profile], **(extra_rules or {}))
    run_fn, meta = build_cell(arch, shape_name, mesh, prob=prob, remat=remat,
                              hccs_router=hccs_router,
                              seq_parallel=seq_parallel, extra_rules=rules,
                              hot_buffer=hot_buffer, num_layers=num_layers)
    cfg, shape = meta["cfg"], meta["shape"]
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": list(mesh.mesh.shape), "chips": chips,
           "prob": prob or cfg.attention_prob, "remat": cfg.remat,
           "num_layers": cfg.num_layers, "hot_buffer": cfg.hot_buffer,
           "tag": tag, "profile": profile, "ok": False,
           "hardware": {"card": "H100 SXM5 80GB, 700 W (data sheet)",
                        "peak_flops": RL.PEAK_FLOPS, "hbm_bw": RL.HBM_BW,
                        "link_bw": RL.LINK_BW}}
    t0 = time.time()
    try:
        c, wshapes, mem = run_fn()
        rec["trace_s"] = round(time.time() - t0, 1)
        coll = RL.collective_bytes(c.collectives)
        flops_dev, bytes_dev = float(c.flops), float(c.bytes)
        coll_dev = float(coll["total_bytes"])
        terms = RL.roofline_terms(flops_dev, bytes_dev, coll_dev)
        n_params = RL.count_params(wshapes)
        n_active = RL.count_active_params(cfg, wshapes)
        tokens = shape.global_batch * (
            shape.seq_len if shape.kind != "decode" else 1)
        mflops = RL.model_flops(cfg, n_params, n_active, tokens, shape.kind)
        rec.update(
            ok=True,
            flops_per_dev=flops_dev, bytes_per_dev=bytes_dev,
            collectives=coll, roofline=terms,
            n_params=n_params, n_active=n_active, tokens=tokens,
            model_flops=mflops,
            useful_flops_ratio=(mflops / (flops_dev * chips)
                                if flops_dev else 0.0),
            memory=dict(mem, temp_bytes=c.peak_temp_bytes),
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    rec["total_s"] = round(time.time() - t0, 1)

    os.makedirs(out_dir, exist_ok=True)
    suffix = f"_{tag}" if tag else ""
    path = os.path.join(out_dir,
                        f"{arch}_{shape_name}_{mesh_kind}{suffix}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=str)
    status = "OK" if rec["ok"] else f"FAIL ({rec.get('error', '?')[:120]})"
    print(f"[dryrun] {arch} x {shape_name} x {mesh_kind}: {status} "
          f"({rec['total_s']}s)")
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", default="pod", choices=["pod", "multipod", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--prob", default=None, choices=[None, "hccs", "softmax"])
    ap.add_argument("--remat", default=None)
    ap.add_argument("--hccs-router", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--profile", default="default", choices=list(PROFILES))
    ap.add_argument("--hot-buffer", type=int, default=0)
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to N layers (default: the config's)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)

    meshes = ["pod", "multipod"] if args.mesh == "both" else [args.mesh]
    # one fake group serves both meshes: the larger one's size
    init_fake_process_group(max(
        int(np.prod(production_mesh_shape(m == "multipod")[0]))
        for m in meshes))
    kw = dict(prob=args.prob, tag=args.tag, remat=args.remat,
              hccs_router=args.hccs_router, profile=args.profile,
              hot_buffer=args.hot_buffer, num_layers=args.layers)
    if args.all:
        cells = [(a, s.name) for a, s, _ in iter_cells(include_skipped=False)]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        cells = [(args.arch, args.shape)]
    return [run_cell(arch, shape, mk, args.out, **kw)
            for arch, shape in cells for mk in meshes]


if __name__ == "__main__":
    recs = main()
    raise SystemExit(0 if all(r["ok"] for r in recs) else 1)
