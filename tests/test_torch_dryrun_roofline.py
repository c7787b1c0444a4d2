"""The twin of tests/test_dryrun_roofline.py for the port's multi-device
layer: collective counting on DTensor redistributions, the roofline math,
sharding-rule resolution and the spec trees (equal to JAX's entry for
entry), the local shard each mesh coordinate holds (equal to JAX's
NamedSharding layout), the FLOP counter on local shards, the dry-run's
inputs and grid (equal to JAX's), the meshes, a sharded checkpoint
restore. The two mini dry-run cells and inspect_hlo run in subprocesses in
test_torch_dryrun_subprocess.py.

Every mesh here lies over torch's fake process group: collectives move
nothing and the local shards are meta or small CPU tensors. A test that
needs one initializes it through `fake_group` and destroys it after.
"""
import torch_threads  # noqa: F401  (first: one torch thread a worker)
import contextlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.launch import roofline as RL
from repro_torch.parallel import sharding as SH

ROOT = Path(__file__).resolve().parents[1]


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(int(np.prod(shape))).reshape(shape),
                      mesh_dim_names=names)


def _dt(shape, mesh, placements, dtype=torch.float32):
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(torch.empty(shape, dtype=dtype, device="meta"),
                             mesh, placements, src_data_rank=None)


# ------------------------------------------------------------ collectives --

def test_collective_bytes_of_hand_made_redistributions():
    """On a fake (4, 2) mesh: Shard -> Replicate over data is one
    all-gather of the gathered bytes, Partial -> Replicate one all-reduce,
    Partial -> Shard one reduce-scatter, Shard(0) -> Shard(1) over data
    one all-to-all (the mesh names the card's device type, as the dry-run's
    does), each counted by kind with its result bytes."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    with fake_group(8):
        mesh = _mesh((4, 2), ("data", "model"))
        mesh_nccl = __import__("torch.distributed.device_mesh",
                               fromlist=["DeviceMesh"]).DeviceMesh(
            "cuda", torch.arange(8).reshape(4, 2),
            mesh_dim_names=("data", "model"))
        x = _dt((64, 32), mesh, [Shard(0), Replicate()])
        p = _dt((64, 32), mesh, [Partial(), Replicate()])
        y = _dt((64, 32), mesh_nccl, [Shard(0), Replicate()])
        with RL.TraceCounter() as c:
            x.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Replicate(), Replicate()])
            p.redistribute(mesh, [Shard(0), Replicate()])
            y.redistribute(mesh_nccl, [Shard(1), Replicate()])
    out = RL.collective_bytes(c.collectives)
    assert out["all-gather"] == {"bytes": 64 * 32 * 4, "count": 1}
    assert out["all-reduce"] == {"bytes": 64 * 32 * 4, "count": 1}
    assert out["reduce-scatter"] == {"bytes": 16 * 32 * 4, "count": 1}
    assert out["all-to-all"] == {"bytes": 64 * 8 * 4, "count": 1}
    assert out["collective-permute"] == {"bytes": 0, "count": 0}
    assert out["total_bytes"] == sum(out[k]["bytes"] for k in RL.COLLECTIVES)
    assert [(k, s) for k, _, s in c.collectives] == [
        ("all-gather", "float32[64, 32]"), ("all-reduce", "float32[64, 32]"),
        ("reduce-scatter", "float32[16, 32]"),
        ("all-to-all", "float32[64, 8]")]
    assert RL.collective_kind("_c10d_functional.wait_tensor.default") is None
    assert RL.collective_kind("aten.mm.default") is None


@pytest.mark.parametrize("case", ["sharded", "replicated"])
def test_flop_counter_counts_the_local_shards(case):
    """torch's FlopCounterMode around DTensor ops counts the GLOBAL product
    (the trap); TraceCounter counts each device's: an evenly sharded
    product gives its global FLOPs over the shard count (forward and the
    input gradient), a replicated one its whole FLOPs on every device."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.utils.flop_counter import FlopCounterMode
    m, k, n = 256, 64, 32
    with fake_group(8):
        mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
        pl = ([Shard(0)] * 3 if case == "sharded" else [Replicate()] * 3)
        x = _dt((m, k), mesh, pl).requires_grad_()
        w = _dt((k, n), mesh, [Replicate()] * 3)
        with FlopCounterMode(display=False) as fc:
            x @ w
        with RL.TraceCounter() as c:
            y = x @ w
        with RL.TraceCounter() as cb:
            (gx,) = torch.autograd.grad(y, x, torch.ones_like(y))
    glob = 2 * m * k * n
    assert fc.get_total_flops() == glob
    shards = 8 if case == "sharded" else 1
    assert c.flops == glob // shards
    assert cb.flops == glob // shards
    assert gx.placements == x.placements


# ----------------------------------------------------------- roofline math --

class TestRooflineMath:
    def test_terms_and_dominance(self):
        t = RL.roofline_terms(flops_per_dev=989e12, bytes_per_dev=0.0,
                              coll_bytes_per_dev=0.0)
        assert t["compute_s"] == pytest.approx(1.0)
        assert t["dominant"] == "compute"
        assert t["roofline_fraction"] == pytest.approx(1.0)
        t = RL.roofline_terms(1e12, 3.35e12 * 2, 0.0)
        assert t["dominant"] == "memory"
        assert t["step_s_lower_bound"] == pytest.approx(2.0)
        t = RL.roofline_terms(1e12, 0.0, 450e9 * 3)
        assert t["dominant"] == "collective"
        assert t["collective_s"] == pytest.approx(3.0)

    def test_model_flops(self):
        from repro_torch.configs import get_config
        cfg = get_config("granite-3-2b")
        assert RL.model_flops(cfg, 1e9, 1e9, 1000, "train") == 6e12
        assert RL.model_flops(cfg, 1e9, 1e9, 1000, "prefill") == 2e12
        moe = get_config("qwen3-moe-235b-a22b")
        assert RL.model_flops(moe, 10e9, 2e9, 100, "train") == 6 * 2e9 * 100

    def test_active_params_moe(self):
        """The port's counts on its meta param shapes equal JAX's on
        eval_shape of its init; experts are discounted by k/E."""
        import jax
        from repro.configs import reduced_config as jax_reduced
        from repro.launch import roofline as JRL
        from repro.models import model as JM
        from repro_torch.configs import reduced_config
        from repro_torch.models import model as M
        cfg, jcfg = (reduced_config("granite-moe-1b-a400m"),
                     jax_reduced("granite-moe-1b-a400m"))
        shapes = M.param_shapes(cfg)["weights"]
        jshapes = jax.eval_shape(
            lambda: JM.init_params(jax.random.PRNGKey(0), jcfg))["weights"]
        total = RL.count_params(shapes)
        active = RL.count_active_params(cfg, shapes)
        assert total == JRL.count_params(jshapes)
        assert active == JRL.count_active_params(jcfg, jshapes)
        assert active < total


# -------------------------------------------------------- sharding rules --

def _jax_mesh(names):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(names)),
                names)


class TestShardingRules:
    def test_duplicate_axis_dropped(self):
        from repro.parallel import sharding as JSH
        with fake_group(1):
            mesh = _mesh((1, 1), ("data", "model"))
            with SH.use_rules(mesh, {"seq_act": "model"}):
                s = SH.spec("batch", "seq_act", "model")
        with JSH.use_rules(_jax_mesh(("data", "model")), {"seq_act": "model"}):
            js = JSH.spec("batch", "seq_act", "model")
        # both seq_act and model resolve to "model"; the second is dropped
        assert s[1] == "model" and s[2] is None
        assert s == tuple(js)

    def test_missing_mesh_axis_ignored(self):
        from repro.parallel import sharding as JSH
        with fake_group(1):
            mesh = _mesh((1, 1), ("data", "model"))
            with SH.use_rules(mesh):
                s = SH.spec("batch")       # ("pod","data") -> pod absent
        with JSH.use_rules(_jax_mesh(("data", "model"))):
            js = JSH.spec("batch")
        assert s[0] in ("data", ("data",))
        assert s == tuple(js)
        assert SH.spec("batch", "model") == (None, None)   # no rules

    def test_param_rules_cover_all_archs(self):
        """For every arch of the registry, outside any rules and under both
        production meshes' axis names: the port's spec tree equals JAX's
        param_spec_tree leaf for leaf, the leaves matched by the checkpoint
        key bridge (both packages' keystr paths)."""
        import jax
        from jax.sharding import PartitionSpec
        from repro.configs import ARCH_IDS
        from repro.configs import reduced_config as jax_reduced
        from repro.models import model as JM
        from repro.parallel import sharding as JSH
        from repro_torch.checkpoint.manager import _flatten
        from repro_torch.configs import reduced_config
        from repro_torch.models import model as M
        names_set = [None, ("data", "model"), ("pod", "data", "model")]
        with fake_group(1):
            for arch in ARCH_IDS:
                shapes = M.param_shapes(reduced_config(arch))
                jshapes = jax.eval_shape(
                    lambda c=jax_reduced(arch): JM.init_params(
                        jax.random.PRNGKey(0), c))
                for names in names_set:
                    ctx = (contextlib.nullcontext(), contextlib.nullcontext())
                    if names:
                        ctx = (SH.use_rules(_mesh((1,) * len(names), names)),
                               JSH.use_rules(_jax_mesh(names)))
                    with ctx[0]:
                        specs = SH.param_spec_tree(shapes)
                    with ctx[1]:
                        jspecs = JSH.param_spec_tree(jshapes)
                    port = _flatten(specs, is_leaf=lambda x: isinstance(
                        x, tuple))
                    ref = {jax.tree_util.keystr(p): tuple(s) for p, s in
                           jax.tree_util.tree_flatten_with_path(
                               jspecs, is_leaf=lambda x: isinstance(
                                   x, PartitionSpec))[0]}
                    assert port == ref, (arch, names)
                    assert len(port) == len(jax.tree.leaves(jshapes))


def test_bytes_per_device_matches_jax():
    """Parameter bytes per device under the rules on a (4, 2) mesh equal
    JAX's for every arch (JAX's function reads only the mesh's axis names
    and shape, so a stand-in carries them)."""
    import types

    import jax
    from repro.configs import ARCH_IDS
    from repro.configs import reduced_config as jax_reduced
    from repro.models import model as JM
    from repro.parallel import sharding as JSH
    from repro_torch.configs import reduced_config
    from repro_torch.models import model as M
    names = ("data", "model")
    jmesh = types.SimpleNamespace(axis_names=names,
                                  devices=np.empty((4, 2)))
    with fake_group(8):
        mesh = _mesh((4, 2), names)
        for arch in ARCH_IDS:
            shapes = M.param_shapes(reduced_config(arch))
            jshapes = jax.eval_shape(lambda c=jax_reduced(arch): (
                JM.init_params(jax.random.PRNGKey(0), c)))
            with SH.use_rules(mesh):
                got = SH.bytes_per_device(shapes, mesh)
            with JSH.use_rules(jmesh):
                want = JSH.bytes_per_device(jshapes, jmesh)
            assert got == pytest.approx(want, rel=1e-12), arch


def test_meshes_take_jax_shapes_and_never_shrink(monkeypatch):
    """make_production_mesh / make_debug_mesh: JAX's shapes and axis names
    on the default process group; REPRO_MESH replaces the (data, model)
    part; fewer ranks than the mesh needs raise, as JAX's does, and no
    process group raises too."""
    from repro_torch.launch import mesh as MESH
    monkeypatch.delenv("REPRO_MESH", raising=False)
    with pytest.raises(RuntimeError, match="process group"):
        MESH.make_production_mesh()
    assert MESH.production_mesh_shape() == ((16, 16), ("data", "model"))
    assert MESH.production_mesh_shape(True) == (
        (2, 16, 16), ("pod", "data", "model"))
    with fake_group(8):
        with pytest.raises(RuntimeError, match="need 256 ranks"):
            MESH.make_production_mesh(device_type="cpu")
        monkeypatch.setenv("REPRO_MESH", "4,2")
        m = MESH.make_production_mesh(device_type="cpu")
        assert tuple(m.mesh.shape) == (4, 2)
        assert m.mesh_dim_names == ("data", "model")
        with pytest.raises(RuntimeError, match="need 16 ranks"):
            MESH.make_production_mesh(multi_pod=True, device_type="cpu")
        d = MESH.make_debug_mesh(pod=2, device_type="cpu")
        assert tuple(d.mesh.shape) == (2, 2, 2)
        assert d.mesh_dim_names == ("pod", "data", "model")


# the JAX side of the layout test: each device's index into an (8, 12)
# array under three specs on a (2, 2, 2) mesh of 8 host devices
_JAX_LAYOUT = """
import json, os
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
mesh = Mesh(np.asarray(jax.devices()).reshape(2, 2, 2),
            ("pod", "data", "model"))
out = []
for spec in SPECS:
    idx = NamedSharding(mesh, P(*spec)).devices_indices_map((8, 12))
    out.append({d.id: [[s.start, s.stop] for s in sl]
                for d, sl in idx.items()})
print(json.dumps(out))
"""
LAYOUT_SPECS = [(("pod", "data"), "model"), ("data", None),
                (None, ("data", "model"))]


def test_local_shards_match_jax_layout():
    """Every mesh coordinate's local shard of DTensor under to_placements(
    spec) is the slice JAX's NamedSharding puts on that device, for a dim
    sharded over two mesh axes (major to minor), over one, and a second
    dim over two; rank r of the DeviceMesh and device r of the jax Mesh
    stand at the same coordinate."""
    from torch.distributed.tensor import distribute_tensor
    code = _JAX_LAYOUT.replace("SPECS", repr(LAYOUT_SPECS))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr[-2000:]
    ref = json.loads(res.stdout.strip().splitlines()[-1])
    x = torch.arange(96, dtype=torch.float32).reshape(8, 12)
    for rank in range(8):
        with fake_group(8, rank):
            mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
            for spec_, idx in zip(LAYOUT_SPECS, ref):
                local = distribute_tensor(x, mesh, SH.to_placements(
                    spec_, mesh), src_data_rank=None).to_local()
                (r0, r1), (c0, c1) = [
                    (a if a is not None else 0, b if b is not None else n)
                    for (a, b), n in zip(idx[str(rank)], (8, 12))]
                assert torch.equal(local, x[r0:r1, c0:c1]), (rank, spec_)
    with fake_group(8):
        mesh = _mesh((2, 2, 2), ("pod", "data", "model"))
        with pytest.raises(ValueError, match="mesh's axis order"):
            SH.to_placements((("data", "pod"),), mesh)


def test_constrain_redistributes_dtensors_under_rules():
    """Under use_rules a DTensor is redistributed to the resolved
    placements; outside them, and for a plain tensor, the argument itself
    comes back."""
    from torch.distributed.tensor import Replicate, Shard
    with fake_group(8):
        mesh = _mesh((4, 2), ("data", "model"))
        x = _dt((8, 4, 6), mesh, [Replicate(), Replicate()])
        assert SH.constrain(x, "batch", None, "model") is x
        plain = torch.zeros(2)
        with SH.use_rules(mesh):
            y = SH.constrain(x, "batch", None, "model")
            assert SH.constrain(plain, "batch") is plain
        assert tuple(y.placements) == (Shard(0), Shard(2))
        assert y.to_local().shape == (2, 4, 3)


# --------------------------------------------------------- dry-run inputs --

def test_input_specs_and_iter_cells_match_jax():
    """Over the whole grid (every arch x shape, skipped cells included):
    the same (arch, shape, applicable) triples, and every cell's meta
    inputs have JAX's keys, shapes and dtypes, mrope_positions (3, b, t)
    included."""
    import jax.numpy as jnp
    from repro.configs import get_config as jax_get
    from repro.configs import input_specs as jax_specs
    from repro.configs import iter_cells as jax_cells
    from repro_torch.configs import SHAPES, get_config, input_specs, \
        iter_cells
    from repro_torch.configs.shapes import LONG_CONTEXT_FAMILIES
    from repro.configs.shapes import LONG_CONTEXT_FAMILIES as J_LCF
    assert LONG_CONTEXT_FAMILIES == J_LCF
    port = [(a, s, ok) for a, s, ok in iter_cells(include_skipped=True)]
    ref = list(jax_cells(include_skipped=True))
    assert [(a, s.name, ok) for a, s, ok in port] == [
        (a, s.name, ok) for a, s, ok in ref]
    assert [(a, s.name) for a, s, _ in iter_cells()] == [
        (a, s.name) for a, s, _ in jax_cells()]
    for (arch, shape, _), (_, jshape, _) in zip(port, ref):
        assert (shape.seq_len, shape.global_batch, shape.kind) == (
            jshape.seq_len, jshape.global_batch, jshape.kind)
        got = input_specs(get_config(arch), SHAPES[shape.name])
        want = jax_specs(jax_get(arch), jshape)
        assert got.keys() == want.keys(), arch
        for k in got:
            assert got[k].device.type == "meta"
            assert tuple(got[k].shape) == tuple(want[k].shape), (arch, k)
            assert str(got[k].dtype).removeprefix("torch.") == \
                jnp.dtype(want[k].dtype).name, (arch, k)


# --------------------------------------------------------- sharded restore --

def test_sharded_restore_on_a_fake_4_rank_mesh(tmp_path):
    """A checkpoint restored with shardings on a fake (2, 2) mesh: every
    rank's DTensor holds its own slice of the saved array under the
    placements asked for (Shard over both axes, Shard over one, and a
    replicated leaf), with the global shape; bf16 leaves keep their bits;
    None leaves restore as plain tensors; no collective runs."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.checkpoint import CheckpointManager
    rng = np.random.default_rng(0)
    tree = {"w": torch.from_numpy(rng.normal(size=(6, 8)).astype(np.float32)),
            "b": torch.from_numpy(rng.normal(size=(5,)).astype(
                np.float32)).to(torch.bfloat16),
            "s": torch.tensor(3, dtype=torch.int32)}
    CheckpointManager(str(tmp_path)).save(7, tree)
    for rank in range(4):
        with fake_group(4, rank):
            mesh = _mesh((2, 2), ("data", "model"))
            sh = {"w": SH.NamedSharding(mesh, (Shard(0), Shard(1))),
                  "b": SH.NamedSharding(mesh, (Shard(0), Replicate())),
                  "s": None}
            with RL.TraceCounter() as c:
                out, manifest = CheckpointManager(str(tmp_path)).restore(
                    tree, shardings=sh)
            assert c.collectives == [] and manifest["step"] == 7
            i, j = divmod(rank, 2)
            assert out["w"].shape == (6, 8)
            assert torch.equal(out["w"].to_local(),
                               tree["w"][3 * i:3 * i + 3, 4 * j:4 * j + 4])
            lo, hi = (0, 3) if i == 0 else (3, 5)    # uneven: chunk
            assert out["b"].to_local().dtype == torch.bfloat16
            assert torch.equal(out["b"].to_local(), tree["b"][lo:hi])
            assert not SH.is_dtensor(out["s"]) and int(out["s"]) == 3
