"""The port's sharding rules, plans, shapes and roofline against the JAX
package's, on the CPU, with no rank and no device.

- Rules, exact, on a duck-typed mesh (16x16 and 2x16x16): every
  parameter leaf of all ten configs at full size (shapes from fake
  tensors on the port's side, ``jax.eval_shape`` on ``repro``'s), with
  ``fsdp`` and ``no_ep`` on and off, gives ``repro``'s spec without its
  leading ``[L]`` entry; the same for every cache leaf (decode_32k,
  long_500k), ``batch_spec`` and ``plan_for`` on every (arch, shape,
  mesh), field by field.
- ``input_specs``, ``cell_supported``, ``model_flops`` and
  ``roofline_report`` (given the same inputs and hardware figures) equal
  ``repro``'s; the collective wire factors equal what ``repro``'s HLO
  parser gives for the same collectives.
- The shard-local MoE dispatch's arithmetic at S = 2 and 4 (EP and
  ``no_ep``) on olmoe_1b_7b's smoke config at capacity factor 1.25 (drops
  on) against ``repro``'s ``moe_dispatch``/``moe_combine`` composed per
  shard, float32 within 1e-6.
- ``shard=True``'s lane mesh: three blocks of lanes on the CPU, with and
  without chunks, bitwise the unsharded run.
"""

import dataclasses

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import jax
import jax.numpy as jnp
from repro import configs as jx_configs
from repro.launch import shapes as jx_shapes
from repro.models import model as jx_model
from repro.models import moe as jx_moe
from repro.parallel import sharding as jx_sharding
from repro.roofline import analysis as jx_analysis
from repro_torch import configs
from repro_torch.core.scenarios import ScenarioSpec, pack_specs
from repro_torch.kernels.registry import resolve_tick_impl
from repro_torch.launch import shapes
from repro_torch.models import model as pt_model
from repro_torch.models import moe
from repro_torch.parallel import sharding
from repro_torch.roofline import analysis
from repro_torch.sim import batched
from repro_torch.sim.jobs import RetryPolicy
from repro_torch.sim.sweep import run_sweep
from torch_threads import one_torch_thread  # noqa: F401


class FakeMesh:
    """Duck-typed mesh: the rules read only shape/axis_names/size."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = int(np.prod(list(shape.values())))


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16})}
PLANS = [dict(fsdp=f, no_ep=n) for f in (False, True) for n in (False, True)]


def _norm(spec, ndim):
    """A spec as a tuple of one entry a dim (jax's P() pads with None; a
    one-axis tuple is that axis, as jax reads it)."""
    t = tuple(a[0] if isinstance(a, tuple) and len(a) == 1 else a
              for a in spec)
    return t + (None,) * (ndim - len(t))


def _jx_paths(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jx_sharding._path_str(p): leaf for p, leaf in flat}


def _port_paths(tree):
    return dict(sharding.tree_paths(tree))


def _jx_key(port_path: str, jx_leaves) -> tuple:
    """``repro``'s leaf for a port path and whether it is stacked: the
    port's ``layers/<i>/...`` is ``repro``'s ``layers/...`` with a leading
    ``[L]``, or the same path where ``repro`` keeps a list."""
    if port_path in jx_leaves:
        return port_path, False
    parts = port_path.split("/")
    for i, p in enumerate(parts):
        if p.isdigit():
            key = "/".join(parts[:i] + parts[i + 1:])
            if key in jx_leaves:
                return key, True
    raise KeyError(port_path)


@pytest.fixture(scope="module")
def shapes_by_arch():
    out = {}
    for arch in configs.ARCHITECTURES:
        cfg, jcfg = configs.get_config(arch), jx_configs.get_config(arch)
        with FakeTensorMode():
            pt = {k: tuple(v.shape) for k, v in
                  _port_paths(pt_model.init_params(cfg, device="cpu")).items()}
        jx = {k: tuple(v.shape) for k, v in _jx_paths(jax.eval_shape(
            lambda: jx_model.init_params(jcfg, jax.random.PRNGKey(0)))).items()}
        out[arch] = (pt, jx)
    return out


@pytest.mark.parametrize("arch", configs.ARCHITECTURES)
def test_param_specs_equal_repro_without_the_layer_entry(arch, shapes_by_arch):
    pt, jx = shapes_by_arch[arch]
    assert len(pt) >= len(jx)
    for mesh in MESHES.values():
        for kw in PLANS:
            plan = sharding.ParallelPlan(**kw)
            jplan = jx_sharding.ParallelPlan(**kw)
            jspecs = {k: _norm(jx_sharding.spec_for_param(k, s, mesh, jplan),
                               len(s)) for k, s in jx.items()}
            for path, shape in pt.items():
                key, stacked = _jx_key(path, jx)
                assert jx[key][1 if stacked else 0:] == shape, path
                want = jspecs[key][1:] if stacked else jspecs[key]
                got = _norm(sharding.spec_for_param(path, shape, mesh, plan),
                            len(shape))
                assert got == want, (arch, path, kw, mesh.shape)


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
def test_cache_specs_equal_repro(shape_name):
    batch = jx_shapes.SHAPES[shape_name]["batch"]
    S = jx_shapes.decode_cache_len(shape_name)
    for arch in configs.ARCHITECTURES:
        cfg, jcfg = configs.get_config(arch), jx_configs.get_config(arch)
        with FakeTensorMode():
            pc = pt_model.init_cache(cfg, batch, S, "cpu")
            if cfg.is_enc_dec:
                ck = (batch, 4096, cfg.n_kv_heads, cfg.hd)
                pc["cross_kv"] = [(torch.empty(ck), torch.empty(ck))
                                  for _ in range(cfg.n_layers)]
            pt = {k: tuple(v.shape) for k, v in _port_paths(pc).items()}
        jc = jax.eval_shape(lambda: jx_model.init_cache(jcfg, batch, S))
        if cfg.is_enc_dec:
            ck = jax.ShapeDtypeStruct((cfg.n_layers,) + ck, jnp.bfloat16)
            jc["cross_kv"] = (ck, ck)
        jleaves = _jx_paths(jc)
        for mname, mesh in MESHES.items():
            jplan = jx_sharding.plan_for(jcfg, shape_name, mesh)
            plan = sharding.plan_for(cfg, shape_name, mesh)
            got = dict(_spec_paths(sharding.cache_shardings(mesh, plan, cfg,
                                                            pc)))
            for path, shape in pt.items():
                if path.startswith("cross_kv/"):
                    jpath, stacked = "cross_kv/" + path.split("/")[2], True
                else:
                    jpath, stacked = _jx_key(path, jleaves)
                jshape = tuple(jleaves[jpath].shape)
                want = _norm(_jx_cache_spec(jpath, jshape, mesh, jplan, jcfg),
                             len(jshape))
                want = want[1:] if stacked else want
                assert _norm(got[path], len(shape)) == want, (
                    arch, path, mname)


def _spec_paths(tree, prefix=""):
    if isinstance(tree, sharding.PartitionSpec):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_paths(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _spec_paths(v, f"{prefix}{i}/")


def _jx_cache_spec(path, shape, mesh, plan, cfg):
    """``repro``'s ``cache_shardings`` rule for one leaf, on the duck-typed
    mesh (its function wraps the spec in a ``NamedSharding``, which needs
    devices)."""
    captured = {}

    class NS:
        def __init__(self, m, spec):
            captured["spec"] = spec

    tree = {}
    node = tree
    keys = path.split("/")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    node[keys[-1]] = jax.ShapeDtypeStruct(shape, jnp.float32)
    orig = jx_sharding.NamedSharding
    jx_sharding.NamedSharding = NS
    try:
        jx_sharding.cache_shardings(mesh, plan, cfg, tree)
    finally:
        jx_sharding.NamedSharding = orig
    return captured["spec"]


def test_batch_spec_and_plans_equal_repro():
    for mesh in MESHES.values():
        for b in (1, 2, 4, 16, 32, 128, 256, 512, 48):
            assert _norm(sharding.batch_spec(mesh, b), 1) == _norm(
                jx_sharding.batch_spec(mesh, b), 1), b
        for arch in configs.ARCHITECTURES:
            cfg, jcfg = configs.get_config(arch), jx_configs.get_config(arch)
            for shape_name in shapes.SHAPES:
                got = sharding.plan_for(cfg, shape_name, mesh)
                want = jx_sharding.plan_for(jcfg, shape_name, mesh)
                for f in dataclasses.fields(want):
                    assert getattr(got, f.name) == getattr(want, f.name), (
                        arch, shape_name, f.name)
                assert ({f.name for f in dataclasses.fields(got)}
                        == {f.name for f in dataclasses.fields(want)})


def test_plan_without_a_mesh_keeps_the_single_card_rules():
    for arch in configs.ARCHITECTURES:
        cfg = configs.get_config(arch)
        plan = sharding.plan_for(cfg)
        assert (plan.fsdp, plan.microbatches, plan.grad_accum_dtype) == (
            False, 1, "bf16")


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    mesh.mesh_dim_names = None  # duck-typed: read through shape
    P = sharding.P
    assert sharding.placements(P(("pod", "data"), "model"), mesh) == (
        Shard(0), Shard(0), Shard(1))
    assert sharding.placements(P(None, None, "model"), mesh) == (
        Replicate(), Replicate(), Shard(2))
    assert sharding.placements(P(), mesh) == (Replicate(),) * 3
    assert sharding.local_shape((64, 32), P(("pod", "data"), "model"),
                                mesh) == (2, 2)


# ------------------------------------------------------ shapes and roofline
def test_input_specs_and_cell_support_equal_repro():
    for arch in configs.ARCHITECTURES:
        cfg, jcfg = configs.get_config(arch), jx_configs.get_config(arch)
        for shape_name in shapes.SHAPES:
            assert shapes.cell_supported(arch, shape_name) == \
                jx_shapes.cell_supported(arch, shape_name)
            got = shapes.input_specs(cfg, shape_name)
            want = jx_shapes.input_specs(jcfg, shape_name)
            assert set(got) == set(want)
            for k in want:
                assert got[k].shape == tuple(want[k].shape), (arch, k)
                assert str(got[k].dtype).split(".")[-1] == \
                    jnp.dtype(want[k].dtype).name, (arch, k)
            assert shapes.decode_cache_len(shape_name) == \
                jx_shapes.decode_cache_len(shape_name)
    assert shapes.SHAPES == jx_shapes.SHAPES
    assert shapes.LONG_CONTEXT_OK == jx_shapes.LONG_CONTEXT_OK


def test_model_flops_and_roofline_report_equal_repro():
    jhw = jx_analysis.HW(peak_flops=analysis.HW().peak_flops,
                         hbm_bw=analysis.HW().hbm_bw,
                         ici_bw=analysis.HW().link_bw)
    for arch in configs.ARCHITECTURES:
        cfg, jcfg = configs.get_config(arch), jx_configs.get_config(arch)
        for shape_name, shape in shapes.SHAPES.items():
            kind = shape["kind"]
            assert analysis.model_flops(kind, cfg, shape) == \
                jx_analysis.model_flops(kind, jcfg, shape)
            for flops, nbytes, wire in ((3.2e14, 1.1e12, 7e10), (0.0, 5e9, 0.0)):
                got = analysis.roofline_report(
                    kind, cfg, shape, 256, flops, nbytes,
                    {"total_wire_bytes": wire})
                want = jx_analysis.roofline_report(
                    kind, jcfg, shape, 256, flops, nbytes,
                    {"total_wire_bytes": wire}, hw=jhw)
                assert got == want


def test_hw_is_the_h100_datasheet():
    hw = analysis.HW()
    assert (hw.peak_flops, hw.hbm_bw, hw.link_bw, hw.nvlink_bw) == (
        989.4e12, 3.35e12, 50e9, 450e9)


@pytest.mark.parametrize("n", [2, 4, 16, 256])
@pytest.mark.parametrize("kind", analysis.KINDS)
def test_wire_factors_equal_repro_parser(kind, n):
    groups = "{" + ",".join(str(i) for i in range(n)) + "}"
    line = (f"  %x = bf16[1024,256]{{1,0}} {kind}(bf16[1024,256] %p), "
            f"replica_groups={{{groups}}}")
    want = jx_analysis.collective_bytes(line)
    got = analysis.collective_bytes([{"kind": kind, "bytes": 1024 * 256 * 2,
                                      "group_size": n}])
    assert got["per_kind"] == pytest.approx(want["per_kind"], rel=1e-15)
    assert got["count"] == want["count"]
    assert got["total_wire_bytes"] == pytest.approx(want["total_wire_bytes"],
                                                    rel=1e-15)


# ------------------------------------------------------- local dispatch
def _olmoe_inputs(T: int, seed: int = 0):
    cfg = configs.get_smoke_config("olmoe_1b_7b").replace(
        dtype=torch.float32, capacity_factor=1.25)
    jcfg = jx_configs.get_smoke_config("olmoe_1b_7b").replace(
        dtype=jnp.float32, capacity_factor=1.25)
    rng = np.random.default_rng(seed)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    w = {"w_gate": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_up": rng.normal(size=(E, d, f)) / np.sqrt(d),
         "w_down": rng.normal(size=(E, f, d)) / np.sqrt(f)}
    w = {k: v.astype(np.float32) for k, v in w.items()}
    x = rng.normal(size=(T, d)).astype(np.float32)
    logits = rng.normal(size=(T, E)).astype(np.float32)
    logits[:, 0] += 1.0  # a favoured expert: its shards overflow
    gates, idx, _ = jx_moe.router_topk(jnp.asarray(logits), cfg.top_k)
    return cfg, jcfg, w, x, np.array(gates), np.array(idx)


def _jx_local(jcfg, w, x, gates, idx, S):
    """``repro``'s dispatch, expert FFNs and combine, one shard at a time."""
    T, d = x.shape
    t_loc = T // S
    cap = max(int((t_loc * jcfg.top_k / jcfg.n_experts) * jcfg.capacity_factor)
              + 1, min(t_loc, 4))
    outs = []
    for s in range(S):
        sl = slice(s * t_loc, (s + 1) * t_loc)
        buf, e, p = jx_moe.moe_dispatch(jnp.asarray(x[sl]), jnp.asarray(idx[sl]),
                                        cap, jcfg.n_experts)
        h = jnp.einsum("ecd,edf->ecf", buf, w["w_gate"])
        u = jnp.einsum("ecd,edf->ecf", buf, w["w_up"])
        eo = jnp.einsum("ecf,efd->ecd", jax.nn.silu(h) * u, w["w_down"])
        outs.append(jx_moe.moe_combine(eo, jnp.asarray(gates[sl]), e, p))
    return np.asarray(jnp.concatenate(outs))


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("no_ep", [False, True])
def test_local_dispatch_matches_repro_per_shard(S, no_ep):
    cfg, jcfg, w, x, gates, idx = _olmoe_inputs(T=64)
    want = _jx_local(jcfg, w, x, gates, idx, S)
    pw = {k: torch.from_numpy(v) for k, v in w.items()}
    got = moe.local_dispatch(pw, cfg, torch.from_numpy(x),
                             torch.from_numpy(gates),
                             torch.from_numpy(idx).long(), S, no_ep=no_ep)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # drops are on: some assignment overflowed its shard's capacity
    t_loc = 64 // S
    cap = moe.local_capacity(cfg, t_loc)
    counts = np.stack([np.bincount(idx[s * t_loc:(s + 1) * t_loc].ravel(),
                                   minlength=cfg.n_experts) for s in range(S)])
    assert counts.max() > cap
    assert moe.local_dispatch(pw, cfg, torch.from_numpy(x)[:63],
                              torch.from_numpy(gates)[:63],
                              torch.from_numpy(idx)[:63].long(), S) is None


# --------------------------------------------------------------- lane mesh
def test_lane_mesh_blocks_are_bitwise_the_unsharded_run(monkeypatch):
    specs = [ScenarioSpec(base="III", cache_tb=c, days=0.05, n_files=300,
                          seed=s) for c in (5.0, 20.0) for s in (1, 2, 3)]
    grid = pack_specs(specs, tick=60.0)
    impl = resolve_tick_impl("torch", "cpu")
    whole = batched.simulate_packed(grid, tick_impl="torch", device="cpu")
    mesh = sharding.lane_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {"lanes": 4} and mesh.axis_names == ("lanes",)
    monkeypatch.setattr(batched, "lane_mesh", lambda device_type: mesh)
    # 6 lanes: blocks of 2 on three devices; chunks of 3: blocks of 1
    for chunk, blocks in ((None, 3), (3, 6)):
        devs, block = batched._lane_mesh_run(torch.device("cpu"), chunk)
        assert devs == list(mesh.devices)
        got, _, _, n = batched._simulate(grid, impl, devs, False, None, block)
        assert n == blocks
        sh = batched.simulate_packed(grid, tick_impl="torch", device="cpu",
                                     shard=True, lane_chunk=chunk)
        for k, want in whole.items():
            np.testing.assert_array_equal(got[k], want, err_msg=k)
            np.testing.assert_array_equal(sh[k], want, err_msg=k)
    # the job path runs each chunk over the mesh in its runner
    plain = run_sweep(specs, tick=60.0, device="cpu")
    jobs = run_sweep(specs, tick=60.0, device="cpu", shard=True, lane_chunk=3,
                     retry=RetryPolicy())
    for a, b in zip(jobs.results, plain.results):
        assert a.metrics == b.metrics
    assert sharding.lane_mesh(device_type="cpu").size == 1
    with pytest.raises(ValueError, match="not both"):
        sharding.lane_mesh(2, devices=["cpu"])
    with pytest.raises(ValueError, match="at least one"):
        sharding.lane_mesh(devices=[])
