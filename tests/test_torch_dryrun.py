"""The shape-only dry run of the production meshes
(``repro_torch/launch/dryrun.py``) on the CPU, at small shapes.

* Argument bytes: the rank's inputs on ``meta`` (``dryrun.rank_inputs``:
  its parameter slices, AdamW's slots in train, its rows, its cache
  slices and the position in decode) at the 16 x 16 and 2 x 16 x 16
  meshes, for one config of each family (``ARG_ARCHS``: MoE with MLA,
  dense with a cut MQA head, hybrid, SSM, VLM, audio; every config's
  specs are held entry for entry against the reference's in
  ``tests/test_torch_tp.py::test_specs_match_jax``) and the four input
  shapes, equal the bytes of
  the shards of the JAX package's ``param_specs``/``batch_specs``/
  ``cache_specs`` (and ``param_specs`` of AdamW's state) on the same
  meshes, but the reference's 4-byte step counter (the port keeps it as a
  Python int).
* Every coordinate of a (2, 2) and a (1, 4) mesh gives the same counts
  (flops, collectives, bytes, argument, output and peak bytes).
* Depth: the counts extrapolated from the lead layers plus 1 and plus 2
  equal the full-depth pass's at 5 layers, every one of them, the peak
  within ``PEAK_SLACK`` bytes (a maximum, not a sum: its moment holds a
  few scalars that do not grow with depth).
* The peak tracker (``obs/memory.py::LiveStorage``) reads the same
  arguments and high-water mark on a real CPU train step as on the
  ``meta`` pass of the same step.
* The decode kernel's routes: on the CPU its plain version (bitwise the
  reference function), on ``meta`` empty outputs of its shapes with no
  launch counted; the plain version's counted products are the kernel's
  count (``decode_flops``), which the dry run adds on ``meta``.
* The collectives on an abstract mesh: counted as a real rank counts them,
  ``meta`` results of the real shapes, and any other tensor refused.
* ``_parse_opts`` and the record's keys.

The ranks that really run are held against the pass in
``tests/test_torch_tp.py`` and ``tests/test_torch_tp_train.py``, in their
launches. The module runs in one torch thread.
"""
import dataclasses
import math
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_arch as j_get_arch
from repro.launch import sharding as j_sharding
from repro.launch.input_specs import input_specs as j_input_specs
from repro.models.transformer import model as jm
from repro.train import optimizer as j_opt
from repro_torch.configs import get_arch
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.input_specs import INPUT_SHAPES, batch_struct, input_specs
from repro_torch.launch.input_specs import cache_struct
from repro_torch.models.transformer import model as tm
from repro_torch.obs.memory import LiveStorage
from repro_torch.train.optimizer import adamw

B, S, CTX = 4, 32, 64
#: one config of each family
ARG_ARCHS = ["deepseek-v2-lite-16b", "granite-20b", "hymba-1.5b",
             "mamba2-2.7b", "llava-next-mistral-7b", "musicgen-medium"]
#: bytes the extrapolated peak may lie off the full-depth one
PEAK_SLACK = 64


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _small(arch, layers=None):
    cfg = get_arch(arch).reduced()
    return dataclasses.replace(cfg, num_layers=layers) if layers else cfg


def _inputs(cfg, kind):
    """(global batch, caches, pos) on ``meta`` at the small shapes."""
    if kind != "decode":
        return batch_struct(cfg, B, S + cfg.num_patches, "meta"), None, None
    tok = (B, 1) + ((cfg.num_codebooks,) if cfg.num_codebooks else ())
    return ({"tokens": torch.empty(tok, dtype=torch.int32, device="meta")},
            cache_struct(cfg, B, CTX, "meta"),
            torch.empty((), dtype=torch.int32, device="meta"))


def _pass(cfg, kind, mesh):
    batch, caches, pos = _inputs(cfg, kind)
    out = dryrun.rank_pass(cfg, kind, mesh, batch, caches=caches, pos=pos)
    out.pop("t_trace_s")
    return out


# --------------------------------------------------------------------- #
# argument bytes against the reference's specs
# --------------------------------------------------------------------- #
def _shard_bytes(sds_tree, spec_tree, mesh) -> int:
    """Bytes of one device's shards of a tree of ``ShapeDtypeStruct``s
    under a tree of ``PartitionSpec``s."""
    is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
    specs = jax.tree_util.tree_leaves(spec_tree, is_leaf=is_p)
    leaves = jax.tree_util.tree_leaves(sds_tree)
    assert len(specs) == len(leaves)
    total = 0
    for leaf, spec in zip(leaves, specs):
        entries = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        n = 1
        for dim, e in zip(leaf.shape, entries):
            axes = () if e is None else (e,) if isinstance(e, str) else e
            n *= dim // math.prod(mesh.shape[a] for a in axes)
        total += n * leaf.dtype.itemsize
    return total


@pytest.mark.parametrize("arch", ARG_ARCHS)
def test_argument_bytes_are_the_reference_specs_shards(arch):
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    params = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jcfg))
    opt = jax.eval_shape(j_opt.adamw(1e-3).init, params)
    for multi in (False, True):
        mesh = mesh_mod.abstract_mesh(mesh_mod.production_shape(multi))
        jmesh = SimpleNamespace(shape=dict(mesh.shape),
                                axis_names=mesh.axis_names)
        p_bytes = _shard_bytes(params, j_sharding.param_specs(jcfg, params,
                                                              jmesh), jmesh)
        o_bytes = _shard_bytes(opt.slots, j_sharding.param_specs(
            jcfg, opt, jmesh).slots, jmesh)
        for shape_name, shape in INPUT_SHAPES.items():
            ji = j_input_specs(jcfg, shape_name)
            want = p_bytes + _shard_bytes(
                ji["batch"], j_sharding.batch_specs(jcfg, ji["batch"], jmesh),
                jmesh)
            if shape.kind == "train":
                want += o_bytes
            if shape.kind == "decode":
                vcfg = ji["cfg"]
                want += 4 + _shard_bytes(  # pos: one int32
                    ji["caches"], j_sharding.cache_specs(vcfg, ji["caches"],
                                                         jmesh), jmesh)
            spec = input_specs(cfg, shape_name, "meta")
            inp = dryrun.rank_inputs(spec["cfg"], shape.kind, mesh,
                                     spec["batch"], caches=spec.get("caches"),
                                     pos=spec.get("pos"))
            assert dryrun._bytes(inp["args"]) == want, (multi, shape_name)


# --------------------------------------------------------------------- #
# every coordinate, depth extrapolation, the tracker
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch,kind", [
    ("deepseek-v2-lite-16b", "train"), ("deepseek-v2-lite-16b", "decode"),
    ("granite-20b", "decode"),
    ("musicgen-medium", "decode")])
def test_every_coordinate_gives_the_same_record(arch, kind):
    cfg = _small(arch)
    for shape in ((2, 2), (1, 4)):
        records = []
        for idx in range(math.prod(shape)):
            coords = dict(zip(("data", "model"), divmod(idx, shape[1])))
            records.append(_pass(cfg, kind,
                                 mesh_mod.abstract_mesh(shape, coords=coords)))
        assert all(r == records[0] for r in records), (shape, kind)
        assert records[0]["collectives"]["count"] > 0


@pytest.mark.parametrize("arch,kind", [
    ("deepseek-v2-lite-16b", "train"), ("granite-20b", "prefill"),
    ("hymba-1.5b", "decode"), ("mamba2-2.7b", "train")])
def test_depth_extrapolation_equals_the_full_depth_count(arch, kind):
    """At 5 layers (past a MoE model's dense lead one), every count
    extrapolated from the lead layers plus 1 and plus 2 equals the
    full-depth pass's: flops, bytes, each collective's calls and bytes,
    argument, output and peak bytes."""
    cfg = _small(arch, layers=5)
    mesh = mesh_mod.abstract_mesh((2, 2), coords={"data": 1, "model": 1})

    def count(c):
        batch, caches, pos = _inputs(c, kind)
        return dryrun.rank_pass(c, kind, mesh, batch, caches=caches, pos=pos)

    full, how = dryrun.depth_counts(cfg, count, fast=True)
    assert how == "full: 5 layers"
    extra, how = dryrun.depth_counts(cfg, count)
    assert how.startswith("extrapolated")
    for counts in (full, extra):
        assert counts.pop("t_trace_s") > 0
    # the peak is a maximum over the pass, not a sum: its moment holds a
    # few scalars that do not grow with depth
    peak = extra.pop("peak_bytes")
    assert abs(peak - full.pop("peak_bytes")) <= PEAK_SLACK
    assert extra == full


def test_live_storage_reads_the_same_peak_on_the_cpu_as_on_meta():
    cfg = _small("deepseek-v2-lite-16b")
    got = {}
    for dev in ("cpu", "meta"):
        gen = torch.Generator().manual_seed(0) if dev == "cpu" else None
        model = (tm.init_params(cfg, gen) if dev == "cpu"
                 else tm.empty_params(cfg, "meta"))
        opt = adamw(1e-3)
        state = opt.init(list(model.parameters()))
        batch = batch_struct(cfg, 2, 16, dev, gen)
        step = tm.make_train_step(cfg, opt)
        with LiveStorage(list(model.parameters()), state.slots, batch) as live:
            step(model, state, batch["tokens"])
        got[dev] = (live.base, live.peak)
    assert got["cpu"] == got["meta"]
    assert got["cpu"][1] > got["cpu"][0] > 0


def test_live_storage_frees_with_the_last_tensor():
    x = torch.empty(8, 8, device="meta")
    with LiveStorage(x) as live:
        y = x @ x  # 256 bytes
        z = y.view(-1)  # the same storage
        assert live.live == 512
        del y
        assert live.live == 512
        del z
        w = x + 1
    assert live.peak == 512 and live.live == 512 and w.is_meta


# --------------------------------------------------------------------- #
# the decode kernel's routes and the collectives' shape-only route
# --------------------------------------------------------------------- #
def test_decode_kernel_routes_cpu_plain_and_meta_shapes():
    g = torch.Generator().manual_seed(0)
    Bq, H, KV, L, D = 2, 8, 2, 40, 16
    q = torch.randn(Bq, H, D, generator=g)
    k = torch.randn(Bq, L, KV, D, generator=g)
    v = torch.randn(Bq, L, KV, D, generator=g)
    n = torch.tensor([L - 5], dtype=torch.int32)
    before = dict(fd.LAUNCHES)
    out = fd.flash_decode(q, k, v, n)
    assert torch.equal(out, fd_ref.decode_attention_ref(q, k, v, n.reshape(())))
    o, m, d = fd.flash_decode_partial(q, k, v, n)
    want = fd_ref.decode_attention_partial_ref(q, k, v, n.reshape(()))
    for a, b in zip((o, m, d), want):
        assert torch.equal(a, b)
    meta = [t.to("meta") for t in (q, k, v, n)]
    out = fd.flash_decode(*meta)
    assert out.is_meta and out.shape == (Bq, H, D) and out.dtype == q.dtype
    parts = fd.flash_decode_partial(*meta)
    assert [tuple(t.shape) for t in parts] == [(Bq, H, D), (Bq, H), (Bq, H)]
    assert all(t.is_meta and t.dtype == torch.float32 for t in parts)
    assert fd.LAUNCHES == before
    with pytest.raises(ValueError, match="multiple"):
        fd.flash_decode(meta[0][:, :7], *meta[1:])
    # the plain version's counted products are the kernel's count, at the
    # physical rows it computes
    with FlopCounterMode(display=False) as counter:
        fd.flash_decode(q, k, v, n)
    assert counter.get_total_flops() == fd.decode_flops(Bq, H, L, D, D)


def test_collectives_on_an_abstract_mesh_count_and_shape_only():
    mesh = mesh_mod.abstract_mesh((2, 2), coords={"data": 1, "model": 1})
    t = torch.empty(3, 4, device="meta")
    mesh_mod.reset_collectives()
    assert mesh_mod.all_reduce(t, mesh) is t
    g = mesh_mod.all_gather(t, mesh, dim=1)
    assert g.is_meta and g.shape == (3, 8)
    x = torch.empty(3, 8, device="meta", requires_grad=True)
    y = mesh_mod.all_gather(x, mesh, dim=0, axis="data")
    (gx,) = torch.autograd.grad(y.sum(), [x])  # a reduce-scatter adjoint
    assert gx.shape == x.shape and gx.is_meta
    rec = mesh_mod.collective_record()["by_axis"]
    assert rec["model"]["all-reduce"] == {"count": 1, "bytes": 48}
    assert rec["model"]["all-gather"] == {"count": 1, "bytes": 96}
    assert rec["data"]["all-gather"] == {"count": 1, "bytes": 192}
    assert rec["data"]["reduce-scatter"] == {"count": 1, "bytes": 96}
    with pytest.raises(ValueError, match="meta"):
        mesh_mod.all_reduce(torch.zeros(3, 4), mesh)


def test_parse_opts_and_the_record_keys(monkeypatch):
    assert dryrun._parse_opts("opt_mla_absorb=1,opt_remat=none,x=3") == {
        "opt_mla_absorb": True, "opt_remat": "none", "x": 3}
    # lower_one at a small config: its record has the reference's keys
    small = _small("smollm-135m")
    monkeypatch.setattr(dryrun, "get_arch", lambda arch: small)
    monkeypatch.setattr(dryrun, "production_shape", lambda multi: (2, 2))
    monkeypatch.setitem(dryrun.INPUT_SHAPES, "tiny_train",
                        dataclasses.replace(INPUT_SHAPES["train_4k"],
                                            name="tiny_train", seq_len=S,
                                            global_batch=B))
    monkeypatch.setattr(dryrun, "input_specs", lambda cfg, name, dev: {
        "shape": dryrun.INPUT_SHAPES[name], "cfg": cfg,
        "batch": batch_struct(cfg, B, S, dev)})
    rec = dryrun.lower_one("smollm-135m", "tiny_train", opts="")
    for key in ("arch", "shape", "kind", "mesh", "chips", "flops",
                "bytes_accessed", "bytes_basis", "collectives",
                "flops_global", "memory", "params", "active_params",
                "variant_window", "opts", "roofline", "t_trace_s", "depth"):
        assert key in rec, key
    assert set(rec["memory"]) == {"argument_size_gib", "output_size_gib",
                                  "temp_size_gib", "peak_gib"}
    assert rec["flops_global"] == rec["flops"] * rec["chips"]
    assert "by_axis" in rec["collectives"]
    assert rec["roofline"]["bottleneck"] in ("compute", "memory",
                                             "collective")
    assert np.isclose(rec["memory"]["temp_size_gib"],
                      rec["memory"]["peak_gib"]
                      - rec["memory"]["argument_size_gib"])
