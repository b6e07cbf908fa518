"""The transformer across ranks in the port: the (data, model) mesh
(``launch/mesh.py``), the transformer half of ``launch/sharding.py``, the
tensor-parallel serve path with its sequence-sharded decode, and the
expert-local MoE, held on the CPU against the JAX package.

* Specs: ``param_specs``, ``batch_specs`` and ``cache_specs`` of all ten
  configs at full width on the 16 x 16 and 2 x 16 x 16 meshes, entry for
  entry against the JAX functions (their leading layer axis dropped), on
  ``jax.eval_shape`` and ``input_specs``' trees for ``decode_32k`` and
  ``train_4k``.
* Slicers: each (2, 2) coordinate's slice of every parameter, cache and
  batch leaf has its spec's local shape.
* The partial decode and its merge (plain versions): two shards merged
  within 1e-5 of the unsharded decode in float32 (within
  ``decode_attention_bound`` in bf16), with a shard with no valid row and
  a ring.
* Serve: prefill and 4 decode steps of the eight attention configs'
  reduced form (float32; LLaVA's 16-row ring; a Granite ring of 16 rows
  sharded by sequence; DeepSeek with ``opt_mla_absorb`` and with
  ``opt_moe_shard_map``) on 4 gloo ranks as (data 2, model 2), against the
  JAX package's unsharded prefill and decode on the same weights (the
  port's seeded ones as numpy arrays; the first case's ranks take them
  through ``transformer_params_from_jax``, the others draw them): logits
  within 1e-4 and equal tokens; each rank holds its spec's slice of every
  parameter and cache leaf. A (1, 1) mesh is the unsharded path bit for bit
  for all ten configs; Mamba2 and Hymba build their slices and caches on a
  model axis (``tests/test_torch_tp_train.py`` serves and trains them
  there).
* MoE: the port's ``moe_apply_shard_map`` on the ranks against JAX's under
  ``shard_map`` on a (2, 2) mesh of 4 forced host devices (one
  subprocess), 2e-4 / 2e-5, at the reference test's capacity 8.0 and at
  0.5, where each shard drops tokens by its own capacity; the global
  dispatch on the mesh equals the unsharded ``moe_apply``.

The ranks run in ONE launch (a module fixture, with its own limit), the JAX
references meanwhile: the serve cases' in this process, the MoE cases' in
one subprocess (it needs 4 forced host devices).
"""
import dataclasses
import math
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap
import weakref
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import sharding as j_sharding
from repro.launch.input_specs import input_specs as j_input_specs
from repro.models.transformer import model as jm
from repro.models.transformer.config import ArchConfig as JArchConfig
from repro_torch import serve
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import shapes, sharding, spmd
from repro_torch.launch.input_specs import input_specs
from repro_torch.models.transformer import blocks as tb
from repro_torch.models.transformer import layers as tlayers
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer import moe as tmoe
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.obs.memory import peak_allocations
from repro_torch.train.optimizer import sgd
from test_torch_lm_train import jax_tree
from test_torch_tp_ranks import moe_cases_rank, np_tree, serve_cases_rank

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESH = (2, 2)
ATTENTION = ["smollm-135m", "gemma-7b", "granite-20b", "phi3-mini-3.8b",
             "musicgen-medium", "llava-next-mistral-7b",
             "deepseek-v2-lite-16b", "deepseek-v2-236b"]
#: the eight attention configs, and three variants: a name and an option
SERVE_CASES = ATTENTION + ["granite-20b:ring16", "deepseek-v2-lite-16b:absorb",
                           "deepseek-v2-lite-16b:shard_map"]
#: a variant's option
VARIANTS = {"absorb": "opt_mla_absorb", "shard_map": "opt_moe_shard_map"}
B, S, NEW = 2, 16, 5  # prefill, then 4 decode steps
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=2e-4, atol=2e-5)
#: the MoE cases: the reference test's capacity (no token drops) and one
#: where each data shard drops tokens by its own capacity
MOE_CASES = {"cap8": (8.0, 8), "cap0.5": (0.5, 64)}
LIMIT_S = 240


def _cfgs(case):
    """(JAX config, port config) of a serve case: the reduced config (a
    window of 16 rows where the config is windowed), and its variant."""
    name, _, variant = case.partition(":")
    full = j_get_arch(name)
    over = {"attn_window": 16 if full.attn_window else None}
    if variant == "ring16":
        over["attn_window"] = 16
    elif variant:
        over[VARIANTS[variant]] = True
    jcfg = full.reduced(**over)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _moe_jcfg(cf):
    return JArchConfig(name="t", family="moe", num_layers=1, d_model=16,
                       vocab_size=32, num_experts=8, moe_top_k=2, moe_d_ff=8,
                       num_shared_experts=1, moe_capacity_factor=cf,
                       mlp_type="swiglu", dtype="float32")


#: the JAX side of the MoE cases, in a subprocess with 4 forced host
#: devices: ``moe_apply_shard_map`` on a (2, 2) mesh
JAX_MOE_SCRIPT = textwrap.dedent("""
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.models.transformer.config import ArchConfig
    from repro.models.transformer.moe import moe_apply_shard_map
    with open(sys.argv[1], "rb") as f:
        job = pickle.load(f)
    out = {}
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    with jax.set_mesh(mesh):
        for name, c in job.items():
            cfg = ArchConfig(**c["cfg"])
            params = jax.tree_util.tree_map(jnp.asarray, c["params"])
            y, aux = jax.jit(lambda p, x: moe_apply_shard_map(p, x, cfg))(
                params, jnp.asarray(c["x"]))
            out[name] = {"y": np.asarray(y), "aux": float(aux)}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
""")


def _jax_embed(dst, src):
    if dst.shape == src.shape:
        return src.astype(dst.dtype)
    axis = [i for i, (a, b) in enumerate(zip(dst.shape, src.shape)) if a != b][0]
    return jax.lax.dynamic_update_slice_in_dim(dst, src.astype(dst.dtype), 0,
                                               axis=axis)


def _jax_serve(jcfg, params, prompts, patches):
    """The JAX package's unsharded prefill and greedy decode loop (the
    example's) -> (step logits (NEW, B, ...), tokens (B, NEW, ...))."""
    params = jax.tree_util.tree_map(jax.numpy.asarray, params)
    batch = {"tokens": jax.numpy.asarray(prompts, jax.numpy.int32)}
    if patches is not None:
        batch["patches"] = jax.numpy.asarray(patches)
    start = S + (patches.shape[1] if patches is not None else 0)
    logits, pre = jax.jit(jm.make_prefill_step(jcfg))(params, batch)
    caches = jax.tree_util.tree_map(_jax_embed,
                                    jm.init_caches(jcfg, B, start + NEW), pre)
    decode = jax.jit(jm.make_decode_step(jcfg))
    tok = jax.numpy.argmax(logits[:, -1:], axis=-1).astype(jax.numpy.int32)
    tokens, steps = [tok], [logits[:, -1]]
    for t in range(NEW - 1):
        logits, caches = decode(params, {"tokens": tok},
                                jax.numpy.int32(start + t), caches)
        tok = jax.numpy.argmax(logits[:, -1:], axis=-1).astype(jax.numpy.int32)
        tokens.append(tok)
        steps.append(logits[:, -1])
    return (np.stack([np.asarray(a) for a in steps]),
            np.asarray(jax.numpy.concatenate(tokens, axis=1)))


# --------------------------------------------------------------------- #
# the fixture: one launch of four gloo ranks, the JAX references beside it
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs():
    def weights(cfg):
        return jax_tree(tm.init_params(cfg, torch.Generator().manual_seed(0)))

    # the ranks draw the port's seeded weights themselves (serve_rank's
    # init_params); the first case carries them as the JAX tree instead
    rank_cases = []
    for case in SERVE_CASES:
        _, cfg = _cfgs(case)
        rank_cases.append({"cfg": cfg, "new": NEW, "np_params": None,
                           "prompts": serve.make_prompts(cfg, B, S, 1),
                           "patches": serve.make_patches(cfg, B, 1)})
    rank_cases[0]["np_params"] = weights(rank_cases[0]["cfg"])
    moe_in = {}
    for name, (cf, seq) in MOE_CASES.items():
        jcfg = _moe_jcfg(cf)
        moe_in[name] = {
            "cfg": dataclasses.asdict(jcfg),
            "params": np_tree(tmoe.moe_init(torch.Generator().manual_seed(0),
                                            ArchConfig(**dataclasses.asdict(jcfg)),
                                            torch.float32)),
            "x": np.random.default_rng(1).normal(size=(4, seq, 16)).astype(
                np.float32)}
    moe_ranks = [{"cfg": ArchConfig(**c["cfg"]), "params": c["params"],
                  "x": c["x"]} for c in moe_in.values()]
    tasks = [(serve_cases_rank, (MESH, rank_cases)),
             (moe_cases_rank, (MESH, moe_ranks))]
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu", PYTHONPATH=SRC)
    with tempfile.TemporaryDirectory(prefix="tp-") as tmp, \
            ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spmd.launch, tasks, 4, "cpu", LIMIT_S)
        # meanwhile the MoE reference in its subprocess, the serve references
        # in this process
        inp, outp = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump(moe_in, f)
        proc = subprocess.Popen([sys.executable, "-c", JAX_MOE_SCRIPT, inp, outp],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        try:
            want = {case: _jax_serve(_cfgs(case)[0], weights(c["cfg"]),
                                     c["prompts"], c["patches"])
                    for case, c in zip(SERVE_CASES, rank_cases)}
            _, err = proc.communicate(timeout=LIMIT_S)
            assert proc.returncode == 0, err
            ranks = ranks.result()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        with open(outp, "rb") as f:
            jax_moe = pickle.load(f)
    return SimpleNamespace(
        serve={case: [r[0][i] for r in ranks]
               for i, case in enumerate(SERVE_CASES)},
        moe={name: [r[1][i] for r in ranks] for i, name in enumerate(MOE_CASES)},
        want=want, jax_moe=jax_moe, moe_in=moe_in)


# --------------------------------------------------------------------- #
# specs and slicers
# --------------------------------------------------------------------- #
def _j_spec(tree, path):
    node = tree
    for k in path:
        node = node[int(k)] if isinstance(node, list) else node[k]
    return tuple(node)


@pytest.mark.parametrize("arch", list_archs())
def test_specs_match_jax(arch):
    """``param_specs``/``batch_specs``/``cache_specs`` entry for entry
    against the JAX package's on the production meshes: a scanned block's
    JAX spec leads with None for its layer axis, which the port's per-layer
    blocks do not have."""
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    shapes_ = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0), jcfg))
    model = tm.empty_params(cfg, "meta")
    n_lead = cfg.first_dense_layers if cfg.family == "moe" else 0
    for multi in (False, True):
        mesh = mesh_mod.production_mesh(multi)
        jmesh = SimpleNamespace(shape=dict(mesh.shape), axis_names=mesh.axis_names)
        jspec = j_sharding.param_specs(jcfg, shapes_, jmesh)
        got = sharding.param_specs(cfg, model, mesh)
        assert len(got) == len(list(model.parameters()))
        for name, spec in got.items():
            top, *rest = name.split(".")
            if top == "blocks":
                want = _j_spec(jspec["blocks"], rest[1:])[1:]
            elif top == "lead_blocks":
                want = _j_spec(jspec["lead_blocks"], rest)
            else:
                want = tuple(jspec[name])
            assert spec == want, (multi, name)
        for shape_name in ("decode_32k", "train_4k"):
            ji = j_input_specs(jcfg, shape_name)
            ti = input_specs(cfg, shape_name, device="meta")
            jb = j_sharding.batch_specs(jcfg, ji["batch"], jmesh)
            assert sharding.batch_specs(cfg, ti["batch"], mesh) == {
                k: tuple(v) for k, v in jb.items()}
            if shape_name != "decode_32k":
                continue
            jc = j_sharding.cache_specs(jcfg, ji["caches"], jmesh)
            is_p = lambda x: isinstance(x, jax.sharding.PartitionSpec)  # noqa: E731
            scan = jax.tree_util.tree_map(lambda p: tuple(p)[1:], jc["scan"],
                                          is_leaf=is_p)
            for i, layer in enumerate(sharding.cache_specs(cfg, ti["caches"],
                                                           mesh)):
                want = (jax.tree_util.tree_map(tuple, jc["lead"][i], is_leaf=is_p)
                        if i < n_lead else scan)
                assert layer == want, (multi, i)


def _local(shape, spec, mesh):
    return tuple(n // (1 if e is None else sharding._axis_size(e, mesh))
                 for n, e in zip(shape, spec))


@pytest.mark.parametrize("arch", ["granite-20b", "deepseek-v2-lite-16b",
                                  "smollm-135m", "musicgen-medium"])
def test_slicers_give_each_coordinate_its_spec_shape(arch):
    """At every (2, 2) coordinate, ``param_slice``, ``cache_slice`` and
    ``batch_slice`` give each leaf its spec's local shape, and the slices
    of the model axis tile the leaf: concatenated, they are the whole."""
    cfg = serve.serve_config(arch, reduced=True)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    named = dict(model.named_parameters())
    caches = tm.init_caches(cfg, 4, 20, "cpu")
    g = torch.Generator().manual_seed(1)
    for c in caches:
        for t in c.values():
            t.normal_(generator=g)
    batch = {"tokens": torch.arange(4 * 16 * max(1, cfg.num_codebooks)).reshape(
        (4, 16) + ((cfg.num_codebooks,) if cfg.num_codebooks else ()))}
    base = mesh_mod.abstract_mesh(MESH)
    pspecs = sharding.param_specs(cfg, model, base)
    cspecs = sharding.cache_specs(cfg, caches, base)
    slices = {}
    for d in range(2):
        for j in range(2):
            mesh = mesh_mod.abstract_mesh(MESH, coords={"data": d, "model": j})
            local = sharding.param_slice(cfg, model, mesh)
            for name, t in local.items():
                assert tuple(t.shape) == _local(named[name].shape,
                                                pspecs[name], mesh), name
            slices[d, j] = local
            for layer, spec, full in zip(sharding.cache_slice(cfg, caches, mesh),
                                         cspecs, caches, strict=True):
                for name, t in layer.items():
                    assert tuple(t.shape) == _local(full[name].shape,
                                                    spec[name], mesh)
            rows = sharding.batch_slice(cfg, batch, mesh)["tokens"]
            assert torch.equal(rows, batch["tokens"][2 * d:2 * d + 2])
    for name, spec in pspecs.items():
        if "model" in spec:
            dim = spec.index("model")
            whole = torch.cat([slices[0, j][name] for j in range(2)], dim=dim)
            assert torch.equal(whole, named[name].detach()), name
    # the sequence-sharded caches hold MQA's k/v and MLA's latents
    seq = [name for name, spec in cspecs[-1].items() if spec[1] == "model"]
    assert seq == {"granite-20b": ["k", "v"],
                   "deepseek-v2-lite-16b": ["c_kv", "k_rope"]}.get(arch, [])


@pytest.mark.parametrize("arch", ["granite-20b", "deepseek-v2-lite-16b"])
def test_a_rank_builds_its_slices_one_leaf_at_a_time(arch, monkeypatch):
    """On each coordinate of a (1, 2) mesh ``init_params(mesh=)`` draws a
    leaf, keeps its slice and drops the leaf before it draws the next: no
    whole leaf drawn before is alive at any draw, so a rank's peak is its
    slices and one leaf. The slices are the unsharded model's, bit for bit,
    marked on their spec's model dimension; ``transformer_params_from_jax``
    with the mesh gives the same; the rank's parameter bytes are its
    specs' local shapes'."""
    cfg = serve.serve_config(arch, reduced=True)
    whole = dict(tm.init_params(cfg, torch.Generator().manual_seed(0))
                 .named_parameters())
    specs = sharding.param_specs(cfg, whole, mesh_mod.abstract_mesh((1, 2)))
    np_params = jax_tree(tm.init_params(cfg, torch.Generator().manual_seed(0)))
    drawn = []
    draw = tlayers._normal

    def counted(*args):
        alive = [name for name, ref in drawn if ref() is not None]
        assert not alive, f"whole leaves alive at a draw: {alive}"
        t = draw(*args)
        drawn.append((tuple(t.shape), weakref.ref(t)))
        return t

    monkeypatch.setattr(tlayers, "_normal", counted)
    for j in range(2):
        mesh = mesh_mod.abstract_mesh((1, 2), coords={"model": j})
        drawn.clear()
        model = tm.init_params(cfg, torch.Generator().manual_seed(0), mesh)
        assert len(drawn) == sum(t.dim() > 1 for t in whole.values())
        local = dict(model.named_parameters())
        carried = dict(tm.transformer_params_from_jax(np_params, cfg, "cpu",
                                                      mesh).named_parameters())
        for name, spec in specs.items():
            want = sharding.spec_slice(whole[name].detach(), spec, mesh)
            assert torch.equal(local[name], want), name
            assert torch.equal(carried[name], want), name
            dim = spec.index("model") if "model" in spec else None
            assert sharding.model_dim(local[name]) == dim, name
            assert sharding.model_dim(carried[name]) == dim, name
        assert sum(t.numel() for t in local.values()) == sum(
            math.prod(_local(whole[n].shape, specs[n], mesh)) for n in specs)
        assert model.mesh is mesh


def test_peak_allocations_replays_a_trace_to_its_peak():
    """``obs/memory.py::peak_allocations`` on an allocator trace: the peak
    of the bytes its own allocations held (a free of a block allocated
    before the trace is ignored) and the largest allocations alive then,
    each with the innermost frame of the package."""
    def frames(fn):
        return [{"filename": "/x/lib/torch/functional.py", "line": 9,
                 "name": "einsum"},
                {"filename": os.path.join("/x", "repro_torch", "models",
                                          "layers.py"), "line": 7, "name": fn}]

    trace = [{"action": "free_completed", "addr": 99, "size": 500},
             {"action": "alloc", "addr": 1, "size": 100, "frames": frames("a")},
             {"action": "alloc", "addr": 2, "size": 300, "frames": frames("b")},
             {"action": "free_requested", "addr": 1, "size": 100},
             {"action": "free_completed", "addr": 1, "size": 100},
             {"action": "alloc", "addr": 3, "size": 250, "frames": frames("c")},
             {"action": "alloc", "addr": 4, "size": 50, "frames": []},
             {"action": "free_completed", "addr": 3, "size": 250},
             {"action": "alloc", "addr": 5, "size": 200, "frames": frames("d")}]
    got = peak_allocations(trace, top=2)
    assert got["peak_bytes"] == 600 and got["events"] == 7
    where = os.path.join("models", "layers.py")
    assert got["top"] == [{"bytes": 300, "where": f"{where}:7 b"},
                          {"bytes": 250, "where": f"{where}:7 c"}]


# --------------------------------------------------------------------- #
# the partial decode and its merge
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L", [3, 8, 13, 16])
def test_partial_decode_merge_matches_unsharded(L, dtype):
    """A 16-row cache (a ring that has wrapped, at L = 16: every physical
    slot valid) in two shards of 8 rows, each shard's valid count clamp(L -
    8 j, 0, 8): the plain partial outputs merged equal the unsharded
    decode, within 1e-5 in float32 and ``decode_attention_bound`` in bf16.
    At L = 3 the second shard has no valid row: o = 0, m = -1e30, d = 0,
    and it weighs nothing."""
    g = torch.Generator().manual_seed(L)
    q = torch.randn(2, 6, 16, generator=g).to(dtype)
    k = torch.randn(2, 16, 2, 16, generator=g).to(dtype)
    v = torch.randn(2, 16, 2, 8, generator=g).to(dtype)
    parts = [fd_ref.decode_attention_partial_ref(
        q, k[:, 8 * j:8 * (j + 1)], v[:, 8 * j:8 * (j + 1)],
        torch.tensor(min(max(L - 8 * j, 0), 8))) for j in range(2)]
    if L <= 8:
        o, m, d = parts[1]
        assert bool((o == 0).all()) and bool((d == 0).all())
        assert bool((m == -1e30).all())
    got = fd_ref.merge_partials(*(torch.stack(t) for t in zip(*parts)), dtype)
    assert got.dtype == dtype
    if dtype == torch.float32:
        want = fd_ref.decode_attention_ref(q, k, v, torch.tensor(L))
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        want, bound = fd_ref.decode_attention_bound(q, k, v, torch.tensor(L))
        assert bool(((got.float() - want).abs() <= bound).all())


# --------------------------------------------------------------------- #
# the serve path across ranks
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", SERVE_CASES)
def test_sharded_serve_matches_jax(runs, case):
    """Each of the four ranks' rows: every step's logits within 1e-4 of the
    JAX package's unsharded serve, the greedy tokens equal; its parameters
    and caches its spec's slices; the model ranks of one data rank give the
    same logits; every model-axis collective counted."""
    _, cfg = _cfgs(case)
    want_logits, want_tokens = runs.want[case]
    model = tm.empty_params(cfg, "meta")
    # the context (the prompt, a VLM's patch rows, the new tokens), rounded
    # up to the model ranks
    ctx = -(-(S + (cfg.num_patches or 0) + NEW) // MESH[1]) * MESH[1]
    caches = tm.init_caches(cfg, B, ctx, "meta")
    outs = runs.serve[case]
    for out in outs:
        a, b = out["rows"]
        assert b - a == B // MESH[0]
        np.testing.assert_allclose(out["step_logits"].numpy(),
                                   want_logits[:, a:b], **MODEL_TOL)
        np.testing.assert_array_equal(out["tokens"].numpy(), want_tokens[a:b])
        mesh = mesh_mod.abstract_mesh(MESH, coords=out["coords"])
        assert out["param_shapes"] == {
            k: tuple(v.shape) for k, v in
            sharding.param_slice(cfg, model, mesh).items()}
        assert out["cache_shapes"] == [
            serve._shapes(c) for c in sharding.cache_slice(cfg, caches, mesh)]
        by = out["collectives"]["by_axis"]
        assert by["model"]["all-reduce"]["count"] > 0
        assert out["collectives"]["total"] == sum(
            k["bytes"] for a in by.values() for k in a.values())
        assert out["launches"] == {"flash_decode": 0, "flash_decode_partial": 0}
        assert out["host_transport"]
    for d in range(MESH[0]):
        same = [o for o in outs if o["coords"]["data"] == d]
        assert torch.equal(same[0]["step_logits"], same[1]["step_logits"])


@pytest.mark.parametrize("arch", list_archs())
def test_one_by_one_mesh_is_the_unsharded_path_bitwise(arch):
    """A (1, 1) mesh (no collective runs at all, so no process group is
    needed): ``shard_params`` keeps every leaf whole and ``generate`` of the
    model on the mesh equals the unsharded ``generate`` bit for bit, for all
    ten configs."""
    cfg = serve.serve_config(arch, reduced=True)
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    prompts = torch.as_tensor(serve.make_prompts(cfg, B, S, 1))
    patches = serve.make_patches(cfg, B, 1)
    patches = None if patches is None else torch.as_tensor(patches)
    want = serve.generate(model, prompts, 3, patches)
    mesh = mesh_mod.abstract_mesh((1, 1))
    tm.shard_params(model, mesh)
    mesh_mod.reset_collectives()
    got = serve.generate(model, prompts, 3, patches)
    assert torch.equal(got["step_logits"], want["step_logits"])
    assert torch.equal(got["tokens"], want["tokens"])
    assert mesh_mod.collective_record()["count"] == 0


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "hymba-1.5b"])
def test_ssm_and_hybrid_shard_on_a_model_axis(arch):
    """Mamba2 and Hymba build on a (1, 2) mesh, at each model coordinate:
    ``shard_params`` and ``init_params(mesh=)`` give each parameter its
    spec's slice (``in_proj`` in column blocks, ``out_proj`` in row
    blocks), ``init_caches(mesh=)`` each cache its spec's shape (the SSM
    state by head), and the steps build; a data axis alone too."""
    cfg = serve.serve_config(arch, reduced=True)
    whole = tm.init_params(cfg, torch.Generator().manual_seed(0))
    named = dict(whole.named_parameters())
    caches = tm.init_caches(cfg, 2, 8, "meta")
    for j in range(2):
        mesh = mesh_mod.abstract_mesh((1, 2), coords={"model": j})
        specs = sharding.param_specs(cfg, whole, mesh)
        assert specs["blocks.0.ssm.in_proj"] == (None, "model")
        assert specs["blocks.0.ssm.out_proj"] == ("model", None)
        want = sharding.param_slice(cfg, whole, mesh)
        built = dict(tm.init_params(cfg, torch.Generator().manual_seed(0),
                                    mesh).named_parameters())
        for name, t in want.items():
            assert tuple(t.shape) == _local(named[name].shape, specs[name],
                                            mesh), name
            assert torch.equal(built[name], t), name
        model = tm.init_params(cfg, torch.Generator().manual_seed(0))
        tm.shard_params(model, mesh)
        assert {k: tuple(v.shape) for k, v in model.named_parameters()} == {
            k: tuple(v.shape) for k, v in want.items()}
        local = tm.init_caches(cfg, 2, 8, "cpu", mesh)
        assert [serve._shapes(c) for c in local] == [
            serve._shapes(c) for c in sharding.cache_slice(cfg, caches, mesh)]
        state = local[0]["state"]
        assert state.shape[1] == cfg.ssm_nheads // 2
        assert sharding.model_dim(state) == 1
        tm.make_decode_step(cfg, mesh)
        tm.make_prefill_step(cfg, mesh)
    # a data axis alone is fine
    tm.make_decode_step(cfg, mesh_mod.abstract_mesh((2, 1)))


def test_mesh_refusals():
    """A batch the data axes do not divide, a ring the model axis does not
    divide (a sequence-sharded MQA cache), bad axes and sharding a model
    twice all raise."""
    cfg = serve.serve_config("granite-20b", reduced=True)
    with pytest.raises(ValueError, match="does not split over 2 data ranks"):
        tm.init_caches(cfg, 3, 8, "cpu", mesh_mod.abstract_mesh((2, 1)))
    ring = dataclasses.replace(cfg, attn_window=15)
    with pytest.raises(ValueError, match="does not split over 2 model ranks"):
        tm.init_caches(ring, 2, 40, "cpu", mesh_mod.abstract_mesh((1, 2)))
    # unwindowed, the context is rounded up to the model ranks
    caches = tm.init_caches(cfg, 2, 21, "cpu", mesh_mod.abstract_mesh((1, 2)))
    assert caches[0]["k"].shape == (2, 11, 1, 32)
    with pytest.raises(ValueError, match="needs the axes"):
        mesh_mod.abstract_mesh((2, 2), ("model", "data"))
    with pytest.raises(ValueError, match="outside axis"):
        mesh_mod.abstract_mesh((2, 2), coords={"model": 2})
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    tm.shard_params(model, mesh_mod.abstract_mesh((1, 1)))
    with pytest.raises(ValueError, match="sharded already"):
        tm.shard_params(model, mesh_mod.abstract_mesh((1, 1)))


def test_mesh_axes_and_the_production_shapes():
    assert mesh_mod.production_shape() == (16, 16)
    assert mesh_mod.production_shape(multi_pod=True) == (2, 16, 16)
    mesh = mesh_mod.production_mesh(multi_pod=True)
    assert mesh.axis_names == ("pod", "data", "model")
    assert mesh_mod.data_axes(mesh) == ("pod", "data")
    assert mesh_mod.model_axis(mesh) == "model"
    assert (mesh.data_size, mesh.model_size) == (32, 16)
    m = mesh_mod.abstract_mesh((2, 3, 4), coords={"pod": 1, "data": 2,
                                                  "model": 3})
    assert (m.data_index, m.model_index) == (5, 3)


def test_roofline_record_reads_the_exchange_counters():
    """``roofline_record`` with a mesh: ``chips`` the mesh's ranks and
    ``collectives`` the counters (result bytes by kind, total, count), whose
    total enters the collective term; without one, one card and 0."""
    cfg = serve.serve_config("smollm-135m", reduced=True)
    model = tm.empty_params(cfg, "meta")
    mesh_mod.reset_collectives()
    mesh_mod._count("model", "all-reduce", 4096)
    mesh_mod._count("model", "all-gather", 1024)
    mesh_mod._count("data", "all-gather", 512)
    rec = shapes.roofline_record(cfg, model, "decode_32k", 2, 1, 1e-3,
                                 flops=10 ** 9, cache_len=16,
                                 mesh=mesh_mod.abstract_mesh(MESH))
    assert rec["chips"] == 4
    assert (rec["collectives"]["all-reduce"], rec["collectives"]["all-gather"],
            rec["collectives"]["total"], rec["collectives"]["count"]) == (
        4096, 1536, 5632, 3)
    assert rec["roofline"]["t_collective_s"] > 0
    mesh_mod.reset_collectives()
    assert shapes.roofline_record(cfg, model, "decode_32k", 2, 1, 1e-3,
                                  flops=10 ** 9, cache_len=16)["collectives"] \
        == {"total": 0, "count": 0}


# --------------------------------------------------------------------- #
# the expert-local MoE
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(MOE_CASES))
def test_moe_shard_map_matches_jax(runs, name):
    """Each rank's rows of the port's ``moe_apply_shard_map`` within 2e-4 /
    2e-5 of JAX's under ``shard_map`` on a (2, 2) mesh, aux too; each rank
    holds E/2 experts. At capacity 0.5 each shard's own capacity (from its
    T_loc tokens) drops tokens and decides the output: it differs from the
    global dispatch, which equals the unsharded ``moe_apply``."""
    cf, seq = MOE_CASES[name]
    want = runs.jax_moe[name]
    c = runs.moe_in[name]
    cfg = ArchConfig(**c["cfg"])
    flat = {k: torch.as_tensor(v) for k, v in tm._flatten(c["params"]).items()}
    unsharded, un_aux = tmoe.moe_apply(tm._unflatten(flat), torch.as_tensor(c["x"]),
                                       cfg)
    for out in runs.moe[name]:
        a, b = out["rows"]
        assert out["experts"] == cfg.num_experts // MESH[1]
        np.testing.assert_allclose(out["y"], want["y"][a:b], **MOE_TOL)
        np.testing.assert_allclose(out["aux"], want["aux"], **MOE_TOL)
        np.testing.assert_allclose(out["global"], unsharded[a:b].numpy(),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(out["global_aux"], float(un_aux), rtol=1e-5)
        gap = np.abs(out["y"] - unsharded[a:b].numpy()).max()
        assert (gap > 1e-3) == (cf < 1.0), gap
    # the per-shard capacity drops picks at 0.5, none at 8.0
    x = torch.as_tensor(c["x"])
    T_loc = x.shape[0] // MESH[0] * x.shape[1]
    C = tmoe.moe_capacity(cfg, T_loc)
    gates = torch.softmax(x[:x.shape[0] // MESH[0]].reshape(-1, 16)
                          @ flat["router"], -1)
    load = torch.bincount(torch.topk(gates, 2).indices.reshape(-1),
                          minlength=cfg.num_experts)
    assert bool((load > C).any()) == (cf < 1.0), (load, C)


def test_moe_shard_map_needs_a_mesh_and_divisible_experts():
    cfg = dataclasses.replace(get_arch("deepseek-v2-lite-16b").reduced(),
                              opt_moe_shard_map=True)
    with pytest.raises(ValueError, match="opt_moe_shard_map"):
        tm.make_train_step(cfg, sgd(0.1))
    with pytest.raises(ValueError, match="do not split"):
        tmoe.moe_apply_shard_map({}, torch.zeros(1, 1, cfg.d_model), cfg,
                                 mesh_mod.abstract_mesh((1, 3)))
    # with a mesh the steps build, and a (1, 1) mesh serves without one rank
    # more: the shard-map dispatch over all the experts, its aux the shard's
    mesh = mesh_mod.abstract_mesh((1, 1))
    model = tm.init_params(cfg, torch.Generator().manual_seed(0))
    tm.shard_params(model, mesh)
    out = serve.generate(model, torch.as_tensor(serve.make_prompts(cfg, B, S, 1)),
                         3)
    assert torch.isfinite(out["step_logits"]).all()
    assert tb.check_mesh(cfg, mesh) is None
