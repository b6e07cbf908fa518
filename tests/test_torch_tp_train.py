"""The transformer train step across ranks in the port, and Mamba2 and
Hymba on a model axis: ``make_train_step(cfg, adamw, mesh)`` on a rank of
a (data, model) mesh (``launch/mesh.py``'s differentiable collectives,
``launch/sharding.py::opt_state_specs``, ``launch/shapes.py::train_rank``),
held on the CPU against the port's own unsharded step and against the JAX
package.

* Train: one reduced config for each distinct path (Gemma: MHA with tied
  embeddings; Granite: MQA, whose ``wk``/``wv`` shards cut the one KV head
  at (1, 4) and are gathered; MusicGen: codebooks; LLaVA: patches;
  DeepSeek-V2-Lite: MLA and MoE, with the global dispatch and with
  ``opt_moe_shard_map``; Mamba2: its ``in_proj`` column blocks cutting
  z/x/B/C/dt, each rank its heads; Hymba, narrowed so that it keeps the
  full config's layout: 10 SSM heads (the full 50), which 4 does not
  divide, an ``in_proj`` of 682 columns (the full 6482) that 2 divides and
  4 does not, 5 attention heads (the full 25) that neither divides, and an
  odd vocabulary (the full 32001)) on the (2, 2) and the (1, 4) mesh, 2
  AdamW steps each. Each rank's gradient slices of the ``loss`` and the
  ``aux`` term apart (so that an error of the data size on the aux chain
  shows) within 1e-5 of the leaf's largest entry of the unsharded
  gradient; its losses (the mean over the data ranks) within 1e-5; its
  slices after the steps within rtol/atol 1e-4 but for Adam's roundoff
  flips (``test_torch_lm_train_step.py``: where a gradient is at the
  float32 noise of its leaf, the two runs may carry opposite signs and
  Adam's normalised step turns either into a whole lr: within 2 lr a step,
  and fewer than 1e-5 of the entries); its AdamW slots its slices' shapes;
  its replicated leaves bitwise equal across its model group; both steps
  count the same collectives. The expert-local dispatch's unsharded step
  is its function: each data shard's rows through the unsharded model, the
  gradients averaged.
* Against the JAX package's unsharded ``make_train_step`` with ``adamw``
  (the same numpy weights, which the ranks take through
  ``transformer_params_from_jax``): Granite (1, 4), Lite (2, 2), Hymba
  (1, 4) and MusicGen (2, 2), losses and weights by the same rule.
* Serve: Mamba2 and Hymba prefill and 4 decode steps at (2, 2) against the
  JAX package's unsharded serve (1e-4, equal tokens; Hymba's 16-row ring
  sharded by sequence).
* The dry run (``launch/dryrun.py``): at each rank's mesh and coordinate,
  shapes only, the train step's and the serve run's collectives and flops
  exactly.
* In process: ``opt_state_specs`` equal to the JAX ``param_specs(cfg,
  opt_sds, mesh)`` for all ten configs on the 16 x 16 and 2 x 16 x 16
  meshes; a (1, 1) mesh trains bitwise as the unsharded step for all ten
  configs; the reduced DeepSeek-V2-Lite's loss and aux over 10 AdamW steps
  within 1e-4 of the JAX package's.

The ranks run in ONE launch (a module fixture, with its own limit), the
JAX references in two spawned processes and the port's own in this one
meanwhile, in one torch thread.
"""
import dataclasses
import multiprocessing
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import sharding as j_sharding
from repro.models.transformer import model as jm
from repro.train import optimizer as j_opt
from repro_torch import serve
from repro_torch.configs import list_archs
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch import dryrun, sharding, shapes, spmd
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.config import ArchConfig
from repro_torch.train import optimizer as t_opt
from test_torch_lm_train import jax_tree
from test_torch_tp import B as SERVE_B
from test_torch_tp import S as SERVE_S
from test_torch_tp import NEW as SERVE_NEW
from test_torch_tp import _jax_serve, _meta, by_model_coordinate, meta_serve
from test_torch_tp_ranks import serve_cases_rank, train_cases_rank

LR, STEPS = 1e-3, 2
BATCH, SEQ = 4, 32
GRAD_TOL = 1e-5
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
#: one flipped Adam step (``test_torch_lm_train_step.py``)
FLIP = 2 * LR * 1.01
NOISE_SHARE = 1e-5
LIMIT_S = 300
#: Hymba narrowed to the full config's layout on the model axis (module
#: docstring)
HYMBA = dict(d_model=160, num_heads=5, num_kv_heads=5, vocab_size=1001)
#: case -> (architecture, mesh, overrides of the reduced config, held
#: against the JAX package too)
CASES = {
    "gemma-2x2": ("gemma-7b", (2, 2), {}, False),
    "granite-1x4": ("granite-20b", (1, 4), {}, True),
    "musicgen-2x2": ("musicgen-medium", (2, 2), {}, True),
    "llava-1x4": ("llava-next-mistral-7b", (1, 4), {}, False),
    "lite-2x2": ("deepseek-v2-lite-16b", (2, 2), {}, True),
    "lite-shard_map-2x2": ("deepseek-v2-lite-16b", (2, 2),
                           {"opt_moe_shard_map": True}, False),
    "mamba2-2x2": ("mamba2-2.7b", (2, 2), {}, False),
    "hymba-2x2": ("hymba-1.5b", (2, 2), HYMBA, False),
    "hymba-1x4": ("hymba-1.5b", (1, 4), HYMBA, True),
}
JAX_CASES = [c for c, v in CASES.items() if v[3]]
#: the case whose ranks build a roofline record of their last step, and the
#: one whose JAX reference runs on to ``AUX_STEPS`` steps
RECORD_CASE = AUX_CASE = "lite-2x2"
SERVE_CASES = {"mamba2": ("mamba2-2.7b", {}), "hymba": ("hymba-1.5b", HYMBA)}
SERVE_MESH = (2, 2)
AUX_STEPS = 10


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The module's reduced models in one torch thread: they are too small
    to gain from more, and a loaded host (the ranks, the JAX references,
    other test processes) makes many threads wait on one another."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _cfgs(arch, over):
    """(JAX config, port config) of the reduced variant (a window of 16
    rows where the config is windowed)."""
    full = j_get_arch(arch)
    jcfg = full.reduced(attn_window=16 if full.attn_window else None, **over)
    return jcfg, ArchConfig(**dataclasses.asdict(jcfg))


def _model(cfg):
    return tm.init_params(dataclasses.replace(cfg, opt_moe_shard_map=False),
                          torch.Generator().manual_seed(0))


def _terms(cfg):
    return ("loss", "aux") if cfg.family == "moe" else ("loss",)


def _inputs(data):
    patches = data.get("patches")
    return (torch.as_tensor(data["tokens"]),
            None if patches is None else torch.as_tensor(patches))


def _unsharded(cfg, data, data_size):
    """The port's unsharded step: the gradients of each term, and the
    losses and weights of ``STEPS`` AdamW steps. With
    ``opt_moe_shard_map`` the function the expert-local dispatch computes:
    each of the ``data_size`` shards' rows through the unsharded model,
    the gradients and metrics averaged."""
    model = _model(cfg)
    params = list(model.parameters())
    names = [n for n, _ in model.named_parameters()]
    tokens, patches = _inputs(data)
    k = data_size if cfg.opt_moe_shard_map else 1
    parts = list(zip(tokens.chunk(k), patches.chunk(k) if patches is not None
                     else [None] * k))

    def grads_of(term):
        acc, metrics = None, []
        for t, p in parts:
            g, m = tm.lm_grads(model, t, p, term)
            acc = g if acc is None else [a + b for a, b in zip(acc, g)]
            metrics.append(m)
        return [a / k for a in acc], {
            n: float(sum(m[n] for m in metrics)) / k for n in ("loss", "aux")}

    grads = {t: dict(zip(names, grads_of(t)[0])) for t in _terms(cfg)}
    opt = t_opt.adamw(LR)
    state = opt.init(params)
    losses = []
    for _ in range(STEPS):
        g, metrics = grads_of("total")
        _, state = opt.update(g, state, params)
        losses.append(metrics)
    return SimpleNamespace(grads=grads, losses=losses, params={
        n: p.detach() for n, p in model.named_parameters()})


def _jax_train(jcfg, np_params, data, steps=STEPS):
    """The JAX package's unsharded ``make_train_step`` with ``adamw``,
    ``steps`` steps: (losses, auxes, the weights after ``STEPS`` steps as
    the port's names)."""
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(np.array(a)),
                                    np_params)
    batch = {"tokens": jnp.asarray(data["tokens"], jnp.int32)}
    if "patches" in data:
        batch["patches"] = jnp.asarray(data["patches"])
    opt = j_opt.adamw(LR)
    state = opt.init(params)
    step = jax.jit(jm.make_train_step(jcfg, opt))
    losses, auxes = [], []
    for k in range(steps):
        params, state, metrics = step(params, state, batch)
        losses.append(float(metrics["loss"]))
        auxes.append(float(metrics["aux"]))
        if k + 1 == STEPS:
            kept = jax.tree_util.tree_map(np.asarray, params)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    model = tm.transformer_params_from_jax(kept, cfg, "cpu")
    return losses, auxes, {n: p.detach() for n, p in model.named_parameters()}


# --------------------------------------------------------------------- #
# the fixture: one launch of four gloo ranks, the JAX references beside it
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def runs():
    train, want = [], {}
    for case, (arch, mesh, over, with_jax) in CASES.items():
        jcfg, cfg = _cfgs(arch, over)
        data = shapes.train_batch(cfg, BATCH, SEQ, 1)
        np_params = jax_tree(_model(cfg)) if with_jax else None
        train.append({"cfg": cfg, "mesh": mesh, "data": data,
                      "np_params": np_params, "terms": _terms(cfg),
                      "record": case == RECORD_CASE})
    serve_in = []
    for arch, over in SERVE_CASES.values():
        _, cfg = _cfgs(arch, over)
        serve_in.append({"cfg": cfg, "new": SERVE_NEW, "np_params": None,
                         "prompts": serve.make_prompts(cfg, SERVE_B, SERVE_S, 1),
                         "patches": None})
    tasks = [(train_cases_rank, (train, STEPS)),
             (serve_cases_rank, (SERVE_MESH, serve_in))]
    ctx = multiprocessing.get_context("spawn")
    with ThreadPoolExecutor(1) as threads, \
            ProcessPoolExecutor(2, mp_context=ctx) as procs:
        ranks = threads.submit(spmd.launch, tasks, 4, "cpu", LIMIT_S)
        # meanwhile the references: the JAX package's in two processes, the
        # port's own in this one
        jax_train = {case: procs.submit(
            _jax_train, _cfgs(*CASES[case][0:3:2])[0],
            train[list(CASES).index(case)]["np_params"],
            train[list(CASES).index(case)]["data"],
            AUX_STEPS if case == AUX_CASE else STEPS) for case in JAX_CASES}
        serve_want = {
            name: procs.submit(_jax_serve, _cfgs(arch, over)[0],
                               jax_tree(_model(c["cfg"])), c["prompts"], None)
            for (name, (arch, over)), c in zip(SERVE_CASES.items(), serve_in)}
        for case, c in zip(CASES, train):
            want[case] = _unsharded(c["cfg"], c["data"], CASES[case][1][0])
        for case, f in jax_train.items():
            want[case].jax = f.result()
        serve_want = {name: f.result() for name, f in serve_want.items()}
        ranks = ranks.result()
    return SimpleNamespace(
        train={case: [r[0][i] for r in ranks] for i, case in enumerate(CASES)},
        serve={name: [r[1][i] for r in ranks]
               for i, name in enumerate(SERVE_CASES)},
        want=want, serve_want=serve_want, inputs=train)


def _rank_mesh(case, out):
    return mesh_mod.abstract_mesh(CASES[case][1], coords=out["coords"])


def _slices(tensors: dict, cfg, mesh) -> dict:
    specs = sharding.param_specs(cfg, tensors, mesh)
    return {n: sharding.spec_slice(t, specs[n], mesh).numpy()
            for n, t in tensors.items()}


def _check_weights(name, got: dict, want: dict, steps: int):
    """Every entry within ``STEP_TOL``, or (Adam's roundoff flips) within
    ``FLIP`` a step, those fewer than ``NOISE_SHARE`` of the entries;
    returns the entries off."""
    off = total = 0
    for n, b in want.items():
        a = got[n]
        assert a.shape == b.shape, (name, n)
        close = np.isclose(a, b, **STEP_TOL)
        assert (np.abs(a - b)[~close] <= FLIP * steps).all(), (name, n)
        off += int((~close).sum())
        total += b.size
    assert off <= NOISE_SHARE * total, (name, off, total)
    return off


# --------------------------------------------------------------------- #
# the train step across ranks
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(CASES))
def test_sharded_gradients_match_unsharded(runs, case):
    """Each rank's gradient slices of the loss and of the aux term, each
    within 1e-5 of the leaf's largest entry of the unsharded gradient."""
    cfg = runs.inputs[list(CASES).index(case)]["cfg"]
    want = runs.want[case].grads
    for out in runs.train[case]:
        mesh = _rank_mesh(case, out)
        for term, grads in want.items():
            local = _slices(grads, cfg, mesh)
            for n, w in local.items():
                scale = max(float(grads[n].abs().max()), 1e-30)
                err = float(np.abs(out["grads"][term][n] - w).max())
                assert err <= GRAD_TOL * scale, (term, n, err / scale)
        if cfg.family == "moe":  # the aux chain reaches the router
            router = [n for n in want["aux"] if n.endswith("router")]
            assert router and all(
                float(want["aux"][n].abs().max()) > 0 for n in router)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_adamw_steps_match_unsharded(runs, case):
    """Two AdamW steps: the losses (each rank's term, averaged over the
    data ranks) within 1e-5, the rank's slices as ``_check_weights``
    holds them, the AdamW slots of its slices' shapes, the same
    collectives in both steps (the backward's too: reduce-scatters where a
    gather feeds a partial region, one data-axis all-reduce a leaf on a
    data axis of 2)."""
    arch, mesh_shape, _, _ = CASES[case]
    cfg = runs.inputs[list(CASES).index(case)]["cfg"]
    want = runs.want[case]
    outs = runs.train[case]
    D = mesh_shape[0]
    for k in range(STEPS):
        for term in ("loss", "aux"):
            got = sum(o["losses"][k][term] for o in outs) / len(outs)
            np.testing.assert_allclose(got, want.losses[k][term], **LOSS_TOL)
    n_params = len(want.params)
    for out in outs:
        mesh = _rank_mesh(case, out)
        _check_weights(case, out["params"], _slices(want.params, cfg, mesh),
                       STEPS)
        shapes_ = [out["param_shapes"][n] for n in want.params]
        assert out["slot_shapes"] == {"m": shapes_, "v": shapes_}
        first, second = out["collectives"]
        assert first == second
        by = first["by_axis"]
        assert by["model"]["all-reduce"]["count"] > 0
        # the gradient mean, one a leaf (and the expert-local aux's sums)
        means = by["data"]["all-reduce"]["count"]
        assert (means >= n_params if cfg.opt_moe_shard_map else
                means == n_params) if D > 1 else means == 0
        # the gathers into partial regions: Granite's wk/wv, Hymba's
        # attention weights and (at M = 2) its projection, Mamba2's
        # projection, and the global MoE dispatch's tokens over data
        gathers = {"granite-1x4": True, "hymba-2x2": True, "hymba-1x4": True,
                   "mamba2-2x2": True, "lite-2x2": True}
        scatters = by["model"]["reduce-scatter"]["count"] + \
            by["data"]["reduce-scatter"]["count"]
        assert (scatters > 0) == gathers.get(case, False), by
        if case == RECORD_CASE:  # the record holds the last step's
            rec = out["record"]
            assert rec["chips"] == 4 and rec["collectives"] == second
            assert rec["collectives"]["total"] == sum(
                v["bytes"] for a in by.values() for v in a.values())


@pytest.mark.parametrize("case", list(CASES))
def test_replicated_leaves_stay_equal_across_a_model_group(runs, case):
    """After the steps every leaf that no rank shards (norms, the router,
    MLA's down projections, the SSM's vectors, a vocabulary the model axis
    does not divide) is bitwise the same on each rank of a model group."""
    outs = runs.train[case]
    for d in range(CASES[case][1][0]):
        group = [o["digests"] for o in outs if o["coords"]["data"] == d]
        assert group[0] and all(g == group[0] for g in group[1:])


@pytest.mark.parametrize("case", JAX_CASES)
def test_sharded_train_matches_jax(runs, case):
    """The ranks (weights taken from the JAX tree) against the JAX
    package's unsharded ``make_train_step`` with ``adamw``: losses within
    1e-4, the slices after the steps as ``_check_weights`` holds them."""
    cfg = runs.inputs[list(CASES).index(case)]["cfg"]
    losses, auxes, params = runs.want[case].jax
    outs = runs.train[case]
    for k in range(STEPS):
        got = sum(o["losses"][k]["loss"] for o in outs) / len(outs)
        aux = sum(o["losses"][k]["aux"] for o in outs) / len(outs)
        np.testing.assert_allclose(got, losses[k], **STEP_TOL)
        np.testing.assert_allclose(aux, auxes[k], **STEP_TOL)
    for out in outs:
        _check_weights(case, out["params"],
                       _slices(params, cfg, _rank_mesh(case, out)), STEPS)


# --------------------------------------------------------------------- #
# Mamba2 and Hymba served on a model axis
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_sharded_ssm_serve_matches_jax(runs, name):
    """Prefill and 4 decode steps at (2, 2) within 1e-4 of the JAX
    package's unsharded serve, the greedy tokens equal; each rank's
    parameters and caches its specs' slices (the SSM state by head)."""
    arch, over = SERVE_CASES[name]
    _, cfg = _cfgs(arch, over)
    want_logits, want_tokens = runs.serve_want[name]
    meta = tm.empty_params(cfg, "meta")
    ctx = -(-(SERVE_S + SERVE_NEW) // SERVE_MESH[1]) * SERVE_MESH[1]
    caches = tm.init_caches(cfg, SERVE_B, ctx, "meta")
    for out in runs.serve[name]:
        a, b = out["rows"]
        np.testing.assert_allclose(out["step_logits"].numpy(),
                                   want_logits[:, a:b], rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(out["tokens"].numpy(), want_tokens[a:b])
        mesh = mesh_mod.abstract_mesh(SERVE_MESH, coords=out["coords"])
        assert out["param_shapes"] == {
            k: tuple(v.shape)
            for k, v in sharding.param_slice(cfg, meta, mesh).items()}
        assert out["cache_shapes"] == [
            serve._shapes(c) for c in sharding.cache_slice(cfg, caches, mesh)]
        state = out["cache_shapes"][0]["state"]
        assert state[1] == cfg.ssm_nheads // SERVE_MESH[1]
        if name == "hymba":  # the ring of 16 rows sharded by sequence
            assert out["cache_shapes"][0]["attn"]["k"][1] == 8


# --------------------------------------------------------------------- #
# in process: the optimizer's specs, the (1, 1) mesh, the MoE's aux
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", list_archs())
def test_opt_state_specs_match_jax(arch):
    """``opt_state_specs`` of AdamW's state on the production meshes equal
    the JAX ``param_specs(cfg, opt_sds, mesh)``: each slot its leaf's spec
    (a scanned block's leading layer axis dropped), the step counter ();
    a (1, 2) rank's slots (``adamw.init`` of its slices) are accepted."""
    jcfg = j_get_arch(arch)
    cfg = ArchConfig(**dataclasses.asdict(jcfg))
    params_sds = jax.eval_shape(lambda: jm.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    opt_sds = jax.eval_shape(j_opt.adamw(LR).init, params_sds)
    model = tm.empty_params(cfg, "meta")
    names = [n for n, _ in model.named_parameters()]
    state = t_opt.adamw(LR).init(list(model.parameters()))
    for multi in (False, True):
        mesh = mesh_mod.production_mesh(multi)
        jmesh = SimpleNamespace(shape=dict(mesh.shape),
                                axis_names=mesh.axis_names)
        jspec = j_sharding.param_specs(jcfg, opt_sds, jmesh)
        got = sharding.opt_state_specs(cfg, state, mesh)
        assert got.step == tuple(jspec.step) == ()
        for kind in ("m", "v"):
            tree = jspec.slots[kind]
            for name, spec in zip(names, got.slots[kind], strict=True):
                top, *rest = name.split(".")
                node = tree[top]
                for k in (rest[1:] if top == "blocks" else rest):
                    node = node[int(k)] if isinstance(node, list) else node[k]
                want = tuple(node)[1:] if top == "blocks" else tuple(node)
                assert spec == want, (multi, kind, name)
    half = mesh_mod.abstract_mesh((1, 2), coords={"model": 1})
    local = sharding.param_slice(cfg, model, half)
    sliced = t_opt.adamw(LR).init([local[n] for n in names])
    assert sharding.opt_state_specs(cfg, sliced, half).slots["m"] == \
        list(sharding.param_specs(cfg, model, half).values())
    with pytest.raises(ValueError, match="slots for"):
        sharding.opt_state_specs(cfg, t_opt.adamw(LR).init([]), half)


@pytest.mark.parametrize("arch", list_archs())
def test_one_by_one_mesh_trains_bitwise(arch):
    """A (1, 1) mesh (no collective runs, so no process group is needed):
    two AdamW steps of ``make_train_step(cfg, adamw, mesh)`` on a model
    sharded there give the unsharded step's losses and weights bit for
    bit, for all ten configs."""
    _, cfg = _cfgs(arch, {})
    data = shapes.train_batch(cfg, 2, SEQ, 1)
    tokens, patches = _inputs(data)
    runs_ = []
    for mesh in (None, mesh_mod.abstract_mesh((1, 1))):
        model = _model(cfg)
        if mesh is not None:
            tm.shard_params(model, mesh)
        opt = t_opt.adamw(LR)
        state = opt.init(list(model.parameters()))
        step = tm.make_train_step(cfg, opt, mesh)
        mesh_mod.reset_collectives()
        losses = []
        for _ in range(STEPS):
            state, metrics = step(model, state, tokens, patches)
            losses.append((float(metrics["loss"]), float(metrics["aux"])))
        assert mesh_mod.collective_record()["count"] == 0
        runs_.append((losses, [p.detach() for p in model.parameters()]))
    (want, want_p), (got, got_p) = runs_
    assert got == want
    assert all(torch.equal(a, b) for a, b in zip(got_p, want_p, strict=True))


def test_moe_loss_and_aux_trajectories_match_jax(runs):
    """The reduced DeepSeek-V2-Lite from the same weights and batch, 10
    AdamW steps in both packages, unsharded: each step's loss and aux
    within 1e-4 of the JAX package's (the fixture's reference of the
    ``AUX_CASE``, run on to 10 steps), so that the aux's course is the
    setup's, not the port's; here it stays within (0.95, 1.1)."""
    c = runs.inputs[list(CASES).index(AUX_CASE)]
    cfg = dataclasses.replace(c["cfg"], opt_moe_shard_map=False)
    model = _model(cfg)
    tokens, _ = _inputs(c["data"])
    adamw = t_opt.adamw(LR)
    state = adamw.init(list(model.parameters()))
    step = tm.make_train_step(cfg, adamw)
    got = []
    for _ in range(AUX_STEPS):
        state, metrics = step(model, state, tokens)
        got.append((float(metrics["loss"]), float(metrics["aux"])))
    losses, auxes, _ = runs.want[AUX_CASE].jax
    np.testing.assert_allclose(got, list(zip(losses, auxes)), **STEP_TOL)
    # at this width the aux stays near its balanced value of 1 in both
    # packages while the loss falls (ROADMAP Queue C: the rise measured at
    # full width is the setup's)
    assert losses[-1] < 0.01 * losses[0]
    assert all(0.95 < a < 1.1 for a in auxes), auxes


# --------------------------------------------------------------------- #
# the dry run's shape-only pass against the ranks that ran
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", list(CASES))
def test_dry_run_predicts_each_ranks_collectives_and_flops(runs, case):
    """For each rank of the launch, ``dryrun.rank_pass`` of a train step at
    its mesh and model coordinate (``by_model_coordinate``), shapes only,
    on the whole batch's shapes: the collectives of either step (calls and
    result bytes by axis and kind, the backward's and the data-axis
    gradient mean included) and the first step's ``FlopCounterMode``
    flops, exactly."""
    c = runs.inputs[list(CASES).index(case)]
    batch = {k: _meta(v) for k, v in c["data"].items()}
    for out, pred in by_model_coordinate(
            runs.train[case], lambda coords: dryrun.rank_pass(
                c["cfg"], "train", _rank_mesh(case, {"coords": coords}),
                batch)):
        assert pred["collectives"] == out["collectives"][0], out["coords"]
        assert pred["flops"] == out["flops"] > 0, out["coords"]


@pytest.mark.parametrize("name", list(SERVE_CASES))
def test_dry_run_predicts_each_ssm_serving_ranks_counts(runs, name):
    """Mamba2 and Hymba served at (2, 2): ``dryrun.serve_pass`` at each
    rank's model coordinate (``by_model_coordinate``) counts its
    collectives and flops exactly."""
    arch, over = SERVE_CASES[name]
    _, cfg = _cfgs(arch, over)
    prompts = serve.make_prompts(cfg, SERVE_B, SERVE_S, 1)
    for out, pred in by_model_coordinate(runs.serve[name], lambda c: meta_serve(
            cfg, mesh_mod.abstract_mesh(SERVE_MESH, coords=c), prompts, None,
            SERVE_NEW)):
        assert pred["collectives"] == out["collectives"], out["coords"]
        assert pred["flops"] == out["flops"] > 0, out["coords"]
