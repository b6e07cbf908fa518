"""The port's transformer train step (``make_train_step`` + ``adamw(1e-3)``)
against the JAX package's jitted ``make_train_step``, three steps on one
seeded batch, for all ten reduced configs (the helpers and the setting of
``test_torch_lm_train.py``).

Two port models run beside the reference. The free-running one takes its
three steps from the shared initial weights: each step's loss and aux
within rtol/atol 1e-4 of the reference's. The teacher-forced one starts
each step from the reference's weights and Adam slots: its new weights
and slots within rtol/atol 1e-4 of the reference's after each step, but
for one kind of entry. Where the reference's gradient is at the float32
noise of its leaf (at most ``NOISE`` times the leaf's largest entry: a sum
that cancels to roundoff), the two gradients may carry opposite signs, and
Adam's normalised step m / sqrt(v) turns either sign into a whole ``lr``.
Those weights are held within 2 x lr x 1.01 (``|m_hat| / sqrt(v_hat)``
stays under 1.01 over three steps at b1 = 0.9, b2 = 0.999), and they must
be fewer than ``NOISE_SHARE`` of the weights.

Why the weights are compared step by step: a free-running weight that
took such a flipped step moves the next step's gradients of its row and
column by about 1e-6, and wherever those gradients are near 1e-5 Adam
turns that into a visible difference again. The free-running weights are
held within 2 x lr x 1.01 a step and the same share.

In bfloat16 (one config, free-running) the losses and weights within
5e-2: the reference's update promotes a bf16 leaf to float32 (its bias
corrections are float32 arrays), so its weights are float32 from the first
step on, while the port keeps each leaf's dtype, slots included.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.transformer import model as jm
from repro.train import optimizer as j_opt
from repro_torch.models.transformer import model as tm
from repro_torch.train import optimizer as t_opt
from test_torch_lm_train import (
    ARCHS,
    jax_tree,
    train_batch,
    train_cfgs,
    train_model,
)

LR, STEPS = 1e-3, 3
STEP_TOL = dict(rtol=1e-4, atol=1e-4)
BF16_TOL = dict(rtol=5e-2, atol=5e-2)
#: one flipped Adam step: 2 x lr x max |m_hat| / sqrt(v_hat)
FLIP = 2 * LR * 1.01
NOISE = 1e-5
NOISE_SHARE = 1e-5


def _leaves(tree):
    return [np.asarray(a, np.float32) for a in jax.tree_util.tree_leaves(tree)]


def _as_port(tree, cfg):
    """A JAX pytree (params, or an Adam slot) as tensors in the port's
    ``model.parameters()`` order."""
    np_tree = jax.tree_util.tree_map(np.asarray, tree)
    return [t.detach() for t in
            tm.transformer_params_from_jax(np_tree, cfg, "cpu").parameters()]


def _check_step(name, got_tree, want_tree, near_tree, bound):
    """Every leaf within 1e-4, or at a ``near`` entry within ``bound``;
    returns (entries off by more than 1e-4, entries)."""
    paths = [jax.tree_util.keystr(p)
             for p, _ in jax.tree_util.tree_leaves_with_path(want_tree)]
    near_leaves = (jax.tree_util.tree_leaves(near_tree) if near_tree is not None
                   else [None] * len(paths))
    off, total = 0, 0
    for where, a, b, near in zip(paths, _leaves(got_tree), _leaves(want_tree),
                                 near_leaves):
        assert a.shape == b.shape, where
        close = np.isclose(a, b, **STEP_TOL)
        if near is not None:
            assert (close | near).all(), (
                f"{name} {where}: {int((~close & ~near).sum())} entries off by "
                "more than 1e-4 where the reference's gradient is not roundoff")
        assert (np.abs(a - b)[~close] <= bound).all(), f"{name} {where}"
        off += int((~close).sum())
        total += a.size
    return off, total


@pytest.mark.parametrize("name", ARCHS)
def test_three_adamw_steps_match_jax(name):
    jcfg, cfg = train_cfgs(name)
    params, free = train_model(jcfg, cfg)
    _, forced = train_model(jcfg, cfg)
    batch, tokens, patches = train_batch(cfg)
    j_adamw = j_opt.adamw(LR)
    j_state = j_adamw.init(params)
    j_step = jax.jit(jm.make_train_step(jcfg, j_adamw))
    j_grad = jax.jit(jax.grad(lambda p: jm.lm_loss(p, jcfg, batch)[0]))
    adamw = t_opt.adamw(LR)
    step = tm.make_train_step(cfg, adamw)
    free_state = adamw.init(list(free.parameters()))
    forced_state = adamw.init(list(forced.parameters()))
    losses, j_losses, aux, j_aux = [], [], [], []
    for k in range(STEPS):
        near = jax.tree_util.tree_map(
            lambda g: np.abs(g) <= NOISE * np.abs(g).max(),
            jax.tree_util.tree_map(np.asarray, j_grad(params)))
        # the forced model starts from the reference's weights and slots
        with torch.no_grad():
            for dst, src in zip([*forced.parameters(), *forced_state.slots["m"],
                                 *forced_state.slots["v"]],
                                [*_as_port(params, cfg),
                                 *_as_port(j_state.slots["m"], cfg),
                                 *_as_port(j_state.slots["v"], cfg)]):
                dst.copy_(src)
        forced_state = t_opt.OptimizerState(k, forced_state.slots)
        params, j_state, j_metrics = j_step(params, j_state, batch)
        forced_state, _ = step(forced, forced_state, tokens, patches)
        free_state, metrics = step(free, free_state, tokens, patches)
        assert metrics["loss"].shape == () and metrics["aux"].shape == ()
        losses.append(float(metrics["loss"]))
        aux.append(float(metrics["aux"]))
        j_losses.append(float(j_metrics["loss"]))
        j_aux.append(float(j_metrics["aux"]))
        off, total = _check_step(f"{name} step {k + 1}", jax_tree(forced),
                                 params, near, FLIP)
        assert off <= NOISE_SHARE * total, (k, off, total)
        for kind in ("m", "v"):
            _check_step(f"{name} step {k + 1} {kind}",
                        jax_tree(forced, forced_state.slots[kind]),
                        j_state.slots[kind], None, 0)
    np.testing.assert_allclose(losses, j_losses, **STEP_TOL)
    np.testing.assert_allclose(aux, j_aux, **STEP_TOL)
    assert losses[-1] < losses[0]
    assert free_state.step == STEPS
    off, total = _check_step(name, jax_tree(free), params, None, FLIP * STEPS)
    assert off <= NOISE_SHARE * total, (off, total)


def test_three_adamw_steps_match_jax_in_bfloat16():
    """SmolLM's reduced config with bf16 weights, free-running; the slots
    keep each leaf's dtype (bf16 matrices, float32 norms)."""
    jcfg, cfg = train_cfgs("smollm-135m", dtype="bfloat16")
    params, model = train_model(jcfg, cfg)
    batch, tokens, patches = train_batch(cfg)
    j_adamw = j_opt.adamw(LR)
    j_state = j_adamw.init(params)
    j_step = jax.jit(jm.make_train_step(jcfg, j_adamw))
    adamw = t_opt.adamw(LR)
    state = adamw.init(list(model.parameters()))
    step = tm.make_train_step(cfg, adamw)
    losses, j_losses = [], []
    for _ in range(STEPS):
        params, j_state, j_metrics = j_step(params, j_state, batch)
        state, metrics = step(model, state, tokens, patches)
        losses.append(float(metrics["loss"]))
        j_losses.append(float(j_metrics["loss"]))
    np.testing.assert_allclose(losses, j_losses, **BF16_TOL)
    assert losses[-1] < losses[0]
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16,
                                                     torch.float32}
    for kind in ("m", "v"):
        assert [t.dtype for t in state.slots[kind]] == [
            p.dtype for p in model.parameters()]
    for a, b in zip(_leaves(jax_tree(model)), _leaves(params)):
        np.testing.assert_allclose(a, b, **BF16_TOL)
    assert all(jnp.asarray(b).dtype == jnp.float32
               for b in jax.tree_util.tree_leaves(params))
