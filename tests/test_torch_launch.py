"""The port's ``launch/input_specs.py``, ``launch/roofline.py`` and
``launch/shapes.py`` against the JAX package's ``repro.launch`` modules and
transformer, on the CPU (JAX stays on the CPU; the decode wrapper runs its
kernel's plain version).

* Every leaf of ``input_specs`` on ``meta`` has the shape and dtype of the
  reference's ``ShapeDtypeStruct``, for the ten configs x four shapes at the
  global batch (the port's per-layer caches stacked as the reference's
  scanned ones), with ``variant_config``'s window.
* ``tokens_for`` and ``roofline_terms`` equal the reference's, the terms
  once the ratio of the two cards' constants is applied.
* The counted forward flops of a reduced dense config are the sum of its
  products and its live attention blocks, exactly; the depth extrapolation
  equals the count at full depth.
* ``card_batch`` fits its budget and lists its cuts; ``card_bytes`` is its
  estimate at a batch.
* Reduced dense, MLA, SSM and hybrid decode steps at seeded caches, near
  the end of a full 32768-row cache and at position 524287 on a ring
  smaller than it, are within 1e-4 of the reference's (the RoPE angles
  reach 5.2e5 rad there, where torch's and XLA's float32 sin and cos may
  differ; the test prints the largest difference found); a windowed
  prefill at twice the window matches it too.
* ``run_one`` on the CPU gives a record with the reference's keys for a
  decode shape and for ``train_4k``, and leaves a caller's launch count as
  it found it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as j_get_arch
from repro.launch import input_specs as j_specs
from repro.launch import roofline as j_roofline
from repro.models.transformer import model as jm
from repro_torch.configs import get_arch, list_archs
from repro_torch.kernels.flash_decode import kernel as fd
from repro_torch.launch import input_specs as t_specs
from repro_torch.launch import roofline, shapes
from repro_torch.models.transformer import model as tm
from repro_torch.models.transformer.blocks import FLASH_THRESHOLD

ARCHS = list_archs()
SHAPES = list(t_specs.INPUT_SHAPES)
DECODE_TOL = dict(rtol=1e-4, atol=1e-4)
#: DeepSeek-V2-236B's 60 layers are 439 GiB of bf16 weights: its card runs
#: cut it to 2, as ``chip_smoke.py`` does
CARD_LAYERS = {"deepseek-v2-236b": 2}


def _dtype_name(dtype) -> str:
    if isinstance(dtype, torch.dtype):
        return str(dtype).removeprefix("torch.")
    return np.dtype(dtype).name


def _leaf(sds):
    return tuple(sds.shape), _dtype_name(sds.dtype)


def _stacked(caches: list, n_lead: int) -> dict:
    """The port's per-layer caches in the reference's layout: the lead
    layers listed, the rest stacked on a leading axis (shapes only)."""
    def stack(layers):
        first = layers[0]
        if isinstance(first, dict):
            return {k: stack([c[k] for c in layers]) for k in first}
        return (len(layers), *first.shape), _dtype_name(first.dtype)

    def one(c):
        if isinstance(c, dict):
            return {k: one(v) for k, v in c.items()}
        return tuple(c.shape), _dtype_name(c.dtype)

    out = {"scan": stack(caches[n_lead:])}
    if n_lead:
        out["lead"] = [one(c) for c in caches[:n_lead]]
    return out


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_leaves_equal_the_reference(arch, shape):
    want = j_specs.input_specs(j_get_arch(arch), shape)
    got = t_specs.input_specs(get_arch(arch), shape)
    assert got["shape"] == t_specs.InputShape(**dataclasses.asdict(want["shape"]))
    assert dataclasses.asdict(got["cfg"]) == dataclasses.asdict(want["cfg"])
    assert got["cfg"].attn_window == want["cfg"].attn_window
    assert set(got["batch"]) == set(want["batch"])
    for k, t in got["batch"].items():
        assert t.device.type == "meta"
        assert (tuple(t.shape), _dtype_name(t.dtype)) == _leaf(want["batch"][k])
    assert ("caches" in got) == ("caches" in want)
    if "caches" in want:
        assert (tuple(got["pos"].shape), _dtype_name(got["pos"].dtype)) == \
            _leaf(want["pos"])
        cfg = got["cfg"]
        n_lead = cfg.first_dense_layers if cfg.family == "moe" else 0
        assert all(t.device.type == "meta" for c in got["caches"]
                   for t in t_specs._cache_leaves(c))
        assert _stacked(got["caches"], n_lead) == jax.tree_util.tree_map(
            _leaf, want["caches"])


def test_input_specs_seed_tensors_on_a_real_device():
    cfg = get_arch("llava-next-mistral-7b").reduced()
    make = lambda: t_specs.input_specs(  # noqa: E731
        cfg, "train_4k", "cpu", torch.Generator().manual_seed(3), batch=1)
    a, b = make(), make()
    assert a["batch"]["tokens"].shape == (1, 4096 - cfg.num_patches)
    assert a["batch"]["patches"].dtype == torch.bfloat16
    assert torch.equal(a["batch"]["tokens"], b["batch"]["tokens"])
    assert int(a["batch"]["tokens"].max()) < cfg.vocab_size
    dec = t_specs.input_specs(get_arch("hymba-1.5b").reduced(), "long_500k",
                              "cpu", torch.Generator().manual_seed(3))
    assert int(dec["pos"]) == 524287 and dec["pos"].dtype == torch.int32
    c = dec["caches"][0]
    assert c["attn"]["k"].shape[1] == 1024 and c["state"].dtype == torch.float32
    assert float(c["attn"]["k"].std()) > 0.5


@pytest.mark.parametrize("shape", SHAPES)
def test_tokens_for_equals_the_reference(shape):
    rec = {"shape": shape}
    assert roofline.tokens_for(rec) == j_roofline._tokens_for(rec)
    want = 3 if t_specs.INPUT_SHAPES[shape].kind == "decode" else \
        3 * t_specs.INPUT_SHAPES[shape].seq_len
    assert roofline.tokens_for({**rec, "batch": 3}) == want


@pytest.mark.parametrize("kind_shape", ["train_4k", "prefill_32k", "decode_32k",
                                        "long_500k"])
@pytest.mark.parametrize("flops,nbytes,coll", [(3e15, 2e11, 0.0),
                                               (1e12, 7e10, 5e9),
                                               (5e13, 1e9, 4e10)])
def test_roofline_terms_equal_the_reference_by_the_constants(kind_shape, flops,
                                                            nbytes, coll):
    rec = {"arch": "x", "shape": kind_shape,
           "kind": t_specs.INPUT_SHAPES[kind_shape].kind, "chips": 4,
           "flops": flops, "bytes_accessed": nbytes,
           "collectives": {"total": coll}, "active_params": 7_000_000_000}
    got, want = roofline.roofline_terms(rec), j_roofline.roofline_terms(rec)
    ratio = {"t_compute_s": roofline.PEAK_FLOPS / j_roofline.PEAK_FLOPS,
             "t_memory_s": roofline.HBM_BW / j_roofline.HBM_BW,
             "t_collective_s": roofline.LINK_BW / j_roofline.ICI_BW}
    for k, r in ratio.items():
        np.testing.assert_allclose(got[k] * r, want[k], rtol=1e-12)
    assert got["model_flops"] == want["model_flops"]
    assert got["useful_flops_ratio"] == want["useful_flops_ratio"]
    assert got["bottleneck"] == {"t_compute_s": "compute", "t_memory_s": "memory",
                                 "t_collective_s": "collective"}[
        max(ratio, key=lambda k: got[k])]


def test_kernel_bound_and_mfu():
    assert roofline.kernel_bound(3.35e9, 1.0) == (1.0, "bytes")
    ms, by = roofline.kernel_bound(1.0, 989e9, roofline.PEAK_FLOPS)
    assert by == "operations" and ms == pytest.approx(1.0)
    assert roofline.kernel_bound(1.0, 67e9) == (pytest.approx(1.0), "operations")
    assert roofline.INT32_OPS == roofline.FP32_FLOPS / 4
    assert roofline.mfu(989e12, 2.0) == 0.5
    assert fd.decode_flops(2, 9, 100, 64, 64) == 2 * 2 * 9 * 100 * 128
    assert fd.decode_bytes(2, 9, 3, 100, 64, 64, 2) == 2 * (2 * 100 * 3 * 128
                                                           + 2 * 9 * 128)


def _dense_forward_flops(cfg, B, S):
    """A dense swiglu config's prefill products: per layer q, k, v, o and
    the MLP's three, and each live (chunk x chunk) block's scores and value
    product; the tied head on the last row."""
    d, H, KV, hd, ff = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    c = cfg.opt_flash_chunk
    n = S // c
    live = sum(1 for qi in range(n) for kj in range(qi + 1)
               if cfg.attn_window is None
               or (qi - kj - 1) * c + 1 < cfg.attn_window)
    per_layer = (2 * B * S * d * (2 * H * hd + 2 * KV * hd)
                 + 3 * 2 * B * S * d * ff + live * 2 * 2 * B * H * c * c * hd)
    return cfg.num_layers * per_layer + 2 * B * d * cfg.vocab_size


@pytest.mark.parametrize("window", [None, 512])
def test_counted_forward_flops_are_the_products_and_live_blocks(window):
    cfg = dataclasses.replace(get_arch("smollm-135m").reduced(),
                              opt_flash_chunk=256, attn_window=window)
    S = FLASH_THRESHOLD
    got = shapes.meta_flops(cfg, "prefill", 2, S)
    assert got == _dense_forward_flops(cfg, 2, S)
    deep = dataclasses.replace(cfg, num_layers=5)
    assert shapes.meta_flops(deep, "prefill", 2, S) == \
        shapes._meta_flops(deep, "prefill", 2, S) == _dense_forward_flops(deep, 2, S)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b"])
def test_train_flops_extrapolate_exactly(arch):
    cfg = dataclasses.replace(get_arch(arch).reduced(), num_layers=4)
    got = shapes.meta_flops(cfg, "train", 1, 64)
    assert got == shapes._meta_flops(cfg, "train", 1, 64)
    # remat recomputes each block's forward in the backward: more than 3x the
    # forward's products, less than 4x
    fwd = shapes._meta_flops(cfg, "prefill", 1, 64)
    assert 3 * fwd < got < 4 * fwd + 2 * 64 * cfg.d_model * cfg.vocab_size * 4


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_card_batch_fits_its_budget_and_lists_its_cuts(arch, shape):
    cfg = get_arch(arch)
    if arch in CARD_LAYERS:
        cfg = dataclasses.replace(cfg, num_layers=CARD_LAYERS[arch])
    shp = t_specs.INPUT_SHAPES[shape]
    cfg = t_specs.variant_config(cfg, shp)
    weights = sum(p.numel() * p.element_size()
                  for p in tm.empty_params(cfg, "meta").parameters())
    if shp.kind == "train":
        weights *= 4
    res, trans = t_specs.per_sequence_bytes(cfg, shp)
    budget = t_specs.CARD_BUDGET
    if weights + res + trans > budget:
        with pytest.raises(ValueError, match="exceed"):
            t_specs.card_batch(cfg, shp, budget)
        return
    B, cuts = t_specs.card_batch(cfg, shp, budget)
    assert 1 <= B <= shp.global_batch
    assert weights + B * (res + trans) <= budget
    assert t_specs.card_bytes(cfg, shp, B) == weights + B * (res + trans)
    if B < shp.global_batch:
        assert weights + (B + 1) * (res + trans) > budget
        assert len(cuts) == 1 and f"to {B} sequences" in cuts[0]
    else:
        assert cuts == []


def test_card_batch_at_decode_32k():
    """One card's decode_32k batches, from the caches' bytes and MLA's
    expansion of a layer's latent cache."""
    shp = t_specs.INPUT_SHAPES["decode_32k"]

    def batch(arch):
        cfg = get_arch(arch)
        if arch in CARD_LAYERS:
            cfg = dataclasses.replace(cfg, num_layers=CARD_LAYERS[arch])
        return t_specs.card_batch(cfg, shp)[0]

    assert 88 <= batch("smollm-135m") <= 92
    assert batch("gemma-7b") == 3 and batch("phi3-mini-3.8b") == 4
    assert 30 <= batch("granite-20b") <= 34
    assert batch("musicgen-medium") == 6
    assert batch("hymba-1.5b") == batch("mamba2-2.7b") == 128
    assert 95 <= batch("llava-next-mistral-7b") <= 105
    lite = batch("deepseek-v2-lite-16b")
    assert lite < 37
    res, trans = t_specs.per_sequence_bytes(get_arch("deepseek-v2-236b"), shp)
    assert trans > 3.7e9 and res < 0.1e9 * 60  # 236B: set by its transient


def test_card_batch_caps_at_most_and_refuses_what_does_not_fit():
    """``most`` caps the batch without a cut of the budget's; a config whose
    weights alone exceed the card raises, cut in depth or not."""
    shp = t_specs.INPUT_SHAPES["prefill_32k"]
    assert t_specs.card_batch(get_arch("smollm-135m"), shp, most=1) == (1, [])
    B, cuts = t_specs.card_batch(get_arch("gemma-7b"), shp, most=8)
    assert B < 8 and len(cuts) == 1 and f"to {B} sequences" in cuts[0]
    with pytest.raises(ValueError, match="exceed"):
        t_specs.card_batch(get_arch("deepseek-v2-236b"), shp, most=1)


def test_meta_model_has_init_params_shapes_and_refuses_the_kernel():
    cfg = get_arch("deepseek-v2-lite-16b").reduced()
    real = tm.init_params(cfg, torch.Generator().manual_seed(0))
    meta = tm.empty_params(cfg, "meta")
    assert [(n, p.shape, p.dtype) for n, p in real.named_parameters()] == \
        [(n, p.shape, p.dtype) for n, p in meta.named_parameters()]
    assert all(p.device.type == "meta" for p in meta.parameters())
    # on meta the kernel's wrapper returns its output's shape, launches
    # nothing, and refuses what the kernel would refuse
    q = torch.empty(1, 4, 32, device="meta")
    k = torch.empty(1, 8, 4, 32, device="meta")
    n = torch.empty(1, dtype=torch.int32, device="meta")
    before = dict(fd.LAUNCHES)
    out = fd.flash_decode(q, k, k, n)
    assert out.is_meta and out.shape == (1, 4, 32) and fd.LAUNCHES == before
    with pytest.raises(ValueError, match="do not match"):
        fd.flash_decode(q, k[..., :16], k, n)


# --------------------------------------------------------------------------- #
# decode and prefill against the reference at the shapes' positions
# --------------------------------------------------------------------------- #
DECODE_ARCHS = ["smollm-135m", "deepseek-v2-lite-16b", "mamba2-2.7b",
                "hymba-1.5b"]


def _jax_caches(caches: list, n_lead: int):
    """The port's per-layer caches (numpy) in the reference's layout."""
    def as_j(c):
        return jax.tree_util.tree_map(lambda t: jnp.asarray(t.numpy()), c)

    out = {"scan": jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[as_j(c) for c in caches[n_lead:]])}
    if n_lead:
        out["lead"] = [as_j(c) for c in caches[:n_lead]]
    return out


@pytest.mark.parametrize("shape,back", [("decode_32k", 1), ("decode_32k", 3),
                                        ("long_500k", 1)])
@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_step_at_the_shapes_matches_the_reference(arch, shape, back):
    """One decode step at ``pos = seq_len - back`` against seeded caches of
    the shape's variant config (reduced, B = 1): decode_32k near the end of
    a full 32768-row cache, long_500k at 524287 on its ring (8192 rows,
    Hymba's own 1024)."""
    jfull, full = j_get_arch(arch), get_arch(arch)
    shp = t_specs.INPUT_SHAPES[shape]
    cfg = t_specs.variant_config(full.reduced(), shp)
    jcfg = j_specs.variant_config(jfull.reduced(), j_specs.INPUT_SHAPES[shape])
    params = jm.init_params(jax.random.PRNGKey(0), jcfg)
    model = tm.transformer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    pos = shp.seq_len - back
    specs = t_specs.input_specs(cfg, shape, "cpu",
                                torch.Generator().manual_seed(5), batch=1,
                                pos=pos)
    tokens = specs["batch"]["tokens"]
    n_lead = cfg.first_dense_layers if cfg.family == "moe" else 0
    j_caches = _jax_caches(specs["caches"], n_lead)
    want, _ = jax.jit(jm.make_decode_step(jcfg))(
        params, {"tokens": jnp.asarray(tokens.numpy())}, jnp.int32(pos), j_caches)
    with torch.inference_mode():
        got, caches = tm.make_decode_step(cfg)(model, tokens, specs["pos"],
                                               specs["caches"])
    diff = float(np.abs(got.numpy() - np.asarray(want)).max())
    print(f"{arch} {shape} pos {pos}: largest logit difference {diff:.3e}")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **DECODE_TOL)
    if cfg.family != "ssm":
        c0 = caches[0]["attn"] if cfg.family == "hybrid" else caches[0]
        rows = next(iter(c0.values())).shape[1]
        assert rows == (min(shp.seq_len, cfg.attn_window) if cfg.attn_window
                        else shp.seq_len)


@pytest.mark.parametrize("arch", ["smollm-135m", "deepseek-v2-lite-16b"])
def test_windowed_prefill_at_twice_the_window_matches_the_reference(arch):
    """A prefill of 2048 rows, twice a 1024-row window, on the flash path
    (chunk 512): the last row's logits and the emitted ring (the last 1024
    rows) within 1e-4 of the reference's."""
    jcfg = dataclasses.replace(j_get_arch(arch).reduced(), attn_window=1024,
                               opt_flash_chunk=512)
    cfg = dataclasses.replace(get_arch(arch).reduced(), attn_window=1024,
                              opt_flash_chunk=512)
    params = jm.init_params(jax.random.PRNGKey(1), jcfg)
    model = tm.transformer_params_from_jax(
        jax.tree_util.tree_map(np.asarray, params), cfg, "cpu")
    b = t_specs.batch_struct(cfg, 1, 2 * 1024, "cpu",
                             torch.Generator().manual_seed(2))
    want_logits, want_caches = jax.jit(jm.make_prefill_step(jcfg))(
        params, {"tokens": jnp.asarray(b["tokens"].numpy())})
    with torch.inference_mode():
        logits, caches = tm.make_prefill_step(cfg)(model, b["tokens"])
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits)[:, -1:],
                               **DECODE_TOL)
    n_lead = cfg.first_dense_layers if cfg.family == "moe" else 0
    for i, c in enumerate(caches):
        j = want_caches["lead"][i] if i < n_lead else jax.tree_util.tree_map(
            lambda a: a[i - n_lead], want_caches["scan"])
        for k, t in c.items():
            assert t.shape[1] == 1024
            np.testing.assert_allclose(t.numpy(), np.asarray(j[k]), **DECODE_TOL)


RECORD_KEYS = {"arch", "shape", "kind", "chips", "flops", "bytes_accessed",
               "collectives", "memory", "params", "active_params",
               "variant_window", "batch", "reduced", "t_step_s", "roofline",
               "roofline_share", "mfu", "estimated_bytes"}


def test_run_one_on_the_cpu_gives_the_reference_record(monkeypatch):
    # a caller's count stands: run_one reads the counter's rise
    monkeypatch.setitem(fd.LAUNCHES, "flash_decode", 5)
    rec = shapes.run_one("hymba-1.5b", "long_500k", "cpu", reduced=True)
    assert fd.LAUNCHES["flash_decode"] == 5
    assert RECORD_KEYS <= set(rec)
    assert rec["device"] == "cpu" and rec["memory"] is None
    assert rec["batch"] == 1 and rec["variant_window"] == 1024
    assert rec["logits_finite"] and rec["launches"] == 0
    assert rec["roofline"]["bottleneck"] in ("compute", "memory")
    assert rec["flops"] > 0 and rec["bytes_accessed"] > 0
    assert len(rec["step_s"]) == shapes.DECODE_TIMED
    cfg = t_specs.variant_config(get_arch("hymba-1.5b").reduced(),
                                 t_specs.INPUT_SHAPES["long_500k"])
    assert rec["estimated_bytes"] == t_specs.card_bytes(
        cfg, t_specs.INPUT_SHAPES["long_500k"], 1)


def test_run_one_train_4k_on_the_cpu():
    """``train_4k``'s branch: adamw steps at 4096 rows, the losses finite,
    the flops counted on ``meta`` and the record built as phase 21's is
    (``roofline_record``)."""
    rec = shapes.run_one("smollm-135m", "train_4k", "cpu", reduced=True,
                         batch=1)
    assert RECORD_KEYS <= set(rec)
    assert rec["kind"] == "train" and rec["batch"] == 1 and rec["rows"] == 4096
    assert rec["logits_finite"] and rec["launches"] == 0
    assert len(rec["step_s"]) == shapes.TRAIN_TIMED
    cfg = get_arch("smollm-135m").reduced()
    model = tm.empty_params(cfg, "meta")
    want = shapes.roofline_record(cfg, model, "train_4k", 1, 4096,
                                  rec["t_step_s"])
    assert {k: rec[k] for k in want} == want
    assert rec["flops"] == shapes.meta_flops(cfg, "train", 1, 4096)
    assert rec["roofline"]["model_flops"] == 6 * cfg.active_param_count() * 4096


def test_run_one_and_its_cli_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device"):
        shapes.run_one("smollm-135m", "decode_32k")
    with pytest.raises(RuntimeError, match="--device cpu"):
        shapes.main(["--arch", "smollm-135m", "--shape", "long_500k"])
    rec = shapes.main(["--arch", "mamba2-2.7b", "--shape", "decode_32k",
                       "--device", "cpu", "--reduced", "--batch", "2"])
    assert rec["batch"] == 2 and rec["reduced"] == [
        "the config's reduced variant (2 layers, narrow, f32)",
        "batch set to 2 of 128"]


def test_rope_at_position_524287_matches_the_reference():
    """RoPE's float32 angles at long_500k's last positions reach 5.2e5 rad;
    torch's sin and cos there lie within 2.4e-7 of XLA's on the CPU (one
    float32 rounding of the rotated values near 1), held within 1e-6."""
    from repro.models.transformer.layers import apply_rope as j_rope
    from repro_torch.models.transformer.layers import apply_rope

    pos = np.arange(524284, 524288)[None, :]
    for D in (64, 96, 128, 256):
        x = np.random.default_rng(D).standard_normal((1, 4, 2, D)).astype(
            np.float32)
        want = np.asarray(j_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0))
        got = apply_rope(torch.as_tensor(x), torch.as_tensor(pos), 10000.0)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
