"""The benchmark's counts against hand counts on a tiny plan: a ring of six
vertices, targets 0 and 3, every in-edge taken (fan-out above the degree),
two splits {0, 1, 2} and {3, 4, 5}. By hand: the input layer has 12 edges,
5 distinct sources in each split, 6 destinations, and each split sends the
other 2 rows; the top layer has 4 edges, 2 sources a split, 2 targets, and 1
row each way. Then the roofline and idle arithmetic on a synthetic trace."""
import numpy as np
import pytest

from gsbench import roofline
from gsbench.counts import gss_bwd_mixed, gss_bwd_w, gss_fwd, peaks, shuffle_bwd, step
from gsbench.trace import Trace

SAGE = {"kind": "sage", "num_layers": 2, "feat_dim": 3, "hidden_dim": 4, "num_classes": 2}
GAT = dict(SAGE, kind="gat", num_heads=2)
HAND = [
    {"edges": 12, "src_rows": 10, "dst_rows": 6, "depth_rows": 6,
     "send_slots": 4, "send_rows": 4, "shuffles": True},
    {"edges": 4, "src_rows": 4, "dst_rows": 2, "depth_rows": 6,
     "send_slots": 2, "send_rows": 2, "shuffles": True},
]


@pytest.fixture(scope="module")
def plan():
    from repro_torch.core.splitting import build_split_plan
    from repro_torch.graph.csr import CSRGraph
    from repro_torch.graph.sampling import sample_minibatch

    n = 6
    indptr = np.arange(0, 2 * n + 1, 2, dtype=np.int64)
    indices = np.array([[(v - 1) % n, (v + 1) % n] for v in range(n)],
                       dtype=np.int32).reshape(-1)
    smp = sample_minibatch(CSRGraph(indptr, indices), np.array([0, 3]), [10, 10],
                           np.random.default_rng(0))
    return build_split_plan(smp, np.array([0, 0, 0, 1, 1, 1]), 2, pad_multiple=8)


def test_summary_is_the_hand_count(plan):
    assert step.summarize(plan) == HAND


def test_sage_launches_and_counts():
    got = step.launches(HAND, SAGE)
    assert [gss_fwd.count(x) for x in got["gss_fwd"]] == [
        (4 * (10 * 3 + 6 * 3 + 2 * 12), 12 * 3), (4 * (4 * 4 + 2 * 4 + 2 * 4), 4 * 4)]
    # the input layer's rows need no gradient: one row adjoint, for the top
    assert [gss_bwd_mixed.count(x) for x in got["gss_bwd_mixed"]] == [
        (4 * (2 * 4 + 4 * 4 + 2 * 4), 4 * 4)]
    assert got["gss_bwd_w"] == []
    # the top layer's self rows and its shuffle's send gather
    assert [shuffle_bwd.count(x) for x in got["shuffle_bwd"]] == [
        (4 * (2 * 4 + 2 + 2 * 4), 2 * 4), (4 * (2 * 4 + 2 + 2 * 4), 2 * 4)]
    assert step.model_flops(HAND, SAGE) == 3 * (
        (2 * 2 * 6 * 3 * 4 + 12 * 3) + (2 * 2 * 2 * 4 * 2 + 4 * 4))


def test_gat_launches_and_counts():
    got = step.launches(HAND, GAT)
    assert len(got["gss_fwd"]) == len(got["gss_bwd_mixed"]) == len(got["gss_bwd_w"]) == 2
    assert gss_fwd.count(got["gss_fwd"][0]) == (
        4 * (10 * 4 + 6 * 4 + 2 * 12 + 2 * 12), 2 * 12 * 4)
    assert gss_bwd_w.count(got["gss_bwd_w"][1]) == (
        4 * (4 * 2 + 2 * 2 + 2 * 4 + 2 * 4), 2 * 4 * 2)
    # self rows of both layers (transformed widths), the top layer's send
    assert [(x["width"], x["slots"]) for x in got["shuffle_bwd"]] == [(4, 6), (2, 2), (4, 2)]
    fwd = ((2 * 6 * 3 * 4 + 2 * 6 * 4 + 2 * 6 * 4 + 5 * 12 * 2 + 2 * 12 * 4)
           + (2 * 6 * 4 * 2 + 2 * 6 * 2 + 2 * 2 * 2 + 5 * 4 * 2 + 2 * 4 * 2))
    assert step.model_flops(HAND, GAT) == 3 * fwd


def test_dp_layer_has_no_send():
    dp = [dict(layer, shuffles=False) for layer in HAND]
    assert len(step.launches(dp, SAGE)["shuffle_bwd"]) == 1


def test_least_seconds_is_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0) == pytest.approx(1.0)
    assert peaks.least_seconds(0, 67e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 134e12) == pytest.approx(2.0)


def test_roofline_share_and_idle_on_a_synthetic_trace():
    launches = step.launches(HAND, SAGE)["gss_fwd"]
    least = sum(peaks.least_seconds(*gss_fwd.count(x)) for x in launches)
    # two kernels of 1 us and 3 us inside a 10 us window, one host span
    tr = Trace(window=(0.0, 10.0),
               device=[("void gss_fwd_kernel<true>(float*)", 1.0, 2.0),
                       ("gss_fwd_kernel", 1.5, 4.5)],
               host=[("step/stage", 0.0, 6.0), ("step", 0.0, 10.0)])
    rec = {"plans": [HAND], "model": SAGE, "trace": tr}
    assert roofline.share(rec, "gss_fwd") == pytest.approx(100 * least / 4e-6)
    assert tr.busy_s() == pytest.approx(3.5e-6)
    idle = dict(tr.idle_by_host_span())
    assert idle["step/stage"] == pytest.approx(1.0e-6)
    assert idle["step"] == pytest.approx(5.5e-6)
    # a trace whose launch count differs from the plans' reads nothing
    rec["plans"] = [HAND, HAND]
    assert roofline.share(rec, "gss_fwd") is None
