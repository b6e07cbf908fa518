"""The per-field exemption registry for the port's plan-lifecycle checker
(the counterpart of ``repro/analysis/exemptions.py``).

Every entry is ``(contract, field, leg) -> reason`` and asserts, with a
reviewable reason, that the field deliberately skips that lifecycle leg.
The checker enforces hygiene both ways: a missing entry for an unhandled
field fails CI (PL001), an entry for a field that *became* handled fails
too (PL003), and entries naming removed fields rot loudly (PL002).

The dominant pattern is the ``signature`` leg: ``plan_signature`` keys the
jit cache on one representative array per padded axis group, because jit
retraces on *shapes* — two arrays forced to share an axis by construction
cannot diverge, so keying both would only bloat the tuple. Each such
exemption names the keyed representative it is tied to. If a refactor ever
breaks the shared-axis invariant, the exemption's reason is the review
trail pointing at what must change.
"""
from __future__ import annotations

PLAN_LIFECYCLE_EXEMPTIONS: dict[tuple[str, str, str], str] = {
    # ---- LayerPlan / repad ------------------------------------------------
    ("LayerPlan", "send_count", "repad"): (
        "(P, P) true-count matrix; both axes are the static device count, "
        "there is no padded axis to grow"
    ),
    # ---- LayerPlan / signature -------------------------------------------
    ("LayerPlan", "edge_dst", "signature"): (
        "shares the (P, E) edge axis with edge_src, which is keyed; repad "
        "grows the two in lockstep under the E{i} high-water mark"
    ),
    ("LayerPlan", "edge_mask", "signature"): (
        "shares the (P, E) edge axis with edge_src, which is keyed"
    ),
    ("LayerPlan", "edge_perm", "signature"): (
        "shares the (P, E) edge axis with edge_src, which is keyed — and is "
        "never staged to device at all (see its staging exemption)"
    ),
    ("LayerPlan", "send_count", "signature"): (
        "static (P, P) shape; P is already the leading element of every "
        "signature tuple"
    ),
    ("LayerPlan", "n_local", "signature"): (
        "not a traced array: the boundary is rebased into edge_src values "
        "by repad_plan, and the padded front shapes (keyed via front_ids) "
        "pin it — two plans with equal signatures have equal n_local"
    ),
    ("LayerPlan", "seg_offsets", "signature"): (
        "(P, N_i + 1) is a pure function of the front width N_i, keyed via "
        "the front_ids shape tuple"
    ),
    ("LayerPlan", "pack_dst", "signature"): (
        "shares the (P, DB, EB) packed layout axes with pack_perm, which is "
        "keyed; repad grows both under the same EB{i} mark"
    ),
    ("LayerPlan", "ledge_dst", "signature"): (
        "shares the (P, EL) local-half axis with ledge_src, which is keyed "
        "when halves are present"
    ),
    ("LayerPlan", "ledge_mask", "signature"): (
        "shares the (P, EL) local-half axis with ledge_src, which is keyed"
    ),
    ("LayerPlan", "ledge_ids", "signature"): (
        "shares the (P, EL) local-half axis with ledge_src, which is keyed"
    ),
    ("LayerPlan", "lpack_dst", "signature"): (
        "shares the (P, DB, LEB) packed axes with lpack_perm, which is keyed"
    ),
    ("LayerPlan", "redge_dst", "signature"): (
        "shares the (P, ER) remote-half axis with redge_src, which is keyed"
    ),
    ("LayerPlan", "redge_mask", "signature"): (
        "shares the (P, ER) remote-half axis with redge_src, which is keyed"
    ),
    ("LayerPlan", "redge_ids", "signature"): (
        "shares the (P, ER) remote-half axis with redge_src, which is keyed"
    ),
    ("LayerPlan", "rpack_dst", "signature"): (
        "shares the (P, DB, REB) packed axes with rpack_perm, which is keyed"
    ),
    # ---- LayerPlan / staging ---------------------------------------------
    # (the reference exempts send_count here; the port stages it: the send
    # gather's adjoint reads the true counts, kernels/shuffle)
    ("LayerPlan", "n_local", "staging"): (
        "baked into the rebased edge_src values at repad time; the device "
        "consumes mixed-buffer indices, never the boundary itself"
    ),
    ("LayerPlan", "edge_perm", "staging"): (
        "producer-side permutation backing seg_offsets construction and "
        "repad's layout invariant; the kernels consume pack_perm/pack_dst"
    ),
    # ---- CachePlan / signature -------------------------------------------
    ("CachePlan", "local_mask", "signature"): (
        "shares the (P, N) axis with local_slot, which is keyed"
    ),
    ("CachePlan", "recv_pos", "signature"): (
        "shares the (P, P, Sc) axis with send_slot, which is keyed"
    ),
    ("CachePlan", "recv_mask", "signature"): (
        "shares the (P, P, Sc) axis with send_slot, which is keyed"
    ),
    ("CachePlan", "miss_pos", "signature"): (
        "shares the (P, M) miss axis with miss_ids, which is keyed"
    ),
    ("CachePlan", "miss_mask", "signature"): (
        "shares the (P, M) miss axis with miss_ids, which is keyed"
    ),
    # ---- CachePlan / staging ---------------------------------------------
    ("CachePlan", "miss_ids", "staging"): (
        "host-side gather list: consumed by load_miss_features before "
        "staging; the ids themselves never reach the device"
    ),
}


#: (path, function qualname, rule) -> why a host sync (or another hot-path
#: finding) on the step path is deliberate. The purity lint reports an
#: entry that no longer matches a finding (HP009) and one without a reason
#: (HP010).
HOT_PATH_EXEMPTIONS: dict[tuple[str, str, str], str] = {
    ("src/repro_torch/train/trainer.py", "Trainer._sync_step", "HP001"): (
        "the step's one designed sync: one transfer brings the loss, the "
        "accuracy and, under skip_nonfinite, the finite flag to the host, "
        "where the guard reads the loss to keep or drop the update; the "
        "epoch loop reports them every step, as the reference's float() of "
        "its stacked scalars does"
    ),
    ("src/repro_torch/launch/mesh.py", "_sum_", "HP001"): (
        "host transport: gloo takes no CUDA tensor, so a mesh over gloo "
        "(several ranks rehearsed on one card) copies through the host; "
        "over NCCL the branch is not taken"
    ),
    ("src/repro_torch/launch/mesh.py", "_gather", "HP001"): (
        "host transport: gloo takes no CUDA tensor for an all-gather, so a "
        "mesh over gloo copies through the host; over NCCL the branch is "
        "not taken"
    ),
}


#: (package or file path, rule) -> why a kernel package's layout differs
#: from the contract on purpose. The kernel contract checker reports an
#: entry that no longer matches a finding (KC008) and one without a reason
#: (KC009).
KERNEL_CONTRACT_EXEMPTIONS: dict[tuple[str, str], str] = {
    ("src/repro_torch/kernels/segsum", "KC001"): (
        "the plain version (segment_sum_packed_ref) lives in ops.py beside "
        "the wrapper and the packing (pack_edges) it and edge_softmax share; "
        "the reference's ref.py is one jnp function"
    ),
    ("src/repro_torch/kernels/segsum", "KC005"): (
        "the wrapper (segment_sum_packed: launch on a card tensor, the plain "
        "version on a CPU one) lives in ops.py; the reference's kernel.py is "
        "a Pallas body, which a CUDA source in csrc/ replaces"
    ),
    ("src/repro_torch/kernels/edge_softmax", "KC001"): (
        "the plain version (edge_softmax_packed_ref) lives in ops.py beside "
        "the wrapper; it shares segsum.ops' packing"
    ),
    ("src/repro_torch/kernels/edge_softmax", "KC005"): (
        "the wrapper (edge_softmax_packed) lives in ops.py; the reference's "
        "kernel.py is a Pallas body, which csrc/edge_softmax_packed.cu "
        "replaces"
    ),
    ("src/repro_torch/sampler", "KC002"): (
        "the reference's sampler/ops.py is a JAX switch between Pallas and "
        "jnp; the port's padding and dispatch live in "
        "kernel.py::wavefront_expand (the kernel on a card tensor, the plain "
        "version on a CPU one), so it needs no counterpart"
    ),
}
