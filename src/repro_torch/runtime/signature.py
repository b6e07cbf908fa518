"""Plan shape signatures — the counterpart of ``repro/runtime/signature.py``.

Every delivered plan is keyed by its padded-shape tuple, and the cache
records whether that key was seen before. The high-water-mark repad makes
the padded shapes converge after a few batches, so the steady-state hit rate
approaches 1.0. The port compiles nothing yet: the key rides each delivered
batch and ``EpochStats.pipeline`` as in the reference, ready for a cache of
captured CUDA graphs to key on.
"""
from __future__ import annotations

from repro_torch.core.splitting import SplitPlan


def plan_signature(plan: SplitPlan, cache_plan=None, extra: tuple = ()) -> tuple:
    """The padded-shape key of a plan, equal to the JAX package's
    ``plan_signature`` of the same plan.

    The edge halves' widths (EL/ER, LEB/REB) are part of the key when the
    plan carries them, and the cache plan's widths (N_L, Sc, the miss width
    M) when serving. ``extra`` carries static program-structure knobs that
    change no array shape: the trainer passes ``(wire_dtype,
    shuffle_chunks, shuffle_overlap)``.
    """
    fronts = tuple(ids.shape for ids in plan.front_ids)
    # the reference's per-layer key; the replicated-block height R shifts
    # the mixed-buffer regions the gather indices point into, so two plans
    # that differ only in R never share a key
    layers = tuple(
        (
            lp.edge_src.shape,
            lp.send_idx.shape,
            lp.self_pos.shape,
            lp.pack_perm.shape,
            lp.num_replicated,
        )
        + (
            (
                lp.ledge_src.shape,
                lp.lpack_perm.shape,
                lp.redge_src.shape,
                lp.rpack_perm.shape,
            )
            if lp.has_halves
            else ()
        )
        for lp in plan.layers
    )
    cache = ()
    if cache_plan is not None:
        cache = (
            cache_plan.local_slot.shape,
            cache_plan.send_slot.shape,
            cache_plan.miss_ids.shape,
        )
    return (plan.num_devices, plan.num_layers, fronts, layers, cache, extra)


def mesh_signature(parts, extra: tuple = ()) -> tuple:
    """The padded-shape key of a mesh step, equal to the JAX package's
    ``mesh_signature``: ``parts`` is the R ``(plan, cache_plan)`` pairs of
    one ``MeshPlanBatch`` in replica order. The ``"mesh"`` tag and R lead
    the key (P is inside every part's ``plan_signature``), so the R = 1 mesh
    never shares a key with the 1-D path's plan, nor R = 1 with R = 2. After
    warm-up the parts converge to the shared high-water marks, so the count
    of keys stays O(1) per mesh shape.
    """
    return (
        "mesh",
        len(parts),
        tuple(plan_signature(plan, cp) for plan, cp in parts),
        extra,
    )


class SignatureCache:
    """Counts signature reuse across delivered plans."""

    def __init__(self):
        self._seen: dict[tuple, int] = {}
        self.hits = 0
        self.misses = 0

    def record(self, sig: tuple) -> bool:
        """Record one delivery; returns True on a hit (signature known)."""
        hit = sig in self._seen
        self._seen[sig] = self._seen.get(sig, 0) + 1
        if hit:
            self.hits += 1
        else:
            self.misses += 1
        return hit

    @property
    def num_signatures(self) -> int:
        return len(self._seen)

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> dict:
        return {
            "signatures": self.num_signatures,
            "hits": self.hits,
            "misses": self.misses,
            "hit_rate": self.hit_rate,
        }
