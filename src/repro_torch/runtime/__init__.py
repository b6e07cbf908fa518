"""The pipelined runtime (paper §5, cooperative pipelining): plan sources
(``plan_source``), the supervised ordered prefetcher (``prefetch``) and
plan signatures (``signature``)."""
from repro_torch.runtime.signature import (
    SignatureCache,
    mesh_signature,
    plan_signature,
)

__all__ = ["SignatureCache", "mesh_signature", "plan_signature"]
