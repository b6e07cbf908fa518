"""The pipelined runtime (paper §5, cooperative pipelining): plan sources
(``plan_source``), the supervised ordered prefetcher (``prefetch``), plan
signatures (``signature``) and the recompile tracer (``recompile``)."""
from repro_torch.runtime.recompile import RecompileEvent, RecompileTracer
from repro_torch.runtime.signature import (
    SignatureCache,
    mesh_signature,
    plan_signature,
)

__all__ = ["RecompileEvent", "RecompileTracer", "SignatureCache",
           "mesh_signature", "plan_signature"]
