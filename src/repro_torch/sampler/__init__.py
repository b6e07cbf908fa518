"""Device-resident cooperative sampling (the device plan source), the
counterpart of ``repro.sampler`` in sim form:

  * ``shard``    -- padded per-partition CSR blocks + ownership maps
  * ``rng``      -- counter-based draws keyed by (seed, epoch, batch, layer)
  * ``kernel``   -- the CUDA wavefront-expansion kernel's wrapper
                    (``ref`` = its plain version)
  * ``frontier`` -- static-cap sort-based dedup and ownership routing
  * ``engine``   -- the cooperative loop and ``DeviceSampler``, the
                    producer-facing facade with capacity high-water marks
                    and host-sampler fallback
"""
from repro_torch.sampler.engine import DeviceSampler
from repro_torch.sampler.shard import GraphShards, build_shards, shards_to_device

__all__ = ["DeviceSampler", "GraphShards", "build_shards", "shards_to_device"]
