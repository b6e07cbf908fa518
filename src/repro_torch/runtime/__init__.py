"""The pipelined runtime (paper §5, cooperative pipelining): plan sources
(``plan_source``), the supervised ordered prefetcher (``prefetch``) and
plan signatures (``signature``)."""
