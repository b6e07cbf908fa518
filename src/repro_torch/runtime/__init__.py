"""Plan sources feeding the trainer (serial source; the pipelined one comes
with a later slice)."""
