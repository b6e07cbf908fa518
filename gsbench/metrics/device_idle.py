"""The share of a step of the run's window in which the device runs
nothing, in %: one minus the device's busy time a step (the union of the
traced segment's kernel, copy and memset intervals, over its steps) over the
window's mean step time. The traced segment's own steps are slower, the
profiler taking host time a call, so they give the busy time only."""


def read(rec):
    busy = rec["trace"].busy_s() / rec["traced_steps"]
    return 100.0 * (1.0 - busy * len(rec["steps"]) / rec["window_s"])
