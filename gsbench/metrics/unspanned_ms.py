"""The window's host time a step that no program span covers (ms): the
window's mean step (``step_ms``) less the mean of ``t_wait + t_stage +
t_device + t_stats``, the spans of the step's wait, staging, sync and
accounting; what is left is the epoch loop's own time. None where the
program's ``IterStats`` has no ``t_stats``."""


def read(rec):
    steps = rec["steps"]
    if not hasattr(steps[0], "t_stats"):
        return None
    spanned = sum(s.t_wait + s.t_stage + s.t_device + s.t_stats for s in steps)
    return 1e3 * (rec["window_s"] - spanned) / len(steps)
