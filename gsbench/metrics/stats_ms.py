"""Mean ``IterStats.t_stats`` over the window (ms): the ``step/stats`` span,
the step's accounting (``Trainer._iter_stats``) after its sync. None where
the program's ``IterStats`` has no such field."""


def read(rec):
    steps = rec["steps"]
    if not hasattr(steps[0], "t_stats"):
        return None
    return 1e3 * sum(s.t_stats for s in steps) / len(steps)
