"""Mean ``IterStats.t_optimizer`` over the window (ms): the ``step/optimizer``
spans, the mesh's gradient average, the update and its guard as the host
enqueues them. None where the program's ``IterStats`` has no such field."""


def read(rec):
    steps = rec["steps"]
    if not hasattr(steps[0], "t_optimizer"):
        return None
    return 1e3 * sum(s.t_optimizer for s in steps) / len(steps)
