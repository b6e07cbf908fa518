"""Mean ``IterStats.t_forward`` over the window (ms): the ``step/forward``
spans of a step's parts, the forward with its layer shuffles, the masked
loss and the accuracy as the host enqueues them. None where the program's
``IterStats`` has no such field."""


def read(rec):
    steps = rec["steps"]
    if not hasattr(steps[0], "t_forward"):
        return None
    return 1e3 * sum(s.t_forward for s in steps) / len(steps)
