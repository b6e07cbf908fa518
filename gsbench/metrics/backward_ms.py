"""Mean ``IterStats.t_backward`` over the window (ms): the ``step/backward``
spans of a step's parts, ``torch.autograd.grad`` as the host enqueues it.
None where the program's ``IterStats`` has no such field."""


def read(rec):
    steps = rec["steps"]
    if not hasattr(steps[0], "t_backward"):
        return None
    return 1e3 * sum(s.t_backward for s in steps) / len(steps)
