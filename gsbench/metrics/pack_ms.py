"""Mean ``IterStats.t_pack`` over the window (ms): the ``step/pack`` spans of
a step's parts, ``stage_batch``'s fields, the pack into pinned memory, the
views, the enqueue of both copies and the pad. None where the program's
``IterStats`` has no such field."""


def read(rec):
    steps = rec["steps"]
    if not hasattr(steps[0], "t_pack"):
        return None
    return 1e3 * sum(s.t_pack for s in steps) / len(steps)
