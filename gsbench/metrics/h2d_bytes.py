"""Mean ``IterStats.h2d_bytes`` over the window: the bytes a step's staging
copies carry (the packed plan buffer and the feature block), summed over
its parts. None where the program's ``IterStats`` has no such field."""


def read(rec):
    steps = rec["steps"]
    if not hasattr(steps[0], "h2d_bytes"):
        return None
    return sum(s.h2d_bytes for s in steps) / len(steps)
