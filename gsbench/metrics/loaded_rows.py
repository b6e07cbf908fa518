"""Mean ``IterStats.loaded_rows`` over the window: feature rows a step
loads, summed over the splits."""


def read(rec):
    return sum(s.loaded_rows for s in rec["steps"]) / len(rec["steps"])
