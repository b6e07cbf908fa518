"""Mean ``IterStats.shuffle_rows`` over the window: rows crossing splits in
a step's layer shuffles (none in a dp cell, which reports nothing)."""


def read(rec):
    rows = sum(s.shuffle_rows for s in rec["steps"]) / len(rec["steps"])
    return rows or None
