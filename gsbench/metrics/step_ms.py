"""The window's host wall time, from the first step's delivery to the end of
the last step's sync, over the steps completed (ms)."""


def read(rec):
    return 1e3 * rec["window_s"] / len(rec["steps"])
