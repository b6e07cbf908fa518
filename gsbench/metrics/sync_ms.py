"""Mean ``IterStats.t_device`` over the window (ms): the step's one sync,
the device work the host waits for."""


def read(rec):
    return 1e3 * sum(s.t_device for s in rec["steps"]) / len(rec["steps"])
