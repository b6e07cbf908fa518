"""Mean ``IterStats.t_stage`` over the window (ms): staging and enqueueing a
step, its forward, backward and update on the host."""


def read(rec):
    return 1e3 * sum(s.t_stage for s in rec["steps"]) / len(rec["steps"])
