"""Mean host build of the ring's plans in set-up (ms): sampling, the online
split with its repad, and the feature load (``t_sample + t_split +
t_load``)."""


def read(rec):
    return 1e3 * sum(rec["build_s"]) / len(rec["build_s"])
