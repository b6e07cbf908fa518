"""From the process's start to the first timed step (s): data, weights, the
trainer with its presample and partition, the ring's builds, the checked
steps and the warm-up pass, with any kernel build."""


def read(rec):
    return rec["setup_s"]
