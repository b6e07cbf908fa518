"""``Trainer.t_presample + t_partition`` (s): the presample and the
partition that every split-mode trainer runs when it is built."""


def read(rec):
    if rec["traffic"]["mode"] != "split":
        return None
    return rec["t_presample"] + rec["t_partition"]
