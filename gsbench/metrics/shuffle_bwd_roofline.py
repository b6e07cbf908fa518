"""``shuffle_bwd``'s share of its roofline over the traced segment (%)."""
from gsbench.roofline import share


def read(rec):
    return share(rec, "shuffle_bwd")
