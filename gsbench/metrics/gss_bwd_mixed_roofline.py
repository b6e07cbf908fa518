"""The row adjoint's share of its roofline over the traced segment (%):
``gss_bwd_mixed`` with the three kernels of its source walk."""
from gsbench.counts import gss_bwd_mixed
from gsbench.roofline import share


def read(rec):
    return share(rec, "gss_bwd_mixed", gss_bwd_mixed.WALK)
