"""``gss_fwd``: the fused gather and segment sum (``csrc/gather_segsum.cu``),
weighted for GAT. Per launch it reads each true source row once, the true
edges' two packed indices (and a weight per head for GAT), and writes each
true destination row once; one add per edge and feature (a multiply and an
add when weighted)."""

PATTERN = "gss_fwd_kernel"


def count(launch: dict) -> tuple:
    f, e, h = launch["width"], launch["edges"], launch["heads"]
    nbytes = 4 * (launch["src_rows"] * f + launch["dst_rows"] * f + 2 * e + h * e)
    return nbytes, e * f * (2 if h else 1)
