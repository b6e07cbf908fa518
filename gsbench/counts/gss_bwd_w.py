"""``gss_bwd_w``: GAT's weight adjoint, a dot product per edge and head of
the source row and the destination's cotangent. It reads both true row sets
once and the edges' indices, and writes one weight per edge and head."""

PATTERN = "gss_bwd_w_kernel"


def count(launch: dict) -> tuple:
    f, e, h = launch["width"], launch["edges"], launch["heads"]
    nbytes = 4 * (launch["src_rows"] * f + launch["dst_rows"] * f + 2 * e + h * e)
    return nbytes, 2 * e * f
