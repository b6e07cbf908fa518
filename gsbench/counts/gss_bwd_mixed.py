"""``gss_bwd_mixed`` with its source walk (``walk_count``, ``walk_place``,
``walk_order``): the row adjoint of the fused sum. The operation reads each
true destination row's cotangent once, the true edges' indices (and
weights), and writes the cotangent of each true source row once; the walk
is the kernel's own work, so its time counts and its bytes do not."""

PATTERN = "gss_bwd_mixed_kernel"
#: the walk's kernels, launched once each with every row adjoint
WALK = ("walk_count_kernel", "walk_place_kernel", "walk_order_kernel")


def count(launch: dict) -> tuple:
    f, e, h = launch["width"], launch["edges"], launch["heads"]
    nbytes = 4 * (launch["dst_rows"] * f + launch["src_rows"] * f + 2 * e + h * e)
    return nbytes, e * f * (2 if h else 1)
