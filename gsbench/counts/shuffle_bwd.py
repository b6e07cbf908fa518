"""``shuffle_bwd`` (``csrc/shuffle_bwd.cu``): the adjoint of a row gather,
the shuffle's send gather and the layers' self rows alike. It reads each
valid slot's cotangent row and index once and writes each row that a slot
names once (rows no slot names are zeros, which the count leaves out); one
add per valid slot and feature."""

PATTERN = "shuffle_bwd_kernel"


def count(launch: dict) -> tuple:
    f, slots = launch["width"], launch["slots"]
    nbytes = 4 * (slots * f + slots + launch["rows"] * f)
    return nbytes, slots * f
