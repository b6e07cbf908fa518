"""Published peaks of one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data
sheet, dense rates): HBM3 bandwidth and float32 outside the tensor cores,
the rate of the GNN step, which runs float32 with TF32 off."""

HBM_BYTES_S = 3.35e12
FP32_FLOPS_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The least time a launch can take: the larger of its bytes over the
    bandwidth and its operations over the float32 peak."""
    return max(nbytes / HBM_BYTES_S, flops / FP32_FLOPS_S)
