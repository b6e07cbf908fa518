"""A step's model operations over the mean step time of the run's window at
the card's float32 peak (67 TFLOP/s, TF32 off), in %. The window cycles the
ring whole, so a step's operations are the mean over the ring's plans."""
from gsbench.counts import peaks, step


def read(rec):
    plans = rec["plans"]
    flops = sum(step.model_flops(s, rec["model"]) for s in plans) / len(plans)
    step_s = rec["window_s"] / len(rec["steps"])
    return 100.0 * flops / (step_s * peaks.FP32_FLOPS_S)
