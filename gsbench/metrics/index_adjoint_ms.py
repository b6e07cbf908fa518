"""Device ms a step of torch's indexing adjoint (``indexing_backward_kernel``)
in the traced segment: the backward of the advanced-index gathers of GAT's
edge scores."""


def read(rec):
    launches, seconds = rec["trace"].kernel_seconds("indexing_backward_kernel")
    return 1e3 * seconds / rec["traced_steps"] if launches else None
