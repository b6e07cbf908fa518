"""PyTorch/CUDA port of the GSplit reproduction (the JAX package ``repro`` is
the reference it is tested against).

The port imports ``torch`` and ``numpy`` and nothing of ``repro``. Its entry
points run on the card unless the caller passes ``device="cpu"``; the fused
aggregation kernels are hand-written CUDA (``csrc/``), built with ``nvcc`` at
first use.
"""
import torch

# Full-fp32 products everywhere: the parity tolerances against the JAX
# reference (loss 2e-5, grads 5e-4) assume fp32 math, and TF32 keeps about
# three decimal digits. Matmuls already default to fp32 on the card, but
# cuDNN defaults to TF32, so both are stated here rather than inherited.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
