"""Single-token GQA decode attention over a masked KV cache: the CUDA
split-K kernel's wrapper (``kernel.py``), its plain torch version
(``ref.py``) and the public op (``ops.py``)."""
