"""Transformer LM of the port: prefill and greedy decode for all six
families of the JAX package (``model.py``), their blocks (``blocks.py``:
GQA and MLA attention; ``moe.py``; ``ssm.py``), layers and configs."""
