"""Transformer LM of the port: the dense family's prefill and greedy decode
(``model.py``), its blocks and layers, and the architecture configs."""
