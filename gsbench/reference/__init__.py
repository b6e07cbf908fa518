"""Plain references the benchmark judges the program's outputs by. They
import torch and numpy only: nothing of the program and nothing of JAX."""
