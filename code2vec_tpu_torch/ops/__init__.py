"""Pooling ops: the plain PyTorch attention pool (attention.py) and the
hand-written CUDA kernel that fuses it (attention_kernel.py)."""
