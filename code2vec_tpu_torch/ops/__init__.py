"""Ops: the plain PyTorch attention pool (attention.py) and the
hand-written CUDA kernel that fuses it (attention_kernel.py), the
live-row Adam kernels (sparse_update_kernel.py) and their plain
versions (sparse_update.py), int8 tables, the dither stream and the
dense requantize (quant.py) with its CUDA kernel (requant_kernel.py),
the sampled softmax (sampled_softmax.py).
"""
