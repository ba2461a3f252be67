"""Measurement tools of the PyTorch port that run on a CUDA card."""
