"""The encoder as functions over a params dict (encoder.py) and the
predict-side model (torch_model.py)."""
