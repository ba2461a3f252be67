"""The encoder as functions over a params dict (encoder.py), the
predict-side model and the trainer (torch_model.py), the evaluation
metrics (model_base.py)."""
