"""The encoders as functions over a params dict (encoder.py: the bag
and the dispatch; transformer_encoder.py: the transformer), the
predict-side model and the trainer (torch_model.py), the evaluation
metrics (model_base.py), and the VarMisuse head (varmisuse.py) with its
trainer (vm_model.py)."""
