"""Device steps as plain functions: predict and encode (steps.py), the
sparse-row train step (sparse_steps.py) with its row update
(sparse_update.py, sparse_adam.py) and dense optimizer (optimizers.py)."""
