"""Device steps as plain functions: the dense train, eval, predict and
encode steps (steps.py), the sparse-row train step (sparse_steps.py) with
its row update (sparse_update.py, sparse_adam.py), the optimizers and
learning-rate schedules (optimizers.py), a step's random inputs
(draws.py), and the VarMisuse head's steps (vm_steps.py)."""
