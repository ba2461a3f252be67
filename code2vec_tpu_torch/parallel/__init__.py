"""code2vec_tpu_torch.parallel: the data axis of the JAX package's
parallel/ over `torch.distributed`: the process group and its collectives
(distributed.py), the mesh record (mesh.py), the replicated layout and
the batch's rows (sharding.py), and the cohort helpers (compat.py)."""
