"""code2vec_tpu_torch.parallel: the data, context, dcn and model axes of
the JAX package's parallel/ over `torch.distributed`: the process group
and its collectives (distributed.py), the mesh record with the rank's
coordinates and its ctx, model and shard-replica groups (mesh.py), the
differentiable collectives of the ctx and model axes (collectives.py),
the layout (row-sharded tables, the rest replicated), the batch's rows,
the rank's contexts and the tables' windows (sharding.py), and the
cohort helpers (compat.py)."""
