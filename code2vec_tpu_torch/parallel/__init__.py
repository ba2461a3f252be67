"""code2vec_tpu_torch.parallel: the data, context and dcn axes of the
JAX package's parallel/ over `torch.distributed`: the process group and
its collectives (distributed.py), the mesh record with the rank's
coordinates and ctx group (mesh.py), the ctx axis's differentiable
collectives (collectives.py), the replicated layout, the batch's rows
and the rank's contexts (sharding.py), and the cohort helpers
(compat.py)."""
