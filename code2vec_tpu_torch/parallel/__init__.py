"""code2vec_tpu_torch.parallel: what the port has of the JAX package's
parallel/ so far (`compat.free_port`); the mesh, sharding and
distributed modules come with multi-GPU training."""
