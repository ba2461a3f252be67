"""code2vec_tpu_torch: the code2vec system on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package `code2vec_tpu` beside it, one slice at a time.
Two paths of the `code2vec` head with the `bag` encoder are ported:

- serving: raw path-context lines are parsed (data/reader.py), embedded
  by three table gathers and pooled by the hand-written CUDA
  attention-pool kernel (models/encoder.py, ops/attention_kernel.py,
  csrc/attention_pool.cu), scored against the target table
  (training/steps.py), and decoded, behind a micro-batching prediction
  server (serving/server.py);
- training with sparse row updates (models/torch_model.Code2VecTrainer,
  training/sparse_steps.py): `.c2v` batches, gathered-row
  differentiation through the attention-pool kernel, dense Adam on
  TRANSFORM / ATTENTION, and live-row Adam on the vocab tables through
  the hand-written CUDA kernels of csrc/sparse_row_update.cu.

The package imports `torch` and never `jax`, nor anything of the JAX
package: it keeps its own copies of the host-side modules it needs.
Entry points run on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.2.0"
