"""code2vec_tpu_torch: the code2vec system on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package `code2vec_tpu` beside it, one slice at a time.
These paths of the `code2vec` head are ported, with the `bag` encoder
and with the transformer path-encoder (models/transformer_encoder.py,
its multi-head attention in the hand-written CUDA forward and backward
kernels of csrc/xf_attention.cu, ops/xf_attention.py):

- serving: raw path-context lines are parsed (data/reader.py), embedded
  by three table gathers and pooled by the hand-written CUDA
  attention-pool kernel (models/encoder.py, ops/attention_kernel.py,
  csrc/attention_pool.cu), scored against the target table
  (training/steps.py), and decoded, behind a micro-batching prediction
  server (serving/server.py);
- training (models/torch_model.Code2VecTrainer) over `.c2v` batches,
  through the attention-pool kernel: the default dense step
  (training/steps.py) with Adafactor on the vocab tables, Adam on
  TRANSFORM / ATTENTION and a learning-rate schedule
  (training/optimizers.py), int8 tables requantized by the hand-written
  CUDA kernel of csrc/requant.cu; or the sparse-row step
  (training/sparse_steps.py) with live-row Adam on the tables through
  the kernels of csrc/sparse_row_update.cu;
- evaluation (`Code2VecTrainer.evaluate`): top-k accuracy and subtoken
  precision / recall / F1 (models/model_base.py).

The sparse-row step and int8 tables take the bag encoder only, as in the
JAX package. Nested params (the transformer's "xf" subtree) meet the
optimizers as path-keyed leaves (tree.py).

The package imports `torch` and never `jax`, nor anything of the JAX
package: it keeps its own copies of the host-side modules it needs.
Entry points run on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.4.0"
