"""code2vec_tpu_torch: the code2vec system on PyTorch and CUDA (NVIDIA H100).

A port of the JAX package `code2vec_tpu` beside it, one slice at a time.
This slice is the serving path of the default model (the `code2vec`
head with the `bag` encoder): raw path-context lines are parsed
(data/reader.py), embedded by three table gathers and pooled by the
hand-written CUDA attention-pool kernel (models/encoder.py,
ops/attention_kernel.py, csrc/attention_pool.cu), scored against the
target table (training/steps.py), and decoded, behind a micro-batching
prediction server (serving/server.py).

The package imports `torch` and never `jax`, nor anything of the JAX
package: it keeps its own copies of the host-side modules it needs.
Entry points run on the CUDA card unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
