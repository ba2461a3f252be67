"""The dense-parameter optimizer of the sparse-row training step.

Counterpart of the `adam` branch of `make_optimizer` in the JAX
package's training/optimizers.py: `optax.chain(scale_by_adam_f32_moments(),
optax.scale_by_learning_rate(lr))` followed by `optax.apply_updates`,
written out over a dict of tensors and applied in place. The moments
are float32 whatever the parameter dtype. The cast order is part of the
result, and is the JAX package's:

1. the update `(mu / bc1) / (sqrt(nu / bc2) + eps)` is computed in
   float32 and cast to the GRADIENT's dtype;
2. it is multiplied by `-lr` in that dtype (the scalar is rounded to the
   dtype first, as JAX does with a Python scalar);
3. it is added to the parameter and the sum cast to the parameter's
   dtype.

For a bf16 `target_emb` under full softmax every one of those steps
rounds to bf16. Only the constant learning rate is ported; the Adafactor
table optimizer and the other schedules raise `NotImplementedError`.
"""

from __future__ import annotations

from typing import Dict

import torch

_INT32_MAX = 2 ** 31 - 1


class AdamF32Moments:
    """Adam with float32 moments at a constant learning rate, over a dict
    of tensors. State: {"count": int32 0-d, "mu": {k: f32}, "nu": {k: f32}}
    (the JAX package's `ScaleByAdamState(count, mu, nu)`)."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Dict[str, torch.Tensor]) -> dict:
        dev = next(iter(params.values())).device
        return {
            "count": torch.zeros((), dtype=torch.int32, device=dev),
            "mu": {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for k, p in params.items()},
            "nu": {k: torch.zeros(p.shape, dtype=torch.float32,
                                  device=p.device) for k, p in params.items()},
        }

    @torch.no_grad()
    def step(self, params: Dict[str, torch.Tensor],
             grads: Dict[str, torch.Tensor], state: dict) -> None:
        """One update of every param in `grads`, in place on the params
        and the state. Never reads a value back to the host."""
        b1, b2, eps = self.b1, self.b2, self.eps
        count = state["count"]
        # optax.safe_int32_increment: saturates instead of wrapping
        count.copy_(torch.where(count < _INT32_MAX, count + 1, count))
        c = count.to(torch.float32)
        bc1 = 1.0 - b1 ** c
        bc2 = 1.0 - b2 ** c
        for k, g in grads.items():
            g32 = g.to(torch.float32)
            mu, nu = state["mu"][k], state["nu"][k]
            mu.copy_(b1 * mu + (1.0 - b1) * g32)
            nu.copy_(b2 * nu + (1.0 - b2) * (g32 * g32))
            u = ((mu / bc1) / (torch.sqrt(nu / bc2) + eps)).to(g.dtype)
            u = u * torch.full((), -self.learning_rate, dtype=u.dtype,
                               device=u.device)
            p = params[k]
            p.copy_((p + u).to(p.dtype))


def make_lr(learning_rate: float, schedule: str = "constant") -> float:
    """The learning rate of a schedule. Only "constant" is ported."""
    if schedule == "constant":
        return learning_rate
    raise NotImplementedError(
        f"lr schedule {schedule!r} is not ported; only 'constant' is")


def make_optimizer(learning_rate: float,
                   embedding_optimizer: str = "adafactor") -> AdamF32Moments:
    """The dense optimizer. Only the "adam" branch is ported."""
    if embedding_optimizer == "adam":
        return AdamF32Moments(learning_rate)
    raise NotImplementedError(
        f"embedding optimizer {embedding_optimizer!r} is not ported; only "
        f"'adam' (with sparse row updates) is")
