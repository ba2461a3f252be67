"""Optimizer construction: the learning-rate schedules and the optimizers
of the dense and the sparse-row training steps.

Counterpart of `training/optimizers.py` in the JAX package. The JAX
package builds its optimizers from optax; the port keeps its own copy of
the optax transforms those optimizers use, under optax's names and with
optax's arithmetic and dtypes, over dicts of tensors:

- `scale_by_factored_rms`, `clip_by_block_rms`, `scale_by_learning_rate`
  and `scale(-1)` make `optax.adafactor(lr, multiply_by_parameter_scale=
  False, momentum=None)`, the default optimizer of the vocab tables;
- `scale_by_adam` + `scale_by_learning_rate` is stock `optax.adam`, on
  TRANSFORM, ATTENTION and the transformer's "xf" leaves beside
  Adafactor; `scale_by_adam_f32_moments`
  (the JAX package's own) keeps float32 moments for the `adam` branch;
- `scale_by_trust_ratio` is LAMB's per-array (per-leaf) rescale;
- `chain` and `multi_transform` compose them; `make_optimizer` builds
  every branch of the JAX package's function.

The transforms work over flat dicts of tensors. Nested params (the
transformer's "xf" subtree) reach them flattened to path-keyed leaves
("xf/layers/0/qkv", ops/quant.opt_param_view), so every leaf is its own
array, as optax treats each leaf of a pytree.

Each transform's state is a NamedTuple with optax's name and fields
(`FactoredState(count, v_row, v_col, v)`, `ScaleByAdamState(count, mu,
nu)`, `ScaleByScheduleState(count)`, `EmptyState()`), so a JAX optimizer
state carries over leaf for leaf (convert.py). A `multi_transform` state
is a dict {label: the group's chain state}: optax's `MaskedState`
wrappers and `MaskedNode` placeholders hold no values and are dropped.
Unlike optax, `update` changes the state's tensors in place and returns
only the updates; `apply` also adds them to the params in place.

Dtypes and rounding places are optax's: a transform computes in the
param's dtype, so Adafactor's second moments, its factors and its update
are bf16 for bf16 tables (the step count, the decay rate and the
schedules are float32); a Python scalar meeting a bf16 tensor is rounded
to bf16 first, as JAX does with weak types.

`AdamF32Moments` is the sparse-row step's dense optimizer (Adam with
float32 moments at a constant learning rate, state {"count", "mu",
"nu"}), with `scale_by_adam_f32_moments`'s arithmetic.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

TABLE_PARAMS = ("token_emb", "path_emb", "target_emb")

_INT32_MAX = 2 ** 31 - 1

Tensors = Dict[str, torch.Tensor]
Schedule = Callable[[torch.Tensor], torch.Tensor]


# ---- states (optax's names and fields) ----

class EmptyState(NamedTuple):
    """A stateless transform's state."""


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor  # int32 0-d
    mu: Tensors
    nu: Tensors


class FactoredState(NamedTuple):
    count: torch.Tensor  # int32 0-d
    v_row: Tensors       # factored leaves; [1] placeholders elsewhere
    v_col: Tensors
    v: Tensors           # unfactored leaves; [1] placeholders elsewhere


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor  # int32 0-d


def _safe_increment_(count: torch.Tensor) -> None:
    """optax.safe_increment in place: saturates instead of wrapping."""
    count.copy_(torch.where(count < _INT32_MAX, count + 1, count))


def _scalar(x: float, like: torch.Tensor) -> torch.Tensor:
    """A Python scalar as a 0-d tensor of `like`'s dtype: JAX rounds a
    weak-typed scalar to a bf16 operand's dtype before the operation."""
    return torch.full((), x, dtype=like.dtype, device=like.device)


def _mean(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """jnp.mean: a float32 sum divided in float32, cast back to x's dtype."""
    x32 = x.to(torch.float32)
    if dim is None:
        return (x32.sum() / x.numel()).to(x.dtype)
    return (x32.sum(dim=dim, keepdim=keepdim) / x.shape[dim]).to(x.dtype)


def _rsqrt(x: torch.Tensor) -> torch.Tensor:
    """x ** -0.5 computed in float32 and rounded once to x's dtype, as XLA
    computes a bf16 power (torch's bf16 power is off by one bf16 ulp on
    some inputs)."""
    return torch.rsqrt(x.to(torch.float32)).to(x.dtype)


def _device_of(params: Tensors) -> torch.device:
    return next(iter(params.values())).device


def _zero_count(params: Tensors) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32, device=_device_of(params))


class GradientTransformation:
    """init(params) -> state; update(updates, state, params) -> updates,
    with the state's tensors changed in place."""

    def init(self, params: Tensors):
        raise NotImplementedError

    def update(self, updates: Tensors, state, params: Tensors) -> Tensors:
        raise NotImplementedError

    @torch.no_grad()
    def apply(self, params: Tensors, grads: Tensors, state) -> None:
        """One optimizer step in place: `optimizer.update` then
        `optax.apply_updates` ((p + u) cast to p's dtype)."""
        updates = self.update(grads, state, params)
        for k, u in updates.items():
            p = params[k]
            p.copy_((p + u).to(p.dtype))


# ---- the transforms ----

def _factored_dims(shape, factored: bool, min_dim_size_to_factor: int
                   ) -> Optional[Tuple[int, int]]:
    """optax's choice: the two largest axes (second largest, largest), or
    None when the second largest is under `min_dim_size_to_factor`."""
    if not factored or len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < min_dim_size_to_factor:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


class scale_by_factored_rms(GradientTransformation):
    """Adafactor's factored second-moment scaling (optax
    `scale_by_factored_rms` with the default power decay schedule
    `1 - (t + 1)^-decay_rate`)."""

    def __init__(self, factored: bool = True, decay_rate: float = 0.8,
                 step_offset: int = 0, min_dim_size_to_factor: int = 128,
                 epsilon: float = 1e-30):
        self.factored, self.decay_rate = factored, decay_rate
        self.step_offset = step_offset
        self.min_dim_size_to_factor = min_dim_size_to_factor
        self.epsilon = epsilon

    def _dims(self, shape):
        return _factored_dims(tuple(shape), self.factored,
                              self.min_dim_size_to_factor)

    def init(self, params: Tensors) -> FactoredState:
        v_row, v_col, v = {}, {}, {}
        for k, p in params.items():
            def zeros(shape):
                return torch.zeros(tuple(shape), dtype=p.dtype,
                                   device=p.device)
            dims = self._dims(p.shape)
            if dims is not None:
                d1, d0 = dims
                v_row[k] = zeros(np.delete(p.shape, d0))
                v_col[k] = zeros(np.delete(p.shape, d1))
                v[k] = zeros((1,))
            else:
                v_row[k], v_col[k], v[k] = zeros((1,)), zeros((1,)), \
                    zeros(p.shape)
        return FactoredState(_zero_count(params), v_row, v_col, v)

    @torch.no_grad()
    def update(self, updates: Tensors, state: FactoredState,
               params: Tensors) -> Tensors:
        t = (state.count - self.step_offset + 1).to(torch.float32)
        decay_t = 1.0 - t ** -self.decay_rate  # float32 0-d
        out = {}
        for k, g in updates.items():
            dtype = params[k].dtype
            grad_sqr = g * g + _scalar(self.epsilon, g)
            dims = self._dims(params[k].shape)
            if dims is not None:
                d1, d0 = dims
                # decay_t is float32, so the mix runs in float32 and is
                # cast to the param's dtype at the end
                new_v_row = (decay_t * state.v_row[k].to(torch.float32)
                             + (1.0 - decay_t)
                             * _mean(grad_sqr, d0).to(torch.float32)
                             ).to(dtype)
                new_v_col = (decay_t * state.v_col[k].to(torch.float32)
                             + (1.0 - decay_t)
                             * _mean(grad_sqr, d1).to(torch.float32)
                             ).to(dtype)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = _mean(new_v_row, reduced_d1, keepdim=True)
                row_factor = _rsqrt(new_v_row / row_col_mean)
                col_factor = _rsqrt(new_v_col)
                out[k] = (g * row_factor.unsqueeze(d0)
                          * col_factor.unsqueeze(d1))
                state.v_row[k].copy_(new_v_row)
                state.v_col[k].copy_(new_v_col)
            else:
                new_v = (decay_t * state.v[k].to(torch.float32)
                         + (1.0 - decay_t) * grad_sqr.to(torch.float32)
                         ).to(dtype)
                out[k] = g * _rsqrt(new_v)
                state.v[k].copy_(new_v)
        _safe_increment_(state.count)
        return out


class clip_by_block_rms(GradientTransformation):
    """Each update divided by max(1, rms(update) / threshold)."""

    def __init__(self, threshold: float):
        self.threshold = threshold

    def init(self, params: Tensors) -> EmptyState:
        return EmptyState()

    @torch.no_grad()
    def update(self, updates: Tensors, state, params=None) -> Tensors:
        out = {}
        for k, u in updates.items():
            rms = torch.sqrt(_mean(u * u))
            clip_denom = torch.clamp(rms / _scalar(self.threshold, u),
                                     min=1.0)
            out[k] = u / clip_denom
        return out


class scale(GradientTransformation):
    """Updates times a constant."""

    def __init__(self, step_size: float):
        self.step_size = step_size

    def init(self, params: Tensors) -> EmptyState:
        return EmptyState()

    @torch.no_grad()
    def update(self, updates: Tensors, state, params=None) -> Tensors:
        return {k: _scalar(self.step_size, u) * u
                for k, u in updates.items()}


class scale_by_schedule(GradientTransformation):
    """Updates times `step_size_fn(count)`, the count read before it is
    incremented; the float32 step size is cast to each update's dtype."""

    def __init__(self, step_size_fn: Schedule):
        self.step_size_fn = step_size_fn

    def init(self, params: Tensors) -> ScaleByScheduleState:
        return ScaleByScheduleState(_zero_count(params))

    @torch.no_grad()
    def update(self, updates: Tensors, state: ScaleByScheduleState,
               params=None) -> Tensors:
        step_size = torch.as_tensor(self.step_size_fn(state.count),
                                    dtype=torch.float32,
                                    device=state.count.device)
        out = {k: step_size.to(u.dtype) * u for k, u in updates.items()}
        _safe_increment_(state.count)
        return out


def scale_by_learning_rate(learning_rate: Union[float, Schedule],
                           flip_sign: bool = True) -> GradientTransformation:
    m = -1 if flip_sign else 1
    if callable(learning_rate):
        return scale_by_schedule(lambda count: m * learning_rate(count))
    return scale(m * learning_rate)


def _adam_moments_(g32: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                   b1: float, b2: float) -> None:
    """The moment updates of Adam, in place, in the moments' dtype."""
    mu.copy_(_scalar(1 - b1, mu) * g32 + _scalar(b1, mu) * mu)
    nu.copy_(_scalar(1 - b2, nu) * (g32 * g32) + _scalar(b2, nu) * nu)


def _adam_direction(mu: torch.Tensor, nu: torch.Tensor, count: torch.Tensor,
                    b1: float, b2: float, eps: float) -> torch.Tensor:
    """(mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps) for the (already
    incremented) count t; the corrections are float32, cast to the
    moments' dtype."""
    c = count.to(torch.float32)
    bc1 = (1.0 - b1 ** c).to(mu.dtype)
    bc2 = (1.0 - b2 ** c).to(nu.dtype)
    return (mu / bc1) / (torch.sqrt(nu / bc2) + _scalar(eps, nu))


class scale_by_adam(GradientTransformation):
    """Stock optax Adam scaling: moments in the param's dtype."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tensors) -> ScaleByAdamState:
        return ScaleByAdamState(
            _zero_count(params),
            {k: torch.zeros_like(p) for k, p in params.items()},
            {k: torch.zeros_like(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, updates: Tensors, state: ScaleByAdamState,
               params=None) -> Tensors:
        for k, g in updates.items():
            _adam_moments_(g, state.mu[k], state.nu[k], self.b1, self.b2)
        _safe_increment_(state.count)
        return {k: _adam_direction(state.mu[k], state.nu[k], state.count,
                                   self.b1, self.b2, self.eps)
                for k in updates}


class scale_by_adam_f32_moments(scale_by_adam):
    """The JAX package's Adam scaling with float32 moments whatever the
    param dtype; the direction is cast to the update's dtype."""

    def init(self, params: Tensors) -> ScaleByAdamState:
        def zeros(p):
            return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return ScaleByAdamState(_zero_count(params),
                                {k: zeros(p) for k, p in params.items()},
                                {k: zeros(p) for k, p in params.items()})

    @torch.no_grad()
    def update(self, updates: Tensors, state: ScaleByAdamState,
               params=None) -> Tensors:
        for k, g in updates.items():
            _adam_moments_(g.to(torch.float32), state.mu[k], state.nu[k],
                           self.b1, self.b2)
        _safe_increment_(state.count)
        return {k: _adam_direction(state.mu[k], state.nu[k], state.count,
                                   self.b1, self.b2, self.eps).to(g.dtype)
                for k, g in updates.items()}


def _norm(x: torch.Tensor) -> torch.Tensor:
    """jnp.linalg.norm over all elements: squares in x's dtype, a float32
    sum cast back, then the square root."""
    return torch.sqrt((x * x).to(torch.float32).sum().to(x.dtype))


class scale_by_trust_ratio(GradientTransformation):
    """LAMB's per-array rescale: update * ||param|| / ||update||, or 1
    when either norm is 0 (optax defaults: no min norm, coefficient 1,
    eps 0)."""

    def init(self, params: Tensors) -> EmptyState:
        return EmptyState()

    @torch.no_grad()
    def update(self, updates: Tensors, state, params: Tensors) -> Tensors:
        out = {}
        for k, u in updates.items():
            param = params[k]
            param_norm, update_norm = _norm(param), _norm(u)
            ratio = param_norm / update_norm
            zero_norm = (param_norm == 0) | (update_norm == 0)
            out[k] = u * torch.where(zero_norm, _scalar(1.0, param), ratio)
        return out


class chain(GradientTransformation):
    """Transforms applied in order; the state is the tuple of theirs."""

    def __init__(self, *transforms: GradientTransformation):
        self.transforms = transforms

    def init(self, params: Tensors) -> tuple:
        return tuple(tx.init(params) for tx in self.transforms)

    def update(self, updates: Tensors, state: tuple,
               params: Tensors) -> Tensors:
        for tx, st in zip(self.transforms, state):
            updates = tx.update(updates, st, params)
        return updates


class multi_transform(GradientTransformation):
    """One transform per label of `labels(params)`, each over its own
    params; the state is {label: that transform's state}."""

    def __init__(self, transforms: Dict[str, GradientTransformation],
                 labels: Callable[[Tensors], Dict[str, str]]):
        self.transforms, self.labels = transforms, labels

    def _groups(self, tree: Tensors) -> Dict[str, Tensors]:
        labels = self.labels(tree)
        return {lab: {k: v for k, v in tree.items() if labels[k] == lab}
                for lab in self.transforms}

    def init(self, params: Tensors) -> dict:
        return {lab: self.transforms[lab].init(group)
                for lab, group in self._groups(params).items() if group}

    def update(self, updates: Tensors, state: dict,
               params: Tensors) -> Tensors:
        p_groups = self._groups(params)
        out = {}
        for lab, group in self._groups(updates).items():
            if group:
                out.update(self.transforms[lab].update(
                    group, state[lab], p_groups[lab]))
        return out


def adafactor(learning_rate, min_dim_size_to_factor: int = 128,
              decay_rate: float = 0.8, eps: float = 1e-30,
              clipping_threshold: float = 1.0) -> chain:
    """`optax.adafactor(lr, multiply_by_parameter_scale=False,
    momentum=None)`: factored rms, block-rms clip, learning rate, -1."""
    return chain(scale_by_factored_rms(True, decay_rate, 0,
                                       min_dim_size_to_factor, eps),
                 clip_by_block_rms(clipping_threshold),
                 scale_by_learning_rate(learning_rate, flip_sign=False),
                 scale(-1))


def adam(learning_rate) -> chain:
    """`optax.adam(lr)`."""
    return chain(scale_by_adam(), scale_by_learning_rate(learning_rate))


# ---- learning-rate schedules (optax's, in float32) ----

def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count, 0, transition_steps)
        frac = 1 - c / transition_steps
        return (init_value - end_value) * frac + end_value
    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Schedule:
    if not decay_steps > 0:
        raise ValueError(f"cosine_decay_schedule requires positive "
                         f"decay_steps, got {decay_steps}")
    steps = float(decay_steps)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        c = torch.clamp(count.to(torch.float32), max=steps)
        cosine_decay = 0.5 * (1 + torch.cos(math.pi * c / steps))
        return init_value * ((1 - alpha) * cosine_decay + alpha)
    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0) -> Schedule:
    """Linear warmup over `warmup_steps`, then cosine decay over the rest
    of `decay_steps` (optax joins the two at the warmup boundary)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warmup = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)

    def schedule(count: torch.Tensor) -> torch.Tensor:
        return torch.where(count < warmup_steps, warmup(count),
                           decay(count - warmup_steps))
    return schedule


def make_lr(learning_rate: float, schedule: str = "constant",
            total_steps: int = 0, warmup_steps: int = 0):
    """A float (constant) or a schedule `count -> float32 0-d tensor`:
    "cosine" decays to 10% of peak over total_steps, "linear" likewise in
    a straight line, "warmup_cosine" warms up linearly from 0 over
    `warmup_length(total_steps, warmup_steps)` steps, then decays by
    cosine to 10% of peak."""
    if schedule == "constant":
        return learning_rate
    if total_steps <= 0:
        raise ValueError(f"lr schedule {schedule!r} needs total_steps > 0")
    if schedule == "cosine":
        return cosine_decay_schedule(learning_rate, total_steps, alpha=0.1)
    if schedule == "linear":
        return linear_schedule(learning_rate, learning_rate * 0.1,
                               total_steps)
    if schedule == "warmup_cosine":
        w = warmup_length(total_steps, warmup_steps)
        # the cosine part spans decay_steps - w > 0 steps
        return warmup_cosine_decay_schedule(
            0.0, learning_rate, w, max(total_steps, w + 1),
            0.1 * learning_rate)
    raise ValueError(f"unknown lr schedule {schedule!r}")


def warmup_length(total_steps: int, warmup_steps: int) -> int:
    """The warmup make_lr uses: explicit if given, else 5% of the
    horizon, clamped inside it."""
    w = warmup_steps if warmup_steps > 0 else max(1, total_steps // 20)
    return min(w, max(1, total_steps - 1))


def schedule_total_steps(num_examples: int, batch_size: int,
                         epochs: int, num_hosts: int = 1,
                         restored_step: int = 0) -> int:
    """The decay horizon: the steps of `epochs` passes over
    `num_examples` split over `num_hosts` ranks, in batches of
    `batch_size` (the last one padded; the reader's aligned count), plus
    a restored optimizer step for a fine-tune (its count already sits
    there, so without the extension the schedule would start at its
    floor)."""
    per_host = -(-num_examples // num_hosts)
    return -(-per_host // batch_size) * epochs + restored_step


def resolve_checkpoint_schedule(requested: str, manifest: dict,
                                log) -> str:
    """The schedule a loaded model uses: the checkpoint's (its optimizer
    state was built for it); a different request is logged."""
    ckpt_schedule = manifest.get("lr_schedule", "constant")
    if requested != ckpt_schedule:
        log(f"--lr_schedule {requested!r} ignored: using the "
            f"checkpoint's {ckpt_schedule!r} (the optimizer state "
            "structure is fixed at first training)")
    return ckpt_schedule


def resolve_checkpoint_warmup(schedule: str, requested: int,
                              manifest: dict, log) -> int:
    """The warmup a loaded model uses: the checkpoint's effective length
    for `warmup_cosine` (a different request is logged), 0 for any
    other schedule."""
    if schedule != "warmup_cosine":
        if requested > 0:
            log(f"--warmup_steps {requested} ignored: the checkpoint's "
                f"schedule is {schedule!r} (no warmup phase)")
        return 0
    ckpt_warmup = int(manifest.get("lr_warmup_steps", 0))
    if ckpt_warmup > 0 and requested > 0 and requested != ckpt_warmup:
        log(f"--warmup_steps {requested} ignored: using the "
            f"checkpoint's effective warmup {ckpt_warmup} (the LR "
            "trajectory is fixed at first training)")
    return ckpt_warmup if ckpt_warmup > 0 else requested


def make_optimizer(learning_rate, embedding_optimizer: str = "adafactor",
                   trust_ratio: bool = False,
                   trust_ratio_scope: str = "all") -> GradientTransformation:
    """The dense step's optimizer, every branch of the JAX package's
    `make_optimizer`. `learning_rate` is a float or a schedule (make_lr).

    - "adafactor" (the default): Adafactor on the vocab tables, Adam on
      every other leaf (TRANSFORM / ATTENTION, the "xf" subtree), labelled
      by the top-level key;
    - "adam": Adam with float32 moments on every param;
    - `trust_ratio`: LAMB's rescale between the preconditioner and the
      learning rate, on every branch ("all") or on the dense params only
      ("dense", adafactor only)."""
    if trust_ratio_scope not in ("all", "dense"):
        raise ValueError(f"trust_ratio_scope must be 'all' or 'dense', got "
                         f"{trust_ratio_scope!r}")
    if embedding_optimizer == "adam":
        if trust_ratio and trust_ratio_scope != "all":
            raise ValueError(
                "trust_ratio_scope 'dense' requires the adafactor embedding "
                "optimizer (adam runs one transform over all params, so "
                "there is no table/dense split).")
        if not trust_ratio:
            return chain(scale_by_adam_f32_moments(),
                         scale_by_learning_rate(learning_rate))
        return chain(scale_by_adam_f32_moments(), scale_by_trust_ratio(),
                     scale_by_learning_rate(learning_rate))
    if embedding_optimizer == "adafactor":
        def labels(params):
            return {k: ("table" if k in TABLE_PARAMS else "small")
                    for k in params}

        if not trust_ratio:
            table_tx = adafactor(learning_rate)
            small_tx = adam(learning_rate)
        elif trust_ratio_scope == "dense":
            table_tx = adafactor(learning_rate)
            small_tx = chain(scale_by_adam(), scale_by_trust_ratio(),
                             scale_by_learning_rate(learning_rate))
        else:
            # the trust ratio between the clip and the learning rate
            table_tx = chain(scale_by_factored_rms(), clip_by_block_rms(1.0),
                             scale_by_trust_ratio(),
                             scale_by_learning_rate(learning_rate))
            small_tx = chain(scale_by_adam(), scale_by_trust_ratio(),
                             scale_by_learning_rate(learning_rate))
        return multi_transform({"table": table_tx, "small": small_tx},
                               labels)
    raise ValueError(f"unknown embedding_optimizer {embedding_optimizer!r} "
                     "(expected 'adam' or 'adafactor')")


class AdamF32Moments:
    """The sparse-row step's dense optimizer: Adam with float32 moments
    at a constant learning rate, over a dict of tensors, in place. State:
    {"count": int32 0-d, "mu": {k: f32}, "nu": {k: f32}} (the JAX
    package's `ScaleByAdamState(count, mu, nu)`). The cast order is the
    JAX package's: the direction is computed in float32 and cast to the
    GRADIENT's dtype, multiplied by -lr in that dtype (the scalar rounded
    to it first), added to the parameter and cast to its dtype."""

    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8):
        self.learning_rate = float(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps

    def init(self, params: Tensors) -> dict:
        st = scale_by_adam_f32_moments().init(params)
        return {"count": st.count, "mu": st.mu, "nu": st.nu}

    @torch.no_grad()
    def step(self, params: Tensors, grads: Tensors, state: dict) -> None:
        """One update of every param in `grads`, in place on the params
        and the state. Never reads a value back to the host."""
        tx = chain(scale_by_adam_f32_moments(self.b1, self.b2, self.eps),
                   scale(-self.learning_rate))
        st = (ScaleByAdamState(state["count"], state["mu"], state["nu"]),
              EmptyState())
        tx.apply(params, grads, st)
