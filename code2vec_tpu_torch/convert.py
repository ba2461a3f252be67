"""Carry weights between the JAX package and this one.

The JAX package keeps its params as a dict of arrays (`token_emb`,
`path_emb`, `target_emb`, `transform`, `attention`; an int8 table is a
dict `{"q": int8 [V, E], "s": float32 [V, 1]}`). Its leaves, once
`np.asarray`'d, come here as numpy arrays; a bf16 leaf is a numpy array
of the `bfloat16` dtype that `ml_dtypes` registers. Both directions keep
dtypes and bits: bf16 stays bf16, int8 stays int8. Nothing here imports
JAX.

The optimizer states cross the same way:
- the dense step's: optax's `MultiTransformState` (`PartitionState` in
  newer optax) / `MaskedState` /
  `FactoredState` / `ScaleByAdamState` / `ScaleByScheduleState` /
  `EmptyState` tree on the JAX side; here the same NamedTuples
  (training/optimizers.py) with a multi-transform state as a dict
  {label: chain state}, and optax's `MaskedState` wrappers and
  `MaskedNode` placeholders, which hold no values, left out. The leaves
  keep their dtypes (Adafactor's bf16 moments stay bf16);
- the sparse-row step's: `{"dense": (ScaleByAdamState(count, mu, nu),
  EmptyState()), "rows": {table: RowAdamState(m, v)}, "count"}` on the
  JAX side; here `{"dense": {"count", "mu", "nu"}, "rows": {table:
  RowAdamState(m, v)}, "count"}` (training/sparse_steps.
  init_sparse_opt_state).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from code2vec_tpu_torch.device import resolve_device
from code2vec_tpu_torch.ops.sparse_update import RowAdamState
from code2vec_tpu_torch.training import optimizers


def _is_bf16(a: np.ndarray) -> bool:
    return a.dtype.name == "bfloat16"


def _tensor_from_numpy(a: np.ndarray, device: torch.device) -> torch.Tensor:
    if not a.flags.c_contiguous:  # (ascontiguousarray makes 0-d 1-d)
        a = np.ascontiguousarray(a)
    if not a.flags.writeable:  # a tensor may not share read-only memory
        a = a.copy()
    if _is_bf16(a):
        # numpy has no native bf16: move the bits through int16
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16) \
            .to(device)
    return torch.from_numpy(a).to(device)


def _tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes  # numpy's bf16 dtype, as the JAX package uses
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_from_numpy(tree: Dict[str, Any],
                      device: Optional[Union[str, torch.device]] = None
                      ) -> Dict[str, Any]:
    """Numpy param dict (nested dicts allowed) -> the same dict of
    tensors on `device` (None = the CUDA card)."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor_from_numpy(np.asarray(x), dev)
    return conv(tree)


def params_to_numpy(tree: Dict[str, Any]) -> Dict[str, Any]:
    """The inverse of `params_from_numpy`: tensors -> host numpy arrays."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor_to_numpy(x)
    return conv(tree)


def sparse_opt_state_from_numpy(tree: Dict[str, Any],
                                device: Optional[Union[str, torch.device]]
                                = None) -> Dict[str, Any]:
    """The JAX sparse opt state with numpy leaves (the NamedTuples kept,
    as `jax.tree_util.tree_map(np.asarray, state)` leaves them) -> the
    port's opt state on `device` (None = the CUDA card)."""
    dev = resolve_device(device)
    adam = tree["dense"][0]   # ScaleByAdamState(count, mu, nu)
    count, mu, nu = adam[0], adam[1], adam[2]

    def t(a):
        return _tensor_from_numpy(np.asarray(a), dev)
    return {
        "dense": {"count": t(count), "mu": {k: t(a) for k, a in mu.items()},
                  "nu": {k: t(a) for k, a in nu.items()}},
        "rows": {k: RowAdamState(m=t(st[0]), v=t(st[1]))
                 for k, st in tree["rows"].items()},
        "count": t(tree["count"]),
    }


def sparse_opt_state_to_numpy(state: Dict[str, Any]) -> Dict[str, Any]:
    """The port's sparse opt state -> numpy: {"dense": {"count", "mu",
    "nu"}, "rows": {table: {"m", "v"}}, "count"}."""
    d = state["dense"]
    return {
        "dense": {"count": _tensor_to_numpy(d["count"]),
                  "mu": {k: _tensor_to_numpy(x) for k, x in d["mu"].items()},
                  "nu": {k: _tensor_to_numpy(x) for k, x in d["nu"].items()}},
        "rows": {k: {"m": _tensor_to_numpy(st.m), "v": _tensor_to_numpy(st.v)}
                 for k, st in state["rows"].items()},
        "count": _tensor_to_numpy(state["count"]),
    }


_STATES = {cls.__name__: cls for cls in (
    optimizers.EmptyState, optimizers.ScaleByAdamState,
    optimizers.FactoredState, optimizers.ScaleByScheduleState)}


def dense_opt_state_from_numpy(tree: Any,
                               device: Optional[Union[str, torch.device]]
                               = None) -> Any:
    """The JAX dense optimizer state with numpy leaves (optax's
    NamedTuples kept, as `jax.tree_util.tree_map(np.asarray, state)`
    leaves them) -> the port's state on `device` (None = the CUDA
    card)."""
    dev = resolve_device(device)

    def conv(x):
        name = type(x).__name__
        if name in ("MultiTransformState", "PartitionState"):
            return {label: conv(st) for label, st in x.inner_states.items()}
        if name == "MaskedState":
            return conv(x.inner_state)
        if name in _STATES:
            return _STATES[name](*(conv(f) for f in x))
        if isinstance(x, tuple):
            return tuple(conv(f) for f in x)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()
                    if type(v).__name__ != "MaskedNode"}
        return _tensor_from_numpy(np.asarray(x), dev)
    return conv(tree)


def dense_opt_state_to_numpy(state: Any) -> Any:
    """The port's dense optimizer state -> the same tree with host numpy
    leaves; its leaves come in the order of the JAX state's
    `jax.tree_util.tree_leaves`."""
    if isinstance(state, torch.Tensor):
        return _tensor_to_numpy(state)
    if isinstance(state, dict):
        return {k: dense_opt_state_to_numpy(v) for k, v in state.items()}
    if type(state).__name__ in _STATES:
        return type(state)(*(dense_opt_state_to_numpy(f) for f in state))
    return tuple(dense_opt_state_to_numpy(f) for f in state)
