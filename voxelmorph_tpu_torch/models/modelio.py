"""Load the JAX package's self-describing ``.npz`` checkpoints into PyTorch.

A checkpoint holds a JSON config (``__config__``: model class name and
constructor fields) and the flax params flattened to ``a||b||kernel`` keys;
keys under ``__extra__`` hold optimizer and trainer state, which serving
ignores. The format is read here with numpy alone.
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from .. import resolve_device
from .vxm import VxmDense

__all__ = ["read_checkpoint", "params_from_jax", "load_model"]

_SEP = "||"
_EXTRA = "__extra__"


def _decode_config_value(key, val):
    if isinstance(val, dict) and "__config_class__" in val:
        raise NotImplementedError(
            f"config class '{val['__config_class__']}' is not ported yet")
    if isinstance(val, dict) and "__ndarray__" in val:
        return np.asarray(val["__ndarray__"], dtype=val["dtype"])
    if isinstance(val, list):
        return [_decode_config_value(key, v) for v in val]
    return val


def read_checkpoint(path: str) -> Tuple[str, dict, Dict[str, np.ndarray]]:
    """Return (model class name, decoded config, flat params) of a checkpoint."""
    with np.load(path, allow_pickle=False) as data:
        blob = json.loads(bytes(data["__config__"].tobytes()).decode())
        flat = {k: data[k] for k in data.files
                if k != "__config__" and not k.startswith(_EXTRA)}
    config = {k: _decode_config_value(k, v) for k, v in blob["config"].items()}
    return blob["class"], config, flat


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Map flattened flax params to a PyTorch state dict.

    ``a||b||kernel`` of shape ``(*k, ci, co)`` becomes ``a.b.weight`` of shape
    ``(co, ci, *k)``; ``a||b||bias`` becomes ``a.b.bias``. Keys under
    ``__extra__`` are ignored.
    """
    state = {}
    for key, val in flat.items():
        if key.startswith(_EXTRA) or key == "__config__":
            continue
        *path, leaf = key.split(_SEP)
        val = np.asarray(val, dtype=np.float32)
        if leaf == "kernel":
            nd = val.ndim - 2
            val = np.transpose(val, (nd + 1, nd, *range(nd)))
            leaf = "weight"
        elif leaf != "bias":
            raise ValueError(f"unknown parameter '{key}'")
        state[".".join([*path, leaf])] = torch.from_numpy(np.array(val, order="C"))
    return state


def load_model(path: str, device="cuda", **overrides) -> VxmDense:
    """Rebuild a checkpoint's model with its weights, on ``device``.

    ``overrides`` replace config fields (for example ``dtype=torch.float32``).
    """
    device = resolve_device(device)
    name, config, flat = read_checkpoint(path)
    if name != "VxmDense":
        raise NotImplementedError(f"model class '{name}' is not ported yet")
    model = VxmDense(**{**config, **overrides})
    model.load_state_dict(params_from_jax(flat))
    return model.to(device).eval()
