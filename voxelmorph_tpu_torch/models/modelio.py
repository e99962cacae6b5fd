"""The JAX package's self-describing ``.npz`` checkpoints, read and written.

A checkpoint holds a JSON config (``__config__``: model class name and
constructor fields) and the flax params flattened to ``a||b||kernel`` keys;
keys under ``__extra__`` hold optimizer and trainer state, which serving
ignores. The format is read and written here with numpy alone, so that the
JAX package and the port load each other's checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from .vxm import VxmDense, VxmDenseSemiSupervisedPointCloud, VxmDenseSemiSupervisedSeg

__all__ = ["read_checkpoint", "params_from_jax", "params_to_jax", "load_model",
           "save_model"]

# the model classes a checkpoint may name, by the JAX class name
_MODELS = {cls.__name__: cls for cls in (VxmDense, VxmDenseSemiSupervisedSeg,
                                          VxmDenseSemiSupervisedPointCloud)}

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


def read_checkpoint(path: str, with_extra: bool = False):
    """Return (model class name, decoded config, flat params) of a checkpoint,
    and with ``with_extra`` also its extra arrays, keyed without the
    ``__extra__`` prefix (``name||a||b``)."""
    with np.load(path, allow_pickle=False) as data:
        blob = json.loads(bytes(data["__config__"].tobytes()).decode())
        flat = {k: data[k] for k in data.files
                if k != "__config__" and not k.startswith(_EXTRA)}
        extra = {k[len(_EXTRA):]: data[k] for k in data.files if k.startswith(_EXTRA)}
    config = {k: _decode_config_value(k, v) for k, v in blob["config"].items()}
    if with_extra:
        return blob["class"], config, flat, extra
    return blob["class"], config, flat


def _encode_config_value(val):
    if isinstance(val, torch.dtype):
        return {torch.float32: "float32", torch.bfloat16: "bfloat16",
                torch.float16: "float16"}[val]
    if isinstance(val, (tuple, list)):
        return [_encode_config_value(v) for v in val]
    if isinstance(val, np.ndarray):
        return {"__ndarray__": val.tolist(), "dtype": str(val.dtype)}
    if isinstance(val, np.integer):
        return int(val)
    if isinstance(val, np.floating):
        return float(val)
    return val


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``params_from_jax``: ``a.b.weight`` ``(co, ci, *k)``
    becomes ``a||b||kernel`` ``(*k, ci, co)``, ``a.b.bias`` ``a||b||bias``."""
    flat = {}
    for key, val in state.items():
        *path, leaf = key.split(".")
        val = val.detach().to(torch.float32).cpu().numpy()
        if leaf == "weight":
            nd = val.ndim - 2
            val = np.transpose(val, (*range(2, nd + 2), 1, 0))
            leaf = "kernel"
        elif leaf != "bias":
            raise ValueError(f"unknown parameter '{key}'")
        flat[_SEP.join([*path, leaf])] = np.ascontiguousarray(val)
    return flat


def save_model(path: str, model: torch.nn.Module,
               extra_trees: Optional[Dict[str, Dict[str, np.ndarray]]] = None) -> None:
    """Write ``model`` (its config and float32 params) as the JAX package's
    ``save_model`` does, which its ``load_model`` reads. ``extra_trees`` maps
    names to flat ``{key: array}`` dicts, stored under ``__extra__name||key``.
    The file is written under a temporary name and renamed into place."""
    blob = {"class": type(model).__name__,
            "config": {k: _encode_config_value(v) for k, v in model.config.items()},
            "extra": {}}
    encoded = json.dumps(blob)
    flat = params_to_jax(model.state_dict())
    for name, tree in (extra_trees or {}).items():
        for key, val in tree.items():
            flat[f"{_EXTRA}{name}{_SEP}{key}"] = np.asarray(val)
    final = path if path.endswith(".npz") else path + ".npz"
    tmp = final + ".tmp.npz"
    try:
        np.savez(tmp, __config__=np.frombuffer(encoded.encode(), dtype=np.uint8), **flat)
        os.replace(tmp, final)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


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


def load_model(path: str, device="cuda", **overrides) -> torch.nn.Module:
    """Rebuild a checkpoint's model (VxmDense, VxmDenseSemiSupervisedSeg or
    VxmDenseSemiSupervisedPointCloud) with its weights, on ``device``, in
    eval mode.

    ``overrides`` replace config fields (for example ``dtype=torch.float32``).
    """
    device = resolve_device(device)
    name, config, flat = read_checkpoint(path)
    if name not in _MODELS:
        raise NotImplementedError(f"model class '{name}' is not ported yet")
    model = _MODELS[name](**{**config, **overrides})
    model.load_state_dict(params_from_jax(flat))
    return model.to(device).eval()
