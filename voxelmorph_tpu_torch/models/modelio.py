"""The JAX package's self-describing ``.npz`` checkpoints, read and written.

A checkpoint holds a JSON config (``__config__``: model class name and
constructor fields) and the flax params flattened to ``a||b||kernel`` keys;
keys under ``__extra__`` hold optimizer and trainer state, which serving
ignores, and a model's mutable variable collections (``__extra__state||``,
MeanStream's buffers here). A config value that is a config object
(SynthMorph's ``LabelsToImageConfig``) is stored as the JAX package tags
it, ``{"__config_class__": name, "data": to_dict()}``. The format is read
and written here with numpy alone, so that the JAX package and the port
load each other's checkpoints.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch

from .. import resolve_device
from .atlas import ConditionalTemplateCreation, ProbAtlasSegmentation, TemplateCreation
from .hyper import HyperVxmDense
from .synthmorph import (HyperVxmJoint, LabelsToImageConfig, SynthMorphDense,
                         VxmAffineFeatureDetector)
from .vxm import (InstanceDense, VxmDense, VxmDenseSemiSupervisedPointCloud,
                  VxmDenseSemiSupervisedSeg)

__all__ = ["read_checkpoint", "params_from_jax", "params_to_jax", "state_to_jax",
           "checkpoint_state", "load_weights", "load_model", "save_model", "register_model",
           "register_config", "MODEL_REGISTRY", "CONFIG_REGISTRY"]

# the model classes a checkpoint may name, by the JAX class name
_MODELS = {cls.__name__: cls for cls in (
    VxmDense, VxmDenseSemiSupervisedSeg, VxmDenseSemiSupervisedPointCloud, InstanceDense,
    TemplateCreation, ConditionalTemplateCreation, ProbAtlasSegmentation, HyperVxmDense,
    SynthMorphDense, VxmAffineFeatureDetector, HyperVxmJoint)}
# the config objects a config value may hold, tagged by class name as the
# JAX package's register_config does
_CONFIGS = {cls.__name__: cls for cls in (LabelsToImageConfig,)}
# the JAX package's names for the two registries
MODEL_REGISTRY, CONFIG_REGISTRY = _MODELS, _CONFIGS


def register_model(cls):
    """Class decorator: make a model class loadable by name. The class takes
    its checkpoint's config as keyword arguments and keeps them in
    ``config``, for ``save_model``."""
    _MODELS[cls.__name__] = cls
    return cls


def register_config(cls):
    """Class decorator: make a config object a checkpoint's config may hold
    (stored tagged by class name); it needs ``to_dict()`` and a classmethod
    ``from_dict(dict)`` with JSON-safe contents."""
    if not (hasattr(cls, "to_dict") and hasattr(cls, "from_dict")):
        raise TypeError(f"{cls.__name__} needs to_dict/from_dict for checkpoint round-trips")
    _CONFIGS[cls.__name__] = cls
    return cls

_SEP = "||"
_EXTRA = "__extra__"


def _decode_config_value(key, val):
    if isinstance(val, dict) and "__config_class__" in val:
        if val["__config_class__"] not in _CONFIGS:
            raise NotImplementedError(
                f"config class '{val['__config_class__']}' is not ported yet")
        return _CONFIGS[val["__config_class__"]].from_dict(val["data"])
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
    if type(val).__name__ in _CONFIGS:
        return {"__config_class__": type(val).__name__, "data": val.to_dict()}
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
    becomes ``a||b||kernel`` ``(*k, ci, co)`` (a Linear's ``(out, in)``
    becomes a Dense kernel ``(in, out)``), ``a.b.bias`` ``a||b||bias``, and
    any other parameter (``atlas``, ``flow``) keeps its name and layout."""
    flat = {}
    for key, val in state.items():
        *path, leaf = key.split(".")
        val = val.detach().to(torch.float32).cpu().numpy()
        if leaf == "weight":
            nd = val.ndim - 2
            val = np.transpose(val, (*range(2, nd + 2), 1, 0))
            leaf = "kernel"
        flat[_SEP.join([*path, leaf])] = np.ascontiguousarray(val)
    return flat


def _state_keys(model: torch.nn.Module) -> Dict[str, str]:
    """The buffers of the model's mutable collections (each module with a
    ``collection`` attribute, MeanStream's 'stream'), by their flat JAX key
    ``collection||module path||name``, mapped to their state-dict keys."""
    keys = {}
    for path, module in model.named_modules():
        collection = getattr(module, "collection", None)
        if collection is None:
            continue
        for name, _ in module.named_buffers(recurse=False):
            parts = path.split(".") if path else []
            keys[_SEP.join([collection, *parts, name])] = ".".join([*parts, name])
    return keys


def state_to_jax(model: torch.nn.Module,
                 tensors: Optional[Dict[str, torch.Tensor]] = None) -> Dict[str, np.ndarray]:
    """The model's mutable collections as the JAX Trainer's ``state`` tree,
    flattened (``stream||mean_stream||mean``); empty for a stateless model.
    ``tensors`` (buffers by state-dict name) replaces the model's values."""
    buffers = dict(model.named_buffers())
    buffers.update({k: v for k, v in (tensors or {}).items() if k in buffers})
    return {key: buffers[name].detach().to(torch.float32).cpu().numpy()
            for key, name in _state_keys(model).items()}


def load_weights(model: torch.nn.Module, flat: Dict[str, np.ndarray],
                 state: Optional[Dict[str, np.ndarray]] = None) -> None:
    """Load flattened flax params into ``model`` (strictly: every parameter,
    nothing else) and its mutable collections from ``state`` (flat keys as
    ``state_to_jax`` gives them), zero where ``state`` has none. Raises on a
    state key that names no buffer of the model."""
    weights = params_from_jax(flat)
    keys = _state_keys(model)
    state = dict(state or {})
    unknown = sorted(set(state) - set(keys))
    if unknown:
        raise ValueError(f"the checkpoint's state {unknown} names no buffer of "
                         f"{type(model).__name__}")
    buffers = dict(model.named_buffers())
    for key, name in keys.items():
        weights[name] = (torch.from_numpy(np.array(state[key], np.float32)) if key in state
                         else torch.zeros_like(buffers[name]))
    model.load_state_dict(weights)


def save_model(path: str, model: torch.nn.Module,
               extra_trees: Optional[Dict[str, Dict[str, np.ndarray]]] = None,
               tensors: Optional[Dict[str, torch.Tensor]] = None) -> None:
    """Write ``model`` (its config and float32 params) as the JAX package's
    ``save_model`` does, which its ``load_model`` reads. ``extra_trees`` maps
    names to flat ``{key: array}`` dicts, stored under ``__extra__name||key``;
    a model with mutable collections (MeanStream) adds its buffers as the
    ``state`` tree, as the JAX Trainer writes them. ``tensors`` (parameters
    and buffers by state-dict name, a copy taken earlier) are written in
    place of the model's current values. The file is written under a
    temporary name and renamed into place."""
    blob = {"class": type(model).__name__,
            "config": {k: _encode_config_value(v) for k, v in model.config.items()},
            "extra": {}}
    encoded = json.dumps(blob)
    tensors = tensors or {}
    flat = params_to_jax({n: tensors.get(n, p) for n, p in model.named_parameters()})
    extra_trees = dict(extra_trees or {})
    state = state_to_jax(model, tensors)
    if state:
        extra_trees.setdefault("state", state)
    for name, tree in extra_trees.items():
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
    ``(co, ci, *k)`` (a Dense kernel ``(in, out)``, a Linear's ``(out, in)``);
    ``a||b||bias`` becomes ``a.b.bias``, and any other leaf (``atlas``,
    ``flow``) keeps its name and layout. Keys under ``__extra__`` are
    ignored.
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
        state[".".join([*path, leaf])] = torch.from_numpy(np.array(val, order="C"))
    return state


def checkpoint_state(extra: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """The ``state`` tree of a checkpoint's extra arrays (``read_checkpoint``
    with ``with_extra``), flat and without its prefix."""
    prefix = "state" + _SEP
    return {k[len(prefix):]: v for k, v in extra.items() if k.startswith(prefix)}


def load_model(path: str, device="cuda", **overrides) -> torch.nn.Module:
    """Rebuild a checkpoint's model (a class of ``_MODELS``) with its
    weights and, where the checkpoint has one, its ``state`` tree (the
    MeanStream buffers), on ``device``, in eval mode.

    ``overrides`` replace config fields (for example ``dtype=torch.float32``).
    """
    device = resolve_device(device)
    name, config, flat, extra = read_checkpoint(path, with_extra=True)
    if name not in _MODELS:
        raise NotImplementedError(f"model class '{name}' is not ported yet")
    model = _MODELS[name](**{**config, **overrides})
    load_weights(model, flat, checkpoint_state(extra))
    return model.to(device).eval()
