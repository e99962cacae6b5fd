"""Training: loss wiring, the Adam train step, the epoch loop, checkpoints.

Counterpart of ``voxelmorph_tpu/training.py`` for one device: ``LossTerm``
and ``make_loss_fn`` wire model outputs to losses with the same weighting
(``total += mean(w * raw)``) and metrics; ``Trainer`` takes Adam steps with
optax's defaults (``torch.optim.Adam``, b1 0.9, b2 0.999, eps 1e-8, with
optional global-norm clipping as ``optax.clip_by_global_norm`` does it),
runs epochs of steps from a generator and writes checkpoints in the JAX
package's ``.npz`` format, with the optimizer state and the step so that a
run resumes where it stopped, in either package: Adam's moments and step
count are stored as the JAX ``Trainer`` stores optax's state, and read back
from a checkpoint of either. It runs on the GPU unless the caller passes
``device="cpu"``.
"""

from __future__ import annotations

import os
import re
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from . import resolve_device
from .models import modelio

__all__ = ["LossTerm", "make_loss_fn", "Trainer", "MetricsLogger",
           "find_latest_checkpoint", "init_or_resume", "resolve_dtype"]

# extra trees of a checkpoint: optax's state leaves, the step and the JAX
# PRNG key as the JAX Trainer writes them, and the port's own generator state
_OPT = "opt"
_TRAIN = "train"
_TORCH_TRAIN = "torch_train"


class LossTerm:
    """One wired loss: model-output key, loss fn, weight and target.

    ``target_index`` selects the element of the generator's target tuple the
    loss compares against (by default the term's own position);
    ``target_output_key`` compares against another model output instead.
    ``weight`` may be a callable ``(inputs, outputs) -> scalar or (B,)``.
    """

    def __init__(self, output_key: str, fn: Callable, weight=1.0,
                 target_index: Optional[int] = None, name: Optional[str] = None,
                 target_output_key: Optional[str] = None):
        self.output_key = output_key
        self.fn = fn
        self.weight = weight
        self.target_index = target_index
        self.target_output_key = target_output_key
        self.name = name or output_key


def make_loss_fn(model, loss_terms: Sequence[LossTerm]):
    """Build ``loss_fn(inputs, targets, generator=None) -> (total, metrics)``.

    ``generator`` draws the model's sampling noise (``use_probs``); the
    metrics are detached: the mean raw value of each term and the total.
    """
    def loss_fn(inputs, targets, generator=None):
        out = model(*inputs, generator=generator)
        total = 0.0
        metrics = {}
        for i, term in enumerate(loss_terms):
            if term.target_output_key is not None:
                y_true = out[term.target_output_key]
            else:
                y_true = targets[term.target_index if term.target_index is not None else i]
            raw = term.fn(y_true, out[term.output_key])
            w = term.weight(inputs, out) if callable(term.weight) else term.weight
            total = total + torch.mean(w * raw)
            metrics[term.name] = torch.mean(raw).detach()
        metrics["loss"] = total.detach()
        return total, metrics

    return loss_fn


def resolve_dtype(name: str) -> torch.dtype:
    """Map a --dtype CLI string to the torch compute dtype."""
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _clip_by_global_norm(grads, max_norm: float) -> None:
    """Scale ``grads`` in place to a global norm of at most ``max_norm``, as
    ``optax.clip_by_global_norm`` does (no host synchronisation)."""
    norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


class MetricsLogger:
    """Per-epoch metrics appended to a CSV file (nothing if ``path`` is None)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._file = None
        self._keys = None

    def log(self, epoch: int, metrics: Dict[str, float], wall_s: float):
        if self.path is None:
            return
        row = {"epoch": epoch, "wall_s": round(wall_s, 3),
               **{k: float(v) for k, v in sorted(metrics.items())}}
        if self._file is None:
            os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
            self._file = open(self.path, "a")
            self._keys = list(row.keys())
            self._file.write(",".join(self._keys) + "\n")
        self._file.write(",".join(str(row.get(k, "")) for k in self._keys) + "\n")
        self._file.flush()

    def close(self):
        if self._file:
            self._file.close()
            self._file = None


def _optax_order(flat_keys):
    """Flat ``a||b||leaf`` keys in the order of ``jax.tree_util.tree_leaves``
    over the nested flax params: sorted keys at every level."""
    return sorted(flat_keys, key=lambda k: k.split("||"))


class Trainer:
    """Epoch/step training loop with Adam, checkpoints and metrics.

    The generator given to ``fit`` yields ``(inputs, targets)`` tuples of
    numpy arrays, as the JAX package's generators do. The model's initial
    weights are those it was built with (or a checkpoint's, through
    ``load``); ``seed`` seeds the generator of the model's sampling noise.
    """

    def __init__(self, model, loss_terms: Sequence[LossTerm], lr: float = 1e-4,
                 seed: int = 0, clip_norm: Optional[float] = None, device="cuda"):
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.loss_terms = list(loss_terms)
        self.lr = lr
        self.clip_norm = clip_norm
        self.loss_fn = make_loss_fn(self.model, self.loss_terms)
        self.seed = seed
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(seed)
        self.optimizer = None
        self.global_step = 0
        self.loaded_from = None  # checkpoint path when resumed via load()

    def init(self):
        """(Re)create the optimizer for the model's current parameters."""
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr,
                                          betas=(0.9, 0.999), eps=1e-8)

    def _put(self, arrays):
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=self.device)
                     for a in arrays)

    def train_step(self, inputs, targets) -> Dict[str, torch.Tensor]:
        """One Adam step on a batch; returns the step's metrics (device
        scalars, read without a host synchronisation until the caller does)."""
        if self.optimizer is None:
            self.init()
        self.model.train()
        inputs, targets = self._put(inputs), self._put(targets)
        self.optimizer.zero_grad(set_to_none=True)
        loss, metrics = self.loss_fn(inputs, targets, self.generator)
        loss.backward()
        if self.clip_norm is not None:
            _clip_by_global_norm([p.grad for p in self.model.parameters()
                                  if p.grad is not None], self.clip_norm)
        self.optimizer.step()
        self.global_step += 1
        return metrics

    def fit(self, generator, epochs: int, steps_per_epoch: int,
            initial_epoch: int = 0, model_dir: Optional[str] = None,
            save_freq_epochs: int = 20, save_filename: str = "{epoch:04d}.npz",
            log_fn: Callable[[str], None] = print,
            metrics_csv: Optional[str] = None) -> Dict[str, float]:
        """Train ``epochs - initial_epoch`` epochs of ``steps_per_epoch``
        steps; log epoch-mean metrics; checkpoint at the start, every
        ``save_freq_epochs`` epochs and at the end."""
        logger = MetricsLogger(metrics_csv or (
            os.path.join(model_dir, "metrics.csv") if model_dir else None))
        if self.optimizer is None:
            self.init()
        if model_dir:
            os.makedirs(model_dir, exist_ok=True)
            self.save(os.path.join(model_dir, save_filename.format(epoch=initial_epoch)))
        last_metrics = {}
        try:
            for epoch in range(initial_epoch, epochs):
                t0 = time.time()
                step_metrics = [self.train_step(*next(generator))
                                for _ in range(steps_per_epoch)]
                # epoch means; reading them is the epoch's one host sync
                last_metrics = {k: float(torch.stack([m[k] for m in step_metrics]).mean())
                                for k in step_metrics[-1]}
                dt = time.time() - t0
                msg = " - ".join(f"{k}: {v:.6f}" for k, v in sorted(last_metrics.items()))
                log_fn(f"epoch {epoch + 1}/{epochs} [{dt:.1f}s, "
                       f"{steps_per_epoch / dt:.2f} steps/s] {msg}")
                logger.log(epoch + 1, last_metrics, dt)
                if model_dir and ((epoch + 1) % save_freq_epochs == 0 or epoch + 1 == epochs):
                    self.save(os.path.join(model_dir, save_filename.format(epoch=epoch + 1)))
        finally:
            logger.close()
        return last_metrics

    def _optax_leaves(self) -> Dict[str, np.ndarray]:
        """Adam's state as ``optax.adam``'s leaves: the step count, then mu
        and nu in the flax parameter order, kernels in the JAX layout."""
        params = dict(self.model.named_parameters())
        state = self.optimizer.state

        def moments(slot):
            flat = modelio.params_to_jax({
                n: state[p][slot] if p in state else torch.zeros_like(p)
                for n, p in params.items()})
            return [flat[k] for k in _optax_order(flat)]

        steps = {float(s["step"]) for s in state.values()}
        if len(steps) > 1:
            raise ValueError(f"Adam's parameters are at different steps {sorted(steps)}")
        count = np.asarray(int(steps.pop()) if steps else 0, np.int32)
        leaves = [count, *moments("exp_avg"), *moments("exp_avg_sq")]
        return {f"{i:05d}": leaf for i, leaf in enumerate(leaves)}

    def _load_optax_leaves(self, leaves: Dict[str, np.ndarray]) -> None:
        """Set Adam's state from optax's leaves; raise if they do not map
        onto this model's parameters."""
        params = dict(self.model.named_parameters())
        values = [leaves[k] for k in sorted(leaves)]
        n = len(params)
        if len(values) != 1 + 2 * n:
            raise ValueError(
                f"the checkpoint's optimizer state has {len(values)} leaves; Adam over this "
                f"model's {n} parameters has {1 + 2 * n} (count, mu, nu), so it cannot be "
                "restored")
        count = np.asarray(values[0])
        if count.shape != () or not np.issubdtype(count.dtype, np.integer):
            raise ValueError(f"the optimizer state's first leaf is {count.dtype}{count.shape}, "
                             "not Adam's integer step count")
        keys = _optax_order(modelio.params_to_jax(params))
        mu, nu = (modelio.params_from_jax(dict(zip(keys, part)))
                  for part in (values[1:1 + n], values[1 + n:]))
        for name, p in params.items():
            if mu[name].shape != p.shape or nu[name].shape != p.shape:
                raise ValueError(f"the optimizer state of {name} has shapes "
                                 f"{tuple(mu[name].shape)} and {tuple(nu[name].shape)}, the "
                                 f"parameter {tuple(p.shape)}")
        sd = self.optimizer.state_dict()
        sd["state"] = {i: {"step": torch.tensor(float(count), dtype=torch.float32),
                           "exp_avg": mu[name], "exp_avg_sq": nu[name]}
                       for i, name in enumerate(params)}
        self.optimizer.load_state_dict(sd)

    def save(self, path: str):
        """Write a checkpoint in the JAX package's format: the model's config
        and params, Adam's state as optax's leaves and the step as the JAX
        Trainer writes them (which its ``load`` restores), and the sampling
        generator's state under a key that the JAX package ignores."""
        extra = {_TRAIN: {"step": np.asarray(self.global_step, np.int64),
                          # the JAX Trainer's PRNGKey(seed)
                          "base_rng": np.asarray([0, self.seed & 0xFFFFFFFF], np.uint32)},
                 _TORCH_TRAIN: {"generator": self.generator.get_state().numpy()}}
        if self.optimizer is not None:
            extra[_OPT] = self._optax_leaves()
        modelio.save_model(path, self.model, extra_trees=extra)

    def load(self, path: str):
        """Restore the params and, where the checkpoint has them, Adam's
        state, the step and the sampling generator's state, from a checkpoint
        of either package. Raises if its optimizer state cannot be mapped."""
        _, _, flat, extra = modelio.read_checkpoint(path, with_extra=True)
        if any(k.startswith("torch_opt||") for k in extra):
            raise ValueError(f"{path} holds Adam's state under torch_opt||, a layout that "
                             "this version does not read; load its weights with load_model")
        self.model.load_state_dict(modelio.params_from_jax(flat))
        self.init()
        self.loaded_from = path
        opt = {k[len(_OPT) + 2:]: v for k, v in extra.items() if k.startswith(_OPT + "||")}
        if opt:
            self._load_optax_leaves(opt)
        if f"{_TRAIN}||step" in extra:
            self.global_step = int(extra[f"{_TRAIN}||step"])
        if f"{_TORCH_TRAIN}||generator" in extra:
            self.generator.set_state(
                torch.from_numpy(np.array(extra[f"{_TORCH_TRAIN}||generator"])))


def find_latest_checkpoint(model_dir: str):
    """Return (path, epoch) of the newest numbered checkpoint, or (None, 0)."""
    if not os.path.isdir(model_dir):
        return None, 0
    best, best_epoch = None, -1
    for name in os.listdir(model_dir):
        m = re.fullmatch(r"(\d+)\.npz", name)
        if m and int(m.group(1)) > best_epoch:
            best_epoch = int(m.group(1))
            best = os.path.join(model_dir, name)
    return (best, best_epoch) if best else (None, 0)


def init_or_resume(trainer: Trainer, load_weights: Optional[str], model_dir: str,
                   initial_epoch: int = 0, log_fn: Callable[[str], None] = print) -> int:
    """``load_weights`` 'latest' resumes from the newest numbered checkpoint
    in ``model_dir`` (if any), a path loads that file, None starts fresh.
    Returns the epoch to continue from."""
    if load_weights == "latest":
        path, epoch = find_latest_checkpoint(model_dir)
        if path:
            log_fn(f"resuming from {path} (epoch {epoch})")
            trainer.load(path)
            return max(initial_epoch, epoch)
    elif load_weights:
        trainer.load(load_weights)
        return initial_epoch
    trainer.init()
    return initial_epoch
