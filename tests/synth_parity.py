"""SynthMorph's synthesis draws replayed from the JAX package's keys.

``labels_to_image`` in the JAX package draws from a PRNG key; the port
draws from a ``torch.Generator``. To hold the two against each other, the
tests replay JAX's key splits here (``split(key, B)``, ``split(k, 8)`` per
sample, and ``draw_multiscale_noise``'s ``split(key, 3)`` per scale) and
hand the draws to the port's ``labels_to_image_from_draws`` in its format.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import torch


def _t(x):
    return torch.from_numpy(np.array(x))


def _multiscale(key, shape, scales, max_std, nch):
    """``draw_multiscale_noise``'s (std, noise) draws (isotropic std)."""
    draws = []
    for scale in scales:
        key, k_std, k_noise = jax.random.split(key, 3)
        small = tuple(max(int(math.ceil(s / scale)), 2) for s in shape)
        std = jax.random.uniform(k_std, (1,) * (len(shape) + 1), jnp.float32, 0.0, max_std)
        noise = jax.random.normal(k_noise, (*small, nch), jnp.float32)
        draws.append((_t(std), _t(noise)))
    return draws


def jax_draws(key, cfg, batch, intensity_key=None):
    """The draws of the JAX package's ``labels_to_image(key, maps, cfg,
    intensity_key=intensity_key)`` for ``batch`` samples, one dict each,
    in the port's format (``models.synthmorph.labels_to_image_draws``)."""
    keys = jax.random.split(key, batch)
    ikeys = None if intensity_key is None else jax.random.split(intensity_key, batch)
    nd = len(cfg.in_shape)
    out = []
    for b in range(batch):
        k = jax.random.split(keys[b], 8)
        ik = k if ikeys is None else jax.random.split(ikeys[b], 8)
        d = {"means": _t(jax.random.uniform(ik[1], (cfg.nb_in_labels,), jnp.float32,
                                            cfg.mean_range[0], cfg.mean_range[1])),
             "stds": _t(jax.random.uniform(ik[2], (cfg.nb_in_labels,), jnp.float32,
                                           cfg.std_range[0], cfg.std_range[1]))}
        if cfg.zero_background > 0 and cfg.in_label_list[0] == 0:
            d["zero"] = _t(jax.random.uniform(ik[6], ()) < cfg.zero_background)
        d["noise"] = _t(jax.random.normal(k[3], cfg.in_shape, jnp.float32))
        d["svf"] = _multiscale(k[0], cfg.in_shape, cfg.warp_res, cfg.warp_std, nd)
        d["blur_sigma"] = _t(jax.random.uniform(k[4], (), jnp.float32, 0.0, cfg.blur_std))
        if cfg.bias_std > 0:
            d["bias"] = _multiscale(k[5], cfg.in_shape, cfg.bias_res, cfg.bias_std, 1)
        d["gamma"] = _t(jax.random.normal(k[7], ()) * cfg.gamma_std)
        out.append(d)
    return out


def label_maps(seed, batch, shape, labels):
    """``batch`` integer label maps ``(B, *shape, 1)`` of smooth blobs: the
    nearest of a few random centres takes one of ``labels``, so that each
    label is a connected region, as in a brain's segmentation."""
    rng = np.random.default_rng(seed)
    grid = np.stack(np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shape],
                                indexing="ij"), -1)
    maps = []
    for _ in range(batch):
        centres = rng.uniform(0, np.asarray(shape), size=(2 * len(labels), len(shape)))
        owner = np.argmin(((grid[..., None, :] - centres) ** 2).sum(-1), axis=-1)
        maps.append(np.asarray(labels)[owner % len(labels)])
    return np.stack(maps)[..., None].astype(np.int32)
