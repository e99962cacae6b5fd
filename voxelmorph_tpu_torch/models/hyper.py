"""HyperMorph: VxmDense conditioned on its hyperparameters by a hypernetwork.

Counterpart of ``voxelmorph_tpu/models/hyper.py``: a small MLP maps the
hyperparameter vector (the regularisation weight lambda in [0, 1]) to an
embedding, and every U-Net convolution's kernel and bias are generated from
that embedding (``models.unet.HyperConv``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .unet import lecun_normal_
from .vxm import _DTYPES, VxmDense, VxmSlabs

__all__ = ["HyperVxmDense"]


class HyperVxmDense(VxmSlabs, nn.Module):
    """VxmDense conditioned on hyperparameters through a hypernetwork MLP.

    ``hyp_dense_1`` ... ``hyp_dense_{nb_hyp_layers}`` are Linear layers of
    ``nb_hyp_units`` ReLU units in float32 (flax's Dense: lecun-normal
    weights, zero bias); the embedding drives the hyper U-Net of ``vxm``, a
    ``VxmDense(hyper=True)``. The constructor takes the JAX module's fields,
    so a checkpoint's config rebuilds the network; ``generator`` draws the
    initial weights. ``forward(source, target, hyp, generator=None)`` takes
    ``hyp`` ``(B, nb_hyp_params)`` and returns VxmDense's outputs plus
    'hyper_val', ``hyp`` itself. The defaults are the reference's: 6 layers
    of 128 units.

    Over a mesh's 'space' axis the source and the target arrive as slabs
    and the hyper U-Net runs on them. The MLP runs whole on every rank, but
    its embedding reaches the loss only through the HyperConvs' kernels on
    the slabs, so its gradient on a rank is its slab's part too, summed
    over 'space' as the U-Net's (no ``whole_parameters``).
    """

    def __init__(self, inshape: Sequence[int], nb_hyp_params: int = 1, nb_hyp_layers: int = 6,
                 nb_hyp_units: int = 128, nb_unet_features=None, int_steps: int = 7,
                 int_resolution: int = 2, svf_resolution: int = 1, bidir: bool = False,
                 use_probs: bool = False, src_feats: int = 1, trg_feats: int = 1,
                 reg_field: str = "preintegrated", dtype=torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        dtype = _DTYPES.get(dtype, dtype)
        self.config = dict(
            inshape=tuple(inshape), nb_hyp_params=nb_hyp_params, nb_hyp_layers=nb_hyp_layers,
            nb_hyp_units=nb_hyp_units, nb_unet_features=nb_unet_features, int_steps=int_steps,
            int_resolution=int_resolution, svf_resolution=svf_resolution, bidir=bidir,
            use_probs=use_probs, src_feats=src_feats, trg_feats=trg_feats,
            reg_field=reg_field, dtype=dtype)
        self.inshape = tuple(inshape)
        self.nb_hyp_params = nb_hyp_params
        self.nb_hyp_layers = nb_hyp_layers
        self.int_steps = int_steps
        self.dtype = dtype
        for n in range(nb_hyp_layers):
            layer = nn.Linear(nb_hyp_params if n == 0 else nb_hyp_units, nb_hyp_units)
            lecun_normal_(layer.weight, generator)
            nn.init.zeros_(layer.bias)
            self.add_module(f"hyp_dense_{n + 1}", layer)
        self.vxm = VxmDense(inshape, nb_unet_features=nb_unet_features, int_steps=int_steps,
                            int_resolution=int_resolution, svf_resolution=svf_resolution,
                            bidir=bidir, use_probs=use_probs, src_feats=src_feats,
                            trg_feats=trg_feats, reg_field=reg_field, hyper=True, dtype=dtype,
                            nb_hyp_units=nb_hyp_units, generator=generator)

    def forward(self, source: torch.Tensor, target: torch.Tensor, hyp: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> dict:
        x = hyp.float()
        for n in range(self.nb_hyp_layers):
            x = F.relu(getattr(self, f"hyp_dense_{n + 1}")(x))
        out = self.vxm(source, target, x, generator=generator)
        out["hyper_val"] = hyp
        return out
