"""Registration losses of the VxmDense training path.

Counterpart of ``voxelmorph_tpu/losses.py`` (NCC, MSE, Grad, KL), in plain
PyTorch with the JAX package's formulations: NCC's box filters are separable
window sums (a cumulative sum per axis), and KL's degree matrix is the
closed-form neighbour count. Every loss takes channels-last batched tensors
``(B, *spatial, C)`` and ``.loss(y_true, y_pred)`` returns one value per
batch element (MSE and KL a scalar), as in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["NCC", "MSE", "Grad", "KL"]


def _window_sum(x: torch.Tensor, win: Sequence[int], axes: Sequence[int]) -> torch.Tensor:
    """Moving-window sum over ``axes`` with SAME zero padding: an all-ones
    box filter of shape ``win``, as one cumulative-sum difference per axis."""
    for w, axis in zip(win, axes):
        if w == 1:
            continue
        pad_lo = (w - 1) // 2
        pad_hi = w - 1 - pad_lo
        n = x.shape[axis]
        shape = list(x.shape)
        shape[axis] = pad_lo + 1  # one leading zero for the difference
        lo_pad = x.new_zeros(shape)
        shape[axis] = pad_hi
        c = torch.cumsum(torch.cat([lo_pad, x, x.new_zeros(shape)], dim=axis), dim=axis)
        # s[i] = c[i + w] - c[i] over the padded, zero-led cumulative sum
        x = c.narrow(axis, w, n) - c.narrow(axis, 0, n)
    return x


class NCC:
    """Local (windowed) normalized cross-correlation.

    Window sums of I, J, I², J² and IJ with SAME zero padding, summed over
    channels; eps-clamped cross term and variances; ``cc = (cross / I_var) *
    (cross / J_var)`` or, if ``signed``, ``cross / sqrt(I_var J_var + eps)``.
    """

    def __init__(self, win=None, eps: float = 1e-5, signed: bool = False):
        self.win = win
        self.eps = eps
        self.signed = signed

    def ncc(self, Ii: torch.Tensor, Ji: torch.Tensor) -> torch.Tensor:
        ndims = Ii.dim() - 2
        if ndims not in (1, 2, 3):
            raise ValueError(f"volumes should be 1 to 3 dimensions, found {ndims}")
        win = self.win
        if win is None:
            win = [9] * ndims
        elif not isinstance(win, (list, tuple)):
            win = [win] * ndims

        in_ch = Ji.shape[-1]
        # the box filter also sums over channels, which commutes with the
        # window sum: reduce channels first; statistics on the leading axis
        stack = torch.stack([Ii, Ji, Ii * Ii, Ji * Ji, Ii * Ji], dim=0).sum(dim=-1)
        sums = _window_sum(stack, win, axes=tuple(range(2, 2 + ndims)))
        I_sum, J_sum, I2_sum, J2_sum, IJ_sum = sums.unbind(0)

        win_size = math.prod(win) * in_ch
        u_I = I_sum / win_size
        u_J = J_sum / win_size
        cross = IJ_sum - u_J * I_sum - u_I * J_sum + u_I * u_J * win_size
        cross = torch.clamp(cross, min=self.eps)
        I_var = torch.clamp(I2_sum - 2 * u_I * I_sum + u_I * u_I * win_size, min=self.eps)
        J_var = torch.clamp(J2_sum - 2 * u_J * J_sum + u_J * u_J * win_size, min=self.eps)
        if self.signed:
            cc = cross / torch.sqrt(I_var * J_var + self.eps)
        else:
            cc = (cross / I_var) * (cross / J_var)
        return cc[..., None]

    def loss(self, y_true, y_pred, reduce: Optional[str] = "mean"):
        cc = self.ncc(y_true, y_pred).reshape(y_true.shape[0], -1)
        if reduce == "mean":
            cc = cc.mean(dim=-1)
        elif reduce == "max":
            cc = cc.amax(dim=-1)
        elif reduce is not None:
            raise ValueError(f"Unknown NCC reduction type: {reduce}")
        return -cc


class MSE:
    """Mean squared error weighted by ``1 / image_sigma**2``."""

    def __init__(self, image_sigma: float = 1.0):
        self.image_sigma = image_sigma

    def loss(self, y_true, y_pred, reduce: Optional[str] = "mean"):
        m = torch.square(y_true - y_pred)
        if reduce == "mean":
            m = m.mean()
        elif reduce == "max":
            m = m.amax()
        elif reduce is not None:
            raise ValueError(f"Unknown MSE reduction type: {reduce}")
        return (1.0 / (self.image_sigma ** 2)) * m


class Grad:
    """First-order gradient penalty on a dense field ``(B, *S, N)``: forward
    differences per axis, 'l1' or 'l2', averaged over axes; ``loss_mult``
    scales it for fields predicted at reduced resolution and ``vox_weight``
    (shaped like the field) weights each difference."""

    def __init__(self, penalty: str = "l1", loss_mult: Optional[float] = None,
                 vox_weight: Optional[torch.Tensor] = None):
        if penalty not in ("l1", "l2"):
            raise ValueError(f"penalty can only be l1 or l2, got {penalty}")
        self.penalty = penalty
        self.loss_mult = loss_mult
        self.vox_weight = vox_weight

    def loss(self, _, y_pred):
        ndims = y_pred.dim() - 2
        means = []
        for axis in range(1, ndims + 1):
            n = y_pred.shape[axis]
            d = y_pred.narrow(axis, 1, n - 1) - y_pred.narrow(axis, 0, n - 1)
            if self.vox_weight is not None:
                d = self.vox_weight.narrow(axis, 1, n - 1) * d
            d = torch.abs(d) if self.penalty == "l1" else d * d
            means.append(d.reshape(d.shape[0], -1).mean(dim=-1))
        grad = sum(means) / len(means)
        if self.loss_mult is not None:
            grad = grad * self.loss_mult
        return grad


def _degree_matrix(vol_shape: Sequence[int]) -> torch.Tensor:
    """The number of in-bounds +-1 neighbours of each voxel, summed over the
    axes, as ``(1, *S, N)`` (the KL prior's degree matrix)."""
    ndims = len(vol_shape)
    deg = torch.zeros(vol_shape)
    for d, s in enumerate(vol_shape):
        n = torch.full((s,), 2.0)
        n[0] = n[-1] = 1.0
        shape = [1] * ndims
        shape[d] = s
        deg = deg + n.reshape(shape)
    return deg[None, ..., None].expand(1, *vol_shape, ndims)


class KL:
    """KL divergence of a probabilistic flow ``(B, *S, 2N)`` (N means, then N
    log-variances) from the smoothness prior of precision ``prior_lambda``."""

    def __init__(self, prior_lambda: float, flow_vol_shape: Sequence[int]):
        self.prior_lambda = prior_lambda
        self.flow_vol_shape = tuple(flow_vol_shape)
        self.D = _degree_matrix(self.flow_vol_shape)

    def prec_loss(self, mean: torch.Tensor) -> torch.Tensor:
        ndims = mean.dim() - 2
        sm = 0.0
        for axis in range(1, ndims + 1):
            n = mean.shape[axis]
            df = mean.narrow(axis, 1, n - 1) - mean.narrow(axis, 0, n - 1)
            sm = sm + torch.mean(df * df)
        return 0.5 * sm / ndims

    def loss(self, y_true, y_pred):
        ndims = y_pred.dim() - 2
        mean = y_pred[..., :ndims]
        log_sigma = y_pred[..., ndims:]
        D = self.D.to(device=y_pred.device, dtype=y_pred.dtype)
        sigma_term = torch.mean(self.prior_lambda * D * torch.exp(log_sigma) - log_sigma)
        prec_term = self.prior_lambda * self.prec_loss(mean)
        return 0.5 * ndims * (sigma_term + prec_term)
