"""Registration losses of the VxmDense training path.

Counterpart of ``voxelmorph_tpu/losses.py`` (NCC, MSE, TukeyBiweight, Dice,
Grad, KL, MutualInformation), in plain
PyTorch with the JAX package's formulations: NCC's box filters are separable
window sums (a cumulative sum per axis), and KL's degree matrix is the
closed-form neighbour count. Every loss takes channels-last batched tensors
``(B, *spatial, C)`` and ``.loss(y_true, y_pred)`` returns one value per
batch element (MSE, TukeyBiweight, Dice and KL a scalar), as in the JAX
package.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

__all__ = ["NCC", "MSE", "TukeyBiweight", "Dice", "Grad", "KL", "MutualInformation"]


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

    def mse(self, y_true, y_pred):
        """The squared error of each element, unweighted."""
        return torch.square(y_true - y_pred)

    def loss(self, y_true, y_pred, reduce: Optional[str] = "mean"):
        m = self.mse(y_true, y_pred)
        if reduce == "mean":
            m = m.mean()
        elif reduce == "max":
            m = m.amax()
        elif reduce is not None:
            raise ValueError(f"Unknown MSE reduction type: {reduce}")
        return (1.0 / (self.image_sigma ** 2)) * m


class TukeyBiweight:
    """Tukey's biweight robust loss with threshold ``c``: the mean over every
    element of ``c^2/2 * (1 - (1 - e^2/c^2)^3)`` where the squared error e^2
    is at most c^2, and ``c^2/2`` above it."""

    def __init__(self, c: float = 0.5):
        self.csq = c * c

    def loss(self, y_true, y_pred):
        error_sq = (y_true - y_pred) ** 2
        below = error_sq <= self.csq
        rho_above = (~below).to(error_sq.dtype) * (self.csq / 2)
        rho_below = (self.csq / 2) * (
            1 - (1 - (torch.where(below, error_sq, 0.0) / self.csq)) ** 3)
        return torch.mean(rho_above + rho_below)


class Dice:
    """Negative soft Dice over one-hot probability maps ``(B, *S, L)``:
    ``2 sum(t p) / sum(t + p)`` per sample and label (0 where both are empty),
    averaged over samples and labels."""

    def loss(self, y_true, y_pred):
        vol_axes = tuple(range(1, y_pred.dim() - 1))
        top = 2 * torch.sum(y_true * y_pred, dim=vol_axes)
        bottom = torch.sum(y_true + y_pred, dim=vol_axes)
        empty = bottom == 0
        dice = torch.where(empty, 0.0, top / torch.where(empty, 1.0, bottom))
        return -torch.mean(dice)


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

    def mean_loss(self, y_true, y_pred):
        """The penalty averaged over the batch."""
        return torch.mean(self.loss(y_true, y_pred))


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


class MutualInformation:
    """Soft-binned (Parzen window) mutual information between intensity
    volumes: each intensity, clipped to [minval, maxval], belongs to
    ``nb_bins`` Gaussian bins (width ``sigma_ratio`` of the bin spacing),
    normalised over bins; MI of the joint soft histogram, per sample.
    ``loss`` is its negative."""

    def __init__(self, nb_bins: int = 16, minval: float = 0.0, maxval: float = 1.0,
                 sigma_ratio: float = 0.5):
        self.nb_bins = nb_bins
        self.bin_centers = torch.linspace(minval, maxval, nb_bins)
        sigma = torch.mean(torch.diff(self.bin_centers)) * sigma_ratio
        self.preterm = 1.0 / (2 * sigma * sigma)

    def volumes(self, y_true, y_pred):
        centers = self.bin_centers.to(device=y_pred.device, dtype=y_pred.dtype)
        preterm = self.preterm.to(device=y_pred.device, dtype=y_pred.dtype)
        yt = torch.clamp(y_true, centers[0], centers[-1]).reshape(y_true.shape[0], -1, 1)
        yp = torch.clamp(y_pred, centers[0], centers[-1]).reshape(y_pred.shape[0], -1, 1)
        vbc = centers.reshape(1, 1, -1)

        # soft bin memberships (B, V, K), normalised over the bins
        I_a = torch.exp(-preterm * torch.square(yt - vbc))
        I_a = I_a / torch.sum(I_a, dim=-1, keepdim=True)
        I_b = torch.exp(-preterm * torch.square(yp - vbc))
        I_b = I_b / torch.sum(I_b, dim=-1, keepdim=True)

        pab = torch.einsum("bvk,bvl->bkl", I_a, I_b) / yt.shape[1]
        pa = torch.mean(I_a, dim=1, keepdim=True)  # (B, 1, K)
        pb = torch.mean(I_b, dim=1, keepdim=True)
        papb = torch.einsum("bik,bil->bkl", pa, pb) + 1e-8
        return torch.sum(pab * torch.log(pab / papb + 1e-8), dim=(1, 2))

    def loss(self, y_true, y_pred):
        return -self.volumes(y_true, y_pred)
