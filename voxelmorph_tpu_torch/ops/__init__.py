"""Tensor ops: interpolation, the bounded-warp kernel, dense warps."""
