"""Tensor ops: interpolation, warping, affine algebra, augmentation, the
bounded-warp and gather kernels' wrappers and the conv kernel's; importing
them builds no kernel."""

from . import affine, augment, image, interp, warp
from .affine import (
    affine_add_identity,
    affine_matrix_to_params,
    affine_remove_identity,
    affine_to_dense_shift,
    angles_to_rotation_matrix,
    fit_affine,
    invert_affine,
    is_affine_shape,
    make_square_affine,
    params_to_affine_matrix,
    rescale_affine,
    rotation_matrix_to_angles,
    validate_affine_shape,
)
from .augment import draw_affine_params, draw_flip_matrix, draw_swap_matrix
from .image import barycenter, draw_multiscale_noise, gaussian_blur, sqrtm
from .interp import interpn, ndgrid, point_interpn, resize, volshape_to_meshgrid
from .warp import (
    batch_transform,
    compose,
    integrate_vec,
    jacobian_determinant,
    point_spatial_transformer,
    rescale_dense_transform,
    transform,
    value_at_location,
)
