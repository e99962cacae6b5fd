"""The tensor ops under ``utils``, the name the reference package gives its
ops layer (as ``voxelmorph_tpu.utils`` does); they live in ``ops``."""

from .ops import *  # noqa: F401,F403
from .ops.interp import interpn, resize  # noqa: F401
