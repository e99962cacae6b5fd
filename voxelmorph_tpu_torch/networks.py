"""The models under ``networks``, the name the reference package gives them
(as ``voxelmorph_tpu.networks`` does); they live in ``models``."""

from .models import *  # noqa: F401,F403
from .models.unet import Unet  # noqa: F401
from .models.vxm import InstanceDense, Transform, VxmDense  # noqa: F401
from .py.utils import default_unet_features  # noqa: F401
