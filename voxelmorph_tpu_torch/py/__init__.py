"""Host-side numpy utilities: volume file IO, segmentation and surface
helpers."""

from . import io, ndimage, utils
