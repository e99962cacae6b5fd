from . import mesh
from .mesh import (batch_sharding, gather_batch, make_mesh, replicate, replicated,
                   shard_batch)
