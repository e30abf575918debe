"""The device mesh, the sharded aligner steps and multi-process helpers.

Counterpart of ``aligngraph2_tpu/parallel``, exporting the same names."""

from .mesh import make_mesh
from .sharded import (BlockIndex, build_block_index, make_sharded_seeder,
                      make_sharded_extender, put_sharded_index)

__all__ = ["make_mesh", "BlockIndex", "build_block_index",
           "make_sharded_seeder", "make_sharded_extender",
           "put_sharded_index"]
