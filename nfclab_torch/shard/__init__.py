from .mesh import make_mesh, shard_batch
from .temporal import overlap_save_blocks, stitch_blocks, sharded_frontend_step
