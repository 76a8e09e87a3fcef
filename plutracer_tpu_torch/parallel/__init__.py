"""Multi-device scaling: (tiles, spp) meshes over torch devices and
torch.distributed ranks (mesh.make_mesh), sharded rendering
(sharded.render_sharded) and sharded inverse rendering
(sharded.make_train_step).

The two axes are the JAX package's: ``tiles`` splits the pixels (each
position owns a contiguous block of rows; the forward needs no
communication), ``spp`` splits the stratified passes (the partials are
summed). Scene tables are replicated, one copy a device. Gradients of the
pixel loss are reduced over both axes. A multi-process job initialises
torch.distributed (mesh.initialize_distributed) and builds the same mesh
in every process.
"""

from plutracer_tpu_torch.parallel.mesh import make_mesh
from plutracer_tpu_torch.parallel.sharded import make_train_step, render_sharded

__all__ = ["make_mesh", "render_sharded", "make_train_step"]
