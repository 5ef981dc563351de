"""Multi-device rendering (the port of ``opengl_raytracer_tpu/parallel``)."""

from opengl_raytracer_torch.parallel.sharding import (Mesh, RowShardedAccum,
                                                      ShardedRenderer,
                                                      make_mesh)

__all__ = ["Mesh", "RowShardedAccum", "ShardedRenderer", "make_mesh"]
