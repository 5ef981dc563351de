"""Progressive Monte-Carlo path tracer in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper.

The port of ``opengl_raytracer_tpu`` (JAX / XLA / Pallas), which stays in
the repository as its reference.  This package imports ``torch`` and
``numpy`` and never JAX.  It renders a ``Scene`` of ``Mesh`` (OBJ files),
``Rect`` and ``Triangles`` objects, through ``App`` and the CLI
(``python -m opengl_raytracer_torch``) or the ``Renderer`` directly, with
every traversal of the JAX package: the
sub-block BVH traversal kernel (K1, ``csrc/subblock_traversal.cu``, the
main path), the wide-BVH traversal kernel (K3, ``csrc/wide_traversal.cu``),
brute force (G8), the per-ray BVH walk (G7) and the 128-ray packet walk
(G9), each followed by the fused shade kernel (K2, ``csrc/shade.cu``).  On
CPU tensors each kernel's plain torch version runs instead.
"""

from opengl_raytracer_torch.models.mesh import Mesh
from opengl_raytracer_torch.models.rect import Rect
from opengl_raytracer_torch.models.scene import Scene, SceneData, scene_from_numpy
from opengl_raytracer_torch.models.trisoup import Triangles
from opengl_raytracer_torch.ops.camera import Camera, make_camera
from opengl_raytracer_torch.renderer import Renderer, RenderState, state_from_numpy
from opengl_raytracer_torch.utils.config import RenderConfig

__all__ = [
    "Camera",
    "Mesh",
    "Rect",
    "RenderConfig",
    "RenderState",
    "Renderer",
    "Scene",
    "SceneData",
    "Triangles",
    "make_camera",
    "scene_from_numpy",
    "state_from_numpy",
]
