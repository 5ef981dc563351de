"""Checkpoint / resume for progressive renders (the format of
``opengl_raytracer_tpu/utils/checkpoint.py``).

The render state ``(accum, frame_count, tile cursor)`` and the camera pose
round-trip through one ``.npz`` with the JAX package's keys, so a
checkpoint written by either package resumes in the other.  The per-pixel
RNG streams depend only on (x, y, frameNumber) (fragment.glsl:390), so a
resumed render equals an uninterrupted one.
"""

from __future__ import annotations

import numpy as np

from opengl_raytracer_torch.renderer import RenderState, state_from_numpy


def save_checkpoint(path: str, state: RenderState, cam_pos=None,
                    cam_dir=None) -> None:
    np.savez_compressed(
        path,
        accum=state.accum.cpu().numpy(),
        frame_count=state.frame_count,
        tile_x=state.tile_x,
        tile_y=state.tile_y,
        total_frames=state.total_frames,
        cam_pos=np.asarray(cam_pos) if cam_pos is not None else np.zeros(3),
        cam_dir=np.asarray(cam_dir) if cam_dir is not None else np.zeros(2),
        has_camera=cam_pos is not None,
    )


def load_checkpoint(path: str, device):
    """Returns (RenderState on ``device``, cam_pos | None, cam_dir | None)."""
    with np.load(path) as z:
        state = state_from_numpy(z["accum"], z["frame_count"], z["tile_x"],
                                 z["tile_y"], z["total_frames"], device)
        if bool(z["has_camera"]):
            return state, z["cam_pos"], z["cam_dir"]
    return state, None, None
