"""Parameter carry-over between the JAX package and the port.

Both sides meet at numpy arrays: ``np.asarray(scene.vertices)`` and so on
from the JAX package go in, the port's tensors on ``device`` come out,
and back. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.scene import Scene, make_scene


def scene_from_numpy(vertices, albedo, emission, light_idx=None, *,
                     device) -> Scene:
    """``(T,3,3)`` vertices and ``(T,3)`` albedo/emission arrays → Scene."""
    return make_scene(vertices, albedo, emission, device,
                      light_idx=None if light_idx is None
                      else tuple(int(i) for i in light_idx))


def scene_to_numpy(scene: Scene):
    """Scene → ``(vertices, albedo, emission)`` float32 numpy arrays."""
    return tuple(t.detach().cpu().numpy()
                 for t in (scene.vertices, scene.albedo, scene.emission))


def camera_from_numpy(pos, angle, focal, *, device) -> Camera:
    """``(3,)`` position, ``(3,)`` angles and a scalar focal → Camera."""
    def tensor(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return Camera(pos=tensor(pos), angle=tensor(angle),
                  focal=tensor(np.float32(focal)))


def camera_to_numpy(camera: Camera):
    """Camera → ``(pos, angle, focal)`` float32 numpy arrays."""
    return tuple(t.detach().cpu().numpy()
                 for t in (camera.pos, camera.angle, camera.focal))


def inverse_params_from_numpy(cam_pos, cam_angle, cam_focal, albedo, *,
                              device):
    """The JAX package's ``InverseParams`` fields as arrays → the port's
    ``InverseParams`` on ``device``."""
    from spath_tpu_torch.models.inverse import InverseParams

    def tensor(x):
        return torch.from_numpy(np.array(x, np.float32)).to(device)

    return InverseParams(cam_pos=tensor(cam_pos), cam_angle=tensor(cam_angle),
                         cam_focal=tensor(cam_focal), albedo=tensor(albedo))


def inverse_params_to_numpy(params):
    """The port's ``InverseParams`` → ``(cam_pos, cam_angle, cam_focal,
    albedo)`` float32 numpy arrays, the JAX package's field order."""
    return tuple(t.detach().cpu().numpy()
                 for t in params.tensors().values())
