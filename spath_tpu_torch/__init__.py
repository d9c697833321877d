"""spath_tpu_torch: the PyTorch and CUDA port of spath_tpu.

Two estimators render and train on an NVIDIA Hopper card through
hand-written CUDA kernels, each a fused forward and its reverse sweep:

- conformance, the reference's per-pixel LCG and angle-uniform sampler:
  K1 (``ops/kernels/megakernel.py``, ``csrc/megakernel.cu``) and K2
  (``ops/kernels/megakernel_grad.py``, ``csrc/megakernel_grad.cu``), and
  for scenes of up to 2^20 triangles the streamed K6
  (``ops/kernels/bigscene.py``, ``csrc/bigscene.cu``) and K8
  (``ops/kernels/bigscene_grad.py``, ``csrc/bigscene_grad.cu``) with the
  stream scatter K7 (``ops/kernels/stream_scatter.py``,
  ``csrc/stream_scatter.cu``);
- quality, the hash stream, cosine sampler, next-event estimation with
  MIS, Russian roulette and stratification: K3
  (``ops/kernels/megakernel_quality.py``, ``csrc/megakernel_quality.cu``)
  and K4 (``ops/kernels/megakernel_quality_grad.py``,
  ``csrc/megakernel_quality_grad.cu``).

On the CPU both run through the plain PyTorch wavefront and autograd.
The JAX package ``spath_tpu`` is the reference it is tested against; this
package imports neither it nor JAX.
"""

from spath_tpu_torch.camera import Camera, generate_rays
from spath_tpu_torch.config import CONFORMANCE, RenderConfig
from spath_tpu_torch.models.flat import render_flat
from spath_tpu_torch.models.pathtracer import (
    render_pt, render_pt_fast, render_radiance, render_radiance_fastgrad,
)
from spath_tpu_torch.scene import (
    Scene, default_scene, make_scene, procedural_scene,
)

__all__ = [
    "CONFORMANCE", "Camera", "RenderConfig", "Scene", "default_scene",
    "generate_rays", "make_scene", "procedural_scene", "render_flat",
    "render_pt", "render_pt_fast", "render_radiance",
    "render_radiance_fastgrad",
]
