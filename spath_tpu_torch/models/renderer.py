"""One renderer interface over the backends, and the rule that picks one
(``spath_tpu/models/renderer.py``).

``REGISTRY`` lists the backends fastest first; ``forward_renderer`` takes
the first that renders ``(scene, cfg)`` exactly and ``grad_renderer`` the
first that differentiates it, so every entry point agrees on which
kernel a config runs on. The port has six: the fused CUDA kernels for the
conformance estimator (K1 forward, K2 backward), the streamed kernels for
the conformance estimator on large scenes (K6 forward, K8 with its
scatter K7 backward), the fused kernels for the quality estimator in its
hash+cosine form (K3 forward, K4 backward), the streamed kernels for the
quality estimator on large scenes (K9 forward, K10 with K7 backward),
visibility gradients (one of those interiors plus the residual of
``render_vis_residual``, whose sweeps are K5, with the interior's hits
from K11 where it is K9 at up to 8 spp), and the wavefront, with
autograd: on CPU tensors the plain version of every path, on a CUDA
device the wavefront with its sweeps on K5, last in the registry, for
what no fused kernel takes (the threefry stream, ``config.QUALITY``'s,
with its draws from ``csrc/threefry.cu``; the table stream; other
samplers with the hash stream; gradients deeper than the backward
kernels' 64 bounces; ``vis_grad`` over such an interior, as the JAX
package's ``VisGradFusedRenderer`` refuses a wavefront interior). A
config that a fused kernel takes never reaches it, and it takes scenes
of more than ``LIGHT_MAX`` lights with NEE, which K9 and K10 refuse. On a
CUDA device the port raises ``NotImplementedError`` only above 2^20
triangles (the streamed kernels' cap, which the wavefront on the card
keeps), and the JAX package's ``ValueError`` for the settings it refuses
(NEE, roulette or stratification on the LCG or table stream).

The order is the JAX package's: ``compact_fused`` first, then the kernel
renderers, ``visgrad``, ``compact`` (the compacted wavefront) and the
wavefront. The two compacted renderers (``models/compact_fast.py``,
``pathtracer.render_radiance_compact``) run the same kernels on the
camera rays that hit the scene only, with the same frame; they keep a
plan and read a host scalar, so they are not ``jittable``, and callers
that run every step or every rank (``make_train_step``, ``parallel/``)
pass ``require_jittable=True`` to route around them. An eager call that
names its camera takes ``compact_fused`` only where that camera's plan
is already cached and the card measured the cached call faster
(``COMPACT_ROUTES``); ``compact`` is reached by name only;
``get_renderer`` and ``render_any`` reach both by name.
"""

from __future__ import annotations

import torch

from spath_tpu_torch.camera import Camera
from spath_tpu_torch.config import RenderConfig
from spath_tpu_torch.models import compact_fast, pathtracer
from spath_tpu_torch.ops.kernels import (
    bigscene, bigscene_grad, bigscene_quality, bigscene_quality_grad,
    megakernel, megakernel_grad, megakernel_quality, megakernel_quality_grad,
)
from spath_tpu_torch.scene import Scene

#: Routing crossovers between the fused kernels, whose threads read the
#: whole table through the cache (K1; K1+K2 for a gradient), and the
#: streamed ones, which stage it through shared memory (K6; K6+K8+K7):
#: the fused kernels take conformance scenes of up to this many
#: triangles, the streamed ones the larger. Set from the K1/K6 and
#: K1+K2/K6+K8+K7 timings at T in {64, 128, 256, 512, 1024}, 320x240, 8
#: spp, on an NVIDIA H100 80GB HBM3 at 700 W (``chip_smoke.py`` phase
#: 25, PERF.md section 6). With K1 and K2 on their lane loop
#: (csrc/megakernel_lanes.cuh), in two runs K1 was 8-17% faster than K6 at
#: 256 triangles, 1-10% at 512 and 9-12% at 1024, 2-3% slower at 64, and
#: at 128 1% slower in one run and 7% faster in the other, so K1 takes
#: every scene up to its cap (``megakernel.MAX_TRIS``); K1+K2 was 7-25%
#: faster than K6+K8+K7 at 64 triangles, at 128 8% slower in one run and
#: 0.3% faster in the other, and took 4-8%, 14-19% and 20-24% longer at
#: 256, 512 and 1024, so the gradient's route stays at 128. The JAX
#: package's 128 and 64 were measured on a TPU v5e.
SMEM_ROUTE_MAX_TRIS = megakernel.MAX_TRIS
GRAD_ROUTE_MAX_TRIS = 128
#: The same crossovers for the quality estimator, between the fused K3
#: (K3+K4 for a gradient) and the streamed K9 (K9+K10+K7), from the
#: K3/K9 and K3+K4/K9+K10+K7 timings at the same shapes with NEE+MIS on
#: the same card (``chip_smoke.py`` phase 33, PERF.md section 6). With
#: K3 on its lane loop (csrc/quality_lanes.cuh), in two runs K9 was 1-3%
#: slower than K3 at 64 triangles, 4-12% faster at 128 and 0-2% faster at
#: 256; K3+K4 was 7-25% faster at 64 triangles, and K9+K10+K7 took 5-8%
#: less time at 128 in every run. So the fused kernels serve and
#: differentiate scenes of up to 64 triangles. The JAX package's 128 was
#: measured on a TPU v5e.
QUALITY_ROUTE_MAX_TRIS = 64
QUALITY_GRAD_ROUTE_MAX_TRIS = 64

#: Where compaction takes a call on its own (``CompactFusedRenderer.
#: takes_call``): only where the plan of the call's very scene, camera
#: and frame size is already cached (made by a compacted call by name:
#: ``get_renderer("compact_fused")``, ``render_any(backend=...)``,
#: ``compact_fast.render_radiance_compact_fused``), on the kernel routes
#: (``kernel_route``'s names) whose compacted forward, and those whose
#: compacted gradient, were faster than the full launch in both of two
#: runs on the card, in turns (full, compacted, compacted, full), the
#: plan cached (``chip_smoke.py`` phase 51, PERF.md section 6), at the
#: sizes timed: frames of at least ``COMPACT_MIN_PIXELS`` and scenes of at
#: most ``COMPACT_MAX_TRIS`` triangles. On an NVIDIA H100 80GB HBM3 at
#: 700 W, ms full / compacted, each twice in turns, the plan cached: the
#: default scene at 1920x1080, 64 spp (56.8% of its camera rays live)
#: forward K1 5.83, 6.04 / 5.08, 5.07 and K3 13.29, 13.89 / 12.41, 12.61,
#: forward+backward K1+K2 15.89, 16.30 / 16.23, 16.25 (not taken) and
#: K3+K4 53.14, 53.69 / 48.90, 49.64; procedural_scene(10_000) (64.1%
#: live), K6 at 8 spp 707.4, 713.0 / 684.1, 688.4, K6+K8+K7 1420.4,
#: 1423.4 / 1365.3, 1364.9, K9 at 4 spp 594.9, 600.2 / 559.6, 559.5,
#: K9+K10+K7 1213.4, 1214.3 / 1142.7, 1142.7. A first call pays the plan
#: (one K5 sweep of the camera rays, its permutation, a host sync): with
#: it K1 took 8.74 ms, K3 14.71, K6 715.98 and K9 593.75 (7.30, 16.50,
#: 714.52 and 594.11 in a second run; 7.50, 16.62, 720.00 and 592.67 in
#: a third), never clearly under the full launch, so the automatic choice
#: never builds a plan.
COMPACT_ROUTES: frozenset = frozenset(
    {"conformance", "quality", "bigscene", "bigscene_quality"})
COMPACT_GRAD_ROUTES: frozenset = frozenset(
    {"quality", "bigscene", "bigscene_quality"})
COMPACT_MIN_PIXELS = 1920 * 1080
COMPACT_MAX_TRIS = 10_000


class Renderer:
    """Abstract renderer; ``render`` applies the reference's final
    clamp."""

    #: short stable identifier
    name: str = "abstract"
    #: what it is, for a listing (the JAX package's ``description``)
    description: str = ""
    #: False where a call keeps a plan and reads a host scalar: callers
    #: that run every step or every rank route around it
    #: (``require_jittable``), as a traced JAX call must
    jittable: bool = True
    #: False to leave it out of the automatic choice: it is reached by
    #: name only (``get_renderer``, ``render_any(backend=...)``)
    auto: bool = True

    def describe(self) -> str:
        return self.description or self.name

    def available(self, scene: Scene | None = None) -> bool:
        """Can this backend run on the scene's device (without a scene,
        in this process) at all?"""
        return True

    def supports(self, scene: Scene, cfg: RenderConfig) -> bool:
        """Can this backend render this (scene, config) exactly?"""
        raise NotImplementedError

    def supports_grad(self, scene: Scene, cfg: RenderConfig) -> bool:
        """Can this backend differentiate this (scene, config)?"""
        return False

    def takes_call(self, scene: Scene, camera: Camera, cfg: RenderConfig,
                   grad: bool = False) -> bool:
        """Where ``jittable`` is False: does the automatic choice take this
        call? A renderer that keeps no plan across calls never does."""
        return False

    def trace_block(self, scene: Scene, origins, directions, pixel_ids,
                    cfg: RenderConfig, seed: int = 0,
                    grad: bool = False) -> torch.Tensor:
        """Mean radiance ``(n, 3)`` of camera rays with their pixel ids in
        the whole frame, which key the random streams, so that a block
        of a frame's rays gets the frame's bits (``parallel/shard.py``
        traces one a rank). ``grad``: differentiable under autograd.
        ``render_radiance`` and ``render_radiance_grad`` are the same
        function over the whole frame's rays."""
        raise NotImplementedError

    def render_radiance(self, scene: Scene, camera: Camera,
                        cfg: RenderConfig, seed: int = 0) -> torch.Tensor:
        """Unclamped mean radiance ``(H, W, 3)``."""
        raise NotImplementedError

    def render_radiance_grad(self, scene: Scene, camera: Camera,
                             cfg: RenderConfig, seed: int = 0
                             ) -> torch.Tensor:
        """``render_radiance``, differentiable under ``torch.autograd``."""
        raise NotImplementedError(f"{self.name} has no gradient path")

    def render(self, scene: Scene, camera: Camera, cfg: RenderConfig,
               seed: int = 0) -> torch.Tensor:
        return torch.clamp(self.render_radiance(scene, camera, cfg, seed),
                           0.0, 1.0)


def on_cuda(scene: Scene | None) -> bool:
    """Is the scene on a CUDA device (without a scene: has this process
    one)?"""
    if scene is None:
        return torch.cuda.is_available()
    return scene.device.type == "cuda"


def within_caps(scene: Scene) -> bool:
    """Does the scene keep the streamed kernels' cap of T <= 2^20, which
    every backend on a CUDA device keeps? The light cap, ``LIGHT_MAX``
    with NEE, is K9's and K10's alone: the wavefront chooses its light by
    ``torch.searchsorted`` (``ops/nee.py``) and its light distribution
    takes 2^20 triangles (``ops/kernels/light_cdf.py``)."""
    return scene.n_tris <= bigscene.BIG_MAX_TRIS


class KernelRenderer(Renderer):
    """A fused or streamed kernel pair on a CUDA device: ``fits`` and
    ``fits_grad`` are its route's predicates whatever the device, the
    crossovers among them, which ``kernel_route`` and the compacted
    renderers read too."""

    def available(self, scene=None) -> bool:
        return on_cuda(scene)

    def fits(self, scene: Scene, cfg: RenderConfig) -> bool:
        raise NotImplementedError

    def fits_grad(self, scene: Scene, cfg: RenderConfig) -> bool:
        raise NotImplementedError

    def supports(self, scene, cfg) -> bool:
        return self.available(scene) and self.fits(scene, cfg)

    def supports_grad(self, scene, cfg) -> bool:
        return self.available(scene) and self.fits_grad(scene, cfg)


class WavefrontRenderer(Renderer):
    """The wavefront with autograd, every ported estimator and every depth:
    on CPU tensors the plain PyTorch version of every path; on a CUDA
    device, last in the registry, what no kernel renderer takes (scenes
    of more than ``LIGHT_MAX`` lights with NEE among it), within
    ``within_caps``, its sweeps on K5 (``ops/intersect.py``)."""

    name = "wavefront"
    description = "the wavefront with autograd, every estimator (K5 on cards)"

    def supports(self, scene, cfg) -> bool:
        return scene.device.type == "cpu" or within_caps(scene)

    supports_grad = supports

    def render_radiance(self, scene, camera, cfg, seed=0):
        return pathtracer.render_radiance(scene, camera, cfg, seed)

    render_radiance_grad = render_radiance

    def trace_block(self, scene, origins, directions, pixel_ids, cfg,
                    seed=0, grad=False):
        return pathtracer.trace_mean_radiance(scene, origins, directions,
                                              cfg, seed, pixel_ids)


class MegakernelRenderer(KernelRenderer):
    """The fused CUDA kernels, conformance estimator: K1 forward for T <=
    SMEM_ROUTE_MAX_TRIS, and K1 with its reverse sweep K2 for gradients
    for T <= GRAD_ROUTE_MAX_TRIS."""

    name = "megakernel"
    description = "fused CUDA kernels K1/K2 (lcg+angle, small scenes)"

    def fits(self, scene, cfg) -> bool:
        return (scene.n_tris <= SMEM_ROUTE_MAX_TRIS
                and megakernel.supported(scene, cfg))

    def fits_grad(self, scene, cfg) -> bool:
        return (scene.n_tris <= GRAD_ROUTE_MAX_TRIS
                and megakernel_grad.supported_grad(scene, cfg))

    def trace_block(self, scene, origins, directions, pixel_ids, cfg,
                    seed=0, grad=False):
        block = (megakernel_grad.radiance_block_grad if grad
                 else megakernel.radiance_block)
        return block(scene, origins, directions, pixel_ids, cfg, seed)

    def render_radiance(self, scene, camera, cfg, seed=0):
        return megakernel.render_radiance_megakernel(scene, camera, cfg,
                                                     seed)

    def render_radiance_grad(self, scene, camera, cfg, seed=0):
        return megakernel_grad.render_radiance_mega(scene, camera, cfg, seed)


class BigsceneRenderer(KernelRenderer):
    """The streamed CUDA kernels, conformance estimator, T <=
    BIG_MAX_TRIS (2^20): K6 forward, and K6 with its reverse sweep K8 and
    the stream scatter K7 for gradients. Listed after the fused kernels,
    so it takes the scenes above the crossovers."""

    name = "bigscene"
    description = "streamed CUDA kernels K6/K8+K7 (lcg+angle, large scenes)"

    def fits(self, scene, cfg) -> bool:
        return bigscene.supported(scene, cfg)

    def fits_grad(self, scene, cfg) -> bool:
        return bigscene_grad.supported_grad(scene, cfg)

    def trace_block(self, scene, origins, directions, pixel_ids, cfg,
                    seed=0, grad=False):
        block = (bigscene_grad.radiance_block_grad if grad
                 else bigscene.radiance_block)
        return block(scene, origins, directions, pixel_ids, cfg, seed)

    def render_radiance(self, scene, camera, cfg, seed=0):
        return bigscene.render_radiance_bigscene(scene, camera, cfg, seed)

    def render_radiance_grad(self, scene, camera, cfg, seed=0):
        return bigscene_grad.render_radiance_bigscene_grad(scene, camera,
                                                           cfg, seed)


class QualityMegakernelRenderer(KernelRenderer):
    """The fused CUDA kernels, quality estimator (hash RNG, cosine
    sampler, NEE/MIS, Russian roulette, stratification): K3 forward for T
    <= QUALITY_ROUTE_MAX_TRIS, and K3 with its reverse sweep K4 for
    gradients for T <= QUALITY_GRAD_ROUTE_MAX_TRIS; the streamed quality
    kernels take the larger scenes. (The JAX package's crossover, 128
    triangles, was measured on a TPU v5e.)"""

    name = "quality"
    description = "fused CUDA kernels K3/K4 (hash+cosine, NEE/MIS)"

    def fits(self, scene, cfg) -> bool:
        return (scene.n_tris <= QUALITY_ROUTE_MAX_TRIS
                and megakernel_quality.supported(scene, cfg))

    def fits_grad(self, scene, cfg) -> bool:
        return (scene.n_tris <= QUALITY_GRAD_ROUTE_MAX_TRIS
                and megakernel_quality_grad.supported_grad(scene, cfg))

    def trace_block(self, scene, origins, directions, pixel_ids, cfg,
                    seed=0, grad=False):
        block = (megakernel_quality_grad.radiance_block_grad if grad
                 else megakernel_quality.radiance_block)
        return block(scene, origins, directions, pixel_ids, cfg, seed)

    def render_radiance(self, scene, camera, cfg, seed=0):
        return megakernel_quality.render_radiance_quality_megakernel(
            scene, camera, cfg, seed)

    def render_radiance_grad(self, scene, camera, cfg, seed=0):
        return megakernel_quality_grad.render_radiance_quality_grad(
            scene, camera, cfg, seed)


class QualityBigsceneRenderer(KernelRenderer):
    """The streamed CUDA kernels, quality estimator, T <= BIGQ_MAX_TRIS
    (2^20) and, with NEE, at most LIGHT_MAX lights: K9 forward, and K9
    with its reverse sweep K10 and the stream scatter K7 for gradients.
    Listed after the fused quality kernels, so it takes the scenes above
    the crossovers."""

    name = "quality_bigscene"
    description = "streamed CUDA kernels K9/K10+K7 (hash+cosine, large scenes)"

    def fits(self, scene, cfg) -> bool:
        return bigscene_quality.supported(scene, cfg)

    def fits_grad(self, scene, cfg) -> bool:
        return bigscene_quality_grad.supported_grad(scene, cfg)

    def trace_block(self, scene, origins, directions, pixel_ids, cfg,
                    seed=0, grad=False):
        block = (bigscene_quality_grad.radiance_block_grad if grad
                 else bigscene_quality.radiance_block)
        return block(scene, origins, directions, pixel_ids, cfg, seed)

    def render_radiance(self, scene, camera, cfg, seed=0):
        return bigscene_quality.render_radiance_bigscene_quality(
            scene, camera, cfg, seed)

    def render_radiance_grad(self, scene, camera, cfg, seed=0):
        return bigscene_quality_grad.render_radiance_bigscene_quality_grad(
            scene, camera, cfg, seed)


class VisGradFusedRenderer(Renderer):
    """Visibility gradients at kernel speed. The ``vis_grad`` image is the
    interior plus visibility terms whose value is exactly zero, so the
    gradient splits: the interior's forward and backward on a kernel
    renderer (K1+K2, K6+K8+K7, K3+K4 or K9+K10+K7), plus
    ``render_vis_residual``, a detached replay of the walk that
    differentiates only the O(1)-a-lane visibility chains, its sweeps on
    K5. For the streamed quality interior at up to
    ``bigscene_quality.HITS_MAX_SPP`` samples the interior's forward is K11,
    whose hit export the residual replays instead of sweeping. The same
    gradient as the wavefront with ``cfg.vis_grad`` (``spath_tpu``'s
    ``VisGradFusedRenderer``). The interior is never compacted: the JAX
    package's eager call would take ``compact_fused`` first and so skip
    K11, with the same value; the residual's own sweeps, which K11 saves,
    cost a whole streamed forward, and the residual dominates the step."""

    name = "visgrad"
    description = "kernel interior + visibility-gradient residual (K5)"

    def available(self, scene=None) -> bool:
        return on_cuda(scene)

    def supports(self, scene, cfg) -> bool:
        return False            # a frame is the same without vis_grad

    def trace_block(self, scene, origins, directions, pixel_ids, cfg,
                    seed=0, grad=False):
        """The wavefront's, ``vis_grad`` and all: the residual replays
        the camera's whole frame, so a block of it (a rank's, in
        ``parallel/``) takes the wavefront, as the JAX package's sharded
        paths send ``vis_grad`` to the sharded wavefront."""
        return WavefrontRenderer().trace_block(scene, origins, directions,
                                               pixel_ids, cfg, seed, grad)

    def supports_grad(self, scene, cfg) -> bool:
        if not (self.available(scene) and cfg.vis_grad):
            return False
        icfg = cfg.replace(vis_grad=False)
        return any(r.supports_grad(scene, icfg) for r in REGISTRY
                   if r.name not in (self.name, WavefrontRenderer.name))

    def render_radiance_grad(self, scene, camera, cfg, seed=0):
        icfg = cfg.replace(vis_grad=False)
        r = grad_renderer(scene, icfg, require_jittable=True)
        if (r.name == QualityBigsceneRenderer.name
                and cfg.spp <= bigscene_quality.HITS_MAX_SPP):
            interior, hits = \
                bigscene_quality_grad.render_bigscene_quality_with_hits(
                    scene, camera, icfg, seed)
            return interior + pathtracer.render_vis_residual(
                scene, camera, cfg, seed, hits=hits)
        interior = r.render_radiance_grad(scene, camera, icfg, seed)
        return interior + pathtracer.render_vis_residual(scene, camera, cfg,
                                                         seed)


class CompactFusedRenderer(Renderer):
    """The kernel renderers on the camera rays that hit the scene only
    (``models/compact_fast.py``): the plan classifies the frame's camera
    rays once by the exact first-hit sweep (K5 on the card), and K1, K3,
    K6 or K9 (K1+K2, K3+K4, K6+K8+K7, K9+K10+K7 for a gradient) run on the
    live rays; the frame is the full launch's, bit for bit. A plan build
    reads one host scalar, so it is not ``jittable``. The automatic
    choice takes it only where the call's plan is cached and the card
    measured the cached call faster (``takes_call``); by name
    (``get_renderer``, ``render_any``) it builds the plan it lacks."""

    name = "compact_fused"
    description = "kernels on the live camera rays only (serving, training)"
    jittable = False

    def available(self, scene=None) -> bool:
        return on_cuda(scene)

    def supports(self, scene, cfg) -> bool:
        return self.available(scene) and compact_fast.supported(scene, cfg)

    def supports_grad(self, scene, cfg) -> bool:
        return (self.available(scene)
                and compact_fast.supported_grad(scene, cfg))

    def takes_call(self, scene, camera, cfg, grad=False) -> bool:
        routes = COMPACT_GRAD_ROUTES if grad else COMPACT_ROUTES
        return (cfg.width * cfg.height >= COMPACT_MIN_PIXELS
                and scene.n_tris <= COMPACT_MAX_TRIS
                and kernel_route(scene, cfg, grad) in routes
                and compact_fast.has_plan(scene, camera, cfg))

    def trace_block(self, scene, origins, directions, pixel_ids, cfg,
                    seed=0, grad=False):
        """The kernel renderer's that it compacts: a rank's block has no
        frame to compact."""
        return KERNEL_RENDERERS[kernel_route(scene, cfg, grad)].trace_block(
            scene, origins, directions, pixel_ids, cfg, seed, grad)

    def render_radiance(self, scene, camera, cfg, seed=0):
        return compact_fast.render_radiance_compact_fused(scene, camera, cfg,
                                                          seed)

    def render_radiance_grad(self, scene, camera, cfg, seed=0):
        return compact_fast.render_radiance_compact_grad(scene, camera, cfg,
                                                         seed)


class CompactWavefrontRenderer(WavefrontRenderer):
    """The wavefront on the pixels whose camera ray hits the scene only
    (``pathtracer.render_radiance_compact``), bit-equal to the
    wavefront's frame; forward only. One host scalar a call, so it is not
    ``jittable``. Reached by name only (``auto`` False): on the card it
    was faster than the wavefront in one of three runs only
    (``chip_smoke.py`` phase 51, config.QUALITY at 1920x1080, 8 spp, ms
    full / compacted in turns, NVIDIA H100 80GB HBM3 at 700 W: 233.5,
    232.9 / 247.2, 233.3; 171.9, 187.0 / 164.5, 150.4; 266.4, 262.9 /
    274.9, 278.2), whose frame is host-bound by its launches, which
    compaction does not cut."""

    name = "compact"
    description = "the wavefront on the live camera rays only (forward)"
    jittable = False
    auto = False

    def supports_grad(self, scene, cfg) -> bool:
        return False

    def render_radiance(self, scene, camera, cfg, seed=0):
        return pathtracer.render_radiance_compact(scene, camera, cfg, seed)

    render_radiance_grad = Renderer.render_radiance_grad


#: the kernel renderers by ``compact_fast``'s route names, in the order
#: the router tries them
KERNEL_RENDERERS: dict[str, KernelRenderer] = {
    "conformance": MegakernelRenderer(),
    "quality": QualityMegakernelRenderer(),
    "bigscene_quality": QualityBigsceneRenderer(),
    "bigscene": BigsceneRenderer(),
}

#: All backends, fastest first, in the JAX package's order: selection
#: takes the first match.
REGISTRY: tuple[Renderer, ...] = (
    CompactFusedRenderer(),
    *KERNEL_RENDERERS.values(),
    VisGradFusedRenderer(),
    CompactWavefrontRenderer(),
    WavefrontRenderer(),
)


def kernel_route(scene: Scene, cfg: RenderConfig,
                 grad: bool = False) -> str | None:
    """The kernel renderer (a ``KERNEL_RENDERERS`` name) that takes
    ``(scene, cfg)`` on a CUDA device, whatever the scene's device; the
    compacted renderers run it on the live rays."""
    for name, r in KERNEL_RENDERERS.items():
        if (r.fits_grad if grad else r.fits)(scene, cfg):
            return name
    return None


def get_renderer(name: str) -> Renderer:
    """The registered renderer called ``name``; ``KeyError`` naming them
    all where none is."""
    for r in REGISTRY:
        if r.name == name:
            return r
    raise KeyError(f"unknown renderer {name!r}; "
                   f"have {[r.name for r in REGISTRY]}")


def available_renderers() -> list[Renderer]:
    """The renderers that can run in this process."""
    return [r for r in REGISTRY if r.available()]


def _estimator(cfg: RenderConfig) -> str:
    return (f"rng={cfg.rng!r}, sampler={cfg.sampler!r}, nee={cfg.nee}, "
            f"rr_start={cfg.rr_start}, stratify={cfg.stratify}")


def no_kernel(scene: Scene, cfg: RenderConfig, grad: bool) -> str:
    """Why no ported backend takes ``(scene, cfg)`` on the scene's device:
    the streamed kernels' cap of 2^20 triangles, which the wavefront on
    the card keeps for every estimator."""
    what = "differentiates" if grad else "renders"
    if pathtracer.is_conformance(cfg):
        name = "the streamed kernels " + ("K6 and K8" if grad else "K6")
    elif cfg.rng == "hash" and cfg.sampler == "cosine":
        name = "the streamed quality kernels " + (
            "K9 and K10" if grad else "K9")
    else:
        name = "the wavefront on the card, at the streamed kernels' cap,"
    return (f"no ported kernel {what} {_estimator(cfg)} with "
            f"{scene.n_tris} triangles on {scene.device}: {name} take T <= "
            f"{bigscene.BIG_MAX_TRIS} (2^20), as the JAX package's "
            "BIG_MAX_TRIS; so does the wavefront on the card")


def _chosen(r: Renderer, scene: Scene, camera: Camera | None,
            cfg: RenderConfig, require_jittable: bool, grad: bool) -> bool:
    """May the automatic choice take ``r``? A renderer that keeps a plan
    only for an eager caller that names its camera, and only where
    ``r.takes_call``."""
    if not r.auto:
        return False
    if r.jittable:
        return True
    return (not require_jittable and camera is not None
            and r.takes_call(scene, camera, cfg, grad))


def forward_renderer(scene: Scene, cfg: RenderConfig,
                     require_jittable: bool = True,
                     camera: Camera | None = None) -> Renderer:
    """The fastest backend that renders ``(scene, cfg)`` exactly; raises
    ``NotImplementedError`` when no ported backend does.
    ``require_jittable`` (the JAX package's default) skips the renderers
    that keep a plan; eager entry points (``render_pt_fast``,
    ``render_any``) pass False and their ``camera``, whose cached plan
    ``CompactFusedRenderer.takes_call`` looks for."""
    pathtracer.check_estimator(cfg)
    for r in REGISTRY:
        if (r.supports(scene, cfg)
                and _chosen(r, scene, camera, cfg, require_jittable, False)):
            return r
    raise NotImplementedError(no_kernel(scene, cfg, grad=False))


def grad_renderer(scene: Scene, cfg: RenderConfig,
                  require_jittable: bool = False,
                  camera: Camera | None = None) -> Renderer:
    """The fastest backend that differentiates ``(scene, cfg)``; raises
    ``NotImplementedError`` when no ported backend does.
    ``require_jittable`` skips the renderers that keep a plan: train
    steps and the sharded paths pass it; ``camera`` as
    ``forward_renderer`` takes it."""
    pathtracer.check_estimator(cfg)
    for r in REGISTRY:
        if (r.supports_grad(scene, cfg)
                and _chosen(r, scene, camera, cfg, require_jittable, True)):
            return r
    raise NotImplementedError(no_kernel(scene, cfg, grad=True))


def render_any(scene: Scene, camera: Camera, cfg: RenderConfig,
               seed: int = 0, backend: str | None = None) -> torch.Tensor:
    """The clamped frame from the renderer called ``backend``, or from the
    one the eager rule picks."""
    r = get_renderer(backend) if backend else forward_renderer(
        scene, cfg, require_jittable=False, camera=camera)
    return r.render(scene, camera, cfg, seed)
