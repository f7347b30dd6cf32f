"""mafrixraytracing_torch — the differentiable path tracer in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of `mafrixraytracing_tpu` (JAX, the reference it is tested against).
It imports no JAX: scenes compile to flat SoA tensors (`TorchScene`), the
integrator is a wavefront bounce loop with next-event estimation, and the
ray searches run hand-written CUDA kernels (`csrc/`). Tensors are made on
the CUDA card unless the caller passes `device="cpu"`; CPU tensors go
through the kernels' plain PyTorch versions. Gradients flow through
autograd.
"""

__version__ = "0.1.0"

from mafrixraytracing_torch.camera.camera import Camera
from mafrixraytracing_torch.integrator.path import PathTracerConfig, render_image
from mafrixraytracing_torch.scene.compiler import (
    TorchScene,
    compile_scene,
    from_jax_arrays,
)

__all__ = [
    "Camera",
    "PathTracerConfig",
    "TorchScene",
    "compile_scene",
    "from_jax_arrays",
    "render_image",
]
