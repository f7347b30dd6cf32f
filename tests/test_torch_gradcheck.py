"""The port's gradients against central finite differences, and its pixel
chunks against the unchunked frame, on the CPU.

The counterparts of `tests/test_gradients.py` (albedo, light radiance,
emission, a vertex, the camera's origin: the same scenes, steps and
tolerances), of `tests/test_compact.py`'s gradient through compaction, of
`tests/test_smoke_tiers.py`'s FD gradient, and of
`tests/test_film.py::test_render_image_pixel_chunking_exact`, for
`mafrixraytracing_torch`. Both the gradient and the finite difference use
the same keys, so the same sample paths (common random numbers), with
Russian roulette off: the difference then tracks the derivative of one
deterministic estimate to the quadrature step, even at low spp.
"""
import numpy as np
import pytest
import torch

from mafrixraytracing_torch.core import rng
from mafrixraytracing_torch.core.v3 import V3
from mafrixraytracing_torch.geometry.intersect import find_closest
from mafrixraytracing_torch.integrator.path import (
    PathTracerConfig,
    render_image,
    trace_radiance,
)
from mafrixraytracing_torch.scene import spec as S
from mafrixraytracing_torch.scene.builtin import cornell_box
from mafrixraytracing_torch.scene.compiler import compile_scene
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

CFG = PathTracerConfig(max_depth=3, rr_enable=False)


def _simple_scene():
    """A floor of albedo 0.6 under a hidden square light of radiance 10."""
    albedo, Le, s, h = 0.6, 10.0, 0.4, 2.0
    floor = S.make_rect_mesh((-10, 0, 10), (10, 0, 10), (10, 0, -10), (-10, 0, -10))
    light = S.make_rect_mesh((-s, h, -s), (s, h, -s), (s, h, s), (-s, h, s))
    spec = S.SceneSpec(
        materials=[S.MaterialSpec(albedo=(albedo,) * 3)],
        shapes=[S.ShapeSpec(floor, 0)],
        area_lights=[S.AreaLightSpec(light, radiance=(Le,) * 3, visible=False)],
    )
    return compile_scene(spec, device="cpu").scene


def _rays(n, origin, direction):
    o = V3.of(torch.tensor([origin], dtype=torch.float32).expand(n, 3))
    d = V3.of(torch.tensor([direction], dtype=torch.float32).expand(n, 3))
    return o, d


def _mean_radiance(scene, n=512, seed=0, origin=(0.0, 1.0, 0.0),
                   direction=(0.0, -1.0, 0.0)):
    # the origin projects strictly inside one floor triangle: on the quad's
    # diagonal the closest hit would flip under +-eps
    o, d = _rays(n, origin, direction)
    keys = rng.pixel_keys(rng.root_key(seed, "cpu"), n)
    return trace_radiance(scene, o, d, keys, CFG).mean()


def _fd_check(f, x0, eps, rtol, directions):
    """Autograd's derivative of f at x0 against the central finite
    difference along each one-hot direction."""
    x = x0.detach().clone().requires_grad_()
    (g,) = torch.autograd.grad(f(x), x)
    assert torch.isfinite(g).all()
    for at in directions:
        step = torch.zeros_like(x0)
        step[at] = 1.0
        with torch.no_grad():
            fd = (f(x0 + eps * step) - f(x0 - eps * step)) / (2 * eps)
        np.testing.assert_allclose(float(g[at]), float(fd), rtol=rtol, atol=1e-6)
    return g


def test_albedo_gradient_fd():
    scene = _simple_scene()
    _fd_check(lambda a: _mean_radiance(scene.replace(mat_albedo=a)), scene.mat_albedo,
              eps=1e-3, rtol=1e-2, directions=[(0, 0), (0, 2)])


def test_light_radiance_gradient_fd():
    scene = _simple_scene()
    # radiance enters linearly: the derivative must match tightly
    _fd_check(lambda lr: _mean_radiance(scene.replace(light_radiance=lr)),
              scene.light_radiance, eps=1e-2, rtol=1e-3, directions=[(0, 0), (1, 1)])


def test_emission_gradient_fd():
    """Emission of visible emissive geometry: rays from the middle of the
    Cornell box straight up at its light."""
    scene = compile_scene(cornell_box(8, 8), device="cpu").scene

    def f(em):
        return _mean_radiance(scene.replace(mat_emission=em), n=64, seed=1,
                              direction=(0.0, 1.0, 0.0))

    g = _fd_check(f, scene.mat_emission, eps=1e-2, rtol=1e-3, directions=[(3, 0)])
    # the emissive row (after white, green, red) carries ~1/3 a channel
    assert float(g.abs().sum(dim=1)[3]) > 0.3


def test_vertex_gradient_fd():
    """Moving the floor triangle under the rays changes the distance to the
    light (inverse-square falloff): d(radiance)/d(tri_v0 y) of that triangle
    against the finite difference."""
    scene = _simple_scene()
    origin = (2.0, 1.0, 2.0)
    _, idx = find_closest(scene, *_rays(1, origin, (0.0, -1.0, 0.0)), 1e-3, 1e8)
    row = int(idx[0])
    assert row >= 0
    _fd_check(lambda v0: _mean_radiance(scene.replace(tri_v0=v0), n=256, origin=origin),
              scene.tri_v0, eps=1e-3, rtol=0.05, directions=[(row, 1)])


def test_camera_gradient_fd():
    """`tests/test_gradients.py::test_camera_gradient_exists`: d(mean
    radiance)/d(origin y) of an oblique ray (straight down, moving the origin
    would not move the shading point), against the central difference."""
    scene = _simple_scene()
    d0 = torch.tensor([1.0, -1.0, 0.0]) / torch.sqrt(torch.tensor(2.0))

    def f(cam_y):
        o = torch.zeros(128, 3) + torch.stack([torch.zeros(()), cam_y, torch.zeros(())])
        keys = rng.pixel_keys(rng.root_key(2, "cpu"), 128)
        return trace_radiance(scene, V3.of(o), V3.of(d0.expand(128, 3)), keys,
                              CFG).mean()

    y = torch.tensor(1.0, requires_grad=True)
    (g,) = torch.autograd.grad(f(y), y)
    assert torch.isfinite(g) and abs(float(g)) > 1e-4
    with torch.no_grad():
        fd = (float(f(torch.tensor(1.0 + 1e-3))) - float(f(torch.tensor(1.0 - 1e-3)))) / 2e-3
    np.testing.assert_allclose(float(g), fd, rtol=0.05, atol=1e-5)


def test_compaction_gradient_fd():
    """`tests/test_compact.py::test_compaction_gradient_matches_fd`: the
    light-radiance gradient through the compacted bounce loop (the pack's
    sort, slices and fragment merge) against the central difference."""
    scene = _simple_scene()
    cfg = PathTracerConfig(max_depth=3, rr_enable=False, compact=(1.0, 1.0, 0.5))
    o, d = _rays(128, (0.0, 1.0, 0.0), (0.0, -1.0, 0.0))
    keys = rng.pixel_keys(rng.root_key(1, "cpu"), 128)
    _fd_check(lambda lr: trace_radiance(scene.replace(light_radiance=lr), o, d, keys,
                                        cfg).mean(),
              scene.light_radiance, eps=1e-2, rtol=1e-3, directions=[(0, 0)])


def test_smoke_fd_gradient():
    """`tests/test_smoke_tiers.py::test_smoke_fd_gradient`: the light-radiance
    gradient of 64 rays at the seed 5 against the central difference."""
    scene = _simple_scene()
    _fd_check(lambda lr: _mean_radiance(scene.replace(light_radiance=lr), n=64, seed=5),
              scene.light_radiance, eps=1e-2, rtol=1e-3, directions=[(0, 0)])


@pytest.mark.parametrize("wavefront", [512, 1024])
def test_render_image_pixel_chunking_exact(wavefront):
    """A frame larger than `config.wavefront` at G = 1 renders in pixel
    chunks (48 x 48 = 2,304 pixels: 5 or 3 chunks); each pixel's keys do not
    depend on the chunking, so the chunked frame is bit-equal to the
    unchunked one."""
    from dataclasses import replace

    cs = compile_scene(cornell_box(48, 48), device="cpu")
    base = PathTracerConfig(max_depth=2, rr_enable=False)
    key = rng.root_key(3, "cpu")
    with torch.no_grad():
        img_a = render_image(cs.scene, cs.camera, 48, 48, 1, key, base)
        img_b = render_image(cs.scene, cs.camera, 48, 48, 1, key,
                             replace(base, wavefront=wavefront))
    assert torch.isfinite(img_a).all() and float(img_a.mean()) > 0.0
    assert torch.equal(img_a, img_b)
