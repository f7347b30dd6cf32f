"""Fixed-function rasterizer pipeline (the reference's legacy second engine).

Port of `mafrixraytracing_tpu/raster/pipeline.py` (reference `PipelineDraw`,
`EngineCore/Core/Pipeline.fs:69-103`): local -> world -> camera -> clip ->
screen, backface removal, barycentric fill with a z-buffer, per-pixel
texture sample and Lambert lighting. Coverage is dense edge-function
evaluation of every pixel against a chunk of triangles at a time, with a
running z-buffer, as in the JAX package; attribute interpolation is affine
in screen space (the reference's `DrawTrangle`) unless `perspective_correct`.

Plain PyTorch: the JAX version is a `lax.scan` that XLA fuses and reaches no
Pallas kernel. The design differs from the scan in two ways that do not
change a value:

- The winner search (which face each pixel shows, and its depth) runs under
  `torch.no_grad()` over chunks of `chunk` faces; a short last chunk takes
  the place of the scan's padding with index-0 faces. Under autograd every
  chunk's (pixels, chunk) temporaries would be kept. The winner's
  barycentrics are then computed again per pixel, with grad, by the same
  elementwise formula on the same operands, so they are bit-equal to the
  ones the scan carries, and gradients reach vertices, normals, uvs,
  texture and lights in memory linear in the pixels.
- The per-pixel gathers of the winner's corners and of the texture go
  through `ops.unpack.gather_rows`, whose backward on the card is the
  deterministic scatter-add (kernel J): a repeated gradient is bit-equal.

Ties: a chunk takes its first minimum (`torch.argmin`) and a later chunk
must be strictly nearer, so the lowest face index wins a tie whatever
`chunk` is.

Two faults of the JAX version are not copied (`ROADMAP.md` §3, "Recorded
differences"): normals go through the inverse-transpose of the model matrix
(`core.transform.apply_normal`'s matrix; the JAX version applies the
inverse itself, so a rotation turns them the wrong way), and a face whose
screen area is at most 1e-8 is not drawn (the JAX version zeroes its
inverse area and then finds it inside every pixel).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from mafrixraytracing_torch.core.device import resolve
from mafrixraytracing_torch.core.math import normalize
from mafrixraytracing_torch.core.transform import _rows, _scalar
from mafrixraytracing_torch.ops.cuda import same_device
from mafrixraytracing_torch.ops.unpack import gather_rows

MIN_AREA = 1e-8   # twice the screen area (px^2) below which a face is not drawn


# ---------------------------------------------------------------------------
# Camera matrices (reference `Core/Camera.fs:43-86` GetUVNTransMatrix /
# GetPerspectiveMatrix / GetOrthogriphicMatrix)
# ---------------------------------------------------------------------------


def look_at(eye, target, up=(0.0, 1.0, 0.0), device=None) -> torch.Tensor:
    """World -> camera (UVN) matrix; camera looks down -z."""
    device = resolve(device)
    eye = _scalar(eye, device)
    f = normalize(_scalar(target, device) - eye)
    r = normalize(torch.linalg.cross(f, _scalar(up, device)))
    u = torch.linalg.cross(r, f)
    rot = torch.stack([r, u, -f], dim=0)
    top = torch.cat([rot, (-rot @ eye)[:, None]], dim=1)
    return torch.cat([top, _scalar([[0.0, 0.0, 0.0, 1.0]], device)], dim=0)


def perspective(fov_deg, aspect, near=0.1, far=100.0, device=None) -> torch.Tensor:
    """Perspective projection (vertical fov, degrees) -> clip space."""
    device = resolve(device)
    f = 1.0 / torch.tan(torch.deg2rad(_scalar(fov_deg, device)) / 2.0)
    return _rows([[f / aspect, 0, 0, 0],
                  [0, f, 0, 0],
                  [0, 0, (far + near) / (near - far), 2 * far * near / (near - far)],
                  [0, 0, -1, 0]], device)


def orthographic(half_w, half_h, near=0.1, far=100.0, device=None) -> torch.Tensor:
    return _rows([[1.0 / half_w, 0, 0, 0],
                  [0, 1.0 / half_h, 0, 0],
                  [0, 0, -2.0 / (far - near), -(far + near) / (far - near)],
                  [0, 0, 0, 1]], resolve(device))


@dataclass(frozen=True)
class RasterLight:
    """Rasterizer lights (reference DU `Light`, `Core/Lights/Light.fs:66-80`:
    Ambient_Light / Direction_Light / Point_Light)."""

    type: str                       # "ambient" | "directional" | "point"
    color: tuple = (1.0, 1.0, 1.0)
    direction: tuple = (0.0, -1.0, 0.0)   # directional
    position: tuple = (0.0, 5.0, 0.0)     # point


def _shade(lights, points, normals, base_color):
    """Per-pixel Lambert shading (reference `Light.Sample_Li`,
    `Core/Lights/Light.fs:104-117`)."""
    dev = base_color.device
    total = torch.zeros_like(base_color)
    for l in lights:
        c = _scalar(l.color, dev)
        if l.type == "ambient":
            total = total + c
        elif l.type == "directional":
            d = normalize(_scalar(l.direction, dev))
            lam = torch.clamp(-torch.sum(normals * d, dim=-1), min=0.0)
            total = total + lam[..., None] * c
        elif l.type == "point":
            to_l = _scalar(l.position, dev) - points
            d2 = torch.clamp(torch.sum(to_l * to_l, dim=-1), min=1e-6)
            wl = to_l / torch.sqrt(d2)[..., None]
            lam = torch.clamp(torch.sum(normals * wl, dim=-1), min=0.0)
            total = total + (lam / d2)[..., None] * c
        else:
            raise ValueError(l.type)
    return base_color * total


def _screen(vertices, model, view, proj, width: int, height: int):
    """Vertex stage: local -> world -> clip -> NDC -> screen.
    -> (sx, sy, sz, 1/w, world), screen y down (row 0 = top)."""
    vh = torch.cat([vertices, vertices.new_ones(vertices.shape[0], 1)], dim=1)
    world = vh @ model.T
    clip = world @ view.T @ proj.T
    w = torch.where(clip[:, 3:4].abs() > 1e-8, clip[:, 3:4], 1e-8)
    ndc = clip[:, :3] / w
    sx = (ndc[:, 0] * 0.5 + 0.5) * width
    sy = (0.5 - ndc[:, 1] * 0.5) * height
    return sx, sy, ndc[:, 2], 1.0 / w[:, 0], world[:, :3]


def _pixel_centres(width: int, height: int, device):
    """(P,) x and y of the pixel centres, row-major."""
    px = torch.arange(width, dtype=torch.float32, device=device) + 0.5
    py = torch.arange(height, dtype=torch.float32, device=device) + 0.5
    return px.repeat(height), py.repeat_interleave(width)


def _area(x0, x1, x2, y0, y1, y2):
    """Twice the signed screen area; negative for a front face."""
    return (x1 - x0) * (y2 - y0) - (x2 - x0) * (y1 - y0)


def _inv_area(area):
    """1 / area where |area| > MIN_AREA, else 0 (with a finite gradient)."""
    big = area.abs() > MIN_AREA
    return torch.where(big, 1.0 / torch.where(big, area, 1.0), 0.0)


def _barycentrics(x0, x1, x2, y0, y1, y2, inv_area, dx, dy):
    """The edge functions w0, w1 of pixels (dx, dy) (reference `DrawTrangle`
    barycentric fill, `Core/Pipeline.fs:40-65`)."""
    w0 = ((x1 - dx) * (y2 - dy) - (x2 - dx) * (y1 - dy)) * inv_area
    w1 = ((x2 - dx) * (y0 - dy) - (x0 - dx) * (y2 - dy)) * inv_area
    return w0, w1


@torch.no_grad()
def _search(sx, sy, sz, faces, width: int, height: int, chunk: int,
            cull_backfaces: bool):
    """The winner search: -> (zbuf, best), each pixel's depth (inf where
    none) and the index of the face it shows (-1 where none)."""
    dev = sx.device
    P = width * height
    dx, dy = (t[:, None] for t in _pixel_centres(width, height, dev))
    x0, x1, x2 = (sx[faces[:, k]] for k in range(3))
    y0, y1, y2 = (sy[faces[:, k]] for k in range(3))
    z0, z1, z2 = (sz[faces[:, k]] for k in range(3))
    area = _area(x0, x1, x2, y0, y1, y2)
    front = area.abs() > MIN_AREA
    if cull_backfaces:
        front &= area < 0.0
    inv_area = _inv_area(area)
    zbuf = torch.full((P,), torch.inf, dtype=torch.float32, device=dev)
    best = torch.full((P,), -1, dtype=torch.int64, device=dev)
    for base in range(0, faces.shape[0], chunk):
        s = slice(base, base + chunk)
        w0, w1 = _barycentrics(x0[s], x1[s], x2[s], y0[s], y1[s], y2[s],
                               inv_area[s], dx, dy)
        w2 = 1.0 - w0 - w1
        z = w0 * z0[s] + w1 * z1[s] + w2 * z2[s]
        ok = ((w0 >= 0) & (w1 >= 0) & (w2 >= 0) & front[s] & (z > -1) & (z < 1)
              & (z < zbuf[:, None]))
        z = torch.where(ok, z, torch.inf)
        arg = torch.argmin(z, dim=1)
        znew = torch.gather(z, 1, arg[:, None])[:, 0]
        better = torch.isfinite(znew) & (znew < zbuf)
        zbuf = torch.where(better, znew, zbuf)
        best = torch.where(better, arg + base, best)
    return zbuf, best


def _winners(sx, sy, inv_w, world, nrm_w, uvs, faces, best, width: int, height: int):
    """Attribute stage: each pixel's winning face's corners, gathered with
    grad, and its barycentrics w0, w1 computed again by `_search`'s formula
    (0 where no face is drawn). -> (hit, b0, b1, corner), corner (P, 3, K)
    of per-vertex columns: x, y, 1/w, world (3), normal (3), uv (2), zeros."""
    hit = best >= 0
    f = faces[best.clamp(min=0)]
    table = torch.cat([sx[:, None], sy[:, None], inv_w[:, None], world, nrm_w, uvs],
                      dim=1)
    K = 16                                   # a column count gather_rows takes
    table = torch.cat([table, table.new_zeros(table.shape[0], K - table.shape[1])],
                      dim=1)
    corner = gather_rows(table, f.reshape(-1)).reshape(-1, 3, K)
    x, y = corner[..., 0], corner[..., 1]
    xs = (x[:, 0], x[:, 1], x[:, 2], y[:, 0], y[:, 1], y[:, 2])
    dx, dy = _pixel_centres(width, height, sx.device)
    b0, b1 = _barycentrics(*xs, _inv_area(_area(*xs)), dx, dy)
    return hit, torch.where(hit, b0, 0.0), torch.where(hit, b1, 0.0), corner


def rasterize(
    vertices,        # (V, 3) object-space positions
    faces,           # (F, 3) integer
    normals,         # (V, 3) per-vertex normals (object space)
    uvs,             # (V, 2)
    model,           # (4, 4) local -> world
    view,            # (4, 4) world -> camera
    proj,            # (4, 4) camera -> clip
    texture,         # (TH, TW, 3)
    width: int,
    height: int,
    lights: tuple = (RasterLight("ambient", (0.15, 0.15, 0.15)),
                     RasterLight("directional", (0.9, 0.9, 0.9), (0, -1, -1))),
    chunk: int = 64,
    perspective_correct: bool = False,
    cull_backfaces: bool = True,
    background=(0.0, 0.0, 0.0),
) -> torch.Tensor:
    """Render one frame on the device of the operands (ValueError if they
    lie on several). Returns (height, width, 3) f32 colors in [0, ~]."""
    return _frame(vertices, faces, normals, uvs, model, view, proj, texture, width,
                  height, lights, chunk, perspective_correct, cull_backfaces,
                  background)[0]


def _frame(vertices, faces, normals, uvs, model, view, proj, texture, width: int,
           height: int, lights, chunk: int, perspective_correct: bool,
           cull_backfaces: bool, background):
    """`rasterize`, with the indices its two gathers read: -> (image, best,
    texel), best the (P,) face each pixel shows (-1 where none) and texel the
    (P,) row of the (TH * TW, 3) texture it samples."""
    same_device(vertices, faces, model, view, proj, normals, uvs, texture)
    faces = faces.to(torch.int64)
    sx, sy, sz, inv_w, world = _screen(vertices, model, view, proj, width, height)
    _, best = _search(sx, sy, sz, faces, width, height, chunk, cull_backfaces)

    nrm_w = normals @ torch.linalg.inv(model[:3, :3])   # the inverse-transpose
    hit, b0, b1, corner = _winners(sx, sy, inv_w, world, nrm_w, uvs, faces, best,
                                   width, height)
    b2 = 1.0 - b0 - b1

    if perspective_correct:
        iw0, iw1, iw2 = corner[:, 0, 2], corner[:, 1, 2], corner[:, 2, 2]
        denom = torch.clamp(b0 * iw0 + b1 * iw1 + b2 * iw2, min=1e-12)
        c0, c1, c2 = b0 * iw0 / denom, b1 * iw1 / denom, b2 * iw2 / denom
    else:
        c0, c1, c2 = b0, b1, b2  # affine, like the reference's DrawTrangle

    def interp(lo, hi):
        a = corner[..., lo:hi]
        return c0[:, None] * a[:, 0] + c1[:, None] * a[:, 1] + c2[:, None] * a[:, 2]

    pts = interp(3, 6)
    nrm = normalize(interp(6, 9))
    uv = interp(9, 11)

    # nearest texture sample (reference `Texture2D`, `Core/Texture.fs:11-28`)
    TH, TW = texture.shape[0], texture.shape[1]
    tx = torch.clamp(torch.remainder(uv[:, 0], 1.0) * (TW - 1), 0, TW - 1).to(torch.int64)
    ty = torch.clamp(torch.remainder(1.0 - uv[:, 1], 1.0) * (TH - 1), 0,
                     TH - 1).to(torch.int64)
    texel = ty * TW + tx
    base_color = gather_rows(texture.reshape(TH * TW, 3), texel)

    color = _shade(lights, pts, nrm, base_color)
    out = torch.where(hit[:, None], color, _scalar(background, vertices.device))
    return out.reshape(height, width, 3), best, texel
