"""The port's example entry points (`mafrixraytracing_torch/examples/`) at
16x16 on the CPU: the rasterizer demo on a seeded OBJ, the progressive
Cornell render with its live preview, and the usage error for a malformed
`--size`."""
import re
import urllib.request

import numpy as np
import pytest

from mafrixraytracing_torch.examples import rasterize, render_cornell
from mafrixraytracing_torch.film.image import read_image
from mafrixraytracing_torch.profile_walk import write_sphere_obj

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def write_uv_sphere_obj(path, n=8, radius=0.5, seed=0):
    """A seeded displaced UV sphere of 2 n^2 faces with a uv per vertex."""
    rs = np.random.default_rng(seed)
    th = np.linspace(0.05, np.pi - 0.05, n + 1)[:, None]
    ph = np.linspace(0.0, 2.0 * np.pi, n + 1)[None, :]
    r = radius * (1.0 + 0.05 * rs.normal(size=(n + 1, n + 1)))
    v = np.stack([r * np.sin(th) * np.cos(ph), r * np.cos(th),
                  r * np.sin(th) * np.sin(ph)], -1).reshape(-1, 3)
    uv = np.stack(np.broadcast_arrays(ph / (2 * np.pi), 1 - th / np.pi), -1).reshape(-1, 2)
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    a = (i * (n + 1) + j).ravel()
    b, c, d = a + 1, a + n + 1, a + n + 2
    faces = np.concatenate([np.stack([a, c, b], 1), np.stack([b, c, d], 1)]) + 1
    with open(path, "w") as f:
        f.writelines("v %.7f %.7f %.7f\n" % tuple(p) for p in v)
        f.writelines("vt %.7f %.7f\n" % tuple(t) for t in uv)
        f.writelines("f %d/%d %d/%d %d/%d\n" % (x, x, y, y, z, z) for x, y, z in faces)


def test_rasterize_main_writes_its_png(tmp_path, capsys):
    obj, out = tmp_path / "sphere.obj", tmp_path / "raster.png"
    write_uv_sphere_obj(str(obj))
    assert rasterize.main([str(out), "--size", "16x16", "--cpu", "--obj", str(obj),
                           "--angle", "30"]) == 0
    assert "wrote" in capsys.readouterr().out
    img = read_image(str(out))
    assert img.shape == (16, 16, 3)
    background = np.floor(np.array(rasterize.BACKGROUND) * 255.99) / 255.0
    drawn = np.abs(img - background.astype(np.float32)).max(-1) > 1.5 / 255
    assert 0.2 < drawn.mean() < 0.9


def test_rasterize_main_refuses_an_unreadable_texture(tmp_path):
    obj = tmp_path / "sphere.obj"
    write_sphere_obj(str(obj), quads=4)
    with pytest.raises(SystemExit) as e:
        rasterize.main([str(tmp_path / "r.png"), "--size", "8x8", "--cpu", "--obj",
                        str(obj), "--texture", str(tmp_path / "absent.png")])
    assert e.value.code == 2


def test_render_cornell_main_with_preview(tmp_path, capsys):
    out = tmp_path / "cornell.png"
    assert render_cornell.main([str(out), "--size", "16x16", "--spp", "2", "--cpu",
                                "--preview-port", "0"]) == 0
    text = capsys.readouterr().out
    assert "spp 2/2" in text
    port = int(re.search(r"http://127\.0\.0\.1:(\d+)/", text).group(1))
    assert out.read_bytes()[:8] == SIGNATURE
    assert read_image(str(out)).shape == (16, 16, 3)
    with pytest.raises(OSError):            # main closed the preview's server
        urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5)


@pytest.mark.parametrize("module", [rasterize, render_cornell])
@pytest.mark.parametrize("size", ["16by16", "16x", "0x16"])
def test_malformed_size_is_a_usage_error(module, size, capsys):
    with pytest.raises(SystemExit) as e:
        module.main(["--size", size, "--cpu"])
    assert e.value.code == 2
    assert "--size" in capsys.readouterr().err


@pytest.mark.parametrize("flag,value", [("--spp", "0"), ("--spp", "two"),
                                        ("--dump-every", "0"), ("--dump-every", "-4")])
def test_non_positive_count_is_a_usage_error(flag, value, capsys):
    with pytest.raises(SystemExit) as e:
        render_cornell.main([flag, value, "--size", "16x16", "--cpu"])
    assert e.value.code == 2
    assert flag in capsys.readouterr().err
