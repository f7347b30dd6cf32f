"""The port's PNG codec (`film/image.py`) and live preview (`film/preview.py`):
the counterparts of `tests/test_film.py`'s PNG and preview tests, the
decoder against the JAX package's, the encoder's input checks, and the two
changes to the preview (a viewer that goes away mid-response is ignored;
`close` releases the socket)."""
import gc
import io
import os
import socket
import sys
import urllib.error
import urllib.request
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from mafrixraytracing_torch.film import image as img_io
from mafrixraytracing_torch.film.preview import LivePreview, _Handler
from mafrixraytracing_tpu.film import image as jimg_io
import torch_port_helpers  # noqa: F401  (sizes torch's threads to the run)

SIGNATURE = b"\x89PNG\r\n\x1a\n"


def test_png_roundtrip(tmp_path):
    arr = (np.random.default_rng(0).random((8, 6, 3)) * 255).astype(np.uint8)
    p = os.path.join(tmp_path, "t.png")
    img_io.write_png(p, arr)
    back = (img_io.read_image(p) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(back, arr)


def test_png_zlib_fallback(tmp_path):
    arr = (np.random.default_rng(1).random((5, 7, 3)) * 255).astype(np.uint8)
    p = os.path.join(tmp_path, "t2.png")
    with open(p, "wb") as f:
        f.write(img_io._encode_png_zlib(arr))
    back = (img_io.read_image(p) * 255.0 + 0.5).astype(np.uint8)
    np.testing.assert_array_equal(back, arr)


def test_read_image_equals_jax(tmp_path):
    arr = (np.random.default_rng(2).random((9, 4, 3)) * 255).astype(np.uint8)
    p = os.path.join(tmp_path, "t3.png")
    img_io.write_png(p, arr)
    got = img_io.read_image(p)
    assert got.dtype == np.float32 and got.shape == (9, 4, 3)
    np.testing.assert_array_equal(got, jimg_io.read_image(p))


def test_encode_png_of_a_tensor_equals_its_array():
    arr = (np.random.default_rng(3).random((6, 5, 3)) * 255).astype(np.uint8)
    png = img_io.encode_png(torch.from_numpy(arr))
    assert png == img_io.encode_png(arr) == jimg_io.encode_png(arr)
    assert png[:8] == SIGNATURE


@pytest.mark.parametrize("shape", [(4, 4), (4, 4, 4), (2, 3, 4, 3)])
def test_malformed_arrays_are_refused(tmp_path, shape):
    bad = np.zeros(shape, np.uint8)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        img_io.encode_png(bad)
    with pytest.raises(ValueError, match=r"\(H, W, 3\)"):
        img_io.write_png(os.path.join(tmp_path, "bad.png"), bad)


def test_without_pil(tmp_path, monkeypatch):
    """Where PIL is absent (it may be on the card's machine) the encoders
    take the zlib path, and `read_image` raises an ImportError naming PIL."""
    arr = (np.random.default_rng(5).random((4, 3, 3)) * 255).astype(np.uint8)
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert img_io.encode_png(arr) == img_io._encode_png_zlib(arr)
    p = os.path.join(tmp_path, "z.png")
    img_io.write_png(p, torch.from_numpy(arr))
    with open(p, "rb") as f:
        assert f.read() == img_io._encode_png_zlib(arr)
    with pytest.raises(ImportError, match="PIL"):
        img_io.read_image(p)
    from mafrixraytracing_torch.scene.assets import load_texture

    assert load_texture(p) is None


def test_load_texture_reads_through_read_image(tmp_path):
    from mafrixraytracing_torch.scene.assets import load_texture

    arr = (np.random.default_rng(4).random((3, 5, 3)) * 255).astype(np.uint8)
    p = os.path.join(tmp_path, "tex.png")
    img_io.write_png(p, arr)
    np.testing.assert_array_equal(load_texture(p), img_io.read_image(p))
    assert load_texture(os.path.join(tmp_path, "absent.png")) is None
    junk = os.path.join(tmp_path, "junk.png")
    with open(junk, "wb") as f:
        f.write(b"not an image")
    assert load_texture(junk) is None


def test_live_preview_sink(tmp_path):
    """Atomic PNG refresh + in-memory HTTP frame (the replacement for the
    reference's ImGui live window, Core/Film.fs:38-92), on an OS-chosen port."""
    out = tmp_path / "live.png"
    p = LivePreview(out, http_port=0)
    try:
        frame = (np.random.default_rng(0).random((8, 8, 3)) * 255).astype(np.uint8)
        url = f"http://127.0.0.1:{p.port}"
        with pytest.raises(urllib.error.HTTPError):      # no frame yet: 404
            urllib.request.urlopen(url + "/frame.png", timeout=5)
        p.update(frame)
        assert out.exists() and out.read_bytes()[:8] == SIGNATURE
        page = urllib.request.urlopen(url + "/", timeout=5).read()
        assert b"frame.png" in page
        png = urllib.request.urlopen(url + "/frame.png", timeout=5).read()
        assert png == out.read_bytes() == img_io.encode_png(frame)
        # second update replaces the frame atomically; a uint8 tensor is taken
        p.update(torch.zeros((8, 8, 3), dtype=torch.uint8))
        png2 = urllib.request.urlopen(url + "/frame.png", timeout=5).read()
        assert png2 != png and png2 == out.read_bytes()
        assert not (tmp_path / "live.tmp.png").exists()
    finally:
        p.close()


class _GoneViewer:
    """A response stream whose reader has gone away."""

    def __init__(self, error):
        self.error = error

    def write(self, data):
        raise self.error

    def flush(self):
        pass


@pytest.mark.parametrize("error", [BrokenPipeError, ConnectionResetError])
@pytest.mark.parametrize("path", ["/frame.png", "/"])
def test_handler_ignores_a_viewer_that_went_away(capsys, error, path):
    preview = LivePreview()
    preview.update(np.zeros((2, 2, 3), np.uint8))
    h = _Handler.__new__(_Handler)
    h.server = SimpleNamespace(preview=preview)
    h.path, h.command, h.request_version = path, "GET", "HTTP/1.1"
    h.requestline, h.client_address = f"GET {path} HTTP/1.1", ("127.0.0.1", 0)
    h.wfile = _GoneViewer(error())
    h.do_GET()
    captured = capsys.readouterr()
    assert captured.err == "" and captured.out == ""


def test_close_releases_the_port():
    p = LivePreview(http_port=0)
    port = p.port
    urllib.request.urlopen(f"http://127.0.0.1:{port}/", timeout=5).read()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always", ResourceWarning)
        p.close()
        gc.collect()        # a socket left open warns when it is collected
    assert not [w for w in caught if issubclass(w.category, ResourceWarning)]
    assert p.port is None
    # the listening socket is closed, not only no longer served: a
    # connection is refused instead of waiting in its backlog
    with pytest.raises(ConnectionRefusedError):
        socket.create_connection(("127.0.0.1", port), timeout=5).close()
    p.close()                            # a second close is harmless


def test_preview_without_a_server_keeps_the_frame(tmp_path):
    p = LivePreview(tmp_path / "f.png")
    assert p.port is None and p.png() == b""
    png = img_io.encode_png(np.full((3, 3, 3), 7, np.uint8))
    p.update(png)
    assert p.png() == png == (tmp_path / "f.png").read_bytes()
    assert io.BytesIO(p.png()).read(8) == SIGNATURE
    p.close()
