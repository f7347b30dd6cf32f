"""Live progressive preview: the array-output replacement for the reference's
only interactive surface, a GLFW/OpenGL window with an ImGui image refreshed
with the accumulating film every frame (`EngineCore/Core/Film.fs:38-92`,
render-loop callback `Scene/Scene.fs:331-333`).

Port of `mafrixraytracing_tpu/film/preview.py`:

- atomic PNG refresh: `LivePreview.update(frame)` rewrites one PNG through a
  rename, so an image viewer or file watcher polling it always sees a
  complete frame;
- optional localhost HTTP viewer: `LivePreview(..., http_port=N)` serves an
  auto-refreshing page at http://127.0.0.1:N/ with the latest frame from
  memory (port 0: one the OS picks, read back from `port`).

Stdlib only (threading + http.server). A viewer that drops its connection
mid-response is ignored; `close` stops the server and releases its socket.
"""
from __future__ import annotations

import http.server
import os
import threading
from pathlib import Path

from mafrixraytracing_torch.film.image import encode_png

_PAGE = b"""<!doctype html><html><head><title>mafrixraytracing preview</title>
<style>body{background:#111;margin:0;display:grid;place-items:center;
height:100vh}img{image-rendering:pixelated;max-width:96vw;max-height:96vh}
</style></head><body><img id=f src=/frame.png>
<script>setInterval(()=>{f.src='/frame.png?'+Date.now()},500)</script>
</body></html>"""


class _Handler(http.server.BaseHTTPRequestHandler):
    """Serves the page and the latest frame of `self.server.preview`."""

    def do_GET(self):  # noqa: N802 (stdlib API)
        try:
            if self.path.startswith("/frame.png"):
                body = self.server.preview.png()
                if not body:
                    self.send_response(404)
                    self.end_headers()
                    return
                self.send_response(200)
                self.send_header("Content-Type", "image/png")
                self.send_header("Cache-Control", "no-store")
                self.end_headers()
                self.wfile.write(body)
            else:
                self.send_response(200)
                self.send_header("Content-Type", "text/html")
                self.end_headers()
                self.wfile.write(_PAGE)
        except (BrokenPipeError, ConnectionResetError):
            pass   # the viewer went away mid-response

    def log_message(self, *a):  # quiet
        pass


class LivePreview:
    """Progressive-film sink. `update(frame)` refreshes the on-disk PNG
    atomically and the in-memory frame the HTTP viewer serves. A frame is
    encoded PNG bytes, or an (H, W, 3) uint8 array or tensor on any device
    (encoded here with `film.image.encode_png`), such as
    `FilmState.to_bytes()`."""

    def __init__(self, path: str | os.PathLike | None = None,
                 http_port: int | None = None):
        self.path = Path(path) if path is not None else None
        self._png: bytes = b""
        self._lock = threading.Lock()
        self._server = None
        if http_port is not None:
            self._server = http.server.ThreadingHTTPServer(
                ("127.0.0.1", int(http_port)), _Handler)
            self._server.preview = self
            threading.Thread(target=self._server.serve_forever, daemon=True).start()

    def update(self, frame) -> None:
        png = bytes(frame) if isinstance(frame, (bytes, bytearray)) else encode_png(frame)
        with self._lock:
            self._png = png
        if self.path is not None:
            tmp = self.path.with_suffix(".tmp.png")
            tmp.write_bytes(png)
            os.replace(tmp, self.path)  # atomic: viewers never see a torn file

    def png(self) -> bytes:
        """The latest frame's PNG bytes (empty before the first update)."""
        with self._lock:
            return self._png

    @property
    def port(self) -> int | None:
        return self._server.server_address[1] if self._server else None

    def close(self) -> None:
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
