"""Live web viewer — the dependency-free replacement for the reference's
Qt6 viewer main window (counterpart of modular_slam_tpu/viz/server.py).

Serves on localhost while SLAM runs in the main thread:
  /            single-page UI (polls the endpoints below)
  /frame.png   latest RGB frame with the observation overlay
  /depth.png   latest HOT-colormapped depth
  /scene.png   latest 3D map snapshot (if the app publishes one)
  /stats.json  live SlamStatistics (ms/frame, FPS, counts —
               slam_statistics_widget.cpp:28-34 parity)
  /params      GET: registered runtime parameters (parameters_viewer.cpp
               parity); POST {"name": ..., "value": ...}: write-back into
               the running system (the reference's setValue is a stub,
               parameters_viewer.cpp:53-62 — this one works)
  /control     POST {"action": "pause"|"resume"|"stop"} — SlamThread's
               pause/resume/interrupt atomics (slam_thread.hpp:43-45,63-64)

Thread model mirrors the reference inverted: there the GUI owns the main
thread and SLAM runs in a QThread; here SLAM owns the main thread and the
HTTP server runs daemonized (ThreadingHTTPServer).  Shared state is a
dict under one lock (the Qt queued-signal equivalent).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, Optional

import numpy as np

from modular_slam_tpu_torch.viz.png import encode_png

_PAGE = """<!doctype html>
<html><head><title>modular_slam_tpu_torch viewer</title><style>
body { font-family: system-ui, sans-serif; margin: 16px; background: #14171c;
       color: #e8eaed; }
h1 { font-size: 18px; } .row { display: flex; gap: 16px; flex-wrap: wrap; }
.card { background: #1d222b; border-radius: 8px; padding: 12px; }
img { max-width: 640px; border-radius: 4px; display: block; }
table { border-collapse: collapse; } td { padding: 2px 10px 2px 0; }
input[type=range] { width: 220px; vertical-align: middle; }
button { margin-right: 8px; padding: 4px 14px; border-radius: 4px;
         border: none; background: #2a6fdb; color: white; cursor: pointer; }
.val { color: #9aa4b2; font-variant-numeric: tabular-nums; }
</style></head><body>
<h1>modular_slam_tpu_torch — live viewer</h1>
<div class="card" style="margin-bottom:12px">
  <button onclick="ctl('pause')">Pause</button>
  <button onclick="ctl('resume')">Resume</button>
  <button onclick="ctl('stop')">Stop</button>
</div>
<div class="row">
  <div class="card"><h3>Observations</h3><img id="frame"></div>
  <div class="card"><h3>Depth</h3><img id="depth"></div>
  <div class="card"><h3>Map</h3><img id="scene"></div>
  <div class="card"><h3>Statistics</h3><table id="stats"></table>
    <h3>Parameters</h3><div id="params"></div></div>
</div>
<script>
function refreshImg(id, url) {
  const el = document.getElementById(id);
  el.src = url + '?t=' + Date.now();
}
async function tick() {
  refreshImg('frame', '/frame.png');
  refreshImg('depth', '/depth.png');
  refreshImg('scene', '/scene.png');
  const s = await (await fetch('/stats.json')).json();
  document.getElementById('stats').innerHTML = Object.entries(s)
    .map(([k, v]) => `<tr><td>${k}</td><td class="val">${
      typeof v === 'number' && !Number.isInteger(v) ? v.toFixed(2) : v
    }</td></tr>`).join('');
}
async function loadParams() {
  const ps = await (await fetch('/params')).json();
  document.getElementById('params').innerHTML = ps.map(p =>
    `<div>${p.name}: <input type="range" min="${p.min}" max="${p.max}"
      step="${p.step || 1}" value="${p.value}"
      onchange="setParam('${p.name}', this.value)">
      <span class="val" id="pv-${p.name}">${p.value}</span></div>`).join('');
}
async function setParam(name, value) {
  document.getElementById('pv-' + name).textContent = value;
  await fetch('/params', {method: 'POST',
    body: JSON.stringify({name, value: Number(value)})});
}
async function ctl(action) {
  await fetch('/control', {method: 'POST', body: JSON.stringify({action})});
}
loadParams(); tick(); setInterval(tick, 500);
</script></body></html>"""

_BLANK = np.zeros((48, 64, 3), np.uint8)


class ViewerState:
    """Shared state between the SLAM loop and the HTTP threads."""

    def __init__(self):
        self.lock = threading.Lock()
        self.frame_png: bytes = encode_png(_BLANK)
        self.depth_png: bytes = encode_png(_BLANK)
        self.scene_png: Optional[bytes] = None
        self.stats: Dict = {}
        self.params = None          # ParameterRegistry or None
        self.paused = threading.Event()
        self.stopped = threading.Event()

    # -- publishers (SLAM side) --------------------------------------------
    def publish_frame(self, overlay_rgb: np.ndarray) -> None:
        png = encode_png(overlay_rgb)
        with self.lock:
            self.frame_png = png

    def publish_depth(self, depth_rgb: np.ndarray) -> None:
        png = encode_png(depth_rgb)
        with self.lock:
            self.depth_png = png

    def publish_scene_png(self, png_bytes: bytes) -> None:
        with self.lock:
            self.scene_png = png_bytes

    def publish_stats(self, stats: Dict) -> None:
        with self.lock:
            self.stats = dict(stats)

    def wait_if_paused(self) -> bool:
        """Call per frame from the SLAM loop; returns False when stopped."""
        while self.paused.is_set() and not self.stopped.is_set():
            self.stopped.wait(0.05)
        return not self.stopped.is_set()


def _make_handler(state: ViewerState):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):  # quiet
            pass

        def _send(self, code: int, ctype: str, body: bytes) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Cache-Control", "no-store")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            path = self.path.split("?")[0]
            if path == "/":
                self._send(200, "text/html", _PAGE.encode())
            elif path == "/frame.png":
                with state.lock:
                    self._send(200, "image/png", state.frame_png)
            elif path == "/depth.png":
                with state.lock:
                    self._send(200, "image/png", state.depth_png)
            elif path == "/scene.png":
                with state.lock:
                    png = state.scene_png
                if png is None:
                    self._send(200, "image/png", encode_png(_BLANK))
                else:
                    self._send(200, "image/png", png)
            elif path == "/stats.json":
                with state.lock:
                    body = json.dumps(state.stats).encode()
                self._send(200, "application/json", body)
            elif path == "/params":
                ps = []
                if state.params is not None:
                    for p in state.params.definitions():
                        ps.append({
                            "name": p.key, "value": p.value,
                            "min": p.min, "max": p.max,
                            "step": p.step or 1,
                        })
                self._send(200, "application/json", json.dumps(ps).encode())
            else:
                self._send(404, "text/plain", b"not found")

        def do_POST(self):
            n = int(self.headers.get("Content-Length", 0))
            try:
                body = json.loads(self.rfile.read(n) or b"{}")
            except json.JSONDecodeError:
                self._send(400, "text/plain", b"bad json")
                return
            if self.path == "/params" and state.params is not None:
                ok = state.params.set(body["name"], body["value"])
                self._send(200 if ok else 422, "application/json",
                           json.dumps({"ok": bool(ok)}).encode())
            elif self.path == "/control":
                action = body.get("action")
                if action == "pause":
                    state.paused.set()
                elif action == "resume":
                    state.paused.clear()
                elif action == "stop":
                    state.stopped.set()
                    state.paused.clear()
                else:
                    self._send(400, "text/plain", b"unknown action")
                    return
                self._send(200, "application/json", b'{"ok": true}')
            else:
                self._send(404, "text/plain", b"not found")

    return Handler


class ViewerServer:
    """Daemonized HTTP server wrapping a ViewerState."""

    def __init__(self, port: int = 8080, host: str = "127.0.0.1"):
        self.state = ViewerState()
        self._httpd = ThreadingHTTPServer(
            (host, port), _make_handler(self.state))
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, daemon=True)

    def start(self) -> "ViewerServer":
        self._thread.start()
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()

    @property
    def url(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}/"
