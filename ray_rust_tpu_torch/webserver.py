"""Interactive web viewer: a thin host client of the renderer on the card.

PyTorch counterpart of ``ray_rust_tpu/webserver.py``, itself the
replacement of the reference's hyper server (src/webserver.rs): the same
routes (``/``, the page with its JavaScript client; ``/image``, the static
``barb.png``; ``/render?x=&y=&z=&yaw=&pitch=``, a PNG of that pose, the
angles in degrees; anything else 404 with the body ``empty``;
webserver.rs:64-299), the same controls (WASD/QZ move, arrows turn). Each
``/render`` rebuilds the camera on the scene's device (``Quat.from_pyr`` of
the pitch, yaw and the scene's roll) and renders through
``renderer.render_u8``, one render at a time: on a CUDA scene the pack
kernel and K1 (trace mode), or K3 (march mode); then ``utils/image.
encode_png``. The first request in a fresh process builds the kernels with
nvcc (minutes; ``ops/_build.py`` caches them in ``ray_rust_tpu_torch/_build/``).
"""

from __future__ import annotations

import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .config import RenderConfig
from .models.quat import Quat
from .models.scene import Scene, SceneMeta
from .models.vec import v3
from .renderer import render_u8
from .utils.image import encode_png

__all__ = ["run_webserver", "make_server"]

_PAGE = """<html>
<head>
    <title>ray-rust-tpu</title>
    <script>
    window.onload = function(){
        var im = document.getElementById('render');
        var label = document.getElementById('label');
        var x = %(x)f, y = %(y)f, z = %(z)f, yaw = %(yaw)f, pitch = %(pitch)f;
        var buttonStates = {w:false,s:false,a:false,d:false,q:false,z:false,
            ArrowRight:false,ArrowLeft:false,ArrowUp:false,ArrowDown:false};
        function updatePos(){
            fetch(`/render?x=${x}&y=${y}&z=${z}&yaw=${yaw}&pitch=${pitch}`)
                .then(r => { if(r.ok) return r.blob(); })
                .then(b => { im.src = URL.createObjectURL(b); tryUpdate(); })
                .catch(e => console.log('fetch problem: ', e.message));
            label.innerHTML = `x=${x}<br>y=${y}<br>z=${z}<br>yaw=${yaw}<br>pitch=${pitch}`;
        }
        function tryUpdate(){
            var ok = false;
            var s = Math.sin(yaw * Math.PI / 180), c = Math.cos(yaw * Math.PI / 180);
            if(buttonStates.a){ x += 10*s; z += 10*c; ok = true; }
            if(buttonStates.d){ x -= 10*s; z -= 10*c; ok = true; }
            if(buttonStates.w){ x += 10*c; z -= 10*s; ok = true; }
            if(buttonStates.s){ x -= 10*c; z += 10*s; ok = true; }
            if(buttonStates.q){ y += 10; ok = true; }
            if(buttonStates.z){ y -= 10; ok = true; }
            if(buttonStates.ArrowRight){ yaw += 5; ok = true; }
            if(buttonStates.ArrowLeft){ yaw -= 5; ok = true; }
            if(buttonStates.ArrowUp){ pitch -= 5; ok = true; }
            if(buttonStates.ArrowDown){ pitch += 5; ok = true; }
            if(ok){ updatePos(); return true; }
            return false;
        }
        updatePos();
        window.onkeydown = function(e){
            if(e.key in buttonStates){
                if(!buttonStates[e.key]){ buttonStates[e.key] = true; tryUpdate(); }
                e.preventDefault();
            }
        }
        window.onkeyup = function(e){
            if(e.key in buttonStates){ buttonStates[e.key] = false; e.preventDefault(); }
        }
    }
    </script>
    <style> table { border-collapse: collapse; border: solid; } </style>
</head>
<body>
    <h1>ray-rust-tpu web interface</h1>
    <img id='render'>
    <hr>
    <h2>Controls</h2>
    <table border='1'>
    <tr><td>W</td><td>forward</td></tr>
    <tr><td>S</td><td>backward</td></tr>
    <tr><td>A</td><td>left</td></tr>
    <tr><td>D</td><td>right</td></tr>
    <tr><td>Q</td><td>up</td></tr>
    <tr><td>Z</td><td>down</td></tr>
    <tr><td>Left arrow</td><td>Turn left</td></tr>
    <tr><td>Right arrow</td><td>Turn right</td></tr>
    <tr><td>Up arrow</td><td>Turn up</td></tr>
    <tr><td>Down arrow</td><td>Turn down</td></tr>
    </table>
    <hr>
    <h2>Debug</h2>
    <div id='label'></div>
</body></html>"""


def make_server(scene: Scene, meta: SceneMeta, cfg: RenderConfig, port: int):
    """Build (but do not start) the HTTP server on ``port`` of every
    interface; port 0 takes a free one (``server.server_address``)."""
    render_lock = threading.Lock()
    dev = scene.device
    pos0 = [float(c) for c in scene.camera.position]
    pyr0 = [float(c) for c in scene.camera.pyr]

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):  # route prints like the reference
            print("Got request:", fmt % args)

        def _send(self, code: int, body: bytes, headers=()):
            self.send_response(code)
            for name, value in headers:
                self.send_header(name, value)
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            url = urlparse(self.path)
            if url.path == "/":
                body = (_PAGE % {"x": pos0[0], "y": pos0[1], "z": pos0[2],
                                 "yaw": pyr0[1] * 180.0 / math.pi,
                                 "pitch": pyr0[0] * 180.0 / math.pi}).encode()
                self._send(200, body, [("Content-Type", "text/html")])
            elif url.path == "/image":  # static file passthrough (webserver.rs:209-221)
                try:
                    with open("barb.png", "rb") as f:
                        self._send(200, f.read())
                except OSError:
                    self._send(200, b"image")
            elif url.path == "/render":
                q = parse_qs(url.query)

                def fget(name):
                    try:
                        return float(q.get(name, ["0"])[0])
                    except ValueError:
                        return 0.0

                pyr = v3(fget("pitch") * math.pi / 180.0, fget("yaw") * math.pi / 180.0,
                         pyr0[2], device=dev)
                cam = scene.camera._replace(position=v3(fget("x"), fget("y"), fget("z"),
                                                        device=dev),
                                            pyr=pyr, rotation=Quat.from_pyr(pyr))
                with render_lock:
                    img = render_u8(scene._replace(camera=cam), cfg)
                self._send(200, encode_png(img), [("Cache-Control", "no-cache"),
                                                  ("Content-Type", "image/png")])
            else:
                self._send(404, b"empty")

    return ThreadingHTTPServer(("0.0.0.0", port), Handler)


def run_webserver(scene: Scene, meta: SceneMeta, cfg: RenderConfig, port: int = 3000):
    """Serve until interrupted."""
    server = make_server(scene, meta, cfg, port)
    print(f"Listening on http://0.0.0.0:{server.server_address[1]}")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        server.shutdown()
    finally:
        server.server_close()
