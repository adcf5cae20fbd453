"""The web viewer of the PyTorch port (``ray_rust_tpu_torch/webserver.py``).

Twins on ``device="cpu"`` of tests/test_apps.py:48-105 (the routes and
their headers; ``/render`` equal to a direct ``render_u8`` of the pose
rebuilt from its degrees), the port's ``/render`` PNG against the JAX
package's server at the same pose within the golden budget, and the CLI's
``-w`` serving on port 0 until it is shut down.
"""

import io
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import cli, webserver
from ray_rust_tpu_torch.models.quat import Quat
from ray_rust_tpu_torch.models.vec import v3

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)

CFG = dict(xres=24, yres=16, max_refractions=1)  # tests/test_apps.py:53
POSE = "x=10&y=-100&z=-250&yaw=-90&pitch=5"


def _png(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


class _Serving:
    """A server on a thread for the block, shut down and closed after it."""

    def __init__(self, server):
        self.server = server
        self.url = f"http://127.0.0.1:{server.server_address[1]}"

    def __enter__(self):
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()


@pytest.fixture(scope="module")
def port_server():
    scene, meta = rtt.default_scene(device="cpu")
    with _Serving(webserver.make_server(scene, meta, rtt.RenderConfig(**CFG), 0)) as s:
        yield scene, s


def test_webserver_routes(port_server):
    _, s = port_server
    root = urllib.request.urlopen(f"{s.url}/").read()
    assert b"ray-rust-tpu web interface" in root
    assert b"buttonStates" in root  # the embedded JavaScript client
    png = urllib.request.urlopen(f"{s.url}/render?x=0&y=-150&z=-300&yaw=-90&pitch=0")
    assert png.headers["Content-Type"] == "image/png"
    assert png.headers["Cache-Control"] == "no-cache"
    assert _png(png.read()).shape == (16, 24, 3)
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{s.url}/nope")
    assert ei.value.code == 404
    assert ei.value.read() == b"empty"


def test_webserver_camera_matches_direct_render(port_server):
    """/render equals a direct render with the camera rebuilt from the
    yaw/pitch degrees (webserver.rs:268-274), bit for bit."""
    scene, s = port_server
    got = _png(urllib.request.urlopen(f"{s.url}/render?{POSE}").read())
    pyr = v3(5 * np.pi / 180, -90 * np.pi / 180, float(scene.camera.pyr.z))
    cam = scene.camera._replace(position=v3(10.0, -100.0, -250.0), pyr=pyr,
                                rotation=Quat.from_pyr(pyr))
    want = rtt.render_u8(scene._replace(camera=cam), rtt.RenderConfig(**CFG))
    np.testing.assert_array_equal(got, want)


def test_webserver_matches_the_jax_server(port_server):
    """The same request to the JAX package's server: within the golden
    budget (at most 2% of pixels off by more than 1e-3, mean at most 0.01;
    tests/test_parity.py:152-161). The JAX server renders a jitted frame,
    whose fused arithmetic flips knife-edge pixels."""
    import ray_rust_tpu as rt
    from ray_rust_tpu.webserver import make_server as jax_make_server

    _, s = port_server
    got = _png(urllib.request.urlopen(f"{s.url}/render?{POSE}").read()) / 255.0
    scene, meta = rt.default_scene()
    with _Serving(jax_make_server(scene, meta, rt.RenderConfig(**CFG), 0)) as js:
        want = _png(urllib.request.urlopen(f"{js.url}/render?{POSE}").read()) / 255.0
    diff = np.abs(got - want).max(-1)
    assert (diff > 1e-3).mean() <= 0.02 and np.abs(got - want).mean() <= 0.01


def test_cli_webserver_serves_until_shut_down(monkeypatch):
    """``-w -p 0``: the CLI builds the viewer of its scene and config on
    port 0 (a free one) and serves until the server is shut down, then
    returns 0."""
    made, real = [], webserver.make_server

    def capture(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(webserver, "make_server", capture)
    rc = []
    th = threading.Thread(target=lambda: rc.append(cli.main(
        ["24", "16", "-w", "-p", "0", "--max_refractions", "1", "--device", "cpu"])),
        daemon=True)
    th.start()
    for _ in range(500):
        if made:
            break
        th.join(timeout=0.02)
    assert made, "the CLI built no server"
    url = f"http://127.0.0.1:{made[0].server_address[1]}"
    assert b"buttonStates" in urllib.request.urlopen(f"{url}/").read()
    img = _png(urllib.request.urlopen(f"{url}/render?x=0&y=-150&z=-300&yaw=-90&pitch=0").read())
    assert img.shape == (16, 24, 3) and img.mean() > 1
    made[0].shutdown()
    th.join(timeout=10)
    assert not th.is_alive() and rc == [0]
