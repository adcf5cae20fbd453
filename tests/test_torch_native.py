"""The native host runtime in the PyTorch port (``ray_rust_tpu_torch/utils/native.py``).

Twins of tests/test_native.py:28-82 over the port's build of
``native/png_io.cpp``, compiled in place into ``ray_rust_tpu_torch/_build/``
(not into ``native/``, the JAX package's): the encoder round trip through
an independent decoder (PIL) and the port's ``load_png``, the filters on a
smooth image, ``save_png`` keeping the stdlib encoder, the frame-writer pool
and its error count, also for the last frames of a camera path in the CLI; and the native encoder and ``utils/image.encode_png``
giving the same pixels. They skip only where the library cannot be built here (no
g++ or no ``zlib.h``), as the JAX file does.
"""

import io
import time

import numpy as np
import pytest

from ray_rust_tpu_torch.utils import native
from ray_rust_tpu_torch.utils.image import encode_png, load_png, save_png

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)


@pytest.fixture(scope="module", autouse=True)
def native_lib():
    if not native.native_available():
        pytest.skip(f"native toolchain unavailable: {native.build_error()}")
    return native.get_lib()


def _rand_img(rng, h, w):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _pil(data: bytes) -> np.ndarray:
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def test_built_in_place_into_the_port(native_lib):
    assert native.SOURCE.name == "png_io.cpp" and native.SOURCE.parent.name == "native"
    assert native_lib._name.startswith(str(native.BUILD_DIR))


def test_png_encode_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    for h, w in [(1, 1), (7, 13), (64, 128), (33, 257)]:
        img = _rand_img(rng, h, w)
        data = native.encode_png_native(img)
        assert data[:8] == b"\x89PNG\r\n\x1a\n"
        np.testing.assert_array_equal(_pil(data), img)
        path = tmp_path / f"{h}x{w}.png"
        path.write_bytes(data)
        np.testing.assert_array_equal(load_png(str(path)), img)


def test_png_encode_smooth_image_compresses():
    """The filter heuristic makes gradients tiny (Sub/Up filters win)."""
    y = np.arange(128, dtype=np.uint8)[:, None, None]
    img = np.broadcast_to(y, (128, 128, 3)).copy()
    assert len(native.encode_png_native(img)) < 128 * 128 * 3 // 10


def test_save_png_dispatches_native(tmp_path):
    """``write_png_native`` writes the native encoder's bytes; ``save_png``
    keeps the stdlib encoder (``encode_png``) even where the library builds,
    and both files decode to the image."""
    rng = np.random.default_rng(5)
    img = _rand_img(rng, 24, 32)
    p, q = tmp_path / "x.png", tmp_path / "y.png"
    save_png(str(p), img)
    native.write_png_native(str(q), img)
    assert q.read_bytes() == native.encode_png_native(img)
    assert p.read_bytes() == encode_png(img)
    for path in (p, q):
        np.testing.assert_array_equal(_pil(path.read_bytes()), img)


def test_both_encoders_give_the_same_pixels(tmp_path):
    """The native encoder filters its rows, the stdlib one does not: other
    bytes, the same pixels (a rendered frame, smooth and sharp)."""
    import ray_rust_tpu_torch as rtt

    img = rtt.render_u8(rtt.default_scene(device="cpu")[0],
                        rtt.RenderConfig(xres=64, yres=48, max_refractions=1))
    a, b = native.encode_png_native(img), encode_png(img)
    assert a != b
    for i, data in enumerate((a, b)):
        (tmp_path / f"{i}.png").write_bytes(data)
        np.testing.assert_array_equal(load_png(str(tmp_path / f"{i}.png")), img)
        np.testing.assert_array_equal(_pil(data), img)


def test_frame_writer_pool(tmp_path):
    rng = np.random.default_rng(9)
    frames = [_rand_img(rng, 16, 16) for _ in range(12)]
    with native.FrameWriter(n_threads=3) as w:
        for i, f in enumerate(frames):
            w.submit(str(tmp_path / f"f{i}.png"), f)
        assert w.drain() == 0
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(_pil((tmp_path / f"f{i}.png").read_bytes()), f)


def test_frame_writer_reports_errors(tmp_path):
    """A frame that cannot be written is counted. The native drain returns
    once the queue is empty, which can be before the thread that took the
    frame has failed it, so the count is read until it arrives (within 10 s)."""
    w = native.FrameWriter(n_threads=1)
    try:
        w.submit(str(tmp_path / "no_such_dir" / "f.png"), np.zeros((4, 4, 3), np.uint8))
        deadline = time.monotonic() + 10
        while w.drain() != 1 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert w.drain() == 1
    finally:
        assert w.close() == 1


def test_frame_writer_counts_the_last_frames_after_joining(tmp_path):
    """``close`` counts a frame that fails while a thread still writes it,
    after ``drain`` has returned: the last of several, into a directory."""
    rng = np.random.default_rng(11)
    w = native.FrameWriter(n_threads=2)
    paths = [tmp_path / f"f{i}.png" for i in range(6)]
    paths[-1].mkdir()  # fopen("wb") on a directory fails
    for p in paths:
        w.submit(str(p), _rand_img(rng, 64, 64))
    assert w.close() == 1 and w.close() == 1
    for p in paths[:-1]:
        assert _pil(p.read_bytes()).shape == (64, 64, 3)


_MOTION = """camera_motion:
- camera:
    position: {x: 50.0, y: -150.0, z: -300.0}
    pyr: {x: 0.2, y: -1.5707964, z: -1.5707964}
  velocity: {x: 10.0, y: 0.0, z: 0.0}
  duration: 1.0
- camera:
    position: {x: 100.0, y: -150.0, z: -300.0}
    pyr: {x: 0.0, y: -1.5707964, z: -1.5707964}
  velocity: {x: 0.0, y: 0.0, z: 0.0}
  duration: 1.5
"""


def test_cli_exits_1_when_a_last_frame_fails(tmp_path, monkeypatch, capsys):
    """A camera path of 5 frames whose last file cannot be written: the
    other four are written, the CLI names one failed write and exits 1; the
    same file with nothing in the way exits 0."""
    import ray_rust_tpu_torch as rtt
    from ray_rust_tpu_torch import cli
    from ray_rust_tpu_torch.models.serialize import serialize_scene

    scene, meta = rtt.default_scene(device="cpu")
    text = serialize_scene(scene, meta).replace("camera_motion: []\n", _MOTION)
    (tmp_path / "motion.yaml").write_text(text)
    monkeypatch.chdir(tmp_path)
    argv = ["16", "12", "-d", "motion.yaml", "-o", "frame", "-t", "4",
            "--max_refractions", "1", "--device", "cpu"]
    (tmp_path / "frame4.png").mkdir()
    assert cli.main(argv) == 1
    assert "frame writer: 1 failed writes" in capsys.readouterr().err
    for i in range(4):
        assert load_png(str(tmp_path / f"frame{i}.png")).shape == (12, 16, 3)
    (tmp_path / "frame4.png").rmdir()
    assert cli.main(argv) == 0
    assert load_png(str(tmp_path / "frame4.png")).shape == (12, 16, 3)
