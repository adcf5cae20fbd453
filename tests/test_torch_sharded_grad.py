"""The multi-device layer's gradient half on CPU meshes, against the JAX
package: K2's and K4's windows, the sharded training steps, the gradient's
all-reduce across processes, weak scaling, the dry run and the entry points.

- K2's and K4's bodies built with g++ on a ragged window of a 48x32 frame
  give the whole frame's cotangent block with the image cotangent zero
  outside the window (relative L2 1e-6: the adds run in another order), and
  its primal bit for bit; the four cells of a 2x2 mesh sum to the whole
  frame's block; a window with no pixel returns an error code.
- ``sgd_train_step(mesh=)`` on a 4x2 mesh of cpu cells against the JAX
  ``sgd_train_step`` (tests/test_torch_grad.py's config and budget), and
  ``make_train_step(cfg, SceneAdam, mesh=)`` for 3 steps against the JAX
  ``make_train_step(..., mesh=make_mesh(jax.devices(), 4, 2))``, eager
  (tests/test_torch_inverse.py's rule).
- Two processes over gloo on localhost: the sharded step equals the
  single-process one; a NaN on one rank reduces to 0 on both, after the
  sum.
- ``format_report`` and ``measure_scaling`` (tests/test_sharding.py:114-131),
  ``dryrun.run`` and ``entry`` (tests/test_sharding.py:99-111), and the
  CLI's ``--no-pallas``.

The card-only test runs there:
``python -m pytest --noconftest -m cuda tests/test_torch_sharded_grad.py``.
JAX is imported inside the tests that compare with it.
"""

import math
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import cli
from ray_rust_tpu_torch.entry import dryrun_multichip, entry
from ray_rust_tpu_torch.models.scene import Scene
from ray_rust_tpu_torch.ops import _build
from ray_rust_tpu_torch.ops import kernel_march_bwd as kmb
from ray_rust_tpu_torch.ops import kernel_trace as kt
from ray_rust_tpu_torch.ops import kernel_trace_bwd as kb
from ray_rust_tpu_torch.ops.rays import fov_scales
from ray_rust_tpu_torch.parallel import (
    SceneAdam,
    TrainState,
    format_report,
    make_mesh,
    make_train_step,
    measure_scaling,
    render_loss,
    render_sharded,
    sgd_train_step,
    train_state_from_numpy,
)
from ray_rust_tpu_torch.parallel.dryrun import run as dryrun

from .test_torch_kernel_trace import (  # noqa: F401 (one_torch_thread: module fixture)
    _jax_cfg,
    _port,
    one_torch_thread,
)

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
_GLOW = dict(use_raymarching=True, glow_effect=1.0)

# K2's and K4's host builds: the trace and the march with glow at 48x32,
# shallow depths (the window changes no pixel's program)
_CASES = {
    "trace": rtt.RenderConfig(xres=48, yres=32, max_reflections=2, refraction_unroll=1),
    "march_glow": rtt.RenderConfig(xres=48, yres=32, max_refractions=1, march_max_iter=400,
                                   **_GLOW),
}
RAGGED = (7, 5, 13, 20)  # (row0, col0, h, w): 20x13 at (7, 5)
# The windows' blocks against the whole frame's: the same adds in another
# order (f32), relative L2
BLOCK_REL_L2 = 1e-6


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def default_scene():
    return rtt.default_scene(device="cpu")[0]


@pytest.fixture(scope="module")
def bwd_libs(tmp_path_factory):
    """K2's and K4's bodies built with g++, the two builds at once."""
    out = tmp_path_factory.mktemp("bwd_window_host")
    with ThreadPoolExecutor(2) as pool:
        libs = {n: pool.submit(_build.build_host_library, out, n)
                for n in ("trace_bwd", "march_bwd")}
        return {n: f.result() for n, f in libs.items()}


def _host_bwd(libs, scene, cfg, win, g):
    """The host build's ``(rc, block, primal)`` for the window ``win`` =
    (row0, col0, h, w) and its cotangent planes ``g`` (3, h, w)."""
    tables, tex = kt.pack_scene(scene), kt.pack_textures(scene)  # held until the call returns
    n = scene.objects.count
    block = torch.zeros((n + 1, kb.GRAD_COLS))
    prim = torch.zeros((3, max(win[2], 1), max(win[3], 1)))
    sx, sy = fov_scales(cfg)
    if cfg.use_raymarching:
        fn, args = libs["march_bwd"].rt_march_bwd_host, kmb.launch_args(cfg, tex, CPU)
    else:
        fn, args = libs["trace_bwd"].rt_trace_bwd_host, kb.launch_args(cfg, tex, CPU)
    g = torch.as_tensor(np.ascontiguousarray(g))
    rc = fn(*(t.data_ptr() for t in tables), n, cfg.xres, cfg.yres, *win, sx, sy, *args,
            *(g[k].data_ptr() for k in range(3)), block.data_ptr(),
            *(p.data_ptr() for p in prim), None)
    return rc, block.numpy(), prim.numpy()


def _planes(shape, seed=0):
    return np.random.default_rng(seed).standard_normal((3, *shape)).astype(np.float32)


@pytest.mark.parametrize("case", sorted(_CASES))
def test_host_window_gradient_is_the_frame_s(bwd_libs, default_scene, case):
    """K2's (K4's) body on the ragged window: its block within relative L2
    1e-6 of the whole frame's with the cotangent zero outside the window, its
    primal the whole frame's crop bit for bit; a window with no pixel, or
    past the frame, returns 1 (cudaErrorInvalidValue) and adds nothing."""
    cfg = _CASES[case]
    r0, c0, h, w = RAGGED
    g_win = _planes((h, w))
    g_full = np.zeros((3, cfg.yres, cfg.xres), np.float32)
    g_full[:, r0:r0 + h, c0:c0 + w] = g_win
    rc, full, prim_full = _host_bwd(bwd_libs, default_scene, cfg, kt.window(cfg), g_full)
    assert rc == 0
    rc, got, prim = _host_bwd(bwd_libs, default_scene, cfg, RAGGED, g_win)
    assert rc == 0
    np.testing.assert_array_equal(prim, prim_full[:, r0:r0 + h, c0:c0 + w])
    assert np.abs(full).max() > 0
    assert _rel(got, full) <= BLOCK_REL_L2
    for bad in ((r0, c0, 0, w), (r0, c0, h, 0), (cfg.yres - 2, c0, 3, w)):
        rc, block, _ = _host_bwd(bwd_libs, default_scene, cfg, bad, np.zeros((3, 1, 1)))
        assert rc == 1 and not block.any(), bad


@pytest.mark.parametrize("case", sorted(_CASES))
def test_host_cells_sum_to_the_frame(bwd_libs, default_scene, case):
    """The blocks of a 2x2 mesh's four 24x16 cells, each on its window of
    one seeded cotangent, sum to the whole frame's block (relative L2
    1e-6)."""
    cfg = _CASES[case]
    g = _planes((cfg.yres, cfg.xres), seed=1)
    _, full, _ = _host_bwd(bwd_libs, default_scene, cfg, kt.window(cfg), g)
    h, w = cfg.yres // 2, cfg.xres // 2
    total = np.zeros_like(full)
    for r0 in (0, h):
        for c0 in (0, w):
            rc, block, _ = _host_bwd(bwd_libs, default_scene, cfg, (r0, c0, h, w),
                                     g[:, r0:r0 + h, c0:c0 + w])
            assert rc == 0
            total += block
    assert _rel(total, full) <= BLOCK_REL_L2


def _cpu_mesh(dp, sp):
    return make_mesh([CPU] * (dp * sp), dp=dp, sp=sp)


def _all_float_leaves(scene: Scene) -> Scene:
    """``scene`` with fresh float leaves that require grad (the JAX steps
    train every float leaf)."""
    return scene.with_tensors([t.detach().clone().requires_grad_() if t.is_floating_point()
                               else t for t in scene.tensors()])


def test_sharded_sgd_step_matches_jax():
    """``sgd_train_step`` on a 4x2 mesh of cpu cells against the JAX
    ``sgd_train_step`` (eager, tests/test_torch_grad.py's config and budget:
    the loss within 1e-5 relative, every leaf within 1e-4), and against the
    port's whole-frame step: the loss within 1e-6 relative, the steps within
    1e-5 of each other (the cells' gradients sum in another order)."""
    import jax
    import jax.numpy as jnp

    import ray_rust_tpu as rt
    from ray_rust_tpu.ops.rays import camera_rays as jax_camera_rays
    from ray_rust_tpu.ops.trace import trace_image as jax_trace_image
    from ray_rust_tpu.parallel.train import sgd_train_step as jax_sgd_train_step

    cfg = rtt.RenderConfig(xres=32, yres=24, max_refractions=1)  # tests/test_torch_grad.py:42
    jax_scene, _ = rt.default_scene()
    jax_cfg = _jax_cfg(cfg)
    vi, eye = jax_camera_rays(jax_scene.camera.position, jax_scene.camera.rotation, jax_cfg)
    target = np.stack([np.asarray(c) for c in jax_trace_image(jax_scene, jax_cfg, vi, eye)], -1)
    target = target + np.float32(0.05)
    target[:, :, 0] += np.float32(0.05)  # a little more red: not an optimum
    with jax.disable_jit():
        jax_new, jax_loss = jax_sgd_train_step(jax_scene, jax_cfg, jnp.asarray(target), lr=1e-3)

    scene = _all_float_leaves(_port(jax_scene))
    tgt = torch.from_numpy(target)
    new, loss = sgd_train_step(scene, cfg, tgt, lr=1e-3, mesh=_cpu_mesh(4, 2))
    np.testing.assert_allclose(float(loss), float(jax_loss), rtol=1e-5)
    want, before = rtt.scene_to_numpy(jax_new), rtt.scene_to_numpy(scene)
    got = rtt.scene_to_numpy(new)
    moved = 0
    for path, a in got.items():
        np.testing.assert_allclose(a, np.asarray(want[path]), rtol=0, atol=1e-4, err_msg=path)
        moved += int(not np.array_equal(a, before[path]))
    assert moved > 10

    whole, whole_loss = sgd_train_step(scene, cfg, tgt, lr=1e-3)
    np.testing.assert_allclose(float(loss), float(whole_loss), rtol=1e-6)
    sharded_loss = render_loss(scene, cfg, tgt, _cpu_mesh(4, 2)).detach()
    np.testing.assert_allclose(float(sharded_loss), float(whole_loss), rtol=1e-6)
    for path, a in rtt.scene_to_numpy(whole).items():
        np.testing.assert_allclose(got[path] - before[path], a - before[path], rtol=1e-5,
                                   atol=1e-9, err_msg=path)


@pytest.fixture(scope="module")
def jax_mesh_run():
    """The JAX ``make_train_step`` with the example's optimizer and a 4x2
    mesh of the virtual CPU devices, three steps from the perturbed default
    scene at 16x12, eager (tests/test_torch_inverse.py's jax_run with the
    mesh)."""
    import jax
    import jax.numpy as jnp

    import ray_rust_tpu as rt
    from ray_rust_tpu.parallel.shard import make_mesh as jax_make_mesh
    from ray_rust_tpu.parallel.train import TrainState as JaxTrainState
    from ray_rust_tpu.parallel.train import make_train_step as jax_make_train_step
    from ray_rust_tpu_torch.examples import inverse_rendering as example

    from .test_torch_inverse import TRAIN_KW, _copy, jax_example_optimizer

    jax_scene, _ = rt.default_scene()
    cfg = rtt.RenderConfig(**TRAIN_KW)
    target_scene = _port(jax_scene)
    with torch.no_grad():
        target = rtt.render_color(target_scene, cfg).to_array()
    leaves0 = _copy(rtt.scene_to_numpy(example.perturbed(target_scene)))
    js0 = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jax_scene),
                                       [jnp.array(leaves0[p]) for p in leaves0])
    opt = jax_example_optimizer(js0)
    state = JaxTrainState(js0, opt.init(js0))
    step = jax_make_train_step(_jax_cfg(cfg), opt,
                               mesh=jax_make_mesh(jax.devices(), dp=4, sp=2))
    runs = []
    with jax.disable_jit():
        for _ in range(3):
            state, loss = step(state, jnp.array(target.numpy()))
            runs.append((state, float(loss)))
    return cfg, target, leaves0, runs


def test_sharded_make_train_step_matches_jax(jax_mesh_run):
    """Three ``make_train_step(cfg, SceneAdam, mesh=4x2 cpu mesh)`` steps,
    each from the JAX mesh run's state before it: the loss within 1e-4
    relative, the leaves as tests/test_torch_inverse.py holds the whole-frame
    step (trained leaves within its ``step_apart`` rule, the others bit for
    bit)."""
    from .test_torch_inverse import LR, _assert_step_matches, _copy, _jax_adam_moments

    cfg, target, leaves0, runs = jax_mesh_run
    ours = SceneAdam(LR)
    step = make_train_step(cfg, ours, mesh=_cpu_mesh(4, 2))
    for k, (jstate, jloss) in enumerate(runs):
        if k == 0:
            scene0 = rtt.scene_from_numpy(leaves0, device="cpu")
            state = TrainState(scene0, ours.init(scene0))
        else:
            prev = runs[k - 1][0]
            mu, nu, count = _jax_adam_moments(prev.opt_state, prev.scene)
            state = train_state_from_numpy(_copy(rtt.scene_to_numpy(prev.scene)), ours, mu, nu,
                                           count, device="cpu")
        state, loss = step(state, target)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
        _assert_step_matches(rtt.scene_to_numpy(state.scene), jstate, k)


_TRAIN_CFG = rtt.RenderConfig(xres=32, yres=16, max_reflections=2, refraction_unroll=1)


def _colour_scene():
    """The default scene on the CPU with its material colours as the only
    leaves that require grad, and a target with its red material redder."""
    scene = rtt.default_scene(device="cpu")[0]
    m = scene.materials
    red = m.diffuse.r.clone()
    red[2] += 0.1
    with torch.no_grad():
        target = rtt.render_color(
            scene._replace(materials=m._replace(diffuse=m.diffuse._replace(r=red))),
            _TRAIN_CFG).to_array()

    def fresh(c):
        return type(c)(*(t.detach().clone().requires_grad_() for t in c))

    return scene._replace(materials=m._replace(diffuse=fresh(m.diffuse),
                                               specular=fresh(m.specular))), target


# Two ranks of a training step over gloo on localhost: each trains the
# material colours on its row of a 2x2 global mesh, then reduces a gradient
# with a NaN on rank 0; saves both results to argv[1].
_CHILD = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
sys.path.insert(0, sys.argv[2])
from ray_rust_tpu_torch.parallel import multihost, reduce_gradients, sgd_train_step
from tests.test_torch_sharded_grad import _TRAIN_CFG, _colour_scene

assert multihost.init_distributed(backend="gloo", timeout=60) is True
rank = torch.distributed.get_rank()
scene, target = _colour_scene()
mesh = multihost.global_mesh(dp=2, sp=2, devices=[torch.device("cpu")] * 2)
assert len(mesh.local_cells()) == 2 and mesh.multiprocess
new, loss = sgd_train_step(scene, _TRAIN_CFG, target, lr=10.0, mesh=mesh)
g = [torch.tensor([float("nan"), 1.0]) if rank == 0 else torch.tensor([2.0, 3.0])]
(reduced,), total = reduce_gradients(g, torch.tensor(float(rank + 1)), mesh)
assert not any(m == "jax" or m.startswith(("jax.", "ray_rust_tpu.")) for m in sys.modules)
m = new.materials
np.savez(sys.argv[1], loss=loss.numpy(), reduced=reduced.numpy(), total=total.numpy(),
         leaves=torch.stack([*m.diffuse, *m.specular]).detach().numpy())
torch.distributed.destroy_process_group()
"""


def test_two_process_gloo_step(tmp_path):
    """Two processes join a gloo group (a 60 s timeout: a missed collective
    fails this test, not the suite), each renders its row of a 2x2 global
    mesh and takes one SGD step: both get the single-process step's loss
    within 1e-6 relative and its leaves within 1e-6 (the ranks' gradients
    sum in another order). Rank 0's gradient [nan, 1] and rank 1's [2, 3]
    reduce to [0, 4] on both (the sum first, then the zeroing) and the
    losses 1 and 2 to 3. Neither imports JAX."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE="2",
                   RANK=str(rank), PYTHONPATH=_REPO)
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _CHILD, str(tmp_path / f"{rank}.npz"), _REPO], env=env,
            cwd=_REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        outs = [p.communicate(timeout=150) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"rank failed rc={p.returncode}\n{out}\n{err}"
    scene, target = _colour_scene()
    new, loss = sgd_train_step(scene, _TRAIN_CFG, target, lr=10.0)
    m = new.materials
    want = torch.stack([*m.diffuse, *m.specular]).detach().numpy()
    for rank in range(2):
        got = np.load(tmp_path / f"{rank}.npz")
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        np.testing.assert_allclose(got["leaves"], want, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got["reduced"], np.float32([0.0, 4.0]))
        assert float(got["total"]) == 3.0


def test_format_report_matches_jax():
    """The report of one list of results is the JAX function's text, with
    and without the training columns."""
    from ray_rust_tpu.parallel.scaling import format_report as jax_format_report

    results = [{"devices": 1, "image": (128, 256), "fwd_s": 0.0123456, "fwd_efficiency": 1.0,
                "fwd_rays_per_s_per_device": 2.6e6, "step_s": 0.04567, "step_efficiency": 1.0},
               {"devices": 2, "image": (256, 256), "fwd_s": 0.0131, "fwd_efficiency": 0.9424,
                "fwd_rays_per_s_per_device": 2.5e6, "step_s": 0.0512,
                "step_efficiency": 0.8920},
               {"devices": 4, "image": (512, 256), "fwd_s": 0.0157, "fwd_efficiency": 0.786,
                "fwd_rays_per_s_per_device": 2.1e6}]
    assert format_report(results) == jax_format_report(results)


def test_scaling_harness_mechanism():
    """tests/test_sharding.py:114-131's twin on two cpu cells (timings on
    shared cores measure nothing; this checks the mechanism and the
    report)."""
    res = measure_scaling(device_counts=[1, 2], rows_per_device=8, width=32,
                          cfg=rtt.RenderConfig(max_reflections=1, max_refractions=1,
                                               refraction_unroll=1),
                          iters=1, devices=[CPU] * 2)
    assert [r["devices"] for r in res] == [1, 2]
    assert [r["image"] for r in res] == [(8, 32), (16, 32)]
    assert res[0]["fwd_efficiency"] == 1.0
    assert all(math.isfinite(r["step_s"]) and r["step_efficiency"] > 0 for r in res)
    report = format_report(res)
    assert "devices" in report and "step eff" in report


def test_dryrun_and_entry(capsys):
    """tests/test_sharding.py:99-111's twins on cpu cells: the dry run on 8
    cells (a 4x2 mesh) and on 2 (``dryrun_multichip``), and the entry's
    96x128 forward render."""
    dryrun(8, devices=[CPU] * 8)
    dryrun_multichip(2, device="cpu")
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: mesh {'dp': 4, 'sp': 2}, image 32x32" in out
    assert "mesh {'dp': 1, 'sp': 2}, image 8x32" in out
    fn, args = entry(device="cpu")
    img = fn(*args)
    assert tuple(img.r.shape) == (96, 128) and torch.isfinite(img.to_array()).all()


def test_no_pallas_takes_the_plain_version(monkeypatch, tmp_path, default_scene):
    """``--no-pallas`` sets ``use_pallas=False``, which renders the plain
    version on a scene the renderer takes for a CUDA one, where the default
    goes to the kernel (a stand-in here, which records its calls); the CLI
    writes the same image with and without it on the CPU."""
    assert cli.build_parser().parse_args(["8", "6", "--no-pallas"]).no_pallas
    cfg = rtt.RenderConfig(xres=16, yres=12, max_reflections=1, refraction_unroll=0)
    want = rtt.render_color(default_scene, cfg).to_array()
    calls = []
    monkeypatch.setattr(Scene, "device", property(lambda self: torch.device("cuda", 0)))
    monkeypatch.setattr(kt, "render_color_kernel", lambda *a: calls.append(a[2:]) or "K1")
    got = rtt.render_color(default_scene, cfg.with_(use_pallas=False)).to_array()
    assert torch.equal(got, want) and not calls
    assert rtt.render_color(default_scene, cfg) == "K1" and calls == [((0, 0), None)]
    monkeypatch.undo()
    paths = [tmp_path / "a.png", tmp_path / "b.png"]
    for path, flags in zip(paths, ([], ["--no-pallas"])):
        assert cli.main(["16", "12", "-o", str(path), "--device", "cpu", *flags]) == 0
    assert paths[0].read_bytes() == paths[1].read_bytes()


@pytest.mark.cuda
@pytest.mark.parametrize("march", [False, True])
def test_sharded_kernel_gradients_on_card(march):
    """On the card: a 2x2 mesh of cuda:0 launches K1 and K2 (K3 and K4) on
    each cell's window, and the leaves' gradient of a seeded cotangent is the
    whole frame's within relative L2 1e-4 (chip_smoke.REGIME_REL_L2: atomics
    in another order), the image bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ray_rust_tpu_torch.ops import kernel_march as km

    dev = torch.device("cuda", 0)
    cfg = rtt.RenderConfig(xres=96, yres=48, **(_GLOW if march else {}))
    bwd = kmb if march else kb
    g = torch.as_tensor(_planes((48, 96), seed=2), device=dev)

    def grads(render):
        scene = _all_float_leaves(rtt.default_scene(device="cuda")[0])
        img = render(scene)
        leaves = [t for t in scene.tensors() if t.requires_grad]
        got = torch.autograd.grad(sum(torch.sum(c * gk) for c, gk in zip(img, g)), leaves,
                                  allow_unused=True)
        return img.to_array().detach(), [np.zeros(1) if x is None else x.cpu().numpy()
                                         for x in got]

    want_img, want = grads(lambda s: rtt.render_color(s, cfg))
    bwd.LAUNCHES = 0
    mesh = make_mesh([dev] * 4, dp=2, sp=2)
    img, got = grads(lambda s: render_sharded(s, cfg, mesh))
    assert bwd.LAUNCHES == 4 and (km if march else kt).LAUNCHES >= 4
    assert torch.equal(img, want_img)
    assert _rel(np.concatenate([x.ravel() for x in got]),
                np.concatenate([x.ravel() for x in want])) <= 1e-4
