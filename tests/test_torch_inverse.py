"""Inverse rendering in the PyTorch port against the JAX package.

- The example's optimizer (``parallel.SceneAdam``: the global norm
  of every float leaf's gradient clipped to 1.0, then ``torch.optim.Adam``
  on the centres, radii and diffuse colours, the other leaves frozen)
  against ``optax.chain(clip_by_global_norm(1.0), multi_transform({adam,
  set_to_zero}))`` as examples/inverse_rendering.py:111-117 builds it, on
  the same seeded parameters and gradients over 5 updates, within 1e-6;
  also where a frozen leaf's gradient sets the norm.
- ``make_train_step`` against the JAX ``make_train_step`` for 3 steps at
  16x12, each from the JAX run's state (``train_state_from_numpy``).
- The example's ``main`` on the CPU, and its resume from ``--ckpt_dir``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import ray_rust_tpu as rt
import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import checkpoint
from ray_rust_tpu.parallel.train import TrainState as JaxTrainState
from ray_rust_tpu.parallel.train import make_train_step as jax_make_train_step
from ray_rust_tpu.parallel.train import optax_apply
from ray_rust_tpu_torch.examples import inverse_rendering as example
from ray_rust_tpu_torch.parallel import (
    EXAMPLE_TRAINED,
    SceneAdam,
    TrainState,
    make_train_step,
    train_state_from_numpy,
)

from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)

LR = 0.5  # the example's default


def jax_example_optimizer(scene, lr=LR):
    """examples/inverse_rendering.py:97-117's optimizer for a JAX scene."""
    lab = jax.tree_util.tree_map(lambda _: "frozen", scene)
    lab = lab._replace(
        objects=lab.objects._replace(org=type(scene.objects.org)("opt", "opt", "opt"),
                                     radius="opt"),
        materials=lab.materials._replace(diffuse=type(scene.materials.diffuse)("opt", "opt",
                                                                               "opt")))
    return optax.chain(optax.clip_by_global_norm(1.0),
                       optax.multi_transform({"opt": optax.adam(lr), "frozen": optax.set_to_zero()},
                                             lab))


def _float_paths(leaves: dict) -> list:
    return [p for p, a in leaves.items() if a.dtype == np.float32]


def _jax_tree(template, leaves: dict):
    """A JAX scene shaped like ``template`` with the float leaves from
    ``leaves`` and every integer leaf a zero f32 scalar (the zero gradients
    ``make_train_step`` gives them)."""
    paths = iter(rtt.scene_to_numpy(template))

    def leaf(x):
        p = next(paths)
        return jnp.asarray(leaves[p]) if p in leaves else jnp.zeros((), jnp.float32)
    return jax.tree_util.tree_map(leaf, template)


def _adam_f64(params: dict, grads_seq: list, lr=LR, max_norm=1.0) -> dict:
    """The example's optimizer in float64 numpy: the exact function both
    packages round."""
    p = {k: v.astype(np.float64) for k, v in params.items()}
    m = {k: np.zeros_like(p[k]) for k in EXAMPLE_TRAINED}
    v = {k: np.zeros_like(p[k]) for k in EXAMPLE_TRAINED}
    for t, grads in enumerate(grads_seq, 1):
        g = {k: a.astype(np.float64) for k, a in grads.items()}
        norm = np.sqrt(sum(np.sum(a * a) for a in g.values()))
        if norm >= max_norm:
            g = {k: a / norm * max_norm for k, a in g.items()}
        for k in EXAMPLE_TRAINED:
            m[k] = 0.9 * m[k] + 0.1 * g[k]
            v[k] = 0.999 * v[k] + 0.001 * g[k] * g[k]
            p[k] = p[k] - lr * (m[k] / (1 - 0.9 ** t)) / (np.sqrt(v[k] / (1 - 0.999 ** t)) + 1e-8)
    return p


@pytest.mark.parametrize("frozen_dominates", [False, True], ids=["trained", "frozen_dominates"])
def test_example_optimizer_matches_optax(frozen_dominates):
    """Parameters of magnitude ~1 (seeded), so 1e-6 is a few ulps of them.
    The port's optimizer is within 1e-6 of the function computed in float64
    everywhere. optax is not: its Adam takes the second moment with
    ``1 - 0.999`` rounded from float64 (0.001) and the bias correction
    ``1 - 0.999**t`` in float32 (0.00099998713 at t = 1), so its ``nu_hat``
    runs 1.3e-5 high and each step ~lr·6.4e-6 short (measured: 3.4e-6 at
    lr 0.5, t = 1), which ``torch.optim.Adam`` (float64 corrections)
    reproduces with no choice of betas. So against optax the bound is that,
    five steps over: 5 · 0.5 · 1.3e-5 = 3.3e-5."""
    rng = np.random.default_rng(3)
    jax_scene, _ = rt.default_scene()
    base = rtt.scene_to_numpy(jax_scene)
    floats = _float_paths(base)
    params = dict(base, **{p: np.asarray(rng.standard_normal(base[p].shape), np.float32)
                           for p in floats})
    jparams = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jax_scene),
                                           [jnp.asarray(params[p]) for p in base])
    opt = jax_example_optimizer(jparams)
    jstate = opt.init(jparams)

    scene = rtt.scene_from_numpy(params, device="cpu")
    ours = SceneAdam(LR)
    adam = ours.init(scene)
    grads_seq = []
    for k in range(5):
        grads = {p: np.asarray(rng.standard_normal(base[p].shape) * 0.3, np.float32)
                 for p in floats}
        if frozen_dominates:  # the camera's gradient sets the global norm
            for c in "xyzw":
                grads[f"camera.rotation.{c}"] *= 1e3
        grads_seq.append(grads)
        updates, jstate = opt.update(_jax_tree(jparams, grads), jstate, jparams)
        jparams = optax_apply(jparams, updates)
        with torch.no_grad():
            ours.update([torch.from_numpy(grads[p]) for p in floats], adam, scene)
    exact = _adam_f64({p: params[p] for p in floats}, grads_seq)
    want, got = rtt.scene_to_numpy(jparams), rtt.scene_to_numpy(scene)
    for p in floats:
        np.testing.assert_allclose(got[p], exact[p], rtol=0, atol=1e-6, err_msg=p)
        np.testing.assert_allclose(got[p], want[p], rtol=0, atol=3.3e-5, err_msg=p)
        if p not in EXAMPLE_TRAINED:
            np.testing.assert_array_equal(got[p], params[p], err_msg=p)
    moved = [p for p in EXAMPLE_TRAINED if not np.array_equal(got[p], params[p])]
    assert moved == list(EXAMPLE_TRAINED)


# -- make_train_step against the JAX one -------------------------------------

W, H = 16, 12
TRAIN_KW = dict(xres=W, yres=H, max_reflections=2, refraction_unroll=1)


def _jax_adam_moments(opt_state, scene):
    """optax Adam's (mu, nu, count) in the example's chain state, mu and nu
    as ``{dotted path: array}`` of the trained leaves."""
    adam = opt_state[1].inner_states["opt"].inner_state[0]
    paths = list(rtt.scene_to_numpy(scene))

    def flat(tree):
        vals = jax.tree_util.tree_leaves(tree, is_leaf=lambda x: isinstance(x, optax.MaskedNode))
        return {p: np.asarray(v) for p, v in zip(paths, vals) if p in EXAMPLE_TRAINED}
    return flat(adam.mu), flat(adam.nu), int(adam.count)


def _copy(leaves: dict) -> dict:
    """``scene_to_numpy``'s arrays share the CPU tensors' memory, which the
    optimizer updates in place; a JAX array made from one may too."""
    return {p: np.array(a) for p, a in leaves.items()}


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's ``make_train_step`` with the example's optimizer,
    three steps from the perturbed default scene at 16x12 (eager: a jitted
    step contracts to FMAs and flips knife-edge pixels): the config, the
    target, the start leaves, and the state and loss after each step."""
    jax_scene, _ = rt.default_scene()
    cfg = rtt.RenderConfig(**TRAIN_KW)
    target_scene = rtt.scene_from_numpy(rtt.scene_to_numpy(jax_scene), device="cpu")
    with torch.no_grad():
        target = rtt.render_color(target_scene, cfg).to_array()
    leaves0 = _copy(rtt.scene_to_numpy(example.perturbed(target_scene)))
    js0 = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(jax_scene),
                                       [jnp.array(leaves0[p]) for p in leaves0])
    opt = jax_example_optimizer(js0)
    state = JaxTrainState(js0, opt.init(js0))
    step = jax_make_train_step(rt.RenderConfig(**TRAIN_KW), opt)
    runs = []
    with jax.disable_jit():
        for _ in range(3):
            state, loss = step(state, jnp.array(target.numpy()))
            runs.append((state, float(loss)))
    return cfg, target, leaves0, runs


# Adam's step for an entry is lr·m̂/(√v̂ + eps), eps 1e-8: where the
# bias-corrected first moment m̂ is under NOISE_MOMENT the step still
# depends on |g| against eps, so the two gradients' rounding (another
# summation order; the card's atomics) moves it by up to lr; above it the
# step moves by less than eps/|g| <= 1e-2 of the gradient's relative error.
NOISE_MOMENT = 1e-6
STEP_ATOL = 1e-3  # an entry with a real gradient; a noise entry: lr


def step_apart(got: dict, want: dict, moments: dict, t: int, lr: float = LR) -> float:
    """The trained leaves after Adam step ``t`` (1-based) in two runs from
    the same state, ``moments`` the reference run's first moments by path:
    raises where an entry is apart by more than :data:`STEP_ATOL` (lr for a
    noise entry); returns the largest gap of the entries with a gradient."""
    worst = 0.0
    for p in EXAMPLE_TRAINED:
        noise = np.abs(moments[p] / (1 - 0.9 ** t)) < NOISE_MOMENT
        d = np.abs(np.asarray(got[p], np.float64) - want[p])
        assert np.all(d[~noise] <= STEP_ATOL), (p, t, d[~noise].max())
        assert np.all(d[noise] <= lr), (p, t, d[noise].max())
        worst = max(worst, float(d[~noise].max(initial=0.0)))
    return worst


def _assert_step_matches(got: dict, jstate, k: int):
    """The leaves after step ``k`` (0-based) against the JAX state's: the
    trained ones by :func:`step_apart` (the JAX gradient of a floor the red
    sphere's pixels do not see is 1e-12 where the port's is exactly 0, a
    noise entry), every other one bit for bit."""
    want = rtt.scene_to_numpy(jstate.scene)
    mu, _, count = _jax_adam_moments(jstate.opt_state, jstate.scene)
    assert count == k + 1
    for p, a in want.items():
        if p not in EXAMPLE_TRAINED:
            np.testing.assert_array_equal(got[p], a, err_msg=p)
    step_apart(got, want, mu, k + 1)


def test_make_train_step_matches_jax(jax_run):
    """Three steps, each from the JAX run's state before it (carried over by
    ``train_state_from_numpy``, moments and count included): the loss
    within 1e-4 relative, the trained leaves as
    :func:`_assert_step_matches` holds them, every other leaf bit for bit
    (integer leaves never move). Each step starts from the JAX state, not
    the port's previous one: the default scene sits on knife edges (the
    floor's gradation jumps at x = 0 under the camera's centre column), so a
    noise entry's step (the floor's ``org.x`` moves 5.8e-5 in the JAX step
    from a 1e-12 gradient, not at all in the port's) flips whole pixel
    columns, and the next losses part by far more than rounding."""
    cfg, target, leaves0, runs = jax_run
    ours = SceneAdam(LR)
    step = make_train_step(cfg, ours)
    for k, (jstate, jloss) in enumerate(runs):
        if k == 0:
            scene0 = rtt.scene_from_numpy(leaves0, device="cpu")
            state = TrainState(scene0, ours.init(scene0))
        else:
            prev = runs[k - 1][0]
            mu, nu, count = _jax_adam_moments(prev.opt_state, prev.scene)
            state = train_state_from_numpy(_copy(rtt.scene_to_numpy(prev.scene)), ours, mu, nu,
                                           count, device="cpu")
        before = _copy(rtt.scene_to_numpy(state.scene))
        state, loss = step(state, target)
        np.testing.assert_allclose(float(loss), jloss, rtol=1e-4)
        got = rtt.scene_to_numpy(state.scene)
        _assert_step_matches(got, jstate, k)
        # Adam steps a trained entry with a real gradient by ~lr (less once
        # its first moment and gradient part in sign)
        assert np.abs(got["objects.org.x"] - before["objects.org.x"]).max() > 0.1


# -- the example ---------------------------------------------------------------

def _losses(out: str) -> dict:
    return {int(line.split()[1]): float(line.split()[3]) for line in out.splitlines()
            if line.startswith("step ")}


def test_example_main_and_resume(tmp_path, capsys):
    """``--size 32 --steps 4`` on the CPU: it prints each step's loss and
    ``|dx_red|`` and the ms a step; with ``--ckpt_every 2`` a second run to
    6 steps resumes from step 2's checkpoint (step 3 onward) and equals the
    uninterrupted run's steps bit for bit (the plain version sums in a fixed
    order)."""
    args = ["--size", "32", "--device", "cpu", "--ckpt_every", "2"]
    rc = example.main(args + ["--steps", "6"])
    full = _losses(capsys.readouterr().out)
    assert rc in (0, 1) and sorted(full) == [0, 5]
    ck = str(tmp_path / "ck")
    example.main(args + ["--steps", "4", "--ckpt_dir", ck])
    out = capsys.readouterr().out
    assert "|dx_red|" in out and "ms/step" in out
    assert checkpoint.all_steps(ck) == [1, 3]
    example.main(args + ["--steps", "6", "--ckpt_dir", ck])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out
    assert _losses(out)[5] == full[5]
