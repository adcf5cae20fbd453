"""Checkpoint and resume in the PyTorch port (``ray_rust_tpu_torch/checkpoint.py``).

Twins on ``device="cpu"`` of the six tests of tests/test_checkpoint.py
(the JAX treedef check becomes the port's structure check), a
``TrainState`` with Adam's moments through save and restore (bit for bit,
the optimizer over the restored scene's leaves, the next ten steps equal to
the uninterrupted run's), and ``train_state_from_numpy`` from a JAX
``TrainState`` with optax Adam state.
"""

import numpy as np
import pytest
import torch

import ray_rust_tpu as rt
import ray_rust_tpu_torch as rtt
from ray_rust_tpu_torch import checkpoint
from ray_rust_tpu_torch.examples import inverse_rendering as example
from ray_rust_tpu_torch.parallel import (
    EXAMPLE_TRAINED,
    SceneAdam,
    TrainState,
    make_train_step,
    train_state_from_numpy,
)

from .test_torch_inverse import LR, _jax_adam_moments, _jax_tree, jax_example_optimizer
from .test_torch_kernel_trace import one_torch_thread  # noqa: F401 (module fixture)


@pytest.fixture
def scene():
    return rtt.default_scene(device="cpu")[0]


def _leaves(state) -> list:
    """Every tensor a checkpoint holds for ``state``, by name, on the host."""
    return [(name, t.detach().cpu().clone()) for name, t in checkpoint.leaves(state)]


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [n for n, _ in la] == [n for n, _ in lb]
    for (name, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype, name
        assert torch.equal(x, y), name


def test_scene_roundtrip(tmp_path, scene):
    path = checkpoint.save(str(tmp_path), 7, scene)
    assert path.endswith("step_00000007.npz")
    loaded, step = checkpoint.restore(str(tmp_path), scene)
    assert step == 7
    _assert_same(loaded, scene)
    assert isinstance(loaded, rtt.Scene) and loaded.objects.kind.dtype == torch.int32


def test_train_state_roundtrip(tmp_path, scene):
    opt = SceneAdam(1e-2)
    state = TrainState(scene, opt.init(scene))
    checkpoint.save(str(tmp_path), 0, state)
    loaded, _ = checkpoint.restore(str(tmp_path), state)
    _assert_same(loaded, state)


def test_latest_and_keep(tmp_path, scene):
    ck = checkpoint.Checkpointer(str(tmp_path), keep=2)
    for s in (1, 5, 9):
        ck.save(s, scene)
    assert checkpoint.all_steps(str(tmp_path)) == [5, 9]
    assert checkpoint.latest_step(str(tmp_path)) == 9
    loaded, nxt = ck.restore_or(scene)
    assert nxt == 10
    _assert_same(loaded, scene)


def test_restore_or_fresh(tmp_path, scene):
    ck = checkpoint.Checkpointer(str(tmp_path / "empty"))
    st, step = ck.restore_or(scene)
    assert step == 0
    assert st is scene


def test_structure_mismatch_raises(tmp_path, scene):
    checkpoint.save(str(tmp_path), 0, scene)
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), {"not": torch.zeros(1), "x": torch.zeros(3)})
    # the same tree with one leaf of another shape
    grown = scene._replace(light=scene.light._replace(x=torch.zeros(2)))
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), grown)
    # a scene against a training state's checkpoint: the optimizer's moments
    opt = SceneAdam(1e-2)
    checkpoint.save(str(tmp_path), 1, TrainState(scene, opt.init(scene)))
    with pytest.raises(ValueError, match="structure mismatch"):
        checkpoint.restore(str(tmp_path), scene, step=1)


def test_restore_missing_raises(tmp_path, scene):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore(str(tmp_path / "nope"), scene)


def test_train_state_with_adam_moments_resumes(tmp_path):
    """Three steps of the example at 16x12, save, restore into a fresh state:
    the scene, Adam's moments and its step bit for bit, the restored
    optimizer over the restored scene's own leaves, and its next ten steps'
    losses and leaves bit-equal to the uninterrupted run's (the plain version
    on the CPU sums in a fixed order)."""
    cfg = example.example_config(16)
    _, target, scene0 = example.problem(cfg, "cpu")
    opt = SceneAdam(LR)
    step = make_train_step(cfg, opt)
    state = TrainState(scene0, opt.init(scene0))
    for _ in range(3):
        state, _ = step(state, target)
    ck = checkpoint.Checkpointer(str(tmp_path), keep=1)
    ck.save(2, state)
    saved = _leaves(state)
    fresh = example.perturbed(rtt.default_scene(device="cpu")[0])
    restored, start = ck.restore_or(TrainState(fresh, opt.init(fresh)))
    assert start == 3
    _assert_same(restored, state)
    adam = restored.opt_state
    assert adam.param_groups[0]["params"][0] is restored.scene.objects.org.x
    assert float(adam.state[adam.param_groups[0]["params"][0]]["step"]) == 3
    assert adam.param_groups[0]["lr"] == LR
    runs = []
    for s in (state, restored):
        losses = []
        for _ in range(10):
            s, loss = step(s, target)
            losses.append(float(loss))
        runs.append((losses, _leaves(s)))
    assert runs[0][0] == runs[1][0]
    for (name, x), (_, y) in zip(runs[0][1], runs[1][1]):
        assert torch.equal(x, y), name
    # the checkpoint held the state as it was at save time
    for (name, x), (_, y) in zip(saved, _leaves(checkpoint.restore(str(tmp_path), state)[0])):
        assert torch.equal(x, y), name


def test_train_state_from_numpy_carries_optax_adam():
    """A JAX TrainState with optax Adam state (the example's chain) carried
    into the port: the moments and the step as optax keeps them, on the
    trained leaves in ``Scene.tensors()``'s order, and the scene's leaves."""
    jax_scene, _ = rt.default_scene()
    opt = jax_example_optimizer(jax_scene)
    rng = np.random.default_rng(5)
    grads = {p: np.asarray(rng.standard_normal(a.shape), np.float32)
             for p, a in rtt.scene_to_numpy(jax_scene).items() if a.dtype == np.float32}
    jstate = opt.init(jax_scene)
    for _ in range(2):
        _, jstate = opt.update(_jax_tree(jax_scene, grads), jstate, jax_scene)
    mu, nu, count = _jax_adam_moments(jstate, jax_scene)
    assert count == 2 and sorted(mu) == sorted(EXAMPLE_TRAINED)
    state = train_state_from_numpy(rtt.scene_to_numpy(jax_scene), SceneAdam(LR), mu, nu,
                                   count, device="cpu")
    adam = state.opt_state
    assert adam.param_groups[0]["params"][0] is state.scene.objects.org.x
    for p, path in zip(adam.param_groups[0]["params"], EXAMPLE_TRAINED):
        st = adam.state[p]
        np.testing.assert_array_equal(st["exp_avg"].numpy(), mu[path])
        np.testing.assert_array_equal(st["exp_avg_sq"].numpy(), nu[path])
        assert float(st["step"]) == 2
    for p, a in rtt.scene_to_numpy(state.scene).items():
        np.testing.assert_array_equal(a, rtt.scene_to_numpy(jax_scene)[p])
