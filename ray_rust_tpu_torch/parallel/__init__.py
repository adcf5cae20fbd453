"""Training over the renderer on one device (``parallel/train.py``): the
loss, the SGD step, and the optimizer step with its state. The device mesh
of the JAX package comes with the multi-device layer."""

from .train import (
    EXAMPLE_TRAINED,
    SceneAdam,
    TrainState,
    make_train_step,
    render_loss,
    sgd_train_step,
    train_state_from_numpy,
)

__all__ = ["render_loss", "sgd_train_step", "TrainState", "make_train_step", "SceneAdam",
           "train_state_from_numpy", "EXAMPLE_TRAINED"]
