"""Training over the renderer: the single-device trainer functions
(``parallel/train.py``). The device mesh of the JAX package comes with the
multi-device layer."""

from .train import render_loss, sgd_train_step

__all__ = ["render_loss", "sgd_train_step"]
