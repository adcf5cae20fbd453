"""The multi-device layer: the ``(dp, sp)`` mesh and sharded rendering
(``shard.py``), multi-process rendering over ``torch.distributed``
(``multihost.py``), and training over the renderer on one device
(``train.py``: the loss, the SGD step, the optimizer step with its state).
The sharded gradient, weak scaling and the dry run of the JAX package's
layer come in a later slice."""

from .multihost import (
    global_mesh,
    init_distributed,
    is_primary,
    local_device,
    render_multihost,
    world_size,
)
from .shard import (
    Mesh,
    Tile,
    make_mesh,
    render_sharded,
    render_sharded_kernel,
    render_tiled_u8,
    render_tiles,
)
from .train import (
    EXAMPLE_TRAINED,
    SceneAdam,
    TrainState,
    make_train_step,
    render_loss,
    sgd_train_step,
    train_state_from_numpy,
)

__all__ = ["Mesh", "Tile", "make_mesh", "render_tiles", "render_sharded",
           "render_sharded_kernel", "render_tiled_u8", "init_distributed", "is_primary",
           "world_size", "local_device", "global_mesh", "render_multihost",
           "render_loss", "sgd_train_step", "TrainState", "make_train_step", "SceneAdam",
           "train_state_from_numpy", "EXAMPLE_TRAINED"]
