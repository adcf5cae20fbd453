"""The multi-device layer: the ``(dp, sp)`` mesh and sharded rendering
(``shard.py``), multi-process rendering over ``torch.distributed``
(``multihost.py``), training on one device or over a mesh and across ranks
(``train.py``: the loss, the SGD step, the optimizer step with its state,
the gradient's all-reduce), weak scaling (``scaling.py``) and the dry run
(``dryrun.py``)."""

from .multihost import (
    global_mesh,
    init_distributed,
    is_primary,
    local_device,
    render_multihost,
    world_size,
)
from .scaling import format_report, measure_scaling
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
    reduce_gradients,
    render_loss,
    sgd_train_step,
    train_state_from_numpy,
)

__all__ = ["Mesh", "Tile", "make_mesh", "render_tiles", "render_sharded",
           "render_sharded_kernel", "render_tiled_u8", "init_distributed", "is_primary",
           "world_size", "local_device", "global_mesh", "render_multihost",
           "render_loss", "reduce_gradients", "sgd_train_step", "TrainState",
           "make_train_step", "SceneAdam", "train_state_from_numpy", "EXAMPLE_TRAINED",
           "measure_scaling", "format_report"]
