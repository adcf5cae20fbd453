"""Multi-device sharded rendering.

PyTorch counterpart of ``ray_rust_tpu/parallel/shard.py``. The JAX package
shards the pixel grid over a ``jax.sharding.Mesh``, rows over its ``dp``
axis and columns over ``sp``, and ``render_sharded_pallas`` launches the
kernel on each device for its own pixel window at its global origin. Here a
:class:`Mesh` is a ``(dp, sp)`` grid of ``torch.device`` cells, each owned
by a process (rank); a cell may repeat a device (eight ``cpu`` cells, or a
2x2 mesh of ``cuda:0`` on one card). Each cell renders its window of the
frame through the renderer's one dispatch (``renderer.render_color`` with
``origin=`` and ``shape=``): K1 or K3 on CUDA, the plain version on the
CPU. A window's pixels are the whole frame's bit for bit, so a sharded
render is the whole-frame render. A scene that requires grad differentiates
through the same dispatch: on CUDA each cell is a ``TraceRender`` (or
``MarchRender``) on its window, K2 (K4) in its backward, and autograd sums
the cells' pull-backs on the scene's own leaves through ``scene.to(dev)``
and :func:`assemble`'s ``torch.cat`` (the JAX package's replicated scene,
whose gradient XLA sums over the mesh). Rays never communicate: the
collectives are the gather of a frame across processes
(``parallel/multihost.py``) and the training step's sum of the gradient
across them (``parallel/train.py``).

For images too large for one launch (4K, 8K), :func:`render_tiled_u8`
renders row bands in turn, each split over the mesh and converted to u8 on
the mesh's first device before one copy to the host.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import RenderConfig
from ..models.scene import Scene
from ..models.vec import Color
from ..renderer import render_color, to_u8

__all__ = ["Mesh", "Tile", "make_mesh", "process_rank", "cell_shape", "render_tiles",
           "assemble", "render_sharded", "render_sharded_kernel", "render_tiled_u8"]


def process_rank() -> int:
    """This process's rank in the default ``torch.distributed`` group (0
    without one)."""
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _indexed(d) -> torch.device:
    """``d`` as a device with its index (``cuda`` is the current CUDA
    device), as a tensor there reports its device."""
    d = torch.device(d)
    return torch.device("cuda", torch.cuda.current_device()) if d == torch.device("cuda") else d


class Mesh:
    """A ``(dp, sp)`` grid of cells: rows of the image over ``dp``, columns
    over ``sp``. Each cell is a device and the rank of the process that
    renders on it. ``devices`` and ``ranks`` are given row-major; the ranks
    default to this process's."""

    def __init__(self, devices, dp: int, sp: int, ranks=None):
        devices = [_indexed(d) for d in devices]
        ranks = [process_rank()] * len(devices) if ranks is None else [int(r) for r in ranks]
        if dp < 1 or sp < 1 or dp * sp != len(devices) or len(ranks) != len(devices):
            raise ValueError(f"mesh {dp}x{sp} != {len(devices)} devices")
        self.dp, self.sp = dp, sp
        self.devices = [devices[i * sp:(i + 1) * sp] for i in range(dp)]
        self.ranks = [ranks[i * sp:(i + 1) * sp] for i in range(dp)]

    @property
    def shape(self) -> dict:
        return {"dp": self.dp, "sp": self.sp}

    def cells(self) -> List[Tuple[int, int, torch.device, int]]:
        """``(i, j, device, rank)`` of every cell, row-major."""
        return [(i, j, self.devices[i][j], self.ranks[i][j])
                for i in range(self.dp) for j in range(self.sp)]

    def local_cells(self) -> List[Tuple[int, int, torch.device, int]]:
        """The cells this process renders."""
        me = process_rank()
        return [c for c in self.cells() if c[3] == me]

    @property
    def multiprocess(self) -> bool:
        """Whether the cells belong to more than one process."""
        return len({r for row in self.ranks for r in row}) > 1


def make_mesh(devices=None, dp: Optional[int] = None, sp: int = 1) -> Mesh:
    """Build a ``(dp, sp)`` mesh over ``devices`` (by default every CUDA
    device; RuntimeError where there is none). ``dp`` shards image rows (the
    analogue of the reference's ``-t`` thread rows), ``sp`` columns; by
    default every device goes on the ``dp`` axis."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n == 0:
            raise RuntimeError("make_mesh: no CUDA device; pass the devices "
                               "(e.g. [torch.device('cpu')] * 8) to build a mesh without one")
        devices = [torch.device("cuda", k) for k in range(n)]
    devices = list(devices)
    if dp is None:
        dp = len(devices) // sp
    return Mesh(devices, dp, sp)


class Tile(NamedTuple):
    """One cell's window of the frame: the cell ``(i, j)``, the window's
    global ``origin`` ``(row0, col0)`` and its image, ``(h, w)`` planes on
    the cell's device."""

    index: Tuple[int, int]
    origin: Tuple[int, int]
    color: Color


def cell_shape(rows: int, cfg: RenderConfig, mesh: Mesh) -> Tuple[int, int]:
    """``(h, w)`` of each cell's window of a band of ``rows`` rows; raises
    ValueError where the band does not divide over the mesh."""
    if rows % mesh.dp or cfg.xres % mesh.sp:
        raise ValueError(f"image {rows}x{cfg.xres} not divisible by mesh {mesh.dp}x{mesh.sp}")
    return rows // mesh.dp, cfg.xres // mesh.sp


def render_tiles(scene: Scene, cfg: RenderConfig, mesh: Mesh, y0: int = 0,
                 rows: Optional[int] = None) -> List[Tile]:
    """The tiles of this process's cells for the band of ``rows`` rows (the
    whole frame by default) from row ``y0``: cell ``(i, j)`` renders the
    window at ``(y0 + i·h, j·w)`` of size ``h = rows/dp`` by ``w =
    xres/sp`` on its device, the scene copied once to each distinct device.
    Raises ValueError where the band does not divide over the mesh."""
    rows = cfg.yres if rows is None else rows
    h, w = cell_shape(rows, cfg, mesh)
    copies = {}
    tiles = []
    for i, j, dev, _ in mesh.local_cells():
        if dev not in copies:
            copies[dev] = scene if scene.device == dev else scene.to(dev)
        origin = (y0 + i * h, j * w)
        tiles.append(Tile((i, j), origin, render_color(copies[dev], cfg, origin, (h, w))))
    return tiles


def assemble(tiles: List[Tile], mesh: Mesh, device=None) -> Color:
    """The image the tiles of every cell of ``mesh`` make, as one Color on
    ``device`` (the mesh's first by default): each plane is its tiles
    concatenated, a row of the mesh after another (differentiable, so a CPU
    render keeps its autograd graph)."""
    device = mesh.devices[0][0] if device is None else torch.device(device)
    by_index = {t.index: t.color for t in tiles}
    if len(by_index) != mesh.dp * mesh.sp:
        raise ValueError(f"{len(by_index)} tiles for a {mesh.dp}x{mesh.sp} mesh")

    def plane(k):
        return torch.cat([torch.cat([by_index[i, j][k].to(device) for j in range(mesh.sp)], 1)
                          for i in range(mesh.dp)], 0)

    return Color(plane(0), plane(1), plane(2))


def render_sharded(scene: Scene, cfg: RenderConfig, mesh: Mesh) -> Color:
    """Render with the pixel grid sharded over the one-process ``mesh``
    (:func:`render_tiles`), assembled on the mesh's first device. Each CUDA
    cell launches K1 (K3 in march mode) on its window, each CPU cell renders
    the plain version. Differentiable: on a scene that requires grad each
    CUDA cell's backward launches K2 (K4) on its window, and the leaves'
    gradient sums the cells' (in another order than the whole frame's).
    Raises ValueError where the image does not divide over the mesh."""
    if mesh.multiprocess:
        raise ValueError("render_sharded takes a mesh of one process; "
                         "multihost.render_multihost renders a global mesh")
    cell_shape(cfg.yres, cfg, mesh)
    return assemble(render_tiles(scene, cfg, mesh), mesh)


# The counterpart of the JAX package's render_sharded_pallas: every CUDA cell
# of render_sharded launches the kernel (K1 or K3) on its window already.
render_sharded_kernel = render_sharded


def render_tiled_u8(scene: Scene, cfg: RenderConfig, mesh: Mesh,
                    rows_per_tile: int = 256) -> np.ndarray:
    """Large-image path: render row bands of ``rows_per_tile`` rows in turn,
    each split over the one-process mesh (:func:`render_tiles`), converted to
    u8 on the mesh's first device and copied into the host's ``(H, W, 3)``
    uint8 array. Replaces the reference's per-row mpsc gather
    (render.rs:870-886) with banded device launches; the bands are the
    frame's pixels bit for bit. ``rows_per_tile`` must divide the image's
    rows (2160 takes 270 or 240, not 256) or exceed them."""
    assert cfg.yres % rows_per_tile == 0 or rows_per_tile > cfg.yres
    if mesh.multiprocess:
        raise ValueError("render_tiled_u8 takes a mesh of one process")
    rows = min(rows_per_tile, cfg.yres)
    cell_shape(rows, cfg, mesh)
    out = np.empty((cfg.yres, cfg.xres, 3), np.uint8)
    with torch.no_grad():
        for y0 in range(0, cfg.yres, rows):
            band = assemble(render_tiles(scene, cfg, mesh, y0, rows), mesh)
            out[y0:y0 + rows] = to_u8(band).cpu().numpy()
    return out
