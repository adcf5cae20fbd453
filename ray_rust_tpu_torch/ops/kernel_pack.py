"""The scene's tables packed in one hand-written CUDA kernel, their
pull-back in another, the texture atlas packed once per bank, and their
plain versions.

Counterpart of ``ray_rust_tpu/ops/pallas_trace.py:_pack_scene`` (``:127``)
and its VJP, ``jax.vjp(pack_f32, scene)`` (``:1656-1661``), and of the atlas
of ``_pack_textures`` (``:200``). The JAX package packs inside its jitted
program, where XLA fuses the gathers and stacks; eager PyTorch runs them as
~20 small ops a pack (:func:`pack_scene`) and autograd as ~40 in the
backward, most of the host's enqueue around each kernel. The kernels
(``csrc/pack_scene.cu``, per-entry bodies ``csrc/pack_body.cuh``) take one
launch each:

- :func:`launch_pack` writes the four tables of :func:`pack_scene` bit for
  bit, and the texture meta rows of :func:`pack_textures`, from the
  scene's leaves where they lie, through ``rt_pack_scene``, into one buffer
  of words: the trace and march kernels launch on its addresses
  (:func:`word_pointers`), and :func:`pack_tables` shows it as the tables;
- :func:`pack_scene_vjp` pulls a backward kernel's ``(n+1, 20)`` block
  (:data:`GRAD_COLS`) back to the scene's float leaves through
  ``rt_pack_scene_vjp``: what autograd of :func:`pack_scene` gives them,
  each material's sum over its objects in object index order, zeros for
  the leaves the tables do not read;
- :func:`texture_atlas` builds the atlas words of a bank's u8 texels once
  and serves them again while the bank's tensor is unchanged (its
  ``_version`` and ``data_ptr``).

On a CUDA scene each launches its kernel or raises ``ValueError`` on a leaf
it does not take (type, device, shape or stride); it never falls back. On a
CPU scene each takes its plain version: :func:`pack_scene`,
:func:`pack_textures`, autograd of :func:`pack_scene`
(:func:`pack_scene_vjp_plain`).
"""

from __future__ import annotations

import array
import weakref

import torch

from ..models.scene import Scene

__all__ = ["pack_scene", "pack_textures", "atlas_words", "pack_tables", "launch_pack",
           "pack_scene_vjp", "pack_scene_vjp_plain", "split_block", "split_vjp",
           "texture_atlas", "texture_pointers", "float_leaves", "leaf_pointers", "pack_words",
           "split_words", "word_pointers", "sizes"]

# Launches of the pack kernel and of its pull-back since import (or since a
# caller reset them).
LAUNCHES = 0
VJP_LAUNCHES = 0

F32_COLS, I32_COLS = 19, 4
CAM_COLS, LIGHT_COLS = 8, 4
TEX_META_COLS = 4  # csrc/trace_body.cuh: rt::TEX_META_COLS
GRAD_COLS = 20  # the backward kernels' block: object rows of 19, then camera 7 + light 3
# The most bytes atlas_words widens at once (its int32 copy of a chunk of
# textures' u8 texels)
ATLAS_CHUNK_BYTES = 2**30

_ATLASES: dict = {}  # id(bank.packed) -> (weakref, version, data_ptr, atlas words)


def pack_scene(scene: Scene):
    """The kernel's scene tables, in the JAX kernel's column layout
    (``pallas_trace.py:_pack_scene``): f32 ``(N, 19)`` with the material
    fields joined through the object->material index, i32 ``(N, 4)``,
    camera ``(1, 8)`` and light ``(1, 4)``."""
    objs, mats = scene.objects, scene.materials
    m = objs.mat.long()
    f32t = torch.stack(
        [
            objs.org.x, objs.org.y, objs.org.z,
            objs.normal.x, objs.normal.y, objs.normal.z,
            mats.diffuse.r[m], mats.diffuse.g[m], mats.diffuse.b[m],
            mats.specular.r[m], mats.specular.g[m], mats.specular.b[m],
            mats.pn[m], mats.transparency[m], mats.refraction[m],
            mats.pattern_scale[m], mats.pattern_angle_scale[m],
            objs.radius,
            mats.glow_dist[m],
        ],
        dim=1,
    ).to(torch.float32)
    i32t = torch.stack(
        [objs.kind, mats.pattern[m], objs.uvmap, mats.texture_id[m]], dim=1
    ).to(torch.int32)
    cam = scene.camera
    zero = torch.zeros_like(scene.light.x)
    cam_t = torch.stack(
        [cam.position.x, cam.position.y, cam.position.z,
         cam.rotation.x, cam.rotation.y, cam.rotation.z, cam.rotation.w, zero]
    ).to(torch.float32).reshape(1, 8)
    light_t = torch.stack(
        [scene.light.x, scene.light.y, scene.light.z, zero]
    ).to(torch.float32).reshape(1, 4)
    return f32t, i32t, cam_t, light_t


def atlas_words(packed: torch.Tensor) -> torch.Tensor:
    """The texture atlas of :func:`pack_textures` from a bank's texels
    ``packed`` (``TextureBank.packed``, ``(T, Hmax, Wmax, 12)`` u8): ``(T,
    Hmax, Wmax, 4)`` int32, each tap ``r | g<<8 | b<<16``. Built a chunk of
    textures at a time, so that besides the atlas it takes at most
    :data:`ATLAS_CHUNK_BYTES` (a bank of 2^31 texels: an atlas of 32 GiB
    from 24 GiB of u8, where widening all of ``packed`` at once would take
    96 GiB)."""
    t, hmax, wmax = packed.shape[:3]
    atlas = torch.empty((t, hmax, wmax, 4), dtype=torch.int32, device=packed.device)
    step = max(1, ATLAS_CHUNK_BYTES // max(1, 12 * 4 * hmax * wmax))
    for k in range(0, t, step):
        q = packed[k:k + step].to(torch.int32).reshape(-1, hmax, wmax, 4, 3)
        atlas[k:k + step] = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
    return atlas


def pack_textures(scene: Scene):
    """The kernel's texture atlas, or None for an untextured scene:
    ``(atlas, meta)``. ``atlas`` is ``(T, Hmax, Wmax, 4)`` int32, 16 bytes a
    texel holding its four taps (``TextureBank.packed``'s p00, p10,
    p01, p11) as ``r | g<<8 | b<<16`` words, texture-major with row stride
    ``Wmax``: the layout of the JAX package's ``_pack_textures``
    (``pallas_trace.py:200-265``) without its 128-lane chunks. ``meta`` is
    ``(T, 4)`` int32 rows ``[width, height, base texel, filter]``, the
    filter of the texture's owner material (by scatter-max, so a texture
    shared by a Nearest and a Bilinear material is Bilinear, as there); the
    base texel is ``tid * Hmax * Wmax``, or -1 past int32 (the kernels
    derive it in 64 bits and do not read it: ``csrc/trace_body.cuh:
    texel_index``)."""
    bank = scene.textures
    if bank is None:
        return None
    atlas = atlas_words(bank.packed)
    t, hmax, wmax = atlas.shape[:3]
    mats = scene.materials
    tid = mats.texture_id.long()
    owner_filt = torch.where(tid >= 0, mats.texture_filter, 0).to(torch.int32)
    filt = torch.zeros(t, dtype=torch.int32, device=atlas.device).scatter_reduce(
        0, tid.clamp(0, t - 1), owner_filt, reduce="amax")
    base = torch.arange(t, dtype=torch.int64, device=atlas.device) * (hmax * wmax)
    base = torch.where(base < 2**31, base, -1).to(torch.int32)
    meta = torch.stack([bank.widths.to(torch.int32), bank.heights.to(torch.int32), base, filt],
                       dim=1).contiguous()
    return atlas, meta


def _leaves(scene: Scene) -> list:
    """The 37 leaves the pack reads, in ``csrc/pack_body.cuh``'s order
    (``rt::pack::LEAVES``):
    objects (f32 org xyz, normal xyz, radius; i32 kind, mat, uvmap),
    materials (f32 diffuse rgb, specular rgb, pn, transparency, refraction,
    pattern_scale, pattern_angle_scale, glow_dist; i32 pattern, texture_id,
    texture_filter), the camera's position xyz and rotation xyzw, the
    light's xyz, the texture bank's widths and heights (None untextured)."""
    o, m, cam, tex = scene.objects, scene.materials, scene.camera, scene.textures
    p, r, lt = cam.position, cam.rotation, scene.light
    return [o.org.x, o.org.y, o.org.z, o.normal.x, o.normal.y, o.normal.z, o.radius,
            o.kind, o.mat, o.uvmap,
            *m.diffuse, *m.specular, m.pn, m.transparency, m.refraction, m.pattern_scale,
            m.pattern_angle_scale, m.glow_dist, m.pattern, m.texture_id, m.texture_filter,
            p.x, p.y, p.z, r.x, r.y, r.z, r.w, lt.x, lt.y, lt.z,
            *((tex.widths, tex.heights) if tex is not None else (None, None))]


def sizes(scene: Scene):
    """``(n, m, n_tex, texels)``: the scene's objects, materials, textures
    and the texels a texture takes in the atlas (``Hmax * Wmax``)."""
    bank = scene.textures
    n_tex, texels = (0, 0) if bank is None else (bank.packed.shape[0],
                                                  bank.packed.shape[1] * bank.packed.shape[2])
    return scene.objects.count, scene.materials.pn.shape[0], n_tex, texels


# Each leaf's type and the count its length is (0: objects, 1: materials,
# 2: one value, 3: textures), in _leaves's order.
_LEAF_SPECS = ([(torch.float32, 0)] * 7 + [(torch.int32, 0)] * 3 + [(torch.float32, 1)] * 12
               + [(torch.int32, 1)] * 3 + [(torch.float32, 2)] * 10 + [(torch.int32, 3)] * 2)


def leaf_pointers(scene: Scene) -> array.array:
    """The pointers of :func:`_leaves` as the kernels take them, one 64-bit
    word each (0 for an untextured scene's texture leaves); raises
    ValueError unless each leaf is a contiguous tensor of its type and
    length on the scene's device."""
    n, m, n_tex, _ = sizes(scene)
    lengths = (n, m, 1, n_tex)
    dev = scene.light.x.get_device()
    ptrs = array.array("Q")
    for k, (t, (dtype, which)) in enumerate(zip(_leaves(scene), _LEAF_SPECS)):
        if t is None:
            ptrs.append(0)
        elif (t.dtype is dtype and t.get_device() == dev and t.numel() == lengths[which]
              and t.is_contiguous()):
            ptrs.append(t.data_ptr())
        else:
            raise ValueError(f"the pack kernel takes leaf {k} as a contiguous {dtype} tensor of "
                             f"{lengths[which]} on {scene.device}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}"
                             f"{'' if t.is_contiguous() else ', strided'}")
    return ptrs


def pack_words(n: int, n_tex: int) -> int:
    """Words the pack writes (``csrc/pack_body.cuh: pack_words``)."""
    return n * (F32_COLS + I32_COLS) + CAM_COLS + LIGHT_COLS + n_tex * TEX_META_COLS


def split_words(out: torch.Tensor, n: int, n_tex: int):
    """The pack's int32 words ``out`` as its four tables and the meta rows
    (None for ``n_tex`` 0), views of ``out``: f32 table, camera and light,
    then the i32 table and the meta rows."""
    nf = n * F32_COLS
    head = nf + CAM_COLS + LIGHT_COLS
    f32, i32 = out[:head].view(torch.float32), out[head:]
    tables = (f32[:nf].view(n, F32_COLS), i32[:n * I32_COLS].view(n, I32_COLS),
              f32[nf:nf + CAM_COLS].view(1, CAM_COLS), f32[nf + CAM_COLS:].view(1, LIGHT_COLS))
    return tables, (i32[n * I32_COLS:].view(n_tex, TEX_META_COLS) if n_tex else None)


def word_pointers(out: torch.Tensor, n: int):
    """The addresses of :func:`split_words`'s tables in ``out``, without
    the views: ``([f32 table, i32 table, camera, light], meta rows)``."""
    base, nf = out.data_ptr(), n * F32_COLS
    head = base + 4 * (nf + CAM_COLS + LIGHT_COLS)
    return [base, head, base + 4 * nf, base + 4 * (nf + CAM_COLS)], head + 4 * n * I32_COLS


def launch_pack(scene: Scene) -> torch.Tensor:
    """Launch the pack kernel on a CUDA scene: its words
    (:func:`pack_words`), for :func:`split_words` or :func:`word_pointers`.
    Raises ValueError on a leaf it does not take."""
    global LAUNCHES
    from ._build import load_cuda_library

    n, m, n_tex, texels = sizes(scene)
    ptrs = leaf_pointers(scene)
    dev = scene.device
    out = torch.empty(pack_words(n, n_tex), dtype=torch.int32, device=dev)
    lib = load_cuda_library("pack_scene")
    rc = lib.rt_pack_scene(ptrs.buffer_info()[0], n, m, n_tex, texels, out.data_ptr(),
                           dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rt_pack_scene launch failed: {lib.rt_error_string(rc).decode()}")
    LAUNCHES += 1
    return out


def pack_tables(scene: Scene):
    """:func:`pack_scene`'s four tables (f32 ``(N, 19)``, i32 ``(N, 4)``,
    camera ``(1, 8)``, light ``(1, 4)``) and the texture meta rows ``(T,
    4)`` (None untextured), by the pack kernel on a CUDA scene and by the
    plain versions on a CPU one. The kernel's tables are views of one
    buffer and carry no autograd graph."""
    if scene.device.type == "cpu":
        tex = pack_textures(scene)
        return pack_scene(scene), None if tex is None else tex[1]
    n, _, n_tex, _ = sizes(scene)
    return split_words(launch_pack(scene), n, n_tex)


def texture_pointers(scene: Scene, meta_ptr: int) -> list:
    """The trace kernels' texture arguments (``kernel_trace.texture_args``)
    for the scene's cached atlas (:func:`texture_atlas`) and the meta rows
    at ``meta_ptr``: null and zeros untextured."""
    bank = scene.textures
    if bank is None:
        return [None, None, 0, 0, 0]
    atlas = texture_atlas(bank.packed)
    t, hmax, wmax = atlas.shape[:3]
    return [atlas.data_ptr(), meta_ptr, t, wmax, hmax * wmax]


def texture_atlas(packed: torch.Tensor) -> torch.Tensor:
    """The atlas words of a bank's texels ``packed`` (``TextureBank.packed``,
    :func:`atlas_words`), built once and served again while
    ``packed`` is the same tensor with the same ``_version`` and
    ``data_ptr``; an entry goes when its tensor does."""
    key = id(packed)
    hit = _ATLASES.get(key)
    if (hit is not None and hit[0]() is packed and hit[1] == packed._version
            and hit[2] == packed.data_ptr()):
        return hit[3]
    atlas = atlas_words(packed)
    if hit is None:
        weakref.finalize(packed, _ATLASES.pop, key, None)
    _ATLASES[key] = (weakref.ref(packed), packed._version, packed.data_ptr(), atlas)
    return atlas


def float_leaves(scene: Scene) -> list:
    """The scene's float leaves, in the order of ``Scene.tensors()``."""
    return [t for t in scene.tensors() if t.is_floating_point()]


def split_block(block: torch.Tensor, n: int):
    """A backward kernel's ``(n+1, 20)`` block as the cotangents of
    :func:`pack_scene`'s f32 table, camera and light ``(g_f32t (n, 19),
    g_cam (1, 8), g_light (1, 4))``, zero in their pad columns."""
    zero = block.new_zeros(1)
    g_cam = torch.cat([block[n, 0:7], zero]).reshape(1, CAM_COLS)
    g_light = torch.cat([block[n, 7:10], zero]).reshape(1, LIGHT_COLS)
    return block[:n, :F32_COLS], g_cam, g_light


def pack_scene_vjp_plain(scene: Scene, table_grads) -> list:
    """Autograd of :func:`pack_scene` pulled back from the cotangents of
    its f32 table, camera and light (:func:`split_block`'s three): the
    cotangent of each of :func:`float_leaves`, zeros where the tables do not
    read it. The plain version of :func:`pack_scene_vjp`."""
    leaves = [t.detach().requires_grad_() if t.is_floating_point() else t
              for t in scene.tensors()]
    f32t, _, cam, light = pack_scene(scene.with_tensors(leaves))
    wrt = [t for t in leaves if t.requires_grad]
    with torch.enable_grad():
        grads = torch.autograd.grad((f32t, cam, light), wrt, tuple(table_grads),
                                    allow_unused=True)
    return [torch.zeros_like(t) if g is None else g for t, g in zip(wrt, grads)]


def pack_scene_vjp(scene: Scene, block: torch.Tensor) -> list:
    """The cotangents of :func:`float_leaves` of ``scene`` for a backward
    kernel's block (``(n+1, 20)`` f32: object rows of 19, then the camera's
    7 and the light's 3 in row n), as autograd of :func:`pack_scene` gives
    them, with zeros for the leaves the tables do not read (``frac``, the
    camera's ``pyr``). On a CUDA scene one launch of the pull-back kernel,
    whose results are views of one buffer; on a CPU scene
    :func:`pack_scene_vjp_plain`."""
    n, m = scene.objects.count, scene.materials.pn.shape[0]
    if scene.device.type == "cpu":
        return pack_scene_vjp_plain(scene, split_block(block, n))
    global VJP_LAUNCHES
    from ._build import load_cuda_library

    dev = scene.device
    if (block.dtype != torch.float32 or tuple(block.shape) != (n + 1, GRAD_COLS)
            or block.device != dev or not block.is_contiguous()):
        raise ValueError(f"the pull-back takes a contiguous float32 ({n + 1}, {GRAD_COLS}) "
                         f"block on {dev}, got {block.dtype} {tuple(block.shape)} on "
                         f"{block.device}")
    mat = scene.objects.mat
    if mat.dtype != torch.int32 or mat.device != dev or not mat.is_contiguous():
        raise ValueError("the pull-back takes the material indices as contiguous int32 on "
                         f"{dev}")
    leaves = float_leaves(scene)
    out = torch.empty(sum(t.numel() for t in leaves), dtype=torch.float32, device=dev)
    lib = load_cuda_library("pack_scene")
    rc = lib.rt_pack_scene_vjp(block.data_ptr(), mat.data_ptr(), n, m, out.data_ptr(),
                               dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"rt_pack_scene_vjp launch failed: "
                           f"{lib.rt_error_string(rc).decode()}")
    VJP_LAUNCHES += 1
    return split_vjp(leaves, out)


def split_vjp(leaves: list, out: torch.Tensor) -> list:
    """The pull-back's flat output (``csrc/pack_body.cuh:vjp_entry``: the
    elements of a scene's :func:`float_leaves` ``leaves`` in their order)
    as their cotangents, views of ``out`` in their shapes (a view costs the
    host microseconds, so only the scalars take one)."""
    parts = out.split([t.numel() for t in leaves])
    return [p if p.shape == t.shape else p.view(t.shape) for p, t in zip(parts, leaves)]
