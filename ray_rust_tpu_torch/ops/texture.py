"""UV mapping, procedural patterns and image-texture sampling.

PyTorch counterpart of ``ray_rust_tpu/ops/texture.py``: ``get_uv``
(render.rs:220-233), the patterns (render.rs:301-314) and the Nearest and
Bilinear texture lookups with the reference's wrap arithmetic
(render.rs:249-296, blend pixelutil.rs:4-13). :func:`sample_texture_packed`
is the plain version of the trace kernel's texture fetch (K1a,
``csrc/trace_body.cuh:fetch_texture``); it is differentiable in ``u`` and
``v`` through the bilinear weights, and the u8 texels are constants.
"""

from __future__ import annotations

import torch

from ..models.material import (
    FILTER_BILINEAR,
    PATTERN_CHECKERBOARD,
    PATTERN_GRADATION,
    UVMAP_LL,
    UVMAP_YZ,
    UVMAP_ZX,
)
from ..models.vec import Color, Vec3
from ..utils.fastmath import atan2
from ..utils.modutil import fimod, fmod, imod, umod

__all__ = ["get_uv", "lookup_diffuse", "sample_texture", "sample_texture_packed"]


def get_uv(rel: Vec3, uvmap, pattern_scale, pattern_angle_scale):
    """UV of the hit relative to the object origin for all four projections,
    selected per hit by ``uvmap`` (render.rs:220-233)."""
    ps = pattern_scale
    u = rel.x / ps
    v = rel.y / ps
    u = torch.where(uvmap == UVMAP_YZ, rel.y / ps, u)
    v = torch.where(uvmap == UVMAP_YZ, rel.z / ps, v)
    u = torch.where(uvmap == UVMAP_ZX, rel.z / ps, u)
    v = torch.where(uvmap == UVMAP_ZX, rel.x / ps, v)
    u_ll = atan2(rel.z, rel.x) / pattern_angle_scale
    # sqrt has no slope at 0: where rel.x = rel.z = 0 (a hit straight above
    # or below the origin, under any map) the lat-long branch, even when
    # not selected, would carry 0 * inf = NaN into rel's gradient
    q = rel.x * rel.x + rel.z * rel.z
    r_xz = torch.where(q > 0.0, torch.sqrt(torch.where(q > 0.0, q, 1.0)), 0.0)
    v_ll = atan2(r_xz, rel.y) / pattern_angle_scale
    u = torch.where(uvmap == UVMAP_LL, u_ll, u)
    v = torch.where(uvmap == UVMAP_LL, v_ll, v)
    return u, v


def _wrap_indices(bank, tex_id, u, v):
    """Texture sizes, Nearest texel indices, Bilinear fractions and base
    indices at (u, v) (render.rs:253-296): Nearest truncates ``u*w`` toward
    zero, Bilinear floors it, and both wrap by the texture's true size."""
    tid = tex_id.long()
    w, h = bank.widths[tid], bank.heights[tid]
    wf, hf = w.to(torch.float32), h.to(torch.float32)
    nx = imod(torch.trunc(u * wf).to(torch.int32), w)
    ny = imod(torch.trunc(v * hf).to(torch.int32), h)
    fu, iu = fimod(u * wf, wf)
    fv, iv = fimod(v * hf, hf)
    return w, h, nx, ny, fu, iu, fv, iv


def _blend(fu, fv, p00, p01, p10, p11):
    """The bilinear blend in the reference's term order (pixelutil.rs:4-13)."""
    fu, fv = fu[..., None], fv[..., None]
    return ((1.0 - fu) * (1.0 - fv) * p00 + (1.0 - fu) * fv * p01
            + fu * (1.0 - fv) * p10 + fu * fv * p11)


def sample_texture(bank, tex_id, filt, u, v) -> Color:
    """Sample texture ``tex_id`` (valid rows only) of ``bank`` at (u, v),
    Nearest or Bilinear by ``filt``, with four gathers of ``bank.data``: the
    twin of the JAX package's ``_sample_texture``."""
    w, h, nx, ny, fu, iu, fv, iv = _wrap_indices(bank, tex_id, u, v)
    tid = tex_id.long()

    def texel(x, y):
        return bank.data[tid, y.long(), x.long()].to(torch.float32)

    x1, y1 = umod(iu + 1, w), umod(iv + 1, h)
    p_bi = _blend(fu, fv, texel(iu, iv), texel(iu, y1), texel(x1, iv), texel(x1, y1))
    p = torch.where((filt == FILTER_BILINEAR)[..., None], p_bi, texel(nx, ny)) / 256.0
    return Color(p[..., 0], p[..., 1], p[..., 2])


def sample_texture_packed(bank, tex_id, filt, u, v) -> Color:
    """The same sample as :func:`sample_texture` from one gather of the
    neighbourhood-packed atlas (``TextureBank.packed``), as the JAX package's
    ``sample_texture_packed``. The texel's flat index ``(tid*Hmax + iy)*Wmax
    + ix`` is clamped to the atlas, as the trace kernel clamps it (and the
    JAX kernel, ``pallas_trace.py:674``): wrapped indices are in range for
    every finite uv, and the clamp only bounds what an overflowing
    float-to-int conversion at a horizon-grazing hit would give."""
    _, _, nx, ny, fu, iu, fv, iv = _wrap_indices(bank, tex_id, u, v)
    bilin = filt == FILTER_BILINEAR
    ix = torch.where(bilin, iu, nx).long()
    iy = torch.where(bilin, iv, ny).long()
    t, hmax, wmax = bank.packed.shape[:3]
    flat = torch.clamp((tex_id.long() * hmax + iy) * wmax + ix, 0, t * hmax * wmax - 1)
    quad = bank.packed.reshape(-1, 12)[flat].to(torch.float32)
    p00, p10, p01, p11 = quad[..., 0:3], quad[..., 3:6], quad[..., 6:9], quad[..., 9:12]
    p = torch.where(bilin[..., None], _blend(fu, fv, p00, p01, p10, p11), p00) / 256.0
    return Color(p[..., 0], p[..., 1], p[..., 2])


def lookup_diffuse(scene, fields, uv) -> Color:
    """Diffuse color at a hit (render.rs:249-316): the image texture where
    the hit's material has one, else its procedural pattern: checkerboard
    black where floor(u)+floor(v) is even, repeated gradation scales red by
    frac(u) and green by frac(v)."""
    u, v = uv
    diffuse = fields.diffuse
    pattern = fields.pattern

    ix = torch.floor(u).to(torch.int32)
    iy = torch.floor(v).to(torch.int32)
    black = (pattern == PATTERN_CHECKERBOARD) & (torch.remainder(ix + iy, 2) == 0)
    col = Color(*(torch.where(black, 0.0, c) for c in diffuse))
    grad = Color(diffuse.r * fmod(u, 1.0), diffuse.g * fmod(v, 1.0), diffuse.b)
    col = grad.where(pattern == PATTERN_GRADATION, col)
    if scene.textures is not None:
        tid = fields.texture_id
        tex_col = sample_texture_packed(scene.textures, torch.clamp(tid, min=0),
                                        fields.texture_filter, u, v)
        col = tex_col.where(tid >= 0, col)
    return col
