"""The plain reference: the frame a configuration's pipeline states, drawn
from the benchmark's own scene data in plain PyTorch, in float64.

It follows the Vulkan rules the renderer re-creates (the numpy oracle of
the renderer's tests states the same rules triangle by triangle; this is
that arithmetic, vectorized over every (triangle, pixel) pair so that a
million triangles at 1080p take seconds on the card):

* vertex stage ``clip = projection @ view @ model @ [pos, 1]``;
* clipping against the near plane (z >= 0), fan-triangulated, linear
  attributes in clip space; the far plane and the depth range by
  discarding fragments with z outside [0, 1]; no other plane changes
  coverage, so none other is clipped;
* viewport transform, y down, pixel centres at +0.5, the top-left fill
  rule, no culling;
* window-space depth, D16 (``round(z * 65535)``), LESS_OR_EQUAL: the
  winner of a pixel is the fragment of least quantized depth, the latest
  drawn among equals;
* perspective-correct uv, bilinear sampling with mirrored repeat;
* the blend of the configuration's pipeline state.  The mesh pass blends
  its winner over the incoming colour, and with two layers first the
  fragment that held the depth record just before the winner drew (the
  last two steps of the draw-order blend chain); the UI overlay is drawn
  first, triangle by triangle in order at z = 0, with its own blend;
* UNORM8 presentation, round half to even, alpha 255 (opaque).

It imports nothing of the program and takes nothing the program made:
the scene arrays come from the benchmark's generators.  ``precision``
"bf16" rounds the vertex stage's clip coordinates and uvs to bfloat16: the
control that a check must fail.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import math3d

F64 = torch.float64
D16 = 65535.0
_ORDER_BITS = 32
_NO_KEY = torch.iinfo(torch.int64).max
# (triangle, pixel) pairs evaluated at a time
PAIRS_PER_CHUNK = 1 << 23


def _factor(name, s, d, sa, da):
    one = torch.ones_like(s)
    return {
        "ZERO": torch.zeros_like(s), "ONE": one,
        "SRC_COLOR": s, "ONE_MINUS_SRC_COLOR": 1 - s,
        "DST_COLOR": d, "ONE_MINUS_DST_COLOR": 1 - d,
        "SRC_ALPHA": sa * one, "ONE_MINUS_SRC_ALPHA": (1 - sa) * one,
        "DST_ALPHA": da * one, "ONE_MINUS_DST_ALPHA": (1 - da) * one,
    }[name]


def blend(state: dict, src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Vulkan's blend of src over dst ([..., 4] rgba) with an ADD colour
    and alpha op; ``state`` holds the four factors by their Vulkan names."""
    sa, da = src[..., 3:4], dst[..., 3:4]
    rgb = (src[..., :3] * _factor(state["src_color"], src[..., :3],
                                  dst[..., :3], sa, da)
           + dst[..., :3] * _factor(state["dst_color"], src[..., :3],
                                    dst[..., :3], sa, da))
    a = (sa * _factor(state["src_alpha"], sa, da, sa, da)
         + da * _factor(state["dst_alpha"], sa, da, sa, da))
    return torch.clamp(torch.cat([rgb, a], dim=-1), 0.0, 1.0)


class Textures:
    """Every texture of a frame in one flat texel table."""

    def __init__(self, textures, device):
        offs, off = [], 0
        for t in textures:
            offs.append(off)
            off += t.shape[0] * t.shape[1]
        self.texels = torch.cat([torch.as_tensor(t, dtype=F64).reshape(-1, 4)
                                 for t in textures]).to(device)
        self.off = torch.tensor(offs, dtype=torch.long, device=device)
        self.w = torch.tensor([t.shape[1] for t in textures], device=device)
        self.h = torch.tensor([t.shape[0] for t in textures], device=device)

    def sample(self, tex, u, v):
        """Bilinear, mirrored repeat, no mips; tex long [P], u, v f64 [P]."""
        w, h = self.w[tex], self.h[tex]
        tu = u * w - 0.5
        tv = v * h - 0.5
        iu0 = torch.floor(tu).long()
        iv0 = torch.floor(tv).long()
        fu = (tu - iu0)[:, None]
        fv = (tv - iv0)[:, None]

        def mirror(i, n):
            m = torch.remainder(i, 2 * n)
            return torch.where(m >= n, 2 * n - 1 - m, m)

        def texel(iv, iu):
            return self.texels[self.off[tex] + mirror(iv, h) * w
                               + mirror(iu, w)]

        top = texel(iv0, iu0) * (1 - fu) + texel(iv0, iu0 + 1) * fu
        bot = texel(iv0 + 1, iu0) * (1 - fu) + texel(iv0 + 1, iu0 + 1) * fu
        return top * (1 - fv) + bot * fv


def vertex_stage(scene, view, device, precision="f64"):
    """Clip-space triangles of one frame's draws in submission order:
    clip f64 [T, 3, 4], uv [T, 3, 2], texture long [T], draw order long
    [T] (the triangle's place in the frame)."""
    w, h = scene.resolution
    proj = math3d.perspective_rh(np.radians(view.fov_deg), w / h,
                                 view.z_near, view.z_far)
    vp = (torch.as_tensor(proj, dtype=F64)
          @ torch.as_tensor(view.view, dtype=F64)).to(device)
    clips, uvs, texs = [], [], []
    for d in view.draws:
        mesh = scene.meshes[d.mesh]
        pos = torch.as_tensor(mesh.positions, dtype=F64, device=device)
        pos = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
        mvp = vp @ torch.as_tensor(d.model, dtype=F64, device=device)
        idx = torch.as_tensor(mesh.indices.astype(np.int64),
                              device=device).reshape(-1, 3)
        clips.append((pos @ mvp.T)[idx])
        uvs.append(torch.as_tensor(mesh.uvs, dtype=F64, device=device)[idx])
        texs.append(torch.full((idx.shape[0],), d.texture, dtype=torch.long,
                               device=device))
    clip, uv = torch.cat(clips), torch.cat(uvs)
    if precision == "bf16":
        clip = clip.to(torch.bfloat16).to(F64)
        uv = uv.to(torch.bfloat16).to(F64)
    elif precision != "f64":
        raise ValueError(f"unknown precision {precision!r}")
    order = torch.arange(clip.shape[0], device=device)
    return clip, uv, torch.cat(texs), order


def near_clip(clip, attrs, tex, order):
    """Clip against z >= 0 (Sutherland-Hodgman, one plane): a triangle with
    one corner inside becomes one triangle, with two a fan of two; both
    keep the parent's draw order.  Triangles wholly outside go."""
    inside = clip[..., 2] >= 0
    n_in = inside.sum(dim=1)
    keep = n_in == 3
    out = [(clip[keep], attrs[keep], tex[keep], order[keep])]
    for k in (1, 2):
        sel = n_in == k
        if not bool(sel.any()):
            continue
        c, a, i = clip[sel], attrs[sel], inside[sel]
        # rotate (cyclic order kept) so that the inside corners come first
        first = (torch.argmax(i.long(), dim=1) if k == 1
                 else torch.argmin(i.long(), dim=1) + 1)
        rot = (first[:, None] + torch.arange(3, device=c.device)) % 3
        c = torch.gather(c, 1, rot[..., None].expand(-1, -1, c.shape[2]))
        a = torch.gather(a, 1, rot[..., None].expand(-1, -1, a.shape[2]))
        v = torch.cat([c, a], dim=2)
        d = c[..., 2]

        def cut(p, q):   # p inside, q outside: p + t (q - p)
            t = (d[:, p] / (d[:, p] - d[:, q]))[:, None]
            return v[:, p] + t * (v[:, q] - v[:, p])

        if k == 1:
            tris = [torch.stack([v[:, 0], cut(0, 1), cut(0, 2)], dim=1)]
        else:
            p12, p02 = cut(1, 2), cut(0, 2)
            tris = [torch.stack([v[:, 0], v[:, 1], p12], dim=1),
                    torch.stack([v[:, 0], p12, p02], dim=1)]
        for t in tris:
            out.append((t[..., :4], t[..., 4:], tex[sel], order[sel]))
    return tuple(torch.cat(parts) for parts in zip(*out))


class Setup:
    """Screen-space triangles with their pixel boxes on a W x H target."""

    def __init__(self, clip, attrs, tex, order, W, H):
        w = clip[..., 3]
        sx = (clip[..., 0] / w * 0.5 + 0.5) * W
        sy = (clip[..., 1] / w * 0.5 + 0.5) * H
        sz = clip[..., 2] / w
        area2 = ((sx[:, 1] - sx[:, 0]) * (sy[:, 2] - sy[:, 0])
                 - (sy[:, 1] - sy[:, 0]) * (sx[:, 2] - sx[:, 0]))
        x0 = torch.clamp(torch.floor(sx.amin(1)), min=0)
        x1 = torch.clamp(torch.ceil(sx.amax(1)) + 1, max=W)
        y0 = torch.clamp(torch.floor(sy.amin(1)), min=0)
        y1 = torch.clamp(torch.ceil(sy.amax(1)) + 1, max=H)
        bw = torch.clamp(x1 - x0, min=0)
        bh = torch.clamp(y1 - y0, min=0)
        live = (area2 != 0) & (w > 0).all(1) & (bw > 0) & (bh > 0)
        self.W, self.H = W, H
        self.sx, self.sy, self.sz = sx[live], sy[live], sz[live]
        self.inv_w = 1.0 / w[live]
        self.attrs = attrs[live]
        self.tex, self.order = tex[live], order[live]
        self.area2 = area2[live]
        self.sgn = torch.where(self.area2 > 0, 1.0, -1.0).to(F64)
        self.x0, self.y0 = x0[live].long(), y0[live].long()
        self.bw = bw[live].long()
        self.count = self.bw * bh[live].long()

    def __len__(self):
        return int(self.count.shape[0])

    def chunks(self, limit=PAIRS_PER_CHUNK):
        """Ranges [a, b) of triangles with at most ``limit`` pairs each (a
        single larger triangle forms its own range)."""
        ends = torch.cumsum(self.count, 0).cpu().numpy()
        a, n = 0, len(ends)
        while a < n:
            base = ends[a - 1] if a else 0
            b = int(np.searchsorted(ends, base + limit, side="right"))
            b = max(b, a + 1)
            yield a, b
            a = b

    def fragments(self, a, b):
        """The covered, in-range fragments of triangles [a, b): (triangle
        index, pixel index, barycentrics [P, 3], D16 depth as long)."""
        cnt = self.count[a:b]
        dev = cnt.device
        tri = torch.repeat_interleave(torch.arange(a, b, device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        local = torch.arange(tri.shape[0], device=dev) - start[tri - a]
        bw = self.bw[tri]
        px = self.x0[tri] + local % bw
        py = self.y0[tri] + local // bw
        fx, fy = px.to(F64) + 0.5, py.to(F64) + 0.5
        sx, sy, sgn = self.sx[tri], self.sy[tri], self.sgn[tri]
        area = self.area2[tri] * sgn
        cov = torch.ones_like(fx, dtype=torch.bool)
        lam = []
        for i in range(3):
            ia, ib = (i + 1) % 3, (i + 2) % 3
            dx = sx[:, ib] - sx[:, ia]
            dy = sy[:, ib] - sy[:, ia]
            e = ((fy - sy[:, ia]) * dx - (fx - sx[:, ia]) * dy) * sgn
            edx, edy = dx * sgn, dy * sgn
            top_left = (edy < 0) | ((edy == 0) & (edx > 0))
            cov &= torch.where(top_left, e >= 0, e > 0)
            lam.append(e / area)
        lam = torch.stack(lam, dim=1)
        z = (lam * self.sz[tri]).sum(1)
        cov &= (z >= 0) & (z <= 1)
        zq = torch.round(z * D16).long()
        return (tri[cov], (py * self.W + px)[cov], lam[cov], zq[cov])

    def attributes(self, tri, lam):
        """Perspective-correct attributes at the fragments."""
        lw = lam * self.inv_w[tri]
        return (lw[..., None] * self.attrs[tri]).sum(1) / lw.sum(1)[:, None]


def _resolve(su: Setup, init_q, select=None):
    """Per pixel the best fragment key: least D16 depth, then the latest
    draw order; only fragments that pass LESS_OR_EQUAL against ``init_q``
    and, with ``select(order, pix)``, those it keeps."""
    best = torch.full_like(init_q, _NO_KEY)
    for a, b in su.chunks():
        tri, pix, _, zq = su.fragments(a, b)
        order = su.order[tri]
        keep = zq <= init_q[pix]
        if select is not None:
            keep &= select(order, pix)
        key = (zq << _ORDER_BITS) | ((1 << _ORDER_BITS) - 1 - order)
        best.scatter_reduce_(0, pix[keep], key[keep], reduce="amin")
    return best


def _shade(su: Setup, best, textures: Textures):
    """The colour of each pixel's best fragment (rows where it has one)."""
    color = torch.zeros((best.shape[0], 4), dtype=F64, device=best.device)
    for a, b in su.chunks():
        tri, pix, lam, zq = su.fragments(a, b)
        key = (zq << _ORDER_BITS) | ((1 << _ORDER_BITS) - 1 - su.order[tri])
        won = key == best[pix]
        tri, pix, lam = tri[won], pix[won], lam[won]
        uv = su.attributes(tri, lam)
        color[pix] = textures.sample(su.tex[tri], uv[:, 0], uv[:, 1])
    return color


def mesh_pass(su: Setup, textures, state, color, init_q, layers: int):
    """The mesh pass over ``color`` [H*W, 4] with incoming depth ``init_q``
    (D16 as long): its winners blended over the incoming colour, with two
    layers the record holder before each winner first."""
    best = _resolve(su, init_q)
    has = best != _NO_KEY
    if layers == 2:
        win_order = (1 << _ORDER_BITS) - 1 - (best & ((1 << _ORDER_BITS) - 1))
        win_order = torch.where(has, win_order, -1)
        best2 = _resolve(su, init_q,
                         select=lambda order, pix: order < win_order[pix])
        has2 = best2 != _NO_KEY
        second = _shade(su, best2, textures)
        color = torch.where(has2[:, None], blend(state, second, color), color)
    elif layers != 1:
        raise ValueError(f"layers {layers}: the pass blends one or two")
    winner = _shade(su, best, textures)
    return torch.where(has[:, None], blend(state, winner, color), color)


def ui_pass(overlay, textures: Textures, state, W, H, device):
    """The overlay over the clear colour, triangle by triangle in element
    order, at z = 0: (colour [H*W, 4], D16 depth as long [H*W])."""
    color = torch.zeros((H * W, 4), dtype=F64, device=device)
    depth = torch.full((H * W,), int(D16), dtype=torch.long, device=device)
    sw, sh = W / overlay.scale_factor, H / overlay.scale_factor
    for verts, idx, tex in overlay.elements:
        v = torch.as_tensor(verts, dtype=F64, device=device)
        tri = torch.as_tensor(idx.astype(np.int64), device=device).reshape(
            -1, 3)
        p = v[tri]                                   # [T, 3, 8]
        clip = torch.stack([2 * p[..., 0] / sw - 1, 2 * p[..., 1] / sh - 1,
                            torch.zeros_like(p[..., 0]),
                            torch.ones_like(p[..., 0])], dim=-1)
        n = clip.shape[0]
        su = Setup(clip, p[..., 2:8],
                   torch.full((n,), tex, dtype=torch.long, device=device),
                   torch.arange(n, device=device), W, H)
        for t in range(len(su)):
            _, pix, lam, zq = su.fragments(t, t + 1)
            keep = zq <= depth[pix]
            pix, lam = pix[keep], lam[keep]
            at = su.attributes(torch.full_like(pix, t), lam)
            frag = textures.sample(su.tex[t].expand_as(pix), at[:, 0],
                                   at[:, 1]) * at[:, 2:6]
            color[pix] = blend(state, frag, color[pix])
            depth[pix] = zq[keep]
    return color, depth


def render(scene, view, config: dict, device, overlay=None,
           precision="f64") -> np.ndarray:
    """The presented u8 image [H, W, 4] of one frame."""
    W, H = scene.resolution
    pipe = config["pipeline"]
    if overlay is not None:
        color, init_q = ui_pass(
            overlay, Textures(overlay.textures, device), pipe["ui_blend"],
            W, H, device)
    else:
        color = torch.zeros((H * W, 4), dtype=F64, device=device)
        init_q = torch.full((H * W,), int(D16), dtype=torch.long,
                            device=device)
    clip, uv, tex, order = vertex_stage(scene, view, device, precision)
    su = Setup(*near_clip(clip, uv, tex, order), W, H)
    color = mesh_pass(su, Textures(scene.textures, device),
                      pipe["mesh_blend"], color, init_q, pipe["blend_layers"])
    u8 = torch.clamp(torch.round(color * 255.0), 0, 255).to(torch.uint8)
    u8[:, 3] = 255
    return u8.reshape(H, W, 4).cpu().numpy()
