"""Near-plane clipping with static shapes (counterpart of
``tyleri_tpu/ops/clip.py``).

Vulkan clips against z_c >= 0.  Triangles wholly in front are left alone;
per-pixel z tests reproduce the far and side planes.  A crossing triangle is

  #inside | result
  --------+--------------------------------------------
     3    | unchanged
     2    | quad -> the in-place triangle + ONE extra triangle
     1    | clipped triangle, rewritten in place
     0    | culled

Crossers are compacted into ``extra_cap`` work slots; crossers beyond that
capacity are culled and counted as overflow, never drawn unclipped.  Both
halves of a split keep the parent's draw order.  Attributes interpolate
linearly in clip space, as in the oracle's Sutherland-Hodgman clip.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class ClippedTriangles(NamedTuple):
    clip: torch.Tensor       # f32 [T + X, 3, 4]
    uv: torch.Tensor         # f32 [T + X, 3, 2]
    tex_id: torch.Tensor     # i32 [T + X]
    valid: torch.Tensor      # bool [T + X]
    order: torch.Tensor      # i32 [T + X] original draw order
    overflow: torch.Tensor   # i32 [] crossers culled for capacity
    crossings: torch.Tensor  # i32 [] near-plane crossings seen


def _rot1(a):
    return torch.cat([a[:, 1:3], a[:, 0:1]], dim=1)


def _rot2(a):
    return torch.cat([a[:, 2:3], a[:, 0:2]], dim=1)


def clip_work_set(cr0, ur0):
    """Rotate/lerp core of the near clip on X work slots (cr0 [X, 3, 4],
    ur0 [X, 3, A]).  Returns (main_c, main_u, extra_c, extra_u, n_in): the
    in-place rewritten triangle, the quad's second half (meaningful when
    n_in == 2) and the inside count per slot."""
    ins = cr0[..., 2] >= 0.0
    nin = ins.to(torch.int32).sum(dim=1)
    # canonical rotation, winding kept: n_in == 1 puts the inside vertex at
    # slot 0, n_in == 2 the outside vertex at slot 2
    ins_idx = torch.argmax(ins.to(torch.int32), dim=1)
    out_idx = torch.argmax((~ins).to(torch.int32), dim=1)
    r = torch.where(nin == 1, ins_idx, (out_idx + 1) % 3)
    sel1 = (r == 1)[:, None, None]
    sel2 = (r == 2)[:, None, None]

    def rotate(a):
        return torch.where(sel1, _rot1(a), torch.where(sel2, _rot2(a), a))

    cr = rotate(cr0)
    ur = rotate(ur0)
    sr = cr[..., 2]

    def lerp_vertex(a, b):
        """Intersection of edge a -> b with the z_c = 0 plane."""
        sa, sb = sr[:, a], sr[:, b]
        diff = sb - sa
        denom = torch.where(diff == 0, torch.ones_like(diff), diff)
        t = torch.clamp((0.0 - sa) / denom, 0.0, 1.0)[:, None]
        c = cr[:, a] + t * (cr[:, b] - cr[:, a])
        u = ur[:, a] + t * (ur[:, b] - ur[:, a])
        return c, u

    i01c, i01u = lerp_vertex(0, 1)
    i12c, i12u = lerp_vertex(1, 2)
    i20c, i20u = lerp_vertex(2, 0)

    is1 = (nin == 1)[:, None, None]
    main_c = torch.where(is1, torch.stack([cr[:, 0], i01c, i20c], dim=1),
                         torch.stack([cr[:, 0], cr[:, 1], i12c], dim=1))
    main_u = torch.where(is1, torch.stack([ur[:, 0], i01u, i20u], dim=1),
                         torch.stack([ur[:, 0], ur[:, 1], i12u], dim=1))
    extra_c = torch.stack([cr[:, 0], i12c, i20c], dim=1)
    extra_u = torch.stack([ur[:, 0], i12u, i20u], dim=1)
    return main_c, main_u, extra_c, extra_u, nin


def compact_slots(mask: torch.Tensor, X: int):
    """Slot k of X holds the row of the k-th set entry of ``mask`` (inverse
    lookup by binary search, no scatter).  Returns (src clamped to a valid
    row, live [X] bool, count i32 [])."""
    T = mask.shape[0]
    cum = torch.cumsum(mask.to(torch.int32), dim=0, dtype=torch.int32)
    count = cum[-1] if T > 0 else torch.zeros((), dtype=torch.int32,
                                               device=mask.device)
    want = torch.arange(1, X + 1, dtype=torch.int32, device=mask.device)
    src = torch.searchsorted(cum, want, side="left").to(torch.int32)
    live = src < T
    return torch.clamp(src, 0, max(T - 1, 0)).long(), live, count


def scatter_rows(table: torch.Tensor, rows, live, values):
    """table[rows[k]] = values[k] for live slots only (a copy)."""
    T = table.shape[0]
    pad = torch.zeros((1, *table.shape[1:]), dtype=table.dtype,
                      device=table.device)
    out = torch.cat([table, pad])
    out[torch.where(live, rows, T)] = values
    return out[:T]


def near_clip_triangles(clip, uv, tex_id, valid, *, extra_cap: int
                        ) -> ClippedTriangles:
    T = clip.shape[0]
    X = extra_cap
    dev = clip.device
    order = torch.arange(T, dtype=torch.int32, device=dev)
    n_in = (clip[..., 2] >= 0.0).to(torch.int32).sum(dim=1)
    needs = valid & (n_in > 0) & (n_in < 3)
    src_c, live, n_needs = compact_slots(needs, X)

    main_c, main_u, extra_c, extra_u, nin = clip_work_set(clip[src_c],
                                                          uv[src_c])
    clip_out = scatter_rows(clip, src_c, live, main_c)
    uv_out = scatter_rows(uv, src_c, live, main_u)

    xv = live & (nin == 2)
    xt = torch.where(xv, tex_id[src_c], torch.zeros_like(tex_id[src_c]))
    ncum = torch.cumsum(needs.to(torch.int32), dim=0)
    processed = needs & (ncum <= X)
    main_valid = valid & (n_in > 0) & (~needs | processed)
    overflow = torch.clamp(n_needs - X, min=0)
    return ClippedTriangles(
        clip=torch.cat([clip_out, extra_c]),
        uv=torch.cat([uv_out, extra_u]),
        tex_id=torch.cat([tex_id, xt]),
        valid=torch.cat([main_valid, xv]),
        order=torch.cat([order, order[src_c]]),
        overflow=overflow.to(torch.int32),
        crossings=n_needs.to(torch.int32),
    )


def near_cull_triangles(clip, uv, tex_id, valid, *, extra_cap: int
                        ) -> ClippedTriangles:
    """The clip-skip path: crossers are culled whole and counted (reported
    as overflow, so the frame plan re-enables clipping).  Shapes match
    near_clip_triangles, with ``extra_cap`` dead rows."""
    T = clip.shape[0]
    X = extra_cap
    dev = clip.device
    n_in = (clip[..., 2] >= 0.0).to(torch.int32).sum(dim=1)
    needs = valid & (n_in > 0) & (n_in < 3)
    n_needs = needs.to(torch.int32).sum().to(torch.int32)
    return ClippedTriangles(
        clip=torch.cat([clip, clip.new_zeros((X, 3, 4))]),
        uv=torch.cat([uv, uv.new_zeros((X, *uv.shape[1:]))]),
        tex_id=torch.cat([tex_id, tex_id.new_zeros((X,))]),
        valid=torch.cat([valid & (n_in == 3),
                         torch.zeros((X,), dtype=torch.bool, device=dev)]),
        order=torch.arange(T + X, dtype=torch.int32, device=dev),
        overflow=n_needs,
        crossings=n_needs,
    )
