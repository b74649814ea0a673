"""K3's share of its roofline, base variant only: the bound of each
profiled slice's last frame's table (``roofline.k3_bound_ms``, with the
rows visited counted by K3's counts variant rerun once on that table after
the window) over the time of that frame's ``visibility_kernel``, the
slice's last.  The counts variant rejects peel2, so a peel2 frame has
none."""

from benchmark import roofline

CAPTURE = ("rasterize_visibility",)
KERNEL = "visibility_kernel"


def capture(store, slice_, args, kwargs, out):
    if kwargs.get("peel2"):
        return
    store.append([slice_, args, kwargs, None])


def after(store, rec):
    """The visits of each captured table, then the tables go."""
    from tyleri_tpu_torch.ops import raster_cuda

    for item in store:
        _, (binned, depth0, scissor), kw, _ = item
        kw = {k: v for k, v in kw.items() if k != "peel2"}
        _, nvis = raster_cuda.rasterize_visibility(binned, depth0, scissor,
                                                   counts=True, **kw)
        item[3] = roofline.k3_bound_ms(binned, depth0, int(nvis.sum()),
                                       kw["tile_w"] * kw["tile_h"])
        item[1] = item[2] = None


def read(rec):
    bound = spent = 0.0
    last = rec["trace"]["last_of"]
    for slice_, _, _, b in rec["stores"]["k3_roofline"]:
        t = [v for k, v in last[slice_].items() if KERNEL in k] \
            if slice_ < len(last) else []
        if t and b:
            bound += b
            spent += t[0] * 1e3
    return bound / spent * 100.0 if spent else None
