"""K1+K2's share of its roofline: the bound of the table of each profiled
slice's last frame (``roofline.k1k2_bound_ms``) over the time of that
frame's ``fused_setup_kernel``, the slice's last."""

from benchmark import roofline

CAPTURE = ("fused_setup",)
KERNEL = "fused_setup_kernel"


def capture(store, slice_, args, kwargs, out):
    su, _, crossed = out
    store.append((slice_, roofline.k1k2_bound_ms(
        args[:5], (su.channels, su.valid, su.tile_lo, su.tile_hi, crossed),
        args[0].shape[0])))


def read(rec):
    bound = spent = 0.0
    last = rec["trace"]["last_of"]
    for slice_, b in rec["stores"]["k1k2_roofline"]:
        t = [v for k, v in last[slice_].items() if KERNEL in k] \
            if slice_ < len(last) else []
        if t:
            bound += b
            spent += t[0] * 1e3
    return bound / spent * 100.0 if spent else None
