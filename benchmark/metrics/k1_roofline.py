"""k1_roofline: K1's share of its roofline in the profiled dense scene: the
least time of its launches (whole planes read once, at each launch's
shape, `roofline.k1_bound_s`) over its device time (the kernels whose name
holds `tent_warp`), in percent."""

from benchmark import roofline


def read(rec):
    prof = rec.get("profile")
    shapes = rec.get("k1_by_shape") or {}
    if rec["job"] != "mvs" or not prof or not shapes:
        return None
    busy = sum(s for name, (s, _) in prof["ops"].items() if "tent_warp" in name)
    if busy <= 0:
        return None
    return 100.0 * roofline.k1_bound_total_s(shapes) / busy
