"""device.idle_share.sfm: 100 x (1 - the device's busy time in the profiled
SfM scene / the wall time of the same capture's unprofiled scene in the
window)."""


def read(rec):
    prof = rec.get("profile")
    if rec["job"] != "sfm" or not prof or prof["busy_s"] is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / rec["unprofiled_wall_s"])
