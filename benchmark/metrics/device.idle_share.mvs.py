"""device.idle_share.mvs: 100 x (1 - the device's busy time in the profiled
dense scene / the wall time of the same capture's unprofiled scene in the
window): the share of a scene in which the card waits for the host."""


def read(rec):
    prof = rec.get("profile")
    if rec["job"] != "mvs" or not prof or prof["busy_s"] is None:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / rec["unprofiled_wall_s"])
