"""sfm.device_ops: kernels, copies and sets that the profiled SfM scene put
on the device: the sparse stage's host dispatch."""


def read(rec):
    prof = rec.get("profile")
    if rec["job"] != "sfm" or not prof or prof["busy_s"] is None:
        return None
    return prof["device_ops"]
