"""mvs.device_ops: kernels, copies and sets that the profiled dense scene
put on the device: PatchMatch's host dispatch."""


def read(rec):
    prof = rec.get("profile")
    if rec["job"] != "mvs" or not prof or prof["busy_s"] is None:
        return None
    return prof["device_ops"]
