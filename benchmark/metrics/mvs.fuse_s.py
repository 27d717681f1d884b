"""mvs.fuse_s: fusion and filter, `PatchMatchMVS.stats["fuse"] +
stats["filter"]` (host clock; each ends in a pull to the host), mean over
the window's scenes."""


def read(rec):
    vals = [s["fuse"] + s["filter"] for s in rec["stats"] if "fuse" in s]
    return sum(vals) / len(vals) if vals else None
