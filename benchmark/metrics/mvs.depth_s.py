"""mvs.depth_s: PatchMatch's depth stage, `PatchMatchMVS.stats["depth"]`
(host clock; it ends at the sync before fusion), mean over the window's
scenes."""


def read(rec):
    vals = [s["depth"] for s in rec["stats"] if "depth" in s]
    return sum(vals) / len(vals) if vals else None
