"""sfm.final_ba_s: the final bundle adjustment, recovery and rescue,
`SfMPipeline.stats["final_ba_time"]` (host clock), mean over the window's
scenes."""


def read(rec):
    vals = [s["final_ba_time"] for s in rec["stats"] if "final_ba_time" in s]
    return sum(vals) / len(vals) if vals else None
