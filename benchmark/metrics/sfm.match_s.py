"""sfm.match_s: pair matching and geometric verification,
`SfMPipeline.stats["match_time"]` (host clock), mean over the window's
scenes."""


def read(rec):
    vals = [s["match_time"] for s in rec["stats"] if "match_time" in s]
    return sum(vals) / len(vals) if vals else None
