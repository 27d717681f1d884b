"""sfm.register_s: the SfM registration's initial pair, PnP waves, triangulation
and light BA, `SfMPipeline.stats["init_time"] + stats["incremental_time"]`
(host clock), mean over the window's scenes."""


def read(rec):
    vals = [s["init_time"] + s["incremental_time"] for s in rec["stats"]
            if "incremental_time" in s]
    return sum(vals) / len(vals) if vals else None
