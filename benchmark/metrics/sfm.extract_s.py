"""sfm.extract_s: feature extraction, `SfMPipeline.stats["extract_time"]`
(host clock; it ends in the keypoints' pull to the host), mean over the
window's scenes."""


def read(rec):
    vals = [s["extract_time"] for s in rec["stats"] if "extract_time" in s]
    return sum(vals) / len(vals) if vals else None
