"""How far global SfM's result moves from run to run on the card, against
chip_smoke.py's gates for it.

    python3 scripts/global_sfm_spread.py [--runs 8] [--cli-runs 3]

The north-star PNGs of chip_smoke.py with the scene's K: `--runs` warm
runs of SfMPipeline.reconstruct_global, then `--cli-runs` runs of the CLI's
`IMAGES --global-sfm --mvs`. One line each with the cameras, the mean
reprojection error and the similarity-aligned pose errors
(tests/torch_scene.pose_errors), the CLI runs with their dense cloud in the
scene's frame; then one JSON line with the range of each against
GLOBAL_SFM_GATE and GLOBAL_DENSE_GATE. The result moves because the
matcher's RANSAC draws and the card's summation order do, and the
averaged arc is ill-conditioned on this scene (the JAX reference itself
misshapes it).
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402  (binds the name `tests` to the repo's tests/)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--cli-runs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("global_sfm_spread: needs an NVIDIA GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = cs.card_line()
    runs, cli = [], []
    with tempfile.TemporaryDirectory(prefix="global_spread_") as tmp:
        work = Path(tmp)
        scene = cs.render_north_star(work)
        for r in range(args.runs):
            pipe = cs.sparse_pipeline(work)
            pipe.reconstruct_global(str(work / "images"))
            runs.append({"num_cameras": len(pipe.registered),
                         "mean_reproj_px": pipe.stats["mean_reproj_px"],
                         **cs.pose_errors(pipe.poses, scene)})
            print(f"[run {r}] " + json.dumps(runs[-1]), flush=True)
        for r in range(args.cli_runs):
            out = cs.cli_sparse_run(work, scene, card, f"global_cli_{r}", ["--global-sfm"])
            cli.append({"num_cameras": out["num_cameras"],
                        "mean_reproj_px": out["mean_reproj_px"], **out["pose_errors"],
                        "dense_median": out["dense_median"], "dense_share": out["dense_share"]})
            print(f"[cli {r}] " + json.dumps(cli[-1]), flush=True)
    both = runs + cli
    span = {k: [min(x[k] for x in both), max(x[k] for x in both)]
            for k in ("num_cameras", "mean_reproj_px", "mean_rot_err_deg", "mean_center_err")}
    span.update({k: [min(x[k] for x in cli), max(x[k] for x in cli)]
                 for k in ("dense_median", "dense_share")} if cli else {})
    print(json.dumps({"card": card, "runs": len(runs), "cli_runs": len(cli), "range": span,
                      "gate": cs.GLOBAL_SFM_GATE, "dense_gate": cs.GLOBAL_DENSE_GATE}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
