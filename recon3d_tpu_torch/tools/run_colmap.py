"""Optional external-COLMAP wrapper (PyTorch port of
recon3d_tpu/tools/run_colmap.py).

Capability parity with reference src/tools/run_colmap.py (:11-265): find the
colmap binary, stage a clean image directory, and drive the 5-stage pipeline
(feature_extractor -> exhaustive_matcher -> mapper -> model_converter ->
[image_undistorter -> patch_match_stereo -> stereo_fusion]) via subprocess,
with low/medium/high quality presets. This is an integration with an
external tool, kept for workflow parity — the framework's own pipeline
(recon3d_tpu_torch.cli) is the native path.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional

IMAGE_EXTS = {".jpg", ".jpeg", ".png", ".bmp", ".tiff", ".tif"}

QUALITY_SETTINGS: Dict[str, Dict] = {
    "low": {"max_image_size": 1000, "max_num_features": 4096},
    "medium": {"max_image_size": 1600, "max_num_features": 8192},
    "high": {"max_image_size": 3200, "max_num_features": 16384},
}


def find_colmap() -> Optional[str]:
    """Locate the colmap binary (reference run_colmap.py:11-29): on PATH,
    else in /usr/local/bin."""
    p = shutil.which("colmap")
    if p:
        return p
    cand = Path("/usr/local/bin/colmap")
    return str(cand) if cand.exists() else None


def _stage_images(image_dir: Path, clean: Path) -> int:
    clean.mkdir(parents=True, exist_ok=True)
    n = 0
    for f in sorted(image_dir.iterdir()):
        if f.is_file() and f.suffix.lower() in IMAGE_EXTS:
            shutil.copy2(f, clean / f.name)
            n += 1
    return n


def build_stage_commands(
    colmap: str,
    output: Path,
    use_gpu: bool,
    quality: str,
    dense: bool,
) -> List[List[str]]:
    """The full command chain (reference :111-203), returned for dry runs."""
    settings = QUALITY_SETTINGS.get(quality, QUALITY_SETTINGS["medium"])
    db = output / "database.db"
    images = output / "images"
    sparse = output / "sparse"
    dense_p = output / "dense"

    feature = [
        colmap, "feature_extractor",
        "--database_path", str(db),
        "--image_path", str(images),
        "--ImageReader.single_camera", "1",
        "--ImageReader.camera_model", "SIMPLE_RADIAL",
        "--SiftExtraction.max_num_features", str(settings["max_num_features"]),
    ]
    match = [colmap, "exhaustive_matcher", "--database_path", str(db)]
    if not use_gpu:
        feature += ["--SiftExtraction.use_gpu", "0"]
        match += ["--SiftMatching.use_gpu", "0"]
    cmds = [
        feature,
        match,
        [colmap, "mapper", "--database_path", str(db),
         "--image_path", str(images), "--output_path", str(sparse)],
        [colmap, "model_converter", "--input_path", str(sparse / "0"),
         "--output_path", str(output / "sparse.ply"), "--output_type", "PLY"],
    ]
    if dense:
        cmds += [
            [colmap, "image_undistorter", "--image_path", str(images),
             "--input_path", str(sparse / "0"), "--output_path", str(dense_p),
             "--max_image_size", str(settings["max_image_size"])],
            [colmap, "patch_match_stereo", "--workspace_path", str(dense_p),
             "--PatchMatchStereo.geom_consistency", "true"],
            [colmap, "stereo_fusion", "--workspace_path", str(dense_p),
             "--StereoFusion.min_num_pixels", "3",
             "--output_path", str(output / "dense.ply")],
        ]
    return cmds


def run_colmap_reconstruction(
    image_dir: str,
    output_dir: str,
    use_gpu: bool = True,
    quality: str = "medium",
    dense: bool = True,
) -> bool:
    """Stage images and run the COLMAP chain (reference :32-233)."""
    colmap = find_colmap()
    if not colmap:
        print(
            "COLMAP NOT FOUND. Install it, or use the native pipeline: "
            "python -m recon3d_tpu_torch.cli"
        )
        return False

    output = Path(output_dir)
    if output.exists():
        shutil.rmtree(output)
    output.mkdir(parents=True)
    (output / "sparse").mkdir()

    copied = _stage_images(Path(image_dir), output / "images")
    print(f"[colmap] staged {copied} images")
    if copied == 0:
        print("ERROR: no images found")
        return False

    cmds = build_stage_commands(colmap, output, use_gpu, quality, dense)
    for i, cmd in enumerate(cmds):
        print(f"[colmap] stage {i + 1}/{len(cmds)}: {cmd[1]}")
        try:
            subprocess.run(cmd, check=True)
        except subprocess.CalledProcessError as e:
            print(f"[colmap] stage {cmd[1]} failed: {e}")
            return False
    print(f"[colmap] done -> {output}")
    return True


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Run COLMAP reconstruction")
    parser.add_argument("dataset", help="Image directory or dataset name")
    parser.add_argument(
        "--quality", choices=["low", "medium", "high"], default="medium"
    )
    parser.add_argument("--no-gpu", action="store_true")
    parser.add_argument("--sparse-only", action="store_true")
    parser.add_argument("--output", default=None)
    args = parser.parse_args(argv)

    image_dir = Path(args.dataset)
    if not image_dir.is_dir():
        image_dir = Path("data/samples") / args.dataset
    if not image_dir.is_dir():
        print(f"ERROR: not found: {args.dataset}")
        return 1
    output = args.output or str(image_dir / "colmap_reconstruction")
    ok = run_colmap_reconstruction(
        str(image_dir), output,
        use_gpu=not args.no_gpu,
        quality=args.quality,
        dense=not args.sparse_only,
    )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
