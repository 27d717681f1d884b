"""chip_smoke.py's multi_device phase alone, on the card(s) of this host.

    python3 scripts/multi_device_probe.py [--parts abc] [--cli N]
                                          [--out out/multi_device.json]

Renders the first 16 views of the north-star scene (chip_smoke.py's arc),
runs the phase's parts asked for, (a), (b) and, with two cards, (c)
(tests/torch_mesh_check.py), and writes what it measured as JSON: the
agreements, each side's seconds, the all_reduce of the TSDF grids, the BA
milliseconds an LM iteration on one device and on the mesh, and K1's
launches by rank. The card's name and power limit come first.

--cli N also runs the CLI `IMAGES --mvs --stereo --mesh` on 5 rendered
views of 128x160 with --devices N (capped at the visible cards) and with
--devices 1, and holds the products to tests/test_cli_mesh.py:55-110's
bounds.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402  (binds `tests` to the repository's directory)
import torch  # noqa: E402
from tests.render import render_views  # noqa: E402


def cli_check(n: int) -> dict:
    """The CLI with --devices n against --devices 1 (module docstring)."""
    import tempfile

    import numpy as np
    from PIL import Image

    from recon3d_tpu_torch.io.ply import load_ply

    scene = render_views(n_views=5, image_size=(128, 160), arc_step=0.15)
    with tempfile.TemporaryDirectory(prefix="md_cli_") as tmp:
        d = Path(tmp) / "images"
        d.mkdir()
        for i, img in enumerate(scene["images"]):
            Image.fromarray((img * 255).astype(np.uint8)).save(d / f"im_{i:03d}.png")
        runs = {}
        for k in (1, n):
            o, st = Path(tmp) / f"d{k}", Path(tmp) / f"d{k}.json"
            t0 = time.perf_counter()
            rc = chip_smoke.cli_main([str(d), "--mvs", "--stereo", "--mesh", "--seed", "1",
                                      "--mesh-resolution", "64", "--devices", str(k),
                                      "--output", str(o), "--stats-json", str(st)])
            if rc != 0:
                raise AssertionError(f"CLI --devices {k}: rc {rc}")
            runs[k] = (o, json.loads(st.read_text()), time.perf_counter() - t0)
        (o1, s1, w1), (o2, s2, w2) = runs[1], runs[n]
        p1, c1 = load_ply(str(o1 / "sparse.ply"))
        p2, c2 = load_ply(str(o2 / "sparse.ply"))
        if len(p1) != len(p2) or np.abs(p1 - p2).max() > 5e-3 or not np.array_equal(c1, c2):
            raise AssertionError("CLI: sparse.ply beyond tests/test_cli_mesh.py's bounds")
        out = {"devices": s2["devices"], "wall_s": {"1": w1, str(n): w2},
               "sparse_max_abs_err": float(np.abs(p1 - p2).max()), "dense": {},
               "k1_by_rank": {k: [r["kernel"] for r in v.get("by_rank", [])]
                              for k, v in s2["k1_calls_by_stage"].items()}}
        for name in ("dense_mvs.ply", "dense_stereo.ply"):
            a, _ = load_ply(str(o2 / name))
            b, _ = load_ply(str(o1 / name))
            med = float(np.abs(np.median(a, 0) - np.median(b, 0)).max())
            if abs(len(a) - len(b)) > 0.02 * min(len(a), len(b)) or med > 0.05:
                raise AssertionError(f"CLI: {name} {len(a)} / {len(b)} points, medians {med}")
            out["dense"][name] = {"points": [len(b), len(a)], "median_shift": med}
    print(f"[multi_device] CLI --devices {out['devices']} against --devices 1: {out}",
          flush=True)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None, help="write the measurements here (JSON)")
    p.add_argument("--parts", default="abc", help="the phase's parts to run")
    p.add_argument("--cli", type=int, default=0, help="--devices of a CLI run (0: none)")
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("multi_device_probe: no CUDA device visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = chip_smoke.card_line()
    print(f"[device] {card}; torch {torch.__version__}", flush=True)
    lib, build_s, _ = chip_smoke.warp.build()
    print(f"[build] {lib.name}: {build_s:.2f} s", flush=True)
    scene = render_views(n_views=chip_smoke.MD_VIEWS, image_size=chip_smoke.IMAGE_SIZE,
                         arc_step=chip_smoke.ARC_STEP, arc_offset=chip_smoke.ARC_OFFSET)
    t0 = time.perf_counter()
    out = chip_smoke.multi_device_phase(scene, card, a.parts) if a.parts else {}
    out["phase_s"] = time.perf_counter() - t0
    if a.cli:
        out["cli"] = cli_check(a.cli)
    out["card"] = card
    print(f"[multi_device] phase {out['phase_s']:.1f} s", flush=True)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(json.dumps(out, indent=1, default=float))
    print(json.dumps({"ok": True, "phase_s": out["phase_s"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
