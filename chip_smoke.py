"""Smoke test of the PyTorch/CUDA port (recon3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py    # about 2-4 minutes on an H100

Phases, each of which passes or raises:
  1. device: the card's name and power limit (nvidia-smi);
  2. build: every CUDA kernel of the port, from csrc/, with nvcc;
  3. kernels: each kernel against its plain PyTorch version on the card at
     the shapes the main path gives it, with times (kernel, plain version,
     one library call as a yardstick) and the least time the card could take;
  4. small scene: PatchMatchMVS on the card at the settings of
     tests/test_patchmatch.py::test_full_mvs_reconstructor, held to its gate;
  5. main path: the port's CLI `--mvs --from-colmap` on the 50-view 480x640
     rendered scene (tests/render.py), launch counts reset just before and
     read just after, dense cloud gated against the scene's true surfaces
     at the level the JAX reference reaches there (NORTH_STAR_GATE).

Prints the kernel table as one JSON line, then the card line, then
{"ok": true, "device": {...}} as the last line. Exits non-zero, printing no
result, when no CUDA device is visible.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
import types
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))
# tests/ has no __init__.py, so an installed package named `tests` would win
# over it: bind the name to the repository's directory (for tests.render
# and tests.torch_scene, which are numpy only).
_tests = types.ModuleType("tests")
_tests.__path__ = [str(REPO / "tests")]
sys.modules["tests"] = _tests

from recon3d_tpu_torch.cli import main as cli_main  # noqa: E402
from recon3d_tpu_torch.io.colmap import save_colmap_text  # noqa: E402
from recon3d_tpu_torch.io.ply import load_ply  # noqa: E402
from recon3d_tpu_torch.kernels import warp  # noqa: E402
from tests.render import render_views  # noqa: E402
from tests.torch_scene import sparse_from_depth, surface_gate  # noqa: E402

# H100 SXM published peaks: HBM bytes/s and
# float32 operations/s outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

# The north-star scene (scripts/northstar_run.py): 50 views of 480x640.
N_VIEWS, IMAGE_SIZE, ARC_STEP = 50, (480, 640), 0.035
ARC_OFFSET = ARC_STEP * (N_VIEWS - 1) / 2.0
# Surface gate of the north-star dense cloud (median distance, share within
# 0.15). The JAX reference reaches median 0.268-0.271 and share 0.379-0.385
# on this scene at the CLI's settings (seeds 0 and 1, on the CPU:
# tests/torch_reference_levels.py), far from the 0.1 / 0.6 that it passes on
# the small scene; the gate sits 11-13% beyond the reference.
NORTH_STAR_GATE = (0.30, 0.33)

# K1 at the shapes of one keep_best evaluation on the main path: a batch of
# 4 views x J=4 sources = 16 planes; 13 candidate fields at the 30x40
# coarse level (1 + 12 propagation shifts), 9 at the 120x160 fine level
# (1 + 8 shifts, or 1 + 8 refinement samples at the coarse level).
K1_SHAPES = [(16, 120, 160, 9), (16, 30, 40, 13)]
K1_TOL = 2e-6  # inputs in [0, 1]; margin for contraction into FMAs
K1_REPLACES = "recon3d_tpu/ops/warp_pallas.py:98"
# Floating-point operations of one bilinear sample: 2 floor, 4 fraction
# subtractions, 8 products, 3 sums.
K1_OPS_PER_SAMPLE = 17


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, prefill: bool = True) -> float:
    """Mean milliseconds of fn() on the card, by CUDA events, after warm-up.

    prefill: hold the stream with a spin kernel while the host enqueues
    all the calls, so the events time the device's work back to back and
    not the host's launch rate; without it, the time per call is the
    larger of the two, as the main path sees it."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if prefill:
        torch.cuda._sleep(100_000_000)  # ~50 ms at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def k1_inputs(N: int, H: int, W: int, F: int, gen: torch.Generator,
              coherent: bool):
    """Planes in [0, 1] and F*H*W (x, y) points per plane, led by NaN, +-inf,
    out-of-range points, the corners and the exact (W-1, H-1).

    coherent: the points of each of the F fields are the pixel grid moved by
    a random shift of up to 10% of the image, scaled by 0.9-1.1 and jittered
    by up to half a pixel, as PatchMatch's reprojections of a smooth depth
    field are: neighbouring samples read neighbouring texels. Otherwise the
    points are uniform over a margin around the image (every tap a cache
    miss of its own)."""
    dev = "cuda"
    M = F * H * W
    planes = torch.rand((N, H, W), generator=gen, device=dev)
    if coherent:
        ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                                torch.arange(W, device=dev, dtype=torch.float32),
                                indexing="ij")
        a = torch.rand((N, F, 1, 1, 3), generator=gen, device=dev) * 2 - 1
        s = 1.0 + 0.1 * a[..., 0]
        x = xs * s + 0.1 * W * a[..., 1]
        y = ys * s + 0.1 * H * a[..., 2]
        x = (x + torch.rand(x.shape, generator=gen, device=dev) - 0.5).reshape(N, M)
        y = (y + torch.rand(y.shape, generator=gen, device=dev) - 0.5).reshape(N, M)
    else:
        x = torch.rand((N, M), generator=gen, device=dev) * (W + 3) - 2
        y = torch.rand((N, M), generator=gen, device=dev) * (H + 3) - 2
    nan, inf = float("nan"), float("inf")
    special = torch.tensor(
        [[nan, 1.0], [1.0, nan], [inf, 1.0], [-inf, 1.0], [1.0, inf],
         [1.0, -inf], [W - 1, H - 1], [0.0, 0.0], [W - 1, 0.0], [0.0, H - 1],
         [W - 1 + 1e-3, 1.0], [-1e-3, 1.0], [1.0, H - 1 + 1e-3], [W - 1.5, H - 1.5]],
        device=dev,
    )
    coords = torch.stack([x, y], dim=-1)
    coords[:, : len(special)] = special
    return planes, coords.contiguous()


def check_k1(planes, coords, what: str):
    """K1 against its plain version on the card: identical validity, values
    within K1_TOL, and both valid and invalid points present."""
    out, valid = warp.tent_warp(planes, coords)
    ref, ref_valid = warp.tent_warp_reference(planes, coords)
    torch.cuda.synchronize()
    if not torch.equal(valid, ref_valid):
        raise AssertionError(f"K1 valid differs from the plain version on {what}")
    err = float((out - ref).abs().max())
    if not err <= K1_TOL:
        raise AssertionError(f"K1 max |err| {err} > {K1_TOL} on {what}")
    n_invalid = int((~valid).sum())
    if n_invalid == 0 or n_invalid == valid.numel():
        raise AssertionError(f"K1 inputs must hold valid and invalid points ({what})")
    return err, n_invalid


def kernel_phase() -> list:
    """K1 at each shape of K1_SHAPES, on coherent and on uniform points;
    timed on the coherent ones, which are what the main path gives it."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = []
    for N, H, W, F in K1_SHAPES:
        what = f"{N}x{H}x{W} planes, {F * H * W} points each"
        planes_u, coords_u = k1_inputs(N, H, W, F, gen, coherent=False)
        err_u, _ = check_k1(planes_u, coords_u, what + " (uniform)")
        ms_uniform = cuda_ms(lambda: warp.tent_warp(planes_u, coords_u), 200)
        del planes_u, coords_u
        planes, coords = k1_inputs(N, H, W, F, gen, coherent=True)
        err, n_invalid = check_k1(planes, coords, what + " (coherent)")

        M = coords.shape[1]
        gx = 2.0 * coords[..., 0] / (W - 1) - 1.0
        gy = 2.0 * coords[..., 1] / (H - 1) - 1.0
        grid = torch.stack([gx, gy], dim=-1)[:, None]          # (N, 1, M, 2)
        img = planes[:, None]                                  # (N, 1, H, W)

        def k1():
            return warp.tent_warp(planes, coords)

        ms = cuda_ms(k1, 200)
        issue_ms = cuda_ms(k1, 200, prefill=False)
        plain_ms = cuda_ms(lambda: warp.tent_warp_reference(planes, coords), 20)
        library_ms = cuda_ms(
            lambda: torch.nn.functional.grid_sample(
                img, grid, mode="bilinear", padding_mode="border", align_corners=True),
            200,
        )
        n_bytes = N * H * W * 4 + N * M * (8 + 4 + 1)
        n_ops = N * M * K1_OPS_PER_SAMPLE
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
        shapes.append({
            "planes": [N, H, W], "samples_per_plane": M, "invalid": n_invalid,
            "max_abs_err": max(err, err_u), "ms": ms, "issue_ms": issue_ms,
            "ms_uniform_points": ms_uniform,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops,
        })
        print(f"[kernels] tent_warp on {what}: max|err| {max(err, err_u):.3g}; "
              f"{ms:.4f} ms on the device ({ms_uniform:.4f} on uniform points), "
              f"{issue_ms:.4f} ms a call issued back to back; plain {plain_ms:.4f}, "
              f"grid_sample {library_ms:.4f}, bound {shapes[-1]['bound_ms']:.4f} "
              f"by {shapes[-1]['bound_by']}", flush=True)
    return shapes


def gate(points: np.ndarray, max_median: float, min_share: float, what: str):
    """tests.torch_scene.surface_gate, held to its bounds: raises unless
    there are 3000 finite points, median < max_median and share >
    min_share."""
    if not (points.ndim == 2 and points.shape[1] == 3 and np.isfinite(points).all()):
        raise AssertionError(f"{what}: non-finite or malformed points")
    med, share = surface_gate(points)
    print(f"[{what}] {len(points)} dense points; median distance to the true "
          f"surface {med:.4f} (gate < {max_median}), share within 0.15 "
          f"{share:.4f} (gate > {min_share})", flush=True)
    if len(points) < 3000 or not med < max_median or not share > min_share:
        raise AssertionError(f"{what}: dense cloud fails the surface gate")
    return med, share


def small_scene_check() -> None:
    """The port's PatchMatchMVS on the card at the size and settings of
    tests/test_patchmatch.py::test_full_mvs_reconstructor (5 views of 96x128,
    full resolution, 4 rounds, 7x7 windows), held to that test's gate,
    which the JAX reference passes there."""
    from recon3d_tpu_torch.camera import Camera
    from recon3d_tpu_torch.config import PatchMatchConfig
    from recon3d_tpu_torch.dense.patchmatch import PatchMatchMVS

    scene = render_views(n_views=5, image_size=(96, 128), arc_step=0.12)
    cfg = PatchMatchConfig(scale=1.0, num_iterations=4, patch_size=7,
                           min_views=3, voxel_size=0.01)
    rec = PatchMatchMVS(Camera.from_matrix(scene["K"]), cfg, device="cuda")
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(5)}
    points, _ = rec.reconstruct(
        scene["images"], poses,
        sparse_points=sparse_from_depth(scene, per_view=300, views=[2]))
    gate(points, 0.1, 0.6, "small scene")


def main_path(work: Path, card: str) -> dict:
    from PIL import Image

    t0 = time.perf_counter()
    scene = render_views(n_views=N_VIEWS, image_size=IMAGE_SIZE,
                         arc_step=ARC_STEP, arc_offset=ARC_OFFSET)
    img_dir = work / "images"
    img_dir.mkdir()
    names = [f"view_{i:03d}.png" for i in range(N_VIEWS)]
    for name, img in zip(names, scene["images"]):
        Image.fromarray((img * 255).astype(np.uint8)).save(img_dir / name)
    poses = {i: (scene["Rs"][i], scene["ts"][i]) for i in range(N_VIEWS)}
    save_colmap_text(str(work / "model"), scene["K"], IMAGE_SIZE, poses,
                     sparse_from_depth(scene, per_view=100), None, names=names)
    print(f"[main] rendered {N_VIEWS} views of {IMAGE_SIZE} and their COLMAP "
          f"model in {time.perf_counter() - t0:.1f} s (host)", flush=True)

    out, stats_path = work / "recon", work / "stats.json"
    warp.counts.reset()
    t0 = time.perf_counter()
    rc = cli_main([str(img_dir), "--mvs", "--from-colmap", str(work / "model"),
                   "--output", str(out), "--stats-json", str(stats_path),
                   "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = warp.counts.kernel, warp.counts.plain
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    if launches == 0 or plain_calls != 0:
        raise AssertionError(
            f"main path: K1 launched {launches} times, plain version {plain_calls}")

    stats = json.loads(stats_path.read_text())
    points, colors = load_ply(str(out / "dense_mvs.ply"))
    if colors is None or colors.shape != points.shape:
        raise AssertionError("dense_mvs.ply: colours missing or malformed")
    med, frac = gate(points, *NORTH_STAR_GATE, "main")

    stages = stats["stage_times_s"]
    pm = stages["patchmatch_mvs"]
    mpix = N_VIEWS * IMAGE_SIZE[0] * IMAGE_SIZE[1] / 1e6
    print(f"[main] on {card}: wall {wall:.3f} s; stages (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stages.items())
          + "; patchmatch breakdown (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in stats["patchmatch_breakdown_s"].items())
          + f"; {len(points) / pm:.1f} dense points/s and {mpix / pm:.3f} MP/s of "
          f"input through patchmatch_mvs; K1 launches {launches}", flush=True)
    profile_main_path([str(img_dir), "--mvs", "--from-colmap", str(work / "model"),
                       "--output", str(work / "recon_profiled"), "--device", "cuda"],
                      wall)
    return {"launches": launches, "points": len(points), "median": med,
            "share": frac, "wall_s": wall, "stages_s": stages,
            "patchmatch_breakdown_s": stats["patchmatch_breakdown_s"]}


def profile_main_path(argv, wall: float) -> None:
    """Run the main path once more under torch.profiler: device time by
    kernel, K1's share of it, and the device's busy share of `wall`, the
    unprofiled run's time (the profiler slows the host several times)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        cli_main(argv)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    if not events:
        print("[profile] the profiler recorded no device time: not measured")
        return
    busy = sum(e.self_device_time_total for e in events) / 1e6
    k1 = [e for e in events if "tent_warp_kernel" in e.key]
    k1_s = sum(e.self_device_time_total for e in k1) / 1e6
    print(f"[profile] main path under the profiler: device busy {busy:.4f} s in "
          f"{sum(e.count for e in events)} kernels and copies, "
          f"{100 * busy / wall:.1f}% of the unprofiled run's {wall:.3f} s; "
          f"tent_warp {k1_s:.4f} s in {sum(e.count for e in k1)} launches "
          f"({100 * k1_s / busy:.1f}% of device time); top (s):")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        print(f"[profile]   {e.self_device_time_total / 1e6:8.4f}  x{e.count:<6d} "
              f"{e.key[:90]}")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is "
              "False); this script runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    card = card_line()
    print(f"[device] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)

    lib_path, build_s, log = warp.build()
    print(f"[build] {lib_path.name}: {build_s:.2f} s with nvcc"
          + (" (already built)" if build_s == 0.0 else ""), flush=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")

    shapes = kernel_phase()
    small_scene_check()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        result = main_path(Path(tmp), card)

    head = shapes[0]
    kernels = [{
        "name": "tent_warp", "route": "cuda",
        "source": "recon3d_tpu_torch/csrc/warp.cu", "replaces": K1_REPLACES,
        "launches": result["launches"],
        "max_abs_err": max(s["max_abs_err"] for s in shapes),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shapes": shapes,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
