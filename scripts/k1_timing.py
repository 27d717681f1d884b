"""K1, the tent warp, timed on the card at every shape the main path gives it.

    python3 scripts/k1_timing.py [--warp PATH ...] [--out FILE]

Each --warp names a copy of recon3d_tpu_torch/kernels/warp.py (default:
this checkout's); its kernel is built from the csrc/warp.cu beside it. The
copies are timed in the order given, so `--warp A --warp B --warp B --warp
A` compares two versions within one call on one card. At each shape of
chip_smoke.K1_SHAPES, on the main path's kind of points (chip_smoke.
k1_inputs): each copy is held bit for bit to its own plain version and
timed by CUDA events with the queue held full (chip_smoke.cuda_ms); a copy
with a launch planner (warp.variants_for) is timed in every variant that
can take the shape, at every vector width (warp.vec_widths), as well. A
copy whose `shared` splits its planes over grid y (LaunchPlan.
planes_per_block) times `shared` once more in one group of all N planes
("/P=N") and, at the planner's width, in groups of 1, 2, 3, 4, 6, 8, 12,
16, 32 and 64 planes (those below N): the evidence for the planner's rule
for P. grid_sample on the same work is the yardstick.
Then the TSDF diagnostic: the TSDF shape again with one plane (N = 1) on
the same 7,077,888 shared points. Prints one JSON line a shape (and writes
them to --out if given).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def load_warp(path: Path, i: int):
    spec = importlib.util.spec_from_file_location(f"k1_timing_warp_{i}", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod   # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def check(mod, planes, coords, what: str, **kw) -> None:
    out, valid = mod.tent_warp(planes, coords, **kw)
    ref, ref_valid = mod.tent_warp_reference(planes, coords)
    torch.cuda.synchronize()
    if not (torch.equal(valid, ref_valid) and torch.equal(out, ref)):
        raise AssertionError(f"K1 differs from its plain version on {what}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--warp", action="append", type=Path,
                    help="a kernels/warp.py to time (repeatable, timed in order)")
    ap.add_argument("--out", type=Path, help="also write the JSON lines to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("k1_timing: no CUDA device visible", file=sys.stderr)
        return 1
    paths = [p.resolve() for p in (args.warp or [REPO / "recon3d_tpu_torch/kernels/warp.py"])]
    mods = {}
    for p in paths:
        if p not in mods:
            mods[p] = load_warp(p, len(mods))
            lib, seconds, log = mods[p].build()
            regs = [ln.strip() for ln in log.splitlines()
                    if any(k in ln for k in ("registers", "spill", "entry function"))]
            print(f"[build] {p}: {lib.name} in {seconds:.2f} s; {regs}", flush=True)
    card = cs.card_line()
    print(f"[device] {card}", flush=True)

    cases = list(cs.K1_SHAPES) + [("tsdf_mesh", 1, 120, 160, 192 ** 3, "voxels")]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for stage, N, H, W, M, kind in cases:
        planes, coords = cs.k1_inputs(N, H, W, M, kind, gen)
        planes = planes[:N].contiguous()
        Nc = coords.shape[0]
        what = f"{stage} {N}x{H}x{W} x {M}"
        row = {"stage": stage, "planes": [N, H, W], "coord_rows": Nc,
               "samples_per_plane": M, "card": card,
               "bound_ms": 1e3 * cs.k1_bytes(N, H, W, Nc, M) / cs.HBM_BYTES_PER_S,
               "library_ms": cs.cuda_ms(cs.k1_library_call(planes, coords), 200),
               "runs": []}
        for p in paths:
            mod = mods[p]
            check(mod, planes, coords, what)
            run = {"warp": str(p.relative_to(REPO)) if p.is_relative_to(REPO) else str(p),
                   "ms": cs.cuda_ms(lambda: mod.tent_warp(planes, coords), 200)}
            if hasattr(mod, "variants_for"):
                plan = mod.plan_for(planes, coords)
                split = "planes_per_block" in mod.LaunchPlan.__dataclass_fields__
                run["picked"] = f"{plan.variant}/{plan.vec}" + (
                    f"/P={plan.planes_per_block}" if split else "")
                run["variant_ms"] = {}
                align = coords.data_ptr() % 16
                for v in mod.variants_for(N, H, W, Nc):
                    for w in mod.vec_widths(M, align):
                        check(mod, planes, coords, f"{what} ({v}, vec {w})", variant=v, vec=w)
                        run["variant_ms"][f"{v}/{w}"] = cs.cuda_ms(
                            lambda: mod.tent_warp(planes, coords, variant=v, vec=w), 200)
                        if not (split and v == "shared"):
                            continue
                        sweep = (1, 2, 3, 4, 6, 8, 12, 16, 32, 64) if (
                            w == mod.plan_for(planes, coords, v).vec) else ()
                        for P in [P for P in sweep if P < N] + [N]:
                            one = {"variant": v, "vec": w, "planes_per_block": P}
                            check(mod, planes, coords, f"{what} ({v}, vec {w}, P={P})", **one)
                            run["variant_ms"][f"{v}/{w}/P={P}"] = cs.cuda_ms(
                                lambda: mod.tent_warp(planes, coords, **one), 200)
            row["runs"].append(run)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del planes, coords
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text("".join(json.dumps(r) + "\n" for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
