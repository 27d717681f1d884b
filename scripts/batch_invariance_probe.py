"""Which step of the batched pair matcher rounds otherwise on the card when
its batch holds fewer pairs.

A mesh's shard runs its rows of a chunk as a smaller batch. On the CPU
the shards reproduce the whole chunk bit for bit; on a GPU they need not.
This script runs features/frontend._match_verify_batch's steps on the 18
pairs of the first 8 north-star views (chip_smoke.py's arc) once as one
batch and once as its two 9-pair halves, with the same uniforms, and
reports for each step whether the halves equal their rows of the whole,
bit for bit. Then it tests the batched operations those steps call, on
random inputs at the same shapes (and the matrix product at the largest
chunk and capacity), for the same property; and PatchMatch's steps on
the first 16 views, 16 against two batches of 8. Prints one JSON
object; --out writes it to a file too.

Run on a GPU: python3 scripts/batch_invariance_probe.py [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (binds `tests` to the repository's directory)


def _diff(a: torch.Tensor, b: torch.Tensor) -> dict:
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    d = (a - b).abs()
    return {"equal": bool(torch.equal(a, b)), "max_abs": float(d.max()) if d.numel() else 0.0,
            "max_rel": float(d.max() / a.abs().max().clamp_min(1e-30)) if d.numel() else 0.0}


def _halves(fn, n: int) -> dict:
    """fn(lo, hi) -> {name: tensor with rows lo:hi first}: the whole batch
    against its two halves, step by step."""
    whole = fn(0, n)
    parts = [fn(0, n // 2), fn(n // 2, n)]
    return {k: _diff(v, torch.cat([p[k] for p in parts])) for k, v in whole.items()}


def refit_parts(x1, x2, w) -> dict:
    """The first refit's fundamental_8point (ops/epipolar.py) step by step."""
    from recon3d_tpu_torch.ops import epipolar as E
    from recon3d_tpu_torch.ops.linalg import einsum_hp, smallest_eigvec

    T1 = E._normalization_transform(x1, w)
    T2 = E._normalization_transform(x2, w)
    count = w.sum(dim=-1, keepdim=True)
    mean = (x1 * w[..., None]).sum(dim=-2)    # torch.sum, as the refit once summed
    A = E._bilinear_basis(E._apply_h(T1, x1), E._apply_h(T2, x2)) * w[..., None]
    AtA = einsum_hp("...ni,...nj->...ij", A, A)
    f = smallest_eigvec(AtA)
    return {"refit_count": count, "refit_mean_torch_sum": mean, "refit_T1": T1, "refit_A": A,
            "refit_AtA": AtA, "refit_eigvec": f.abs()}


def matcher_steps(device: str) -> dict:
    from recon3d_tpu_torch.features.frontend import FeatureExtractor, match_capacity
    from recon3d_tpu_torch.ops import ransac as R
    from recon3d_tpu_torch.ops.epipolar import (
        fundamental_8point,
        sampson_distance,
        sampson_distance_batch,
    )
    from recon3d_tpu_torch.ops.match import gather_matched_points, match_descriptors_streaming
    from tests.render import render_views

    scene = render_views(n_views=8, image_size=chip_smoke.IMAGE_SIZE,
                         arc_step=chip_smoke.ARC_STEP, arc_offset=chip_smoke.ARC_OFFSET)
    gray = np.stack([im.mean(-1) for im in scene["images"]]).astype(np.float32)
    feats = FeatureExtractor(device=device).extract_batch(gray)
    valid_np = feats.valid.cpu().numpy()
    C = match_capacity(valid_np)
    od = torch.from_numpy(np.argsort(~valid_np, axis=1, kind="stable")[:, :C]).to(device)
    row = torch.arange(od.shape[0], device=device)[:, None]
    desc, valid, xy = (feats.desc[row, od], feats.valid[row, od].to(torch.float32),
                       feats.xy[row, od])
    pairs = [(i, j) for i in range(8) for j in range(i + 1, min(8, i + 4))]
    pij = torch.tensor(pairs, device=device)
    n, H = len(pairs), 1024
    u = torch.rand((n, H, C), generator=torch.Generator(device=device).manual_seed(11),
                   device=device)

    def steps(lo, hi):
        pi, pj = pij[lo:hi, 0], pij[lo:hi, 1]
        m = match_descriptors_streaming(desc[pi], desc[pj], valid[pi], valid[pj],
                                        ratio=0.75, cross_check=True)
        x1, x2 = gather_matched_points(xy[pi], xy[pj], m)
        w = m.mask.to(torch.float32)
        idx = R.indices_from_uniform(u[lo:hi], w, 8)
        ones = torch.ones(idx.shape, dtype=x1.dtype, device=x1.device)
        hyp = fundamental_8point(R.gather_rows(x1, idx), R.gather_rows(x2, idx), ones)
        resid = sampson_distance_batch(hyp, x1, x2)
        res = R.ransac(None, None, None, w, 8, H, 2.0,
                       batch_residual_fn=lambda Fs: sampson_distance_batch(Fs, x1, x2),
                       sample_solver=lambda i: fundamental_8point(
                           R.gather_rows(x1, i), R.gather_rows(x2, i),
                           torch.ones(i.shape, dtype=x1.dtype, device=x1.device)),
                       sample_indices=idx)
        out = {"match_idx2": m.idx2, "match_mask": m.mask, "x1": x1, "hypotheses": hyp,
               "hypothesis_residuals": resid, "vote_F": res.model,
               "vote_inliers": res.inliers}
        model, inl = res.model, res.inliers
        out.update(refit_parts(x1, x2, inl.to(torch.float32) * (w > 0)))
        for k in range(2):
            wk = inl.to(torch.float32) * (w > 0)
            model = torch.where((wk.sum(-1) >= 8)[:, None, None],
                                fundamental_8point(x1, x2, wk), model)
            inl = (sampson_distance(model, x1, x2) < 2.0) & (w > 0)
            out[f"refit{k + 1}_F"], out[f"refit{k + 1}_inliers"] = model, inl
        return out

    return {"pairs": n, "capacity": C, "steps": _halves(steps, n)}


def patchmatch_steps(device: str, n: int = 16) -> dict:
    """PatchMatch's steps (dense/patchmatch.py) on the first n north-star
    views at a quarter of their size (tests/torch_mesh_check.dense_inputs),
    the whole batch against its halves: its operations on random depth
    fields, then patchmatch_depth_batch itself."""
    from recon3d_tpu_torch.dense import patchmatch as pm
    from recon3d_tpu_torch.ops.image import box_filter, resize, resize_batch_invariant
    from recon3d_tpu_torch.ops.ncc import ncc_windowed
    from tests.render import render_views
    from tests.torch_mesh_check import PM_KW, dense_inputs

    scene = render_views(n_views=n, image_size=chip_smoke.IMAGE_SIZE,
                         arc_step=chip_smoke.ARC_STEP, arc_offset=chip_smoke.ARC_OFFSET)
    inp = dense_inputs(scene, n_views=n, scale=0.25)
    t = {k: torch.from_numpy(np.ascontiguousarray(inp[k], np.float32)).to(device)
         for k in ("ref", "src", "K", "Rs", "ts", "R_src", "t_src", "ranges")}
    B, h, w = t["ref"].shape
    g = torch.Generator(device=device).manual_seed(1)
    lo_d, hi_d = t["ranges"][:, :1, None, None], t["ranges"][:, 1:, None, None]
    depth = lo_d + (hi_d - lo_d) * torch.rand((B, 3, h, w), generator=g, device=device)
    rays = pm._rays_for(t["K"], h, w, torch.float32)

    def steps(lo, hi):
        sl = slice(lo, hi)
        samp, ok = pm._warp_sources(depth[sl], rays, t["Rs"][sl], t["ts"][sl],
                                    t["R_src"][sl], t["t_src"][sl], t["K"], t["src"][sl],
                                    t["ranges"][sl, 0] * 0.05)
        cost = pm._eval_cost(depth[sl], rays, t["ref"][sl], t["src"][sl], t["K"], t["Rs"][sl],
                             t["ts"][sl], t["R_src"][sl], t["t_src"][sl], 11,
                             t["ranges"][sl, 0] * 0.05)[0]
        gens = [pm.view_generator(0, v, device) for v in range(lo, hi)]
        out = pm.patchmatch_depth_batch(
            t["ref"][sl], t["src"][sl], t["K"], t["Rs"][sl], t["ts"][sl], t["R_src"][sl],
            t["t_src"][sl], t["ranges"][sl], generators=gens, **PM_KW)
        return {"resize_down (matrix products)": resize(t["ref"][sl], (h // 4, w // 4)),
                "resize_batch_invariant_down": resize_batch_invariant(t["ref"][sl],
                                                                      (h // 4, w // 4)),
                "resize_batch_invariant_up": resize_batch_invariant(
                    depth[sl, 0, : h // 4, : w // 4], (h, w)),
                "box_filter": box_filter(t["src"][sl], 11),
                "warp_samples": samp, "warp_valid": ok,
                "ncc": ncc_windowed(t["ref"][sl, None, None], samp, ok, 11),
                "cost": cost, "normals": pm.normals_from_depth(depth[sl, 0], rays),
                "smooth_field": pm._smooth_field((hi - lo, 8, h, w), generator=gens,
                                                 device=device),
                "patchmatch_depth": out.depth, "patchmatch_confidence": out.confidence}

    return {"views": n, "size": [h, w], "steps": _halves(steps, n)}


def batched_ops(device: str, C: int = 1024, H: int = 1024, n: int = 18) -> dict:
    """The batched operations of those steps on random inputs, whole batch
    of n against its halves."""
    from recon3d_tpu_torch.ops.linalg import (
        eigh_batched,
        einsum_hp,
        matmul_hp,
        sum_batch_invariant,
    )

    g = torch.Generator(device=device).manual_seed(0)

    def r(*shape):
        return torch.randn(shape, generator=g, device=device)

    A, S9, M3 = r(n, C, 9), r(n, H, 9, 9), r(n, H, 3, 3)
    S9 = S9 @ S9.transpose(-1, -2)
    Fh, Z, D1, D2 = r(n, H, 9), r(n, 9, C), r(n, C, 128), r(n, 128, C)
    A8 = r(4 * n, 8 * C, 9)
    cases = {
        "einsum_AtA (n, C, 9)": lambda lo, hi: einsum_hp("...ni,...nj->...ij", A[lo:hi],
                                                         A[lo:hi]),
        "eigh (n, 9, 9)": lambda lo, hi: eigh_batched(S9[lo:hi, 0])[1],
        "eigh (n, H, 9, 9)": lambda lo, hi: eigh_batched(S9[lo:hi])[1],
        "svd (n, H, 3, 3)": lambda lo, hi: torch.linalg.svd(M3[lo:hi])[0],
        "svd (n, 3, 3)": lambda lo, hi: torch.linalg.svd(M3[lo:hi, 0])[0],
        "matmul (n, H, 9) @ (n, 9, C)": lambda lo, hi: matmul_hp(Fh[lo:hi], Z[lo:hi]),
        "matmul (n, H, 3, 3) @ (n, H, 3, 3)": lambda lo, hi: matmul_hp(M3[lo:hi], M3[lo:hi]),
        "bmm (n, C, 128) @ (n, 128, C)": lambda lo, hi: torch.bmm(D1[lo:hi], D2[lo:hi]),
        "sum (n, H, C) over C": lambda lo, hi: (Fh[lo:hi, :, :1] * Z[lo:hi, :1]).sum(-1),
        "sum (n, C) over C": lambda lo, hi: A[lo:hi, :, 0].sum(-1),
        "sum (n, C, 2) over C": lambda lo, hi: A[lo:hi, :, :2].sum(-2),
        "sum_batch_invariant (n, C) over C": lambda lo, hi: sum_batch_invariant(
            A[lo:hi, :, 0], -1),
        "sum_batch_invariant (n, C, 2) over C": lambda lo, hi: sum_batch_invariant(
            A[lo:hi, :, :2], -2),
        "einsum_AtA (4n, 8C, 9)": lambda lo, hi: einsum_hp(
            "...ni,...nj->...ij", A8[4 * lo:4 * hi], A8[4 * lo:4 * hi]),
    }
    out = {}
    for name, fn in cases.items():
        whole = fn(0, n)
        halves = torch.cat([fn(0, n // 2), fn(n // 2, n)])
        out[name] = _diff(whole, halves)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=None)
    a = p.parse_args()
    if not torch.cuda.is_available():
        print("batch_invariance_probe: needs a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"card": chip_smoke.card_line(), "matcher": matcher_steps("cuda")}
    out["ops"] = batched_ops("cuda", C=out["matcher"]["capacity"])
    out["patchmatch"] = patchmatch_steps("cuda")
    text = json.dumps(out, indent=1)
    print(text)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
