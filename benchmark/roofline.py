"""Published peaks of one NVIDIA H100 SXM and the operation and byte
counts of the port's kernels, from their shapes.

Peaks: NVIDIA's data sheet, dense rates at the 700 W limit. A share of a
roofline is the least time the card could take (operations over the
peak rate or bytes over the peak bandwidth, the larger) over the time the
kernel took.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
K1_OPS_PER_SAMPLE = 17   # 4 taps, their weights and the validity test


def k1_shape(key: str) -> Tuple[int, int, int, int, int]:
    """(N, H, W, Nc, M) of a launch key 'NxHxW/NcxM': N planes of H x W
    sampled at Nc rows of M points (Nc is 1 where all planes share the
    points)."""
    planes, coords = key.split("/")
    N, H, W = (int(v) for v in planes.split("x"))
    Nc, M = (int(v) for v in coords.split("x"))
    return N, H, W, Nc, M


def k1_bytes(N: int, H: int, W: int, Nc: int, M: int, texels: Optional[int] = None) -> int:
    """K1's bytes: each input read once (the texels the points touch, else
    the whole planes; the coordinates, 8 B a point), each output written
    once (4 B a sample, 1 B of validity a point of each coordinate row)."""
    return (N * H * W if texels is None else texels) * 4 + Nc * M * (8 + 1) + N * M * 4


def k1_bound_s(N: int, H: int, W: int, Nc: int, M: int, texels: Optional[int] = None) -> float:
    """The least time of one K1 launch on this card, seconds."""
    return max(k1_bytes(N, H, W, Nc, M, texels) / HBM_BYTES_PER_S,
               N * M * K1_OPS_PER_SAMPLE / F32_OPS_PER_S)


def k1_bound_total_s(launches_by_shape: Dict[str, int]) -> float:
    """The least time of all these launches, whole planes counted."""
    return sum(n * k1_bound_s(*k1_shape(key)) for key, n in launches_by_shape.items())


def k1_texels(N: int, H: int, W: int, coords) -> int:
    """The plane texels that K1 must read on these points (torch tensor of
    (Nc, M, 2)): the distinct taps of the valid points of each coordinate
    row, once on each plane that row serves (all N for shared points)."""
    import torch

    x, y = coords[..., 0], coords[..., 1]
    valid = (x >= 0) & (x <= W - 1) & (y >= 0) & (y <= H - 1)
    total = 0
    for row in range(coords.shape[0]):
        x0 = x[row][valid[row]].floor().long()
        y0 = y[row][valid[row]].floor().long()
        x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
        hit = torch.zeros(H * W, dtype=torch.bool, device=coords.device)
        for yi, xi in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
            hit[yi * W + xi] = True
        total += int(hit.sum())
    return total * (N if coords.shape[0] == 1 else 1)
