"""Seeded point clouds that K2's and K3's tests share (numpy only: the card's
tests import this file without the JAX package)."""

import numpy as np


def clustered_cloud(seed: int, n: int = 2400) -> np.ndarray:
    """Six normal clusters of growing spread and 1% uniform outliers."""
    rng = np.random.default_rng(seed)
    centres = rng.normal(0, 1, (6, 3))
    parts = [centres[i] + rng.normal(0, 0.05 + 0.05 * i, (n // 6, 3)) for i in range(6)]
    parts.append(rng.uniform(-5, 5, (n // 100, 3)))
    return np.concatenate(parts).astype(np.float32)


def adversarial_clouds(scale: int = 1) -> dict:
    """Clouds for K2's skip, each of about 3,000 * scale points: a surface (a
    sphere and a plane, a little noise), a uniform block, exact duplicates,
    points on one plane that is a cell boundary (z = 0: floor(0 * inv) = 0,
    the cell below holds z < 0; two points off it give the box a depth), a
    lattice whose k-th distances tie, and a block with a lone cell far off."""
    rng = np.random.default_rng(21)
    u = rng.normal(size=(2000 * scale, 3))
    sphere = u / np.linalg.norm(u, axis=1, keepdims=True)
    plane = np.c_[rng.uniform(-1.5, 1.5, (1200 * scale, 2)), np.full(1200 * scale, -1.2)]
    surface = np.concatenate([sphere, plane]) + rng.normal(0, 2e-3, (3200 * scale, 3))
    base = clustered_cloud(6, 600 * scale)
    flat = np.c_[rng.uniform(-1, 1, (2500 * scale, 2)), np.zeros(2500 * scale)]
    flat = np.concatenate([flat, [[0.0, 0.0, 0.5], [0.3, -0.2, -0.5]]])
    side = round(12 * scale ** (1 / 3))
    axis = np.arange(side, dtype=np.float32) * np.float32(0.25)
    lattice = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"), -1).reshape(-1, 3)
    lone = np.concatenate([rng.uniform(0, 10, (3000 * scale, 3)),
                           [[40.0, 40.0, 40.0], [39.5, 40.0, 40.0], [40.0, 39.0, 40.0]]])
    clouds = {"surface": surface, "uniform": rng.uniform(0, 1, (3000 * scale, 3)),
              "duplicates": np.concatenate([base, base[:200 * scale], base[:50 * scale]]),
              "boundary_plane": flat, "lattice": lattice, "lone_cell": lone}
    return {name: np.ascontiguousarray(c, dtype=np.float32) for name, c in clouds.items()}
