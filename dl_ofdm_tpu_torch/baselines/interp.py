"""Static 2D pilot-interpolation operators.

NumPy and SciPy only; a copy of `dl_ofdm_tpu/baselines/interp.py`, so that
the port imports nothing of the JAX package.  The tests hold the two equal.

The pilot geometry is fixed per configuration, so MATLAB's per-frame
`griddata(...,'v4')` (biharmonic spline) and `scatteredInterpolant` (Delaunay
linear) calls — executed 20,000x inside parfor loops in the reference
(`dev/m/OFDM_Benchmark_dev.m:350-427`) — reduce to ONE precomputed linear
operator A [n_eval, n_pilot]: per-frame estimation is then a single batched
matmul `Hhat_grid = A @ Hhat_pilots`.

  * `biharmonic_operator` — Sandwell (1987) biharmonic Green's-function
    spline, the algorithm behind MATLAB griddata method 'v4':
    g(r) = r^2 (ln r - 1), weights = G_pp^{-1} h, eval = G_ep @ weights.
  * `linear_operator` — Delaunay barycentric interpolation with
    nearest-point extrapolation outside the hull (scatteredInterpolant's
    default 'linear' extrapolation differs slightly outside the hull; the
    in-hull behavior is exact).
"""
from __future__ import annotations

import numpy as np


def _green(r2: np.ndarray) -> np.ndarray:
    """Biharmonic Green's function g(r) = r^2 (ln(r) - 1), g(0) = 0."""
    out = np.zeros_like(r2)
    nz = r2 > 0
    out[nz] = r2[nz] * (0.5 * np.log(r2[nz]) - 1.0)
    return out


def biharmonic_operator(pilot_xy: np.ndarray, eval_xy: np.ndarray) -> np.ndarray:
    """A [n_eval, n_pilot] such that f(eval) = A @ f(pilot) for the
    biharmonic-spline interpolant (MATLAB griddata 'v4')."""
    p = np.asarray(pilot_xy, dtype=np.float64)
    e = np.asarray(eval_xy, dtype=np.float64)
    d_pp = ((p[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    d_ep = ((e[:, None, :] - p[None, :, :]) ** 2).sum(-1)
    g_pp = _green(d_pp)
    g_ep = _green(d_ep)
    return g_ep @ np.linalg.pinv(g_pp)


def linear_operator(pilot_xy: np.ndarray, eval_xy: np.ndarray) -> np.ndarray:
    """A [n_eval, n_pilot] for Delaunay-linear interpolation with
    nearest-pilot extrapolation outside the convex hull."""
    from scipy.spatial import Delaunay, QhullError, cKDTree

    p = np.asarray(pilot_xy, dtype=np.float64)
    e = np.asarray(eval_xy, dtype=np.float64)
    a = np.zeros((len(e), len(p)))
    try:
        tri = Delaunay(p)
    except QhullError:
        # degenerate (collinear) pilot geometry — e.g. the 'block' scheme
        # puts every pilot in one symbol; fall back to nearest-pilot
        _, nearest = cKDTree(p).query(e)
        a[np.arange(len(e)), nearest] = 1.0
        return a
    simplex = tri.find_simplex(e)
    inside = simplex >= 0
    if inside.any():
        s = simplex[inside]
        verts = tri.simplices[s]                     # [n_in, 3]
        t = tri.transform[s]                          # [n_in, 3, 2]
        delta = e[inside] - t[:, 2, :]
        bary = np.einsum("nij,nj->ni", t[:, :2, :], delta)
        w = np.concatenate([bary, 1 - bary.sum(-1, keepdims=True)], axis=-1)
        rows = np.where(inside)[0]
        for j in range(3):
            a[rows, verts[:, j]] += w[:, j]
    if (~inside).any():
        tree = cKDTree(p)
        _, nearest = tree.query(e[~inside])
        a[np.where(~inside)[0], nearest] = 1.0
    return a
