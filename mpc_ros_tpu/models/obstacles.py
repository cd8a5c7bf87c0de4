"""Costmap-derived obstacle penalty terms.

The reference consumes a costmap only for plan bookkeeping — its NLP has NO
obstacle awareness (the costmap_2d handle is wired in
/root/reference/mpc_ros/src/mpc_planner_ros.cpp:47 but never enters
MPC::Solve). The north-star configs (BASELINE.md: "16k scenarios with
costmap-derived obstacle penalty terms") make obstacle costs a first-class
solver feature here.

Design: a robot-frame occupancy-cost grid (the local costmap snapshot),
bilinearly sampled along the predicted (x, y) horizon. Bilinear sampling is
gather + FMA — cheap, batchable over scenarios with per-scenario
grids, and differentiable (piecewise-linear; the solver consumes the
analytic gradient, Gauss-Newton curvature handled by the Levenberg
regularizer).
"""

from __future__ import annotations

from typing import Any

import jax.numpy as jnp

from .. import pytree

Array = Any


@pytree.dataclass
class ObstacleMap:
    """Robot/world-frame cost grid. grid[iy, ix] in [0, 1]; world coords:
    x = origin[0] + ix * resolution, y = origin[1] + iy * resolution.

    `sampling` (static): how the continuous field is reconstructed.
      "bilinear" (default) — exact costmap_2d-style C0 interpolation.
        Cheap (4 gathers) and value-exact at cells, but its gradient
        JUMPS at cell boundaries: minimizers that land ON a cell line
        cannot fire the smooth projected-gradient certificate (the ~4-5%
        cost-converged-but-reported-unconverged kink class,
        tests/test_obstacle_fit.py).
      "spline" — C1 quadratic B-spline reconstruction (9 gathers,
        3x3 stencil): continuous gradient everywhere + an analytic
        piecewise-constant second derivative (PSD-clamped) for the
        backward pass. An APPROXIMATING spline: the field is a smoothed
        (~1-cell blur) version of the grid — the honest trade for C1,
        equivalent to one extra inflation-smoothing pass on the costmap.
      "spline_coeff" — the SAME spline surface evaluated from per-cell
        bi-quadratic coefficient planes (one packed row gather + Horner
        instead of the 9-tap scattered stencil — the recommended grid
        mode). Planes are derived inline per call if not
        attached; `with_spline_coeffs()` precomputes them once per
        costmap update (use `with_grid` for updates — see its docstring).
    """

    grid: Array          # (H, W) float
    origin: Array        # (2,) lower-left corner (x, y)
    resolution: Array    # scalar [m / cell]
    weight: Array        # cost multiplier w_obs
    sampling: str = pytree.field(pytree_node=False, default="bilinear")
    # optional precomputed per-cell bi-quadratic coefficient planes for
    # sampling="spline" ((H, W, 9) or (B, H, W, 9) — see
    # spline_coeff_planes / with_spline_coeffs): sampling becomes one
    # packed row gather + a 2-D Horner instead of the 9-tap scattered
    # stencil. Same polynomial, different factorization (values equal to
    # f32 rounding).
    coeff: "Array | None" = None

    @staticmethod
    def empty(extent: float = 4.0, cells: int = 64, weight: float = 0.0,
              dtype=jnp.float32) -> "ObstacleMap":
        """Centered empty map of +-extent/2 meters."""
        return ObstacleMap(
            grid=jnp.zeros((cells, cells), dtype),
            origin=jnp.asarray([-extent / 2, -extent / 2], dtype),
            resolution=jnp.asarray(extent / cells, dtype),
            weight=jnp.asarray(weight, dtype),
        )

    def with_spline_coeffs(self) -> "ObstacleMap":
        """Attach precomputed per-cell bi-quadratic coefficient planes
        (spline_coeff_planes) so spline sampling becomes one packed row
        gather + Horner. Requires a spline sampling mode; call once per
        costmap update (9x the grid's memory — 144 KB for a 64x64 f32
        map). STALENESS: the planes are derived from the CURRENT grid —
        a later `.replace(grid=...)` does NOT invalidate them; update
        the grid through `with_grid` instead (it re-derives any attached
        planes)."""
        assert self.sampling in ("spline", "spline_coeff"), \
            "coefficient planes apply to spline sampling only"
        return self.replace(coeff=spline_coeff_planes(self.grid))

    def with_grid(self, grid) -> "ObstacleMap":
        """Install a new cost grid, re-deriving the precomputed spline
        coefficient planes when present (the safe per-update path — a raw
        `.replace(grid=...)` would keep sampling the OLD surface through
        stale planes)."""
        m = self.replace(grid=jnp.asarray(grid, self.grid.dtype))
        if self.coeff is not None:
            m = m.replace(coeff=spline_coeff_planes(m.grid))
        return m


def _sampling_mode(omap) -> str:
    """Dispatch family of an ObstacleMap's sampling string: 'spline'
    (covers both the stencil 'spline' and the coefficient-plane
    'spline_coeff' spelling — same surface) or 'bilinear'. Rejects
    unknown strings loudly instead of silently falling through to the
    bilinear branch (a misspelled mode would otherwise sample C0 with no
    warning — the worst of the modes for the solver's certificate)."""
    s = omap.sampling
    if s in ("spline", "spline_coeff"):
        return "spline"
    if s == "bilinear":
        return "bilinear"
    raise ValueError(
        f"unknown ObstacleMap.sampling {s!r}; expected 'bilinear', "
        f"'spline', or 'spline_coeff'")


def bilinear_sample(grid: jnp.ndarray, origin, resolution,
                    xy: jnp.ndarray) -> jnp.ndarray:
    """Bilinearly sample grid at continuous points xy (..., 2).

    Out-of-map points clamp to the border cell (border values should be 0
    so leaving the local map costs nothing, like a costmap's unknown edge).
    """
    H, W = grid.shape
    fx = (xy[..., 0] - origin[0]) / resolution
    fy = (xy[..., 1] - origin[1]) / resolution
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, H - 2)
    tx = jnp.clip(fx - x0.astype(fx.dtype), 0.0, 1.0)
    ty = jnp.clip(fy - y0.astype(fy.dtype), 0.0, 1.0)
    g00 = grid[y0, x0]
    g01 = grid[y0, x0 + 1]
    g10 = grid[y0 + 1, x0]
    g11 = grid[y0 + 1, x0 + 1]
    return ((1 - ty) * ((1 - tx) * g00 + tx * g01)
            + ty * ((1 - tx) * g10 + tx * g11))


def _spline_terms_xy(omap: "ObstacleMap", xy: jnp.ndarray):
    """Unbatched twin of `_spline_terms_bl`: (val, dx, dy, hxx, hyy) per
    point for the single-map ilqr/vmap path, weight-scaled."""
    grid = omap.grid
    H, W = grid.shape
    # _spline_weights clamps the center knot to [1, n-2]: empty range below
    assert H >= 3 and W >= 3, \
        f"sampling='spline' needs a >=3x3 grid, got {H}x{W}"
    if omap.coeff is None and omap.sampling == "spline_coeff":
        # planes requested but not attached: derive them inline from the
        # grid — always fresh (no staleness), but recomputed per call;
        # attach once via with_spline_coeffs for the fast path
        omap = omap.replace(coeff=spline_coeff_planes(grid))
    if omap.coeff is not None:
        res = omap.resolution
        fx = (xy[..., 0] - omap.origin[0]) / res
        fy = (xy[..., 1] - omap.origin[1]) / res
        return _coeff_terms_core(omap.coeff.reshape(H * W, 9), fx, fy,
                                 H, W, res, omap.weight)
    res = omap.resolution
    fx = (xy[..., 0] - omap.origin[0]) / res
    fy = (xy[..., 1] - omap.origin[1]) / res
    mx, wx, dwx = _spline_weights(fx, W)
    my, wy, dwy = _spline_weights(fy, H)
    zero = jnp.zeros_like(fx)
    val = dx = dy = hxx = hyy = zero
    d2 = (1.0, -2.0, 1.0)
    for j in range(3):
        for i in range(3):
            g = grid[my + (j - 1), mx + (i - 1)]
            val = val + wx[i] * wy[j] * g
            dx = dx + dwx[i] * wy[j] * g
            dy = dy + wx[i] * dwy[j] * g
            hxx = hxx + d2[i] * wy[j] * g
            hyy = hyy + wx[i] * d2[j] * g
    in_x = jnp.logical_and(fx >= 0.0, fx <= W - 1.0).astype(fx.dtype)
    in_y = jnp.logical_and(fy >= 0.0, fy <= H - 1.0).astype(fy.dtype)
    inv_r = 1.0 / res
    wgt = omap.weight
    # curvature masked per axis like the gradient: outside in x the field
    # is frozen along x (clamped basis offset), so hxx = 0 there, while
    # hyy in the x-border strip is still genuine (and vice versa) — a
    # frozen axis must contribute zero damping, not phantom stiffness
    return (wgt * val,
            wgt * dx * inv_r * in_x,
            wgt * dy * inv_r * in_y,
            wgt * jnp.maximum(hxx, 0.0) * inv_r * inv_r * in_x,
            wgt * jnp.maximum(hyy, 0.0) * inv_r * inv_r * in_y)


def obstacle_cost(omap: ObstacleMap, xy: jnp.ndarray) -> jnp.ndarray:
    """Total obstacle penalty over points xy (..., 2) (summed over the
    leading axes)."""
    if _sampling_mode(omap) == "spline":
        val, _, _, _, _ = _spline_terms_xy(omap, xy)
        return jnp.sum(val)
    vals = bilinear_sample(omap.grid, omap.origin, omap.resolution, xy)
    return omap.weight * jnp.sum(vals)


def obstacle_grad_xy(omap: ObstacleMap, xy: jnp.ndarray) -> jnp.ndarray:
    """Analytic d(weight * sample)/d(x, y) per point; shape like xy.

    The bilinear surface's gradient is piecewise linear in each cell:
      d/dx = [(1-ty)(g01-g00) + ty(g11-g10)] / res
      d/dy = [(1-tx)(g10-g00) + tx(g11-g01)] / res
    """
    if _sampling_mode(omap) == "spline":
        _, dx, dy, _, _ = _spline_terms_xy(omap, xy)
        return jnp.stack([dx, dy], axis=-1)
    grid = omap.grid
    H, W = grid.shape
    res = omap.resolution
    fx = (xy[..., 0] - omap.origin[0]) / res
    fy = (xy[..., 1] - omap.origin[1]) / res
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, H - 2)
    tx = jnp.clip(fx - x0.astype(fx.dtype), 0.0, 1.0)
    ty = jnp.clip(fy - y0.astype(fy.dtype), 0.0, 1.0)
    g00 = grid[y0, x0]
    g01 = grid[y0, x0 + 1]
    g10 = grid[y0 + 1, x0]
    g11 = grid[y0 + 1, x0 + 1]
    dx = ((1 - ty) * (g01 - g00) + ty * (g11 - g10)) / res
    dy = ((1 - tx) * (g10 - g00) + tx * (g11 - g01)) / res
    # outside the map the sampled value is clamped flat per axis, so the
    # gradient must be zero there too — otherwise nonzero border cells
    # leak a phantom slope the line search can never realize
    in_x = jnp.logical_and(fx >= 0.0, fx <= W - 1.0).astype(dx.dtype)
    in_y = jnp.logical_and(fy >= 0.0, fy <= H - 1.0).astype(dy.dtype)
    dx = dx * in_x
    dy = dy * in_y
    return omap.weight * jnp.stack([dx, dy], axis=-1)


def obstacle_curv_xy(omap: ObstacleMap, xy: jnp.ndarray):
    """Single-map PSD second-difference curvature (hxx, hyy) per point,
    weight-scaled; xy (..., 2) -> each (...,).

    The unbatched twin of `obstacle_curv_bl` (same one-cell central
    second-difference estimator, same >=0 clamp) for the per-scenario
    ilqr/vmap path — keeping the vmap engine's grid backward pass in
    lock-step with the lane path (without it the vmap engine kept the
    rejected-step-spiral behavior the curvature term fixes)."""
    if _sampling_mode(omap) == "spline":
        _, _, _, hxx, hyy = _spline_terms_xy(omap, xy)
        return hxx, hyy
    res = omap.resolution
    ex = jnp.asarray([1.0, 0.0], xy.dtype) * res
    ey = jnp.asarray([0.0, 1.0], xy.dtype) * res
    v = lambda q: omap.weight * bilinear_sample(
        omap.grid, omap.origin, res, q)
    c0 = v(xy)
    inv_r2 = 1.0 / (res * res)
    hxx = jnp.maximum((v(xy + ex) - 2.0 * c0 + v(xy - ex)) * inv_r2, 0.0)
    hyy = jnp.maximum((v(xy + ey) - 2.0 * c0 + v(xy - ey)) * inv_r2, 0.0)
    return hxx, hyy


# per-axis quadratic B-spline basis as polynomials in the fractional
# offset s (cell units, s in [-0.5, 0.5]): w_i(s) = sum_p A[p, i] s^p with
#   w0 = 0.5(0.5-s)^2, w1 = 0.75 - s^2, w2 = 0.5(0.5+s)^2
_SPLINE_A = ((0.125, 0.75, 0.125),
             (-0.5, 0.0, 0.5),
             (0.5, -1.0, 0.5))


def spline_coeff_planes(grid: jnp.ndarray) -> jnp.ndarray:
    """Per-cell bi-quadratic coefficient planes of the quadratic B-spline
    surface: grid (..., H, W) -> (..., H, W, 9) with
        value(sx, sy) = sum_{p,q} C[..., my, mx, 3*p + q] sx^p sy^q,
    sx/sy the fractional offsets from the (clamped) center knot. Computed
    ONCE per costmap update (set_costmap time); per-sample evaluation is
    then one packed row gather + Horner instead of the 9-tap scattered
    stencil.
    Border rows/cols (cell index 0 and n-1) are edge-padded copies — the
    center knot clamps to [1, n-2], so they are never addressed."""
    g = grid
    assert g.shape[-2] >= 3 and g.shape[-1] >= 3, \
        ("spline coefficient planes need >=3x3 grids (the center knot "
         f"clamps to [1, n-2]), got {g.shape[-2]}x{g.shape[-1]}")
    pad = [(0, 0)] * (g.ndim - 2) + [(1, 1), (1, 1)]
    gp = jnp.pad(g, pad, mode="edge")
    H, W = g.shape[-2], g.shape[-1]
    A = _SPLINE_A
    planes = []
    for p in range(3):
        for q in range(3):
            c = None
            for i in range(3):
                for j in range(3):
                    aa = A[p][i] * A[q][j]
                    if aa == 0.0:
                        continue
                    term = aa * gp[..., j:j + H, i:i + W]
                    c = term if c is None else c + term
            planes.append(c)
    return jnp.stack(planes, axis=-1)           # (..., H, W, 9)


def _spline_coeff_eval(c9, sx, sy, dtype):
    """Evaluate the bi-quadratic and its derivatives from gathered
    per-cell coefficients c9 (..., 9) at offsets sx/sy (...,) — pure
    Horner, no further gathers. Returns (val, d/dsx, d/dsy, d2/dsx2,
    d2/dsy2) in CELL units (caller scales by 1/res)."""
    c = [c9[..., k] for k in range(9)]
    # S_q(sx) = sum_p c[3p+q] sx^p
    S = [c[q] + sx * (c[3 + q] + sx * c[6 + q]) for q in range(3)]
    dS = [c[3 + q] + 2.0 * sx * c[6 + q] for q in range(3)]
    val = S[0] + sy * (S[1] + sy * S[2])
    dvx = dS[0] + sy * (dS[1] + sy * dS[2])
    dvy = S[1] + 2.0 * sy * S[2]
    hxx = 2.0 * (c[6] + sy * (c[7] + sy * c[8]))
    hyy = 2.0 * (S[2])
    return val, dvx, dvy, hxx, hyy


def _coeff_terms_core(coeff_rows, fx, fy, H: int, W: int, res, wgt,
                      b_idx=None):
    """Shared tail of the coefficient-plane evaluation (single-map and
    lane-major twins differ only in the row index): clamp the center
    knot/offsets exactly like `_spline_weights`, one packed row gather,
    Horner, then the per-axis border masks and weight/res scaling —
    ONE copy so the mask/clamp policy cannot diverge between paths."""
    mx = jnp.clip(jnp.round(fx).astype(jnp.int32), 1, W - 2)
    my = jnp.clip(jnp.round(fy).astype(jnp.int32), 1, H - 2)
    sx = jnp.clip(fx - mx.astype(fx.dtype), -0.5, 0.5)
    sy = jnp.clip(fy - my.astype(fy.dtype), -0.5, 0.5)
    cell = my * W + mx
    if b_idx is not None:
        cell = b_idx * (H * W) + cell
    c9 = jnp.take(coeff_rows, cell, axis=0)
    val, dvx, dvy, hxx, hyy = _spline_coeff_eval(c9, sx, sy, fx.dtype)
    in_x = jnp.logical_and(fx >= 0.0, fx <= W - 1.0).astype(fx.dtype)
    in_y = jnp.logical_and(fy >= 0.0, fy <= H - 1.0).astype(fy.dtype)
    inv_r = 1.0 / res
    return (wgt * val,
            wgt * dvx * inv_r * in_x,
            wgt * dvy * inv_r * in_y,
            wgt * jnp.maximum(hxx, 0.0) * inv_r * inv_r * in_x,
            wgt * jnp.maximum(hyy, 0.0) * inv_r * inv_r * in_y)


def _spline_weights(f, n: int):
    """3-tap uniform quadratic B-spline weights/derivatives on one axis.
    f: continuous coordinate in cell units; n: axis size. Center knot
    clamped one cell inside so all three taps are in-bounds; the
    fractional offset clamps to the basis support (freezes the value in
    the half-cell border strip, matching the bilinear border clamp)."""
    m = jnp.clip(jnp.round(f).astype(jnp.int32), 1, n - 2)
    s = jnp.clip(f - m.astype(f.dtype), -0.5, 0.5)
    w = (0.5 * (0.5 - s) ** 2, 0.75 - s * s, 0.5 * (0.5 + s) ** 2)
    dw = (s - 0.5, -2.0 * s, s + 0.5)
    return m, w, dw


def _spline_coeff_terms_bl(omaps: "ObstacleMap", x: jnp.ndarray,
                           y: jnp.ndarray):
    """Coefficient-plane twin of `_spline_terms_bl`: same bi-quadratic
    surface evaluated from the precomputed (B, H, W, 9) planes — one
    packed row gather (jnp.take of 9-wide rows at the cell index) + a 2-D
    Horner, instead of 9 scattered single-element gathers."""
    grids = omaps.grid
    B, H, W = grids.shape
    res = omaps.resolution
    fx = (x - omaps.origin[:, 0]) / res
    fy = (y - omaps.origin[:, 1]) / res
    b_idx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32), fx.shape)
    return _coeff_terms_core(omaps.coeff.reshape(B * H * W, 9), fx, fy,
                             H, W, res, omaps.weight, b_idx=b_idx)


def _spline_terms_bl(omaps: "ObstacleMap", x: jnp.ndarray, y: jnp.ndarray):
    """C1 quadratic-B-spline field terms, lane-major batched:
    (val, dx, dy, hxx, hyy), each shaped like x, weight-scaled. The
    second derivatives are analytic (d2B = (1, -2, 1)/res^2 per axis,
    piecewise constant), PSD-clamped for the backward pass. With
    precomputed coefficient planes (`with_spline_coeffs`), evaluation
    routes to the packed-gather twin; sampling='spline_coeff' without
    attached planes derives them inline (fresh per call)."""
    assert omaps.grid.shape[-2] >= 3 and omaps.grid.shape[-1] >= 3, \
        ("sampling='spline' needs >=3x3 grids, got "
         f"{omaps.grid.shape[-2]}x{omaps.grid.shape[-1]}")
    if omaps.coeff is None and omaps.sampling == "spline_coeff":
        omaps = omaps.replace(coeff=spline_coeff_planes(omaps.grid))
    if omaps.coeff is not None:
        return _spline_coeff_terms_bl(omaps, x, y)
    grids = omaps.grid
    B, H, W = grids.shape
    flat = grids.reshape(B * H * W)
    res = omaps.resolution
    fx = (x - omaps.origin[:, 0]) / res
    fy = (y - omaps.origin[:, 1]) / res
    mx, wx, dwx = _spline_weights(fx, W)
    my, wy, dwy = _spline_weights(fy, H)
    b_idx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32), mx.shape)
    base = (b_idx * H + my) * W + mx
    zero = jnp.zeros_like(x)
    val = dx = dy = hxx = hyy = zero
    d2 = (1.0, -2.0, 1.0)
    for j in range(3):
        row = base + (j - 1) * W
        for i in range(3):
            g = jnp.take(flat, row + (i - 1))
            val = val + wx[i] * wy[j] * g
            dx = dx + dwx[i] * wy[j] * g
            dy = dy + wx[i] * dwy[j] * g
            hxx = hxx + d2[i] * wy[j] * g
            hyy = hyy + wx[i] * d2[j] * g
    in_x = jnp.logical_and(fx >= 0.0, fx <= W - 1.0).astype(x.dtype)
    in_y = jnp.logical_and(fy >= 0.0, fy <= H - 1.0).astype(x.dtype)
    inv_r = 1.0 / res
    wgt = omaps.weight
    # per-axis curvature masks — see _spline_terms_xy
    return (wgt * val,
            wgt * dx * inv_r * in_x,
            wgt * dy * inv_r * in_y,
            wgt * jnp.maximum(hxx, 0.0) * inv_r * inv_r * in_x,
            wgt * jnp.maximum(hyy, 0.0) * inv_r * inv_r * in_y)


def obstacle_cost_grad_bl(omaps: "ObstacleMap", x: jnp.ndarray,
                          y: jnp.ndarray):
    """Lane-major batched sampling: per-scenario grids, batch-last points.

    omaps: batched ObstacleMap (leaves with leading B: grid (B,H,W),
    origin (B,2), resolution (B,), weight (B,)). x, y: (..., B) robot-frame
    points. Returns (cost, dx, dy), each (..., B), already weight-scaled.
    Implemented as four flat gathers per point set (bilinear corners);
    sampling="spline" routes to the 9-gather C1 reconstruction.
    """
    if _sampling_mode(omaps) == "spline":
        val, dx, dy, _, _ = _spline_terms_bl(omaps, x, y)
        return val, dx, dy
    grids = omaps.grid                        # (B, H, W)
    B, H, W = grids.shape
    flat = grids.reshape(B * H * W)
    res = omaps.resolution                    # (B,)
    ox = omaps.origin[:, 0]
    oy = omaps.origin[:, 1]
    wgt = omaps.weight

    fx = (x - ox) / res
    fy = (y - oy) / res
    x0 = jnp.clip(jnp.floor(fx).astype(jnp.int32), 0, W - 2)
    y0 = jnp.clip(jnp.floor(fy).astype(jnp.int32), 0, H - 2)
    tx = jnp.clip(fx - x0.astype(fx.dtype), 0.0, 1.0)
    ty = jnp.clip(fy - y0.astype(fy.dtype), 0.0, 1.0)

    b_idx = jnp.broadcast_to(jnp.arange(B, dtype=jnp.int32), x0.shape)
    base = (b_idx * H + y0) * W + x0
    g00 = jnp.take(flat, base)
    g01 = jnp.take(flat, base + 1)
    g10 = jnp.take(flat, base + W)
    g11 = jnp.take(flat, base + W + 1)

    val = ((1 - ty) * ((1 - tx) * g00 + tx * g01)
           + ty * ((1 - tx) * g10 + tx * g11))
    dx = ((1 - ty) * (g01 - g00) + ty * (g11 - g10)) / res
    dy = ((1 - tx) * (g10 - g00) + tx * (g11 - g01)) / res
    # zero the clamped-axis gradient outside the map (see obstacle_grad_xy)
    dx = dx * jnp.logical_and(fx >= 0.0, fx <= W - 1.0).astype(dx.dtype)
    dy = dy * jnp.logical_and(fy >= 0.0, fy <= H - 1.0).astype(dy.dtype)
    return wgt * val, wgt * dx, wgt * dy


def obstacle_curv_bl(omaps: "ObstacleMap", x: jnp.ndarray, y: jnp.ndarray):
    """Smoothed PSD curvature estimate for the grid penalty (hxx, hyy),
    weight-scaled, shapes like x.

    A bilinear surface has ZERO pure second derivatives inside every cell
    — its curvature lives entirely at cell boundaries — so a backward
    pass fed only the grid's gradient has no stiffness information and
    hard scenarios die in rejected-step spirals (mu ramps to 1e3-1e6;
    measured conv 0.94 on the bench grid ensemble, the round-2 0.89
    wart). This estimates curvature with a one-cell central second
    difference of the (continuous) bilinear surface, clamped to >= 0 —
    a PSD diagonal Gauss-Newton-style term that restores step damping
    without biasing the gradient (same fixed points). sampling="spline"
    returns the spline's ANALYTIC (piecewise-constant) second
    derivatives instead — no finite differencing."""
    if _sampling_mode(omaps) == "spline":
        _, _, _, hxx, hyy = _spline_terms_bl(omaps, x, y)
        return hxx, hyy
    c0, _, _ = obstacle_cost_grad_bl(omaps, x, y)
    res = omaps.resolution
    cxp, _, _ = obstacle_cost_grad_bl(omaps, x + res, y)
    cxm, _, _ = obstacle_cost_grad_bl(omaps, x - res, y)
    cyp, _, _ = obstacle_cost_grad_bl(omaps, x, y + res)
    cym, _, _ = obstacle_cost_grad_bl(omaps, x, y - res)
    inv_r2 = 1.0 / (res * res)
    hxx = jnp.maximum((cxp - 2.0 * c0 + cxm) * inv_r2, 0.0)
    hyy = jnp.maximum((cyp - 2.0 * c0 + cym) * inv_r2, 0.0)
    return hxx, hyy


@pytree.dataclass
class GaussianObstacles:
    """Parametric obstacle field: K Gaussian blobs per scenario.

    cost(x, y) = sum_k w[k] * exp(-((x-cx[k])^2 + (y-cy[k])^2) * gamma[k]),
    gamma = 1 / (2 sigma^2). All leaves are batch-major (B, K) (or (K,) for
    a single scenario).

    This is the fast obstacle representation: smooth (C-inf) with an
    analytic gradient AND a PSD Gauss-Newton curvature term, and pure
    elementwise math — no grid gathers — so it runs inside the
    whole-solve kernel. Grid costmaps
    (`ObstacleMap`) remain supported on the XLA paths for exact costmap_2d
    parity; `fit_gaussians_to_map` converts a grid into blobs for the fast
    path.
    """

    cx: Array      # (B, K) blob centers x
    cy: Array      # (B, K) blob centers y
    gamma: Array   # (B, K) 1 / (2 sigma^2)
    w: Array       # (B, K) weights (penalty height)

    @staticmethod
    def from_sigmas(cx, cy, sigma, w) -> "GaussianObstacles":
        cx = jnp.asarray(cx)
        sigma = jnp.broadcast_to(jnp.asarray(sigma, cx.dtype), cx.shape)
        return GaussianObstacles(
            cx=cx, cy=jnp.asarray(cy),
            gamma=1.0 / (2.0 * sigma * sigma),
            w=jnp.broadcast_to(jnp.asarray(w, cx.dtype), cx.shape),
        )

    @property
    def n_blobs(self) -> int:
        return self.cx.shape[-1]

    def to_frame(self, pose) -> "GaussianObstacles":
        """World-frame blobs -> the frame of `pose` (x, y, yaw): rotate and
        translate the centers (isotropic gamma and w are frame-invariant).
        Same convention as the plan transform in the tracking controller
        (x_veh = dx ct + dy st, y_veh = dy ct - dx st)."""
        px, py, yaw = (jnp.asarray(pose[i], self.cx.dtype) for i in range(3))
        ct, st = jnp.cos(yaw), jnp.sin(yaw)
        dx = self.cx - px
        dy = self.cy - py
        return GaussianObstacles(cx=dx * ct + dy * st,
                                 cy=dy * ct - dx * st,
                                 gamma=self.gamma, w=self.w)

    def lane(self):
        """Lane-major views: four (K, B) arrays (cx, cy, gamma, w)."""
        t = lambda a: jnp.swapaxes(jnp.atleast_2d(a), 0, 1)
        return t(self.cx), t(self.cy), t(self.gamma), t(self.w)


def blob_cost(blobs: GaussianObstacles, xy: jnp.ndarray) -> jnp.ndarray:
    """Total blob penalty over points xy (..., 2) for ONE scenario
    (blob leaves (K,)); summed over all leading axes."""
    dx = xy[..., 0:1] - blobs.cx
    dy = xy[..., 1:2] - blobs.cy
    return jnp.sum(blobs.w * jnp.exp(-(dx * dx + dy * dy) * blobs.gamma))


def blob_concave_bl(bx, by, bg, bw, x, y):
    """The blob Hessian's concave isotropic magnitude sum_k 2 g_k v_k —
    the part Gauss-Newton drops (see blob_terms_bl). The gated DDP
    backward subtracts it from the GN curvature diagonal to recover the
    EXACT Hessian near convergence (solver/batch_lane.py)."""
    K = bx.shape[0]
    corr = jnp.zeros(x.shape, x.dtype)
    for k in range(K):
        dx = x - bx[k]
        dy = y - by[k]
        v = bw[k] * jnp.exp(-(dx * dx + dy * dy) * bg[k])
        corr = corr + 2.0 * bg[k] * v
    return corr


def blob_terms_bl(bx, by, bg, bw, x, y):
    """Batch-last blob cost/gradient/GN-curvature at points.

    bx, by, bg, bw: (K, B) lane-major blob params (`GaussianObstacles.lane`).
    x, y: (..., B) points. Returns (val, gx, gy, hxx, hxy, hyy), each
    (..., B), summed over blobs.

    The exact Hessian of one blob is v * (4 g^2 d d^T - 2 g I); the -2 g I
    part is negative (the penalty is concave at its peak), so Gauss-Newton
    keeps only the PSD outer-product part 4 g^2 v d d^T — the gradient stays
    exact, curvature is a convex upper model, and the Levenberg mu absorbs
    the rest (standard GN treatment of repulsive penalties).
    """
    K = bx.shape[0]
    shp = x.shape
    val = gx = gy = hxx = hxy = hyy = jnp.zeros(shp, x.dtype)
    for k in range(K):
        dx = x - bx[k]
        dy = y - by[k]
        g = bg[k]
        v = bw[k] * jnp.exp(-(dx * dx + dy * dy) * g)
        tg = 2.0 * g
        val = val + v
        gx = gx - tg * dx * v
        gy = gy - tg * dy * v
        s = tg * tg * v
        hxx = hxx + s * dx * dx
        hxy = hxy + s * dx * dy
        hyy = hyy + s * dy * dy
    return val, gx, gy, hxx, hxy, hyy


def fit_gaussians_to_map(omap: ObstacleMap, n_blobs: int = 4,
                         min_peak: float = 1e-3,
                         refine: bool = True) -> GaussianObstacles:
    """Fit K Gaussian blobs to a grid costmap: greedy peak peeling, then a
    bounded least-squares refinement.

    Greedy init: repeatedly take the residual grid's peak cell, estimate
    sigma from the second difference at the peak (a Gaussian's
    log-curvature: d2/dx2 log g = -1/sigma^2), subtract, repeat. With
    `refine` (default), all K blobs' (cx, cy, gamma, w) are then jointly
    least-squares fitted to the full grid under box bounds (centers inside
    the map, w >= 0) — on costmap_2d-style inflated maps (plateau +
    exponential decay, the reference's native obstacle representation,
    /root/reference/mpc_ros/src/mpc_planner_ros.cpp:47-49) this drops the
    max fit error from 44-77% of the peak to <= ~12% and the on-support
    mean error to <= ~2% (bound pinned by tests/test_obstacle_fit.py).

    Host-side prep (numpy/scipy) at map-update rate, not per cycle; the
    result feeds the parametric fast path (inside the whole-solve kernel;
    grids run the slower gather-based XLA path). Peaks below `min_peak`
    produce zero-weight blobs (padding).
    """
    import numpy as np

    grid = np.asarray(omap.grid, np.float64).copy()
    H, W = grid.shape
    res = float(omap.resolution)
    ox, oy = float(omap.origin[0]), float(omap.origin[1])
    wmul = float(omap.weight)
    dtype = omap.grid.dtype

    cxs, cys, sigmas, ws = [], [], [], []
    for _ in range(n_blobs):
        iy, ix = np.unravel_index(np.argmax(grid), grid.shape)
        peak = grid[iy, ix]
        if peak < min_peak:
            cxs.append(0.0), cys.append(0.0), sigmas.append(1.0), ws.append(0.0)
            continue
        # sigma from the discrete log-curvature at the peak (clamped inside)
        i0x, i1x = max(ix - 1, 0), min(ix + 1, W - 1)
        i0y, i1y = max(iy - 1, 0), min(iy + 1, H - 1)
        eps = 1e-12
        cxx = (np.log(grid[iy, i1x] + eps) - 2.0 * np.log(peak + eps)
               + np.log(grid[iy, i0x] + eps)) / res**2
        cyy = (np.log(grid[i1y, ix] + eps) - 2.0 * np.log(peak + eps)
               + np.log(grid[i0y, ix] + eps)) / res**2
        curv = max(-0.5 * (cxx + cyy), 1.0 / (20.0 * res) ** 2)
        sigma = 1.0 / np.sqrt(curv)
        cx = ox + ix * res
        cy = oy + iy * res
        X = ox + np.arange(W) * res
        Y = oy + np.arange(H) * res
        XX, YY = np.meshgrid(X, Y)
        blob = peak * np.exp(-((XX - cx) ** 2 + (YY - cy) ** 2)
                             / (2.0 * sigma**2))
        grid = np.maximum(grid - blob, 0.0)
        cxs.append(cx), cys.append(cy), sigmas.append(sigma)
        ws.append(peak * wmul)
    blobs = GaussianObstacles.from_sigmas(
        jnp.asarray(cxs, dtype), jnp.asarray(cys, dtype),
        jnp.asarray(sigmas, dtype), jnp.asarray(ws, dtype))
    if not refine:
        return blobs
    return _refine_blobs_lsq(omap, blobs, dtype)


def _refine_blobs_lsq(omap: ObstacleMap, blobs: GaussianObstacles,
                      dtype) -> GaussianObstacles:
    """Joint bounded least-squares refinement of all K blobs against the
    full grid (scipy trf). Parameters: centers (inside the map), log gamma
    (in [1e-2, 1e3] 1/m^2), amplitude (in [0, 2*peak] grid units)."""
    import numpy as np
    from scipy.optimize import least_squares

    grid = np.asarray(omap.grid, np.float64)
    H, W = grid.shape
    res = float(omap.resolution)
    ox, oy = float(omap.origin[0]), float(omap.origin[1])
    wmul = float(omap.weight)
    xf = (ox + np.arange(W) * res)[None, :].repeat(H, 0).ravel()
    yf = (oy + np.arange(H) * res)[:, None].repeat(W, 1).ravel()
    tgt = grid.ravel()
    peak = float(tgt.max())
    if peak <= 0.0 or wmul == 0.0:
        return blobs

    cx = np.asarray(blobs.cx, float)
    cy = np.asarray(blobs.cy, float)
    g_ = np.asarray(blobs.gamma, float)
    w_ = np.asarray(blobs.w, float) / wmul
    K = len(cx)
    x_hi, y_hi = ox + (W - 1) * res, oy + (H - 1) * res
    p0 = np.concatenate([np.clip(cx, ox, x_hi), np.clip(cy, oy, y_hi),
                         np.log(np.clip(g_, 1e-2, 1e3)),
                         np.clip(w_, 0.0, 2.0 * peak)])
    lo = np.concatenate([np.full(K, ox), np.full(K, oy),
                         np.full(K, np.log(1e-2)), np.zeros(K)])
    hi = np.concatenate([np.full(K, x_hi), np.full(K, y_hi),
                         np.full(K, np.log(1e3)),
                         np.full(K, 2.0 * peak + 1e-9)])

    def resid(p):
        cxk, cyk, lg, wk = p[:K], p[K:2 * K], p[2 * K:3 * K], p[3 * K:]
        gam = np.exp(lg)
        f = np.zeros_like(tgt)
        for k in range(K):
            f += wk[k] * np.exp(-gam[k] * ((xf - cxk[k]) ** 2
                                           + (yf - cyk[k]) ** 2))
        return f - tgt

    r = least_squares(resid, p0, bounds=(lo, hi), max_nfev=120,
                      method="trf")
    p = r.x
    return GaussianObstacles(
        cx=jnp.asarray(p[:K], dtype), cy=jnp.asarray(p[K:2 * K], dtype),
        gamma=jnp.asarray(np.exp(p[2 * K:3 * K]), dtype),
        w=jnp.asarray(p[3 * K:] * wmul, dtype))


def fit_gaussians_to_maps(omaps: ObstacleMap, n_blobs: int = 4,
                          min_peak: float = 1e-3) -> GaussianObstacles:
    """Batched DEVICE greedy blob fit: (B, H, W) costmaps -> (B, K) blobs
    in one jitted program (VERDICT r3 item 3 — the per-cycle fleet-scale
    costmap->Gaussians conversion).

    Same greedy peak-peeling as the host `fit_gaussians_to_map`
    (refine=False): K rounds of [argmax peak -> sigma from the discrete
    log-curvature at the peak -> subtract the blob -> clamp at 0],
    expressed as a `lax.scan` under `vmap`. All math is elementwise over
    the (B, H, W) grid plus (B,)-sized row gathers for the peak and its 4
    neighbors (small row gathers only); equality with
    the host fit is pinned in tests/test_obstacle_fit.py.

    The scipy `refine` stage stays host-side at map-update rate: it is a
    bounded trust-region LSQ (~10 s/map) that tightens plateau-style maps
    from ~12% to ~2% mean error — the greedy fit alone is what a
    per-cycle (20 Hz) refresh can afford, and the closed-loop fidelity of
    exactly that pipeline is pinned in tests/test_obstacle_fit.py.

    `omaps` leaves are batched: grid (B, H, W), origin (B, 2),
    resolution (B,), weight (B,).
    """
    import jax

    grids = omaps.grid
    B, H, W = grids.shape
    dtype = grids.dtype
    eps = 1e-12

    def fit_one(grid, origin, res, wmul):
        ixs = jnp.arange(W, dtype=dtype) * res + origin[0]
        iys = jnp.arange(H, dtype=dtype) * res + origin[1]

        def peel(g, _):
            idx = jnp.argmax(g.reshape(-1))
            iy = idx // W
            ix = idx % W
            peak = g.reshape(-1)[idx]
            # sigma from the discrete log-curvature at the peak, neighbor
            # indices clamped inside the map (same as the host fit)
            gl = g[iy, jnp.maximum(ix - 1, 0)]
            gr = g[iy, jnp.minimum(ix + 1, W - 1)]
            gd = g[jnp.maximum(iy - 1, 0), ix]
            gu = g[jnp.minimum(iy + 1, H - 1), ix]
            lp = jnp.log(peak + eps)
            cxx = (jnp.log(gr + eps) - 2.0 * lp + jnp.log(gl + eps)) / res**2
            cyy = (jnp.log(gu + eps) - 2.0 * lp + jnp.log(gd + eps)) / res**2
            curv = jnp.maximum(-0.5 * (cxx + cyy), 1.0 / (20.0 * res) ** 2)
            inv2sig2 = 0.5 * curv            # 1 / (2 sigma^2)
            cx = origin[0] + ix.astype(dtype) * res
            cy = origin[1] + iy.astype(dtype) * res
            blob = peak * jnp.exp(-((ixs[None, :] - cx) ** 2
                                    + (iys[:, None] - cy) ** 2) * inv2sig2)
            live = (peak >= min_peak).astype(dtype)
            g = jnp.maximum(g - live * blob, 0.0)
            return g, (live * cx, live * cy,
                       jnp.where(live > 0, inv2sig2, 0.5),
                       live * peak * wmul)

        _, (cx, cy, gamma, w) = jax.lax.scan(peel, grid, None,
                                             length=n_blobs)
        return cx, cy, gamma, w

    cx, cy, gamma, w = jax.vmap(fit_one)(grids, omaps.origin,
                                         omaps.resolution, omaps.weight)
    return GaussianObstacles(cx=cx, cy=cy, gamma=gamma, w=w)


def gaussian_blob_map(center, sigma: float = 0.4, extent: float = 4.0,
                      cells: int = 64, weight: float = 50.0,
                      dtype=jnp.float32,
                      sampling: str = "bilinear") -> ObstacleMap:
    """Synthetic costmap: one Gaussian obstacle blob (benchmarks/tests).
    sampling="spline_coeff" builds a spline map with precomputed per-cell
    coefficient planes attached (with_spline_coeffs)."""
    coeffs = sampling == "spline_coeff"
    if coeffs:
        sampling = "spline"
    xs = jnp.linspace(-extent / 2, extent / 2, cells, dtype=dtype)
    X, Y = jnp.meshgrid(xs, xs)
    cx, cy = center
    g = jnp.exp(-((X - cx) ** 2 + (Y - cy) ** 2) / (2.0 * sigma**2))
    m = ObstacleMap(
        grid=g.astype(dtype),
        origin=jnp.asarray([-extent / 2, -extent / 2], dtype),
        resolution=jnp.asarray(extent / (cells - 1), dtype),
        weight=jnp.asarray(weight, dtype),
        sampling=sampling,
    )
    return m.with_spline_coeffs() if coeffs else m
