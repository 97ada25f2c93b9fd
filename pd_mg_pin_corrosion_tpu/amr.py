"""Two-level AMR grid: fine zone near the wire, coarse far field, fictitious
coupling nodes with p=4 IDW interpolation (Shojaei et al., IJMS 144, 2018).

Host-side rewrite of Grid::build_amr + build_neighbors_celllist
(src/grid.cpp:296-808). Differences from the structured path (grid.py):
node arrays are flat [N] (unstructured), and the neighbor structure is a
fixed-degree padded array [N, K] (index/dist/evec/volume with a validity
implied by vol > 0) built by a cell-list radius search — the dense-array
replacement for the reference's CSR rows, consumed by gather-based kernels
in unstructured.py.

Bond rules preserved from the reference:
* bonds only between nodes of the SAME grid level (real or fictitious)
  (grid.cpp:732-739)
* beta partial-volume correction uses the *neighbor's* dx (grid.cpp:751-760)
* coincident-node skip r < 1e-14 (grid.cpp:746)
* OUTSIDE nodes excluded entirely
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

from .config import Config
from .grid import (FICTITIOUS, FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG, WALL)

PI = math.pi


@dataclass(frozen=True)
class AMRGrid:
    """Unstructured two-level grid (flat arrays)."""

    dim: int
    dx: float            # fine spacing
    delta: float         # fine horizon
    m: int
    R_wire: float
    L_wire: float
    R_tube: float

    pos: np.ndarray           # [N, dim]
    node_type: np.ndarray     # [N] uint8
    dx_local: np.ndarray      # [N]
    delta_local: np.ndarray   # [N]
    grid_level: np.ndarray    # [N] int32 (0=fine, 1=coarse)

    # padded fixed-degree neighbors
    nbr_idx: np.ndarray       # [N, K] int32 (self-index where invalid)
    nbr_dist: np.ndarray      # [N, K] (1.0 where invalid — safe divisor)
    nbr_evec: np.ndarray      # [N, K, dim]
    nbr_vol: np.ndarray       # [N, K] (0 where invalid)

    # fictitious IDW coupling (padded)
    fict_nodes: np.ndarray    # [Nf] int32 global indices of FICTITIOUS nodes
    fict_src: np.ndarray      # [Nf, Kf] int32 (0 where invalid)
    fict_w: np.ndarray        # [Nf, Kf] (0 where invalid; rows sum to 1)

    mirror_idx: np.ndarray    # [N] int32 wall-mirror source (-1 none)

    @property
    def N_total(self) -> int:
        return len(self.node_type)

    @property
    def K(self) -> int:
        return self.nbr_idx.shape[1]

    @property
    def shape(self) -> tuple:
        return (self.N_total,)

    @property
    def axial_axis(self) -> int:
        return 1 if self.dim == 2 else 2

    def type_counts(self) -> dict:
        from .grid import NODE_TYPE_NAMES
        counts = np.bincount(self.node_type, minlength=7)
        return {NODE_TYPE_NAMES[t]: int(counts[t]) for t in range(7)}


# ---------------------------------------------------------------------------


def _classify(cfg: Config, px, py, pz, m_local, dx_local):
    """Scalar/vector node classification at local spacing (grid.cpp:302-338)."""
    dim = cfg.dim
    axial = py if dim == 2 else pz
    radial = np.abs(px) if dim == 2 else np.sqrt(px * px + py * py)
    z_min = -cfg.L_upstream
    z_max = cfg.L_wire + cfg.L_downstream
    wall_lim = cfg.R_tube + m_local * dx_local + 0.5 * dx_local

    nt = np.full(np.shape(px), OUTSIDE, dtype=np.uint8)
    up = axial < z_min
    dn = axial > z_max
    mid = ~up & ~dn
    in_tube = radial <= cfg.R_tube
    in_wall = (radial > cfg.R_tube) & (radial <= wall_lim)
    if dim == 2:
        wire = (np.abs(px) <= cfg.R_wire) & (py >= 0.0) & (py <= cfg.L_wire)
    else:
        wire = (px * px + py * py <= cfg.R_wire**2) & (pz >= 0.0) & (pz <= cfg.L_wire)

    nt[up & in_tube] = INLET
    nt[up & in_wall] = WALL
    nt[dn & in_tube] = OUTLET
    nt[dn & in_wall] = WALL
    nt[mid & in_tube & wire] = SOLID_MG
    nt[mid & in_tube & ~wire] = FLUID
    nt[mid & in_wall] = WALL
    return nt


def _in_fine_zone(x, y, fine_r, z_lo, z_hi):
    return (np.abs(x) <= fine_r) & (y >= z_lo) & (y <= z_hi)


def build_amr_grid(cfg: Config) -> AMRGrid:
    """Two-level node placement + fictitious bands (grid.cpp:349-654).

    2D only, matching the reference (its build_amr hardcodes 2D positions).
    """
    assert cfg.dim == 2, "AMR is 2D (matches reference build_amr)"
    dx_f, dx_c = cfg.dx, cfg.dx_coarse
    delta_f, delta_c = cfg.delta, cfg.delta_coarse
    m = cfg.m_ratio

    fine_r = cfg.R_wire + cfg.amr_buffer
    fine_z_lo = -cfg.amr_buffer
    fine_z_hi = cfg.L_wire + cfg.amr_buffer

    z_dom_lo = -cfg.L_upstream - m * dx_c
    z_dom_hi = cfg.L_wire + cfg.L_downstream + m * dx_c
    r_dom_lo = -cfg.R_tube - m * dx_c
    r_dom_hi = cfg.R_tube + m * dx_c

    def lattice(dx):
        nx = int(round((r_dom_hi - r_dom_lo) / dx)) + 1
        ny = int(round((z_dom_hi - z_dom_lo) / dx)) + 1
        xs = r_dom_lo + np.arange(nx) * dx
        ys = z_dom_lo + np.arange(ny) * dx
        X, Y = np.meshgrid(xs, ys)  # [ny, nx]
        return X.ravel(), Y.ravel()

    # Step 1: fine REAL nodes inside the fine zone
    Xf, Yf = lattice(dx_f)
    in_f = _in_fine_zone(Xf, Yf, fine_r, fine_z_lo, fine_z_hi)
    nt_f = _classify(cfg, Xf, Yf, 0.0, m, dx_f)
    keep_f = in_f & (nt_f != OUTSIDE)
    fx, fy, fnt = Xf[keep_f], Yf[keep_f], nt_f[keep_f]

    # Step 2: coarse REAL nodes outside the fine zone
    Xc, Yc = lattice(dx_c)
    in_c = _in_fine_zone(Xc, Yc, fine_r, fine_z_lo, fine_z_hi)
    nt_c = _classify(cfg, Xc, Yc, 0.0, m, dx_c)
    keep_c = ~in_c & (nt_c != OUTSIDE)
    cx, cy, cnt_ = Xc[keep_c], Yc[keep_c], nt_c[keep_c]

    n_fine, n_coarse = len(fx), len(cx)
    pos = np.concatenate([
        np.stack([fx, fy], -1), np.stack([cx, cy], -1)])
    node_type = np.concatenate([fnt, cnt_])
    dx_local = np.concatenate([np.full(n_fine, dx_f), np.full(n_coarse, dx_c)])
    delta_local = np.concatenate([np.full(n_fine, delta_f), np.full(n_coarse, delta_c)])
    grid_level = np.concatenate([np.zeros(n_fine, np.int32), np.ones(n_coarse, np.int32)])
    N_real = n_fine + n_coarse

    # spatial hash over REAL nodes for IDW source lookup (grid.cpp:462-510)
    from scipy.spatial import cKDTree
    tree_fine = cKDTree(pos[:n_fine])
    tree_coarse = cKDTree(pos[n_fine:])

    def idw_sources(px, py, radius, level):
        tree = tree_fine if level == 0 else tree_coarse
        off = 0 if level == 0 else n_fine
        ids = tree.query_ball_point([px, py], radius)
        # exclude OUTSIDE (cannot occur: filtered) — keep reference parity
        out = []
        for j in ids:
            out.append(off + j)
        return out

    # Step 3: auxiliary (fictitious) nodes
    fict_pos, fict_level, fict_srcs, fict_ws = [], [], [], []

    def add_fict(px, py, level, sources):
        if not sources:
            return
        d2 = np.maximum(((pos[sources] - [px, py]) ** 2).sum(-1), 1e-30)
        w = 1.0 / (d2 * d2)  # p=4 IDW (grid.cpp:549)
        w = w / w.sum()
        fict_pos.append((px, py))
        fict_level.append(level)
        fict_srcs.append(np.asarray(sources, np.int64))
        fict_ws.append(w)

    # aux FINE nodes: fine lattice outside fine zone, within delta_f+dx_f band,
    # sourcing from COARSE real nodes within delta_c (grid.cpp:513-558)
    aux_r = fine_r + delta_f + dx_f
    aux_lo = fine_z_lo - delta_f - dx_f
    aux_hi = fine_z_hi + delta_f + dx_f
    band_f = (~in_f) & _in_fine_zone(Xf, Yf, aux_r, aux_lo, aux_hi) & (nt_f != OUTSIDE)
    for px, py in zip(Xf[band_f], Yf[band_f]):
        add_fict(px, py, 0, idw_sources(px, py, delta_c, 1))

    # aux COARSE nodes: coarse lattice inside the fine zone near its boundary,
    # sourcing from FINE real nodes within delta_f (grid.cpp:560-605)
    inner_r = fine_r - delta_c - dx_c
    inner_lo = fine_z_lo + delta_c + dx_c
    inner_hi = fine_z_hi - delta_c - dx_c
    band_c = in_c & ~_in_fine_zone(Xc, Yc, inner_r, inner_lo, inner_hi) & (nt_c != OUTSIDE)
    for px, py in zip(Xc[band_c], Yc[band_c]):
        add_fict(px, py, 1, idw_sources(px, py, delta_f, 0))

    n_fict = len(fict_pos)
    if n_fict:
        pos = np.concatenate([pos, np.asarray(fict_pos)])
        node_type = np.concatenate([node_type,
                                    np.full(n_fict, FICTITIOUS, np.uint8)])
        dx_local = np.concatenate([dx_local, np.where(
            np.asarray(fict_level) == 0, dx_f, dx_c)])
        delta_local = np.concatenate([delta_local, np.where(
            np.asarray(fict_level) == 0, delta_f, delta_c)])
        grid_level = np.concatenate([grid_level,
                                     np.asarray(fict_level, np.int32)])

    N = len(node_type)
    fict_nodes = np.arange(N_real, N, dtype=np.int32)
    Kf = max((len(s) for s in fict_srcs), default=1)
    fict_src = np.zeros((n_fict, Kf), np.int32)
    fict_w = np.zeros((n_fict, Kf))
    for i, (s, w) in enumerate(zip(fict_srcs, fict_ws)):
        fict_src[i, : len(s)] = s
        fict_w[i, : len(w)] = w

    # Step 4: padded neighbor arrays via cell-list search (grid.cpp:660-808)
    nbr_idx, nbr_dist, nbr_evec, nbr_vol = _build_neighbors_padded(
        cfg, pos, node_type, dx_local, delta_local, grid_level)

    mirror_idx = _build_mirror_amr(cfg, pos, node_type, nbr_idx, nbr_dist, nbr_vol)

    print(f"AMR: {n_fine} fine, {n_coarse} coarse, {n_fict} fictitious "
          f"nodes (total {N}); K={nbr_idx.shape[1]}")

    return AMRGrid(
        dim=2, dx=dx_f, delta=delta_f, m=m, R_wire=cfg.R_wire,
        L_wire=cfg.L_wire, R_tube=cfg.R_tube, pos=pos, node_type=node_type,
        dx_local=dx_local, delta_local=delta_local, grid_level=grid_level,
        nbr_idx=nbr_idx, nbr_dist=nbr_dist, nbr_evec=nbr_evec, nbr_vol=nbr_vol,
        fict_nodes=fict_nodes, fict_src=fict_src, fict_w=fict_w,
        mirror_idx=mirror_idx,
    )


def _build_neighbors_padded(cfg, pos, node_type, dx_local, delta_local,
                            grid_level):
    """Cell-list radius search -> fixed-degree padded arrays.

    Same-level-only bonds, neighbor-dx beta correction, r<1e-14 skip
    (grid.cpp:707-770). Invalid slots: idx=self, dist=1, evec=0, vol=0.

    Uses the native OpenMP cell-list builder when available (the same
    component the reference implements at grid.cpp:660-808); falls back to
    a KD-tree search in Python.
    """
    if pos.shape[1] == 2:
        from . import native
        res = native.cell_list_neighbors_2d(
            pos, node_type, dx_local, delta_local, grid_level)
        if res is not None:
            return res

    from scipy.spatial import cKDTree

    N = len(node_type)
    dim = pos.shape[1]
    active = node_type != OUTSIDE

    lists = [[] for _ in range(N)]
    for level in (0, 1):
        sel = np.flatnonzero(active & (grid_level == level))
        if sel.size == 0:
            continue
        tree = cKDTree(pos[sel])
        # search radius per node: delta_i + 0.5*max dx_j of same level
        dmax = dx_local[sel].max()
        for ii, i in enumerate(sel):
            radius = delta_local[i] + 0.5 * dmax
            for jj in tree.query_ball_point(pos[i], radius):
                j = sel[jj]
                if j == i:
                    continue
                d = pos[j] - pos[i]
                r = float(np.sqrt((d * d).sum()))
                if r < 1e-14:
                    continue  # coincident real/fictitious pair
                dxj = dx_local[j]
                if r > delta_local[i] + 0.5 * dxj:
                    continue
                if r <= delta_local[i] - 0.5 * dxj:
                    beta = 1.0
                else:
                    beta = (delta_local[i] + 0.5 * dxj - r) / dxj
                V_j = beta * dxj**dim
                lists[i].append((j, r, d / r, V_j))

    K = max((len(l) for l in lists), default=1)
    K = ((K + 7) // 8) * 8  # pad to lane-friendly multiple
    nbr_idx = np.tile(np.arange(N, dtype=np.int32)[:, None], (1, K))
    nbr_dist = np.ones((N, K))
    nbr_evec = np.zeros((N, K, dim))
    nbr_vol = np.zeros((N, K))
    for i, l in enumerate(lists):
        for k, (j, r, e, V) in enumerate(l):
            nbr_idx[i, k] = j
            nbr_dist[i, k] = r
            nbr_evec[i, k] = e
            nbr_vol[i, k] = V
    return nbr_idx, nbr_dist, nbr_evec, nbr_vol


def _build_mirror_amr(cfg, pos, node_type, nbr_idx, nbr_dist, nbr_vol):
    """Wall FNM mirror for AMR: nearest neighborhood node to the reflected
    point (boundary.cpp:185-203), fallback nearest FLUID (same static-table
    argument as grid._build_mirror_table)."""
    N = len(node_type)
    mirror = np.full(N, -1, np.int32)
    accepted = {FLUID, INLET, OUTLET, SOLID_MG, FICTITIOUS}
    wall = np.flatnonzero(node_type == WALL)
    for n in wall:
        x, y = pos[n, 0], pos[n, 1]
        best, best_d2 = -1, np.inf
        if x > cfg.R_tube:
            xm = 2.0 * cfg.R_tube - x
        elif x < -cfg.R_tube:
            xm = -2.0 * cfg.R_tube - x
        else:
            xm = None
        if xm is not None:
            for k in range(nbr_idx.shape[1]):
                if nbr_vol[n, k] <= 0.0:
                    continue
                j = nbr_idx[n, k]
                if node_type[j] not in accepted:
                    continue
                d2 = (pos[j, 0] - xm) ** 2 + (pos[j, 1] - y) ** 2
                if d2 < best_d2:
                    best_d2 = d2
                    best = j
        if best < 0:
            # nearest FLUID fallback (boundary.cpp:253-263)
            bd = np.inf
            for k in range(nbr_idx.shape[1]):
                if nbr_vol[n, k] <= 0.0:
                    continue
                j = nbr_idx[n, k]
                if node_type[j] == FLUID and nbr_dist[n, k] < bd:
                    bd = nbr_dist[n, k]
                    best = j
        mirror[n] = best
    return mirror
