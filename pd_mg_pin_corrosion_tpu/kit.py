"""Device-side simulation kit: static masks, stencil constants, shift ops.

This is the dense-array replacement for the reference's CSR neighbor arrays
(src/grid.h:36-40): because every node of the uniform lattice shares the
same offset stencil, a PD bond sum over neighbors is a sum over S *shifted
copies* of a dense field array. Shifting = static slicing of a padded
array, which XLA fuses into one stencil loop — no gathers, no indices in
memory, and under jax.sharding the pads/slices lower to halo exchanges.

The Kit is a pytree whose array leaves (masks, profiles, mirror tables) are
traced and whose stencil geometry / config scalars are static metadata, so
every physics function can simply be ``jax.jit``-ed with the Kit as a
regular argument.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .fields import poiseuille_axial
from .grid import (FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG, WALL, Grid)

PI = math.pi


def _hash_cfg(self):
    import dataclasses as _dc
    return hash(tuple(getattr(self, f.name) for f in _dc.fields(self)))


Config.__hash__ = _hash_cfg  # make Config usable as static jit metadata


@partial(
    jax.tree_util.register_dataclass,
    data_fields=[
        "inlet_mask", "outlet_mask", "wall_mask",
        "near_inlet_mask", "near_outlet_mask", "v_pois",
        "initial_solid_mask", "mirror_group_masks", "mirror_none_mask",
        "gs_out_idx", "gs_out_nbr", "gs_out_valid",
        "gs_smo_idx", "gs_smo_nbr", "gs_smo_valid",
        "gs_smo_near_in", "gs_smo_near_out",
        "wm_dst_cols", "wm_fb_src", "wm_fb_dst",
        "wm_G", "wm_S", "wm_colmask",
    ],
    meta_fields=["cfg", "dim", "shape", "mext", "offsets", "dist", "evec",
                 "vol", "dtype", "inlet_rows", "outlet_rows",
                 "mirror_group_offsets", "multi_device"],
)
@dataclass(frozen=True)
class Kit:
    # --- traced device constants ---
    inlet_mask: jax.Array        # [*S] bool (static node types — never change)
    outlet_mask: jax.Array       # [*S] bool
    wall_mask: jax.Array         # [*S] bool
    near_inlet_mask: jax.Array   # [*S] bool — FLUID-classified region within
    near_outlet_mask: jax.Array  #   delta of the axial domain ends (boundary.cpp:332-352)
    v_pois: jax.Array            # [*S] analytic Poiseuille axial velocity
    initial_solid_mask: jax.Array  # [*S] bool — for volume-loss diagnostics
    # FNM wall mirrors grouped by lattice offset: every wall node's mirror
    # source is a nearby node, so the mirror "gather" is a handful of rolls
    # with per-offset masks instead of a full-array gather
    mirror_group_masks: jax.Array  # [n_groups, *S] bool
    mirror_none_mask: jax.Array    # [*S] bool — wall nodes with no source
    # Gauss-Seidel parity tables (empty unless cfg.gs_parity): flat node
    # indices in reference order (ascending flat == the reference's idx order,
    # grid.h:58-64) plus per-node padded stencil-neighbor indices, for the
    # sequential in-place outlet/smoothing sweeps (boundary.py _gs_*).
    gs_out_idx: jax.Array        # [Bo] int32 OUTLET nodes
    gs_out_nbr: jax.Array        # [Bo, S] int32 flat neighbor indices
    gs_out_valid: jax.Array      # [Bo, S] bool (in-bounds & not OUTSIDE)
    gs_smo_idx: jax.Array        # [Bs] int32 near-inlet/outlet band nodes
    gs_smo_nbr: jax.Array        # [Bs, S] int32
    gs_smo_valid: jax.Array      # [Bs, S] bool
    gs_smo_near_in: jax.Array    # [Bs] bool
    gs_smo_near_out: jax.Array   # [Bs] bool
    # 3D FNM wall mirror (structured): the roll-per-offset-group scheme that
    # works in 2D (13 groups) explodes to ~180 groups on the stair-cased 3D
    # cylinder — ~360 full-array rolls per wall-BC application. Instead the
    # mirror splits into (a) PRIMARY nodes whose cross-section mirror map is
    # identical for every z-plane: one gather + one scatter along the
    # *unsharded* cross-section axis, batched over the sharded z axis, and
    # (b) a small static FALLBACK set (mirror rounded into the wall band ->
    # nearest-FLUID source, possibly dz != 0): a tiny flat gather/scatter.
    # (source columns are folded into wm_G at build time and not carried;
    # wm_dst_cols stays traced — tests/test_3d.py and __graft_entry__.py
    # read it to size/validate the primary mirror set)
    wm_dst_cols: jax.Array       # [P] int32 cross-section wall columns
    wm_fb_src: jax.Array         # [F] int32 flat source indices
    wm_fb_dst: jax.Array         # [F] int32 flat wall indices
    # One-hot cross-section mirror operators, applied as two matrix
    # products at Precision.HIGHEST (exact for one-hot operands):
    # vals[Nz, P] = A[Nz, XS] @ wm_G, mirrored[Nz, XS] = vals @ wm_S, and
    # out = A * (1 - wm_colmask) +- mirrored (sign: + density, - velocity).
    wm_G: jax.Array              # [XS, P] f32 one-hot (column p <- src col)
    wm_S: jax.Array              # [P, XS] f32 one-hot (row p -> dst col)
    wm_colmask: jax.Array        # [XS] f32, 1.0 at mirrored wall columns

    # --- static metadata ---
    cfg: Config
    dim: int
    shape: tuple
    mext: int
    offsets: tuple   # S x dim int tuples, array-axis order
    dist: tuple      # S floats
    evec: tuple      # S x dim float tuples, coordinate order (x, y[, z])
    vol: tuple       # S floats (beta * dx^dim)
    dtype: str       # 'float32' | 'float64'
    # static axial band extents: INLET nodes live in rows [0, inlet_rows),
    # OUTLET nodes in rows [outlet_rows, end) of the leading array axis —
    # the ghost layers are geometric and never change, so BC neighbor sums
    # can run on thin slabs instead of the full grid (see boundary.py)
    inlet_rows: int
    outlet_rows: int
    mirror_group_offsets: tuple  # n_groups x ndim int tuples (array axes)
    # set by parallel.sharding.shard_kit: the per-node arrays carry a
    # multi-device axial sharding. Static so trace-time dispatch
    # (pallas_kernels.use_kernels) can route around single-device kernels
    # that have no SPMD partitioning rule.
    multi_device: bool = False

    # ------------------------------------------------------------------
    @property
    def S(self) -> int:
        return len(self.dist)

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    @property
    def axial_comp(self) -> int:
        """Velocity component index of the axial direction."""
        return self.dim - 1

    @property
    def alpha(self) -> float:
        """PD divergence constant alpha = DIM (pd_ns.cpp:8)."""
        return float(self.dim)

    @property
    def V_H(self) -> float:
        """Horizon volume (pd_ns.cpp:10-15)."""
        d = self.cfg.delta
        return PI * d * d if self.dim == 2 else (4.0 / 3.0) * PI * d**3

    @property
    def beta_lap(self) -> float:
        """PD Laplacian constant.

        2D: 4/(pi*delta^2) (pd_ns.cpp:12, second-moment calibrated).
        3D: 9/(2*pi*delta^3) — the *corrected* moment calibration; the
        reference's 12/(pi*delta^2) (pd_ns.cpp:15) is dimensionally
        inconsistent and zeroes out all 3D Laplacians (see
        Config.legacy_3d_constants).
        """
        d = self.cfg.delta
        if self.dim == 2:
            return 4.0 / (PI * d * d)
        if self.cfg.legacy_3d_constants:
            return 12.0 / (PI * d * d)
        return 9.0 / (2.0 * PI * d**3)

    # ------------------------------------------------------------------
    def pad(self, A: jax.Array, fill) -> jax.Array:
        """Pad the spatial axes by mext with a constant fill value."""
        ndim_sp = len(self.shape)
        pads = [(self.mext, self.mext)] * ndim_sp + [(0, 0)] * (A.ndim - ndim_sp)
        return jnp.pad(A, pads, constant_values=fill)

    def shift(self, Ap: jax.Array, s: int) -> jax.Array:
        """Slot-s neighbor view of a padded array (a static slice)."""
        off = self.offsets[s]
        idx = tuple(
            slice(self.mext + o, self.mext + o + n)
            for o, n in zip(off, self.shape)
        )
        return Ap[idx]

    def bond_iter(self):
        """Iterate (s, dist, evec, vol) over stencil slots in reference order."""
        return zip(range(self.S), self.dist, self.evec, self.vol)

    # -- scan-over-stencil mode ----------------------------------------
    @property
    def use_scan(self) -> bool:
        """Use lax.scan over stencil slots instead of a Python-unrolled sum.

        Chosen by measurement for 3D (178 slots): on an H100 at the
        params_3d.cfg geometry the unrolled NS sum took 44 ms and 156 s to
        compile against 11.9 ms and 1 s for the scan, and the unrolled
        matvec 2.9 ms against 1.5 ms (PERF.md). 2D (36 slots) keeps the
        unrolled form, whose fusion XLA handles well and whose summation
        order matches the reference's.
        """
        return self.dim == 3

    def stencil_jnp(self):
        """(offsets [S,nd] i32, dist [S], evec [S,nd], vol [S]) as arrays
        for lax.scan over slots."""
        return (jnp.asarray(self.offsets, jnp.int32),
                jnp.asarray(self.dist, self.jdtype),
                jnp.asarray(self.evec, self.jdtype),
                jnp.asarray(self.vol, self.jdtype))

    def shift_dyn(self, Ap: jax.Array, off: jax.Array) -> jax.Array:
        """Neighbor view of a padded array for a *traced* offset vector
        (scan-over-stencil mode twin of ``shift``)."""
        nd = len(self.shape)
        starts = [self.mext + off[a] for a in range(nd)]
        starts += [jnp.asarray(0, off.dtype)] * (Ap.ndim - nd)
        sizes = list(self.shape) + list(Ap.shape[nd:])
        return jax.lax.dynamic_slice(Ap, starts, sizes)


def _gs_tables(nt: np.ndarray, offsets: np.ndarray, near_in: np.ndarray,
               near_out: np.ndarray):
    """Host-side flat-index tables for the Gauss-Seidel parity sweeps.

    Ascending flat order == the reference's node index order (grid.h:58-64:
    j*Nx+i in 2D, k*Nx*Ny+j*Nx+i in 3D, matching this package's C-order
    [axial-first] layout), which is the sequential order of the reference's
    in-place sweeps under one OpenMP thread.
    """
    shape = nt.shape
    shp = np.asarray(shape)
    nt_flat = nt.ravel()

    def nbr_of(flat_idx: np.ndarray):
        coords = np.stack(np.unravel_index(flat_idx, shape), -1)     # [B, nd]
        nc = coords[:, None, :] + offsets[None, :, :]                # [B, S, nd]
        inb = np.all((nc >= 0) & (nc < shp), axis=-1)
        ncc = np.clip(nc, 0, shp - 1)
        flat = np.ravel_multi_index(
            tuple(np.moveaxis(ncc, -1, 0)), shape).astype(np.int32)
        # CSR parity: OUTSIDE nodes are never neighbors (grid.cpp:196-199)
        valid = inb & (nt_flat[flat] != OUTSIDE)
        return flat, valid

    out_idx = np.flatnonzero(nt_flat == OUTLET).astype(np.int32)
    out_nbr, out_valid = nbr_of(out_idx)

    # smoothing band: static geometry; restrict to nodes that can ever be
    # FLUID (WALL/INLET/OUTLET/OUTSIDE never change type)
    smo_mask = (near_in | near_out) & ((nt == FLUID) | (nt == SOLID_MG))
    smo_idx = np.flatnonzero(smo_mask.ravel()).astype(np.int32)
    smo_nbr, smo_valid = nbr_of(smo_idx)
    return (out_idx, out_nbr, out_valid, smo_idx, smo_nbr, smo_valid,
            near_in.ravel()[smo_idx], near_out.ravel()[smo_idx])


def _mirror_tables_3d(shape, mirror_idx: np.ndarray, node_type: np.ndarray):
    """Split the 3D wall-mirror table into z-invariant cross-section columns
    and a flat fallback list (see the Kit field comments).

    A cross-section column (j, i) is PRIMARY when every z-plane's wall node
    there has a mirror in the *same* z-plane at the *same* cross-section
    source — true for every geometrically-mirrored node (the mirror point
    2*R_tube - r depends only on (x, y), and its accepted-type check
    {FLUID, INLET, OUTLET, SOLID_MG} passes at every k for in-tube points).
    Everything else (nearest-FLUID fallback, boundary.cpp:253-263) goes to
    the flat list.

    Invariance is judged only over z-planes that actually carry a mirror at
    the column; planes without one must be OUTSIDE (the z-batched matmul
    application overwrites the column in *every* plane, which is only safe
    on dead nodes). Axially padded grids (grid.pad_grid_axial for
    multi-device sharding) append OUTSIDE z-planes — under the previous
    all-planes rule those demoted every wall column to the (unapplied)
    fallback list, silently turning the 3D wall BC into a no-op on padded
    grids (round-2 ADVICE, high).
    """
    Nz = shape[0]
    XS = shape[1] * shape[2]
    mi = mirror_idx.reshape(Nz, XS)
    nt = node_type.reshape(Nz, XS)
    has = mi >= 0

    src_k = np.where(has, mi // XS, -1)
    src_q = np.where(has, mi % XS, -1)
    own_k = np.broadcast_to(np.arange(Nz)[:, None], (Nz, XS))

    any_have = has.any(axis=0)
    # reference src column = the first mirror-carrying plane's source
    first_k = np.argmax(has, axis=0)
    ref_q = src_q[first_k, np.arange(XS)]
    in_plane_ok = ((src_k == own_k) | ~has).all(axis=0)
    same_q_ok = ((src_q == ref_q[None, :]) | ~has).all(axis=0)
    dead_ok = (has | (nt == OUTSIDE)).all(axis=0)
    col_invariant = any_have & in_plane_ok & same_q_ok & dead_ok

    dst_cols = np.flatnonzero(col_invariant).astype(np.int32)
    src_cols = ref_q[dst_cols].astype(np.int32)

    fb_mask = has & ~col_invariant[None, :]
    fb_dst = np.flatnonzero(fb_mask.ravel()).astype(np.int32)
    fb_src = mi.ravel()[fb_dst].astype(np.int32)
    return src_cols, dst_cols, fb_src, fb_dst


def _subcell_G_3d(cfg: Config, grid, dst_cols: np.ndarray, XS: int) -> np.ndarray:
    """Weighted cross-section mirror operator for the sub-cell wall mirror
    (cfg.wall_mirror_subcell): column p of G holds the BILINEAR weights of
    the reflected point 2*R_tube - r on the surrounding lattice nodes,
    instead of a one-hot at the nearest node. Same [XS, P] shape and matmul
    application as the staircase operator; weights are z-invariant
    (geometry only). Corners outside the accepted set (WALL/OUTSIDE) are
    dropped and the rest renormalized; a column with no accepted corner
    falls back to one-hot at the staircase source via the caller's tables
    — in practice r_m < R_tube keeps >= 1 corner in-tube."""
    Ny, Nx = grid.shape[1], grid.shape[2]
    dx = grid.dx
    ox, oy = grid.origin[0], grid.origin[1]
    # representative z-plane for accepted-type lookup: the one with the
    # most in-tube (accepted) nodes — robust against axially padded grids
    accepted_types = (FLUID, INLET, OUTLET, SOLID_MG)
    acc3 = np.isin(grid.node_type, accepted_types)
    k_rep = int(np.argmax(acc3.reshape(grid.shape[0], -1).sum(axis=1)))
    acc = acc3[k_rep].ravel()

    P = dst_cols.size
    G = np.zeros((XS, max(P, 1)), np.float32)
    for p, q in enumerate(dst_cols):
        j, i = divmod(int(q), Nx)
        x = ox + i * dx
        y = oy + j * dx
        r = math.sqrt(x * x + y * y)
        r_m = 2.0 * cfg.R_tube - r
        xm = x * r_m / r
        ym = y * r_m / r
        fi = (xm - ox) / dx
        fj = (ym - oy) / dx
        i0 = int(math.floor(fi))
        j0 = int(math.floor(fj))
        tx = fi - i0
        ty = fj - j0
        w = {(j0, i0): (1 - tx) * (1 - ty), (j0, i0 + 1): tx * (1 - ty),
             (j0 + 1, i0): (1 - tx) * ty, (j0 + 1, i0 + 1): tx * ty}
        tot = 0.0
        ent = []
        for (jj, ii), ww in w.items():
            if ww <= 0.0 or not (0 <= jj < Ny and 0 <= ii < Nx):
                continue
            col = jj * Nx + ii
            if not acc[col]:
                continue
            ent.append((col, ww))
            tot += ww
        if tot <= 0.0:
            # degenerate: keep the staircase one-hot source for this column
            # (nearest accepted node in-plane, as in _build_mirror_table)
            best, best_d = -1, np.inf
            for jj in range(max(0, j0 - 1), min(Ny, j0 + 3)):
                for ii in range(max(0, i0 - 1), min(Nx, i0 + 3)):
                    col = jj * Nx + ii
                    if not acc[col]:
                        continue
                    d = (jj - fj) ** 2 + (ii - fi) ** 2
                    if d < best_d:
                        best_d, best = d, col
            if best >= 0:
                G[best, p] = 1.0
            continue
        for col, ww in ent:
            G[col, p] = ww / tot
    return G


def build_kit(grid: Grid, cfg: Config, dtype: str | None = None) -> Kit:
    if dtype is None:
        dtype = "float64" if cfg.precision == "f64" else "float32"

    nt = grid.node_type
    v_pois = poiseuille_axial(cfg, grid.pos)

    # near-inlet / near-outlet bands for smooth_boundary_concentration
    # (boundary.cpp:337-352). Geometric, static; the dynamic FLUID check is
    # applied at use time.
    ax = grid.axial_axis
    y = grid.pos[..., ax]
    y_min_fluid = -cfg.L_upstream
    y_max_fluid = cfg.L_wire + cfg.L_downstream
    near_inlet = (y - y_min_fluid) < cfg.delta
    near_outlet = (y_max_fluid - y) < cfg.delta

    shape = nt.shape
    midx = grid.mirror_idx.ravel()
    has = midx >= 0
    none_mask = ((nt == WALL).ravel() & ~has).reshape(shape)
    if grid.dim == 3:
        # 3D: z-invariant cross-section tables + flat fallback (see Kit)
        wm_src, wm_dst, wm_fb_src, wm_fb_dst = _mirror_tables_3d(
            shape, grid.mirror_idx, nt)
        XS = shape[1] * shape[2]
        P = wm_dst.size
        if cfg.wall_mirror_subcell:
            wm_G = _subcell_G_3d(cfg, grid, wm_dst, XS)
        else:
            wm_G = np.zeros((XS, max(P, 1)), np.float32)
            wm_G[wm_src, np.arange(P)] = 1.0
        wm_S = np.zeros((max(P, 1), XS), np.float32)
        wm_S[np.arange(P), wm_dst] = 1.0
        wm_colmask = np.zeros((XS,), np.float32)
        wm_colmask[wm_dst] = 1.0
        group_offsets = ((0,) * nt.ndim,)
        group_masks = np.zeros((1,) + shape, bool)
    else:
        # 2D: group wall-mirror sources by lattice offset (see Kit docstring)
        wm_src = wm_dst = wm_fb_src = wm_fb_dst = np.zeros((0,), np.int32)
        wm_G = np.zeros((1, 1), np.float32)
        wm_S = np.zeros((1, 1), np.float32)
        wm_colmask = np.zeros((1,), np.float32)
        own = np.arange(midx.size)
        coords_own = np.stack(np.unravel_index(own, shape), -1)
        coords_src = np.stack(np.unravel_index(np.maximum(midx, 0), shape), -1)
        offs = np.where(has[:, None], coords_src - coords_own, 0)
        uniq = {}
        for n in np.flatnonzero(has):
            uniq.setdefault(tuple(int(v) for v in offs[n]), []).append(n)
        group_offsets = tuple(sorted(uniq.keys()))
        group_masks = np.zeros((max(len(group_offsets), 1),) + shape, bool)
        for g, off in enumerate(group_offsets):
            flat = group_masks[g].ravel()
            flat[uniq[off]] = True
        if not group_offsets:
            group_offsets = ((0,) * nt.ndim,)

    # axial band extents of the static INLET/OUTLET ghost layers
    axes_rest = tuple(range(1, nt.ndim))
    inlet_any = (nt == INLET).any(axis=axes_rest)
    outlet_any = (nt == OUTLET).any(axis=axes_rest)
    inlet_rows = int(np.flatnonzero(inlet_any).max() + 1) if inlet_any.any() else 0
    outlet_rows = int(np.flatnonzero(outlet_any).min()) if outlet_any.any() else nt.shape[0]

    st = grid.stencil
    if cfg.gs_parity:
        (go_i, go_n, go_v, gs_i, gs_n, gs_v, gs_ni, gs_no) = _gs_tables(
            nt, np.asarray(st.offsets, np.int64), near_inlet, near_outlet)
    else:
        S = len(st.dist)
        go_i = gs_i = np.zeros((0,), np.int32)
        go_n = gs_n = np.zeros((0, S), np.int32)
        go_v = gs_v = np.zeros((0, S), bool)
        gs_ni = gs_no = np.zeros((0,), bool)
    return Kit(
        inlet_mask=jnp.asarray(nt == INLET),
        outlet_mask=jnp.asarray(nt == OUTLET),
        wall_mask=jnp.asarray(nt == WALL),
        near_inlet_mask=jnp.asarray(near_inlet),
        near_outlet_mask=jnp.asarray(near_outlet),
        v_pois=jnp.asarray(v_pois, jnp.dtype(dtype)),
        initial_solid_mask=jnp.asarray(nt == SOLID_MG),
        cfg=cfg,
        dim=grid.dim,
        shape=grid.shape,
        mext=grid.m + 1,
        offsets=tuple(tuple(int(v) for v in row) for row in st.offsets),
        dist=tuple(float(v) for v in st.dist),
        evec=tuple(tuple(float(v) for v in row) for row in st.evec),
        vol=tuple(float(v) for v in st.vol),
        dtype=dtype,
        inlet_rows=inlet_rows,
        outlet_rows=outlet_rows,
        mirror_group_masks=jnp.asarray(group_masks),
        mirror_none_mask=jnp.asarray(none_mask),
        mirror_group_offsets=group_offsets,
        gs_out_idx=jnp.asarray(go_i), gs_out_nbr=jnp.asarray(go_n),
        gs_out_valid=jnp.asarray(go_v),
        gs_smo_idx=jnp.asarray(gs_i), gs_smo_nbr=jnp.asarray(gs_n),
        gs_smo_valid=jnp.asarray(gs_v),
        gs_smo_near_in=jnp.asarray(gs_ni), gs_smo_near_out=jnp.asarray(gs_no),
        wm_dst_cols=jnp.asarray(wm_dst),
        wm_fb_src=jnp.asarray(wm_fb_src), wm_fb_dst=jnp.asarray(wm_fb_dst),
        wm_G=jnp.asarray(wm_G), wm_S=jnp.asarray(wm_S),
        wm_colmask=jnp.asarray(wm_colmask),
    )
