"""Structured two-level AMR backend: each refinement level as a dense block.

The reference's AMR machinery (src/grid.cpp:296-808) produces an
unstructured node cloud, which round 1-2 consumed through gather-based
kernels (amr.py / unstructured.py) — many times the cost of stencil
shifts. But both AMR levels are themselves REGULAR lattices (fine nodes at dx
inside a rectangular zone around the wire, coarse nodes at amr_ratio*dx
elsewhere), and the reference restricts bonds to same-level pairs
(grid.cpp:732-739). So the whole simulation decomposes into

  * a FINE block   — the rectangular fine zone + its fictitious band,
    a dense [Nyf, Nxf] lattice at spacing dx;
  * a COARSE block — the full domain lattice at dx_coarse, with the
    deep interior of the fine zone deactivated (OUTSIDE) and the thin
    inner band marked FICTITIOUS;
  * a cross-level IDW exchange (p=4, grid.cpp:513-605) touching only the
    two thin fictitious bands.

Each block runs the ordinary structured kit/ops machinery (stencil shifts,
Pallas kernels where applicable); the only gathers left are the tiny IDW
tables. Bond physics per block is *exactly* the uniform-grid physics: all
same-level nodes share dx, so the uniform stencil's beta partial volumes
equal the reference's neighbor-dx correction (grid.cpp:751-760).

State arrays are flat [N] = [fine block raveled | coarse block raveled],
so the orchestrator/solvers see an ordinary State pytree; block ops
reshape the halves (static slices — free under XLA).

Select with config key ``amr_backend = structured`` (default; ``gather``
keeps the round-2 backend).
"""

from __future__ import annotations

import copy
import math
from dataclasses import dataclass, fields as dc_fields, replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .config import Config
from .fields import State
from .grid import (FICTITIOUS, FLUID, OUTSIDE, SOLID_MG, Grid,
                   _classify, build_stencil)
from .kit import Kit, build_kit

PI = math.pi


# ---------------------------------------------------------------------------
# grid construction
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ABGrid:
    """Two structured blocks + flat concatenated views (host numpy).

    The flat layout is [fine.ravel() | coarse.ravel()]; inactive lattice
    sites carry node_type OUTSIDE and are inert in every kernel, exactly
    like the uniform grid's out-of-tube corners.
    """

    dim: int
    dx: float
    delta: float
    m: int
    R_wire: float
    L_wire: float
    R_tube: float

    fine_grid: Grid        # synthetic structured Grid of the fine block
    coarse_grid: Grid      # synthetic structured Grid of the coarse block

    # flat concatenated arrays (fine first)
    pos: np.ndarray            # [N, dim]
    node_type: np.ndarray      # [N] uint8
    dx_local: np.ndarray       # [N]
    delta_local: np.ndarray    # [N]
    grid_level: np.ndarray     # [N] int32 (0=fine, 1=coarse)

    # IDW fictitious coupling in flat-layout indices
    fict_idx: np.ndarray       # [Nf] int32 — fictitious nodes
    fict_src: np.ndarray       # [Nf, Kf] int32 (source REAL nodes; 0-padded)
    fict_w: np.ndarray         # [Nf, Kf] (rows sum to 1; 0 where invalid)

    @property
    def n_fine(self) -> int:
        return self.fine_grid.N_total

    @property
    def N_total(self) -> int:
        return len(self.node_type)

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


def _coarse_cfg(cfg: Config) -> Config:
    """Per-block config for the coarse level: dx = dx_coarse, and
    alpha_art_diff rescaled so D_art = alpha*v*dx keeps using the FINE dx
    (the reference's pd_ard.cpp:166-169 uses the uniform config dx on all
    nodes; the gather backend preserved that, and the rescale makes the
    block backend bond-identical)."""
    c = copy.copy(cfg)
    c.dx = cfg.dx_coarse
    c.alpha_art_diff = cfg.alpha_art_diff * (cfg.dx / cfg.dx_coarse)
    c.use_amr = 0
    return c.compute_derived()


def _fine_cfg(cfg: Config) -> Config:
    c = copy.copy(cfg)
    c.use_amr = 0
    return c.compute_derived()


def build_amr_block_grid(cfg: Config) -> ABGrid:
    """Block-structured twin of amr.build_amr_grid: the same REAL and
    FICTITIOUS node sets (same lattices, zones, bands and IDW sources as
    grid.cpp:349-654), embedded in two dense rectangles.

    3D (dim=3) is a capability the reference only gestures at: its AMR
    builder is DIM-templated but hardwires pz=0.0 in every placement loop
    (grid.cpp:405,437) and tests the AXIAL extent against y instead of z
    (in_fine_zone, grid.cpp:341-347), so its own 3D AMR never worked. Here
    the fine zone is the (corrected) cylinder
    sqrt(x^2+y^2) <= R_wire + amr_buffer, z in [-buffer, L_wire + buffer],
    and the two-block machinery is dimension-generic.
    """
    dim = cfg.dim
    dx_f, dx_c = cfg.dx, cfg.dx_coarse
    delta_f, delta_c = cfg.delta, cfg.delta_coarse
    m = cfg.m_ratio

    fine_r = cfg.R_wire + cfg.amr_buffer
    fine_z_lo = -cfg.amr_buffer
    fine_z_hi = cfg.L_wire + cfg.amr_buffer
    aux_r = fine_r + delta_f + dx_f
    aux_lo = fine_z_lo - delta_f - dx_f
    aux_hi = fine_z_hi + delta_f + dx_f
    inner_r = fine_r - delta_c - dx_c
    inner_lo = fine_z_lo + delta_c + dx_c
    inner_hi = fine_z_hi - delta_c - dx_c

    z_dom_lo = -cfg.L_upstream - m * dx_c
    z_dom_hi = cfg.L_wire + cfg.L_downstream + m * dx_c
    r_dom_lo = -cfg.R_tube - m * dx_c
    r_dom_hi = cfg.R_tube + m * dx_c

    def axis_points(dx, lo, hi):
        n = int(round((hi - lo) / dx)) + 1
        return lo + np.arange(n) * dx

    def zone(px, py, pz, r, lo, hi):
        """Cross-section radius + axial-extent zone predicate (the corrected
        form of grid.cpp:341-347 for both dims)."""
        if dim == 2:
            return (np.abs(px) <= r) & (py >= lo) & (py <= hi)
        return (np.sqrt(px * px + py * py) <= r) & (pz >= lo) & (pz <= hi)

    # ---- fine block: sub-rectangle of the global fine lattice covering
    # the aux rectangle (zone + fictitious band) ----
    xs_f = axis_points(dx_f, r_dom_lo, r_dom_hi)
    zs_f = axis_points(dx_f, z_dom_lo, z_dom_hi)
    ix = np.flatnonzero(np.abs(xs_f) <= aux_r)
    iz = np.flatnonzero((zs_f >= aux_lo) & (zs_f <= aux_hi))
    fx, fz = xs_f[ix], zs_f[iz]
    if dim == 2:
        FX, FY = np.meshgrid(fx, fz)                # [Nyf, Nxf]
        FZ = np.zeros_like(FX)
        pos_fine = np.stack([FX, FY], -1)
    else:
        FZ, FY, FX = np.meshgrid(fz, fx, fx, indexing="ij")  # [Nzf,Nyf,Nxf]
        pos_fine = np.stack([FX, FY, FZ], -1)
    nt_fb = _classify_block(cfg, FX, FY, FZ, m, dx_f)
    in_zone = zone(FX, FY, FZ, fine_r, fine_z_lo, fine_z_hi)
    in_aux = zone(FX, FY, FZ, aux_r, aux_lo, aux_hi)
    # in-zone: REAL (classified); aux band (zone dilated by delta_f + dx_f,
    # grid.cpp:529-531): FICTITIOUS; the rest of the block (the box corners
    # beyond the cylindrical band in 3D) and classified-OUTSIDE: inert
    nt_fine = np.where(nt_fb == OUTSIDE, OUTSIDE,
                       np.where(in_zone, nt_fb,
                                np.where(in_aux, FICTITIOUS,
                                         OUTSIDE))).astype(np.uint8)

    # ---- coarse block: the full domain lattice at dx_c ----
    xs_c = axis_points(dx_c, r_dom_lo, r_dom_hi)
    zs_c = axis_points(dx_c, z_dom_lo, z_dom_hi)
    if dim == 2:
        CX, CY = np.meshgrid(xs_c, zs_c)
        CZ = np.zeros_like(CX)
        pos_coarse = np.stack([CX, CY], -1)
    else:
        CZ, CY, CX = np.meshgrid(zs_c, xs_c, xs_c, indexing="ij")
        pos_coarse = np.stack([CX, CY, CZ], -1)
    nt_cb = _classify_block(cfg, CX, CY, CZ, m, dx_c)
    in_zone_c = zone(CX, CY, CZ, fine_r, fine_z_lo, fine_z_hi)
    in_inner = zone(CX, CY, CZ, inner_r, inner_lo, inner_hi)
    nt_coarse = np.where(
        nt_cb == OUTSIDE, OUTSIDE,
        np.where(~in_zone_c, nt_cb,                       # real coarse
                 np.where(in_inner, OUTSIDE, FICTITIOUS))  # deactivated / band
    ).astype(np.uint8)

    n_fine = nt_fine.size

    # ---- IDW tables (p=4, grid.cpp:513-605) ----
    from scipy.spatial import cKDTree

    real_fine = np.flatnonzero(
        (nt_fine.ravel() != OUTSIDE) & (nt_fine.ravel() != FICTITIOUS))
    real_coarse = np.flatnonzero(
        (nt_coarse.ravel() != OUTSIDE) & (nt_coarse.ravel() != FICTITIOUS))
    tree_f = cKDTree(pos_fine.reshape(-1, dim)[real_fine])
    tree_c = cKDTree(pos_coarse.reshape(-1, dim)[real_coarse])

    fict_rows = []  # (flat_layout_idx, [src_layout_idx...], [w...])
    dropped_f = dropped_c = 0

    def add(flat_idx, p, tree, real_map, offset, radius):
        srcs = tree.query_ball_point(p, radius)
        if not srcs:
            return False
        gsrc = real_map[srcs] + offset
        pts = (pos_fine if offset == 0 else pos_coarse).reshape(-1, dim)
        d2 = np.maximum(((pts[gsrc - offset] - p) ** 2).sum(-1), 1e-30)
        w = 1.0 / (d2 * d2)
        fict_rows.append((flat_idx, gsrc, w / w.sum()))
        return True

    # fine fictitious <- coarse REAL within delta_c
    ntf_flat = nt_fine.ravel()
    pf = pos_fine.reshape(-1, dim)
    for n in np.flatnonzero(ntf_flat == FICTITIOUS):
        if not add(n, pf[n], tree_c, real_coarse, n_fine, delta_c):
            ntf_flat[n] = OUTSIDE  # sourceless aux node: not a node at all
            dropped_f += 1
    # coarse fictitious <- fine REAL within delta_f
    ntc_flat = nt_coarse.ravel()
    pc = pos_coarse.reshape(-1, dim)
    for n in np.flatnonzero(ntc_flat == FICTITIOUS):
        if not add(n_fine + n, pc[n], tree_f, real_fine, 0, delta_f):
            ntc_flat[n] = OUTSIDE
            dropped_c += 1

    nf_rows = len(fict_rows)
    Kf = max((len(s) for _, s, _ in fict_rows), default=1)
    fict_idx = np.zeros(nf_rows, np.int32)
    fict_src = np.zeros((nf_rows, Kf), np.int32)
    fict_w = np.zeros((nf_rows, Kf))
    for r, (n, s, w) in enumerate(fict_rows):
        fict_idx[r] = n
        fict_src[r, : len(s)] = s
        fict_w[r, : len(w)] = w

    # ---- synthetic per-block Grid objects ----
    st_f = build_stencil(dx_f, delta_f, m, dim)
    st_c = build_stencil(dx_c, delta_c, m, dim)

    if dim == 2:
        fine_dims = dict(Nx=len(fx), Ny=len(fz), Nz=1,
                         origin=(float(fx[0]), float(fz[0])))
        coarse_dims = dict(Nx=len(xs_c), Ny=len(zs_c), Nz=1,
                           origin=(float(xs_c[0]), float(zs_c[0])))
    else:
        fine_dims = dict(Nx=len(fx), Ny=len(fx), Nz=len(fz),
                         origin=(float(fx[0]), float(fx[0]), float(fz[0])))
        coarse_dims = dict(Nx=len(xs_c), Ny=len(xs_c), Nz=len(zs_c),
                           origin=(float(xs_c[0]), float(xs_c[0]),
                                   float(zs_c[0])))

    ntc_shaped = ntc_flat.reshape(nt_coarse.shape)
    if dim == 2:
        mirror_c = _build_mirror_block(cfg, ntc_shaped, pos_coarse, st_c)
    else:
        # the 3D coarse block is a full uniform domain lattice (the fine
        # zone's deactivated interior is far from the tube wall), so the
        # uniform grid's z-invariant mirror builder applies directly
        from .grid import _build_mirror_table
        mirror_c = _build_mirror_table(
            _coarse_cfg(cfg), ntc_shaped, pos_coarse, coarse_dims["origin"],
            coarse_dims["Nx"], coarse_dims["Ny"], coarse_dims["Nz"], st_c)

    fine_grid = Grid(
        dim=dim, dx=dx_f, delta=delta_f, m=m, **fine_dims,
        R_wire=cfg.R_wire, L_wire=cfg.L_wire, R_tube=cfg.R_tube,
        node_type=ntf_flat.reshape(nt_fine.shape), pos=pos_fine,
        stencil=st_f,
        mirror_idx=np.full(nt_fine.shape, -1, np.int32),  # no walls in zone
    )
    coarse_grid = Grid(
        dim=dim, dx=dx_c, delta=delta_c, m=m, **coarse_dims,
        R_wire=cfg.R_wire, L_wire=cfg.L_wire, R_tube=cfg.R_tube,
        node_type=ntc_shaped, pos=pos_coarse,
        stencil=st_c,
        mirror_idx=mirror_c,
    )

    node_type = np.concatenate([ntf_flat, ntc_flat])
    pos = np.concatenate([pf, pc])
    dx_local = np.concatenate([np.full(ntf_flat.size, dx_f),
                               np.full(ntc_flat.size, dx_c)])
    delta_local = np.concatenate([np.full(ntf_flat.size, delta_f),
                                  np.full(ntc_flat.size, delta_c)])
    grid_level = np.concatenate([np.zeros(ntf_flat.size, np.int32),
                                 np.ones(ntc_flat.size, np.int32)])

    n_real_f = real_fine.size
    n_real_c = real_coarse.size
    blk = ("x".join(str(s) for s in fine_grid.shape) + " + "
           + "x".join(str(s) for s in coarse_grid.shape))
    print(f"AMR(blocks): {n_real_f} fine, {n_real_c} coarse, {nf_rows} "
          f"fictitious nodes; blocks {blk}"
          + (f" ({dropped_f + dropped_c} sourceless aux dropped)"
             if dropped_f + dropped_c else ""))

    return ABGrid(
        dim=dim, dx=dx_f, delta=delta_f, m=m, R_wire=cfg.R_wire,
        L_wire=cfg.L_wire, R_tube=cfg.R_tube,
        fine_grid=fine_grid, coarse_grid=coarse_grid,
        pos=pos, node_type=node_type, dx_local=dx_local,
        delta_local=delta_local, grid_level=grid_level,
        fict_idx=fict_idx, fict_src=fict_src, fict_w=fict_w,
    )


def _build_mirror_block(cfg, nt, pos, stencil):
    """Wall FNM mirror with the reference's AMR semantics
    (boundary.cpp:185-203, as in amr._build_mirror_amr): nearest
    accepted-type node WITHIN THE NODE'S NEIGHBORHOOD to the reflected
    point 2*R_tube - |x| (fallback: nearest FLUID by bond distance). On a
    regular lattice the neighborhood is exactly the stencil, so this
    reproduces the gather backend's table node-for-node."""
    from .grid import FLUID as _FL, INLET as _IN, OUTLET as _OU, \
        SOLID_MG as _SO, WALL as _WA
    accepted = {_FL, _IN, _OU, _SO, FICTITIOUS}
    shape = nt.shape
    flat_nt = nt.ravel()
    mirror = np.full(nt.size, -1, np.int32)
    offs = np.asarray(stencil.offsets)
    Ny, Nx = shape
    for n in np.flatnonzero(flat_nt == _WA):
        j, i = divmod(n, Nx)
        x, y = pos[j, i, 0], pos[j, i, 1]
        if x > cfg.R_tube:
            xm = 2.0 * cfg.R_tube - x
        elif x < -cfg.R_tube:
            xm = -2.0 * cfg.R_tube - x
        else:
            xm = None
        best, best_d2 = -1, np.inf
        if xm is not None:
            for s in range(len(offs)):
                j2, i2 = j + offs[s, 0], i + offs[s, 1]
                if not (0 <= j2 < Ny and 0 <= i2 < Nx):
                    continue
                if flat_nt[j2 * Nx + i2] not in accepted:
                    continue
                d2 = (pos[j2, i2, 0] - xm) ** 2 + (pos[j2, i2, 1] - y) ** 2
                if d2 < best_d2:
                    best_d2 = d2
                    best = j2 * Nx + i2
        if best < 0:
            bd = np.inf
            for s in range(len(offs)):
                j2, i2 = j + offs[s, 0], i + offs[s, 1]
                if not (0 <= j2 < Ny and 0 <= i2 < Nx):
                    continue
                if flat_nt[j2 * Nx + i2] == _FL and stencil.dist[s] < bd:
                    bd = stencil.dist[s]
                    best = j2 * Nx + i2
        mirror[n] = best
    return mirror.reshape(shape)


def _classify_block(cfg, px, py, pz, m_local, dx_local):
    """Classification at the block's local spacing (grid.cpp:302-338) —
    same predicate as amr._classify."""
    c = copy.copy(cfg)
    c.dx = dx_local
    c.m_ratio = m_local
    return _classify(c, px, py, pz)


# ---------------------------------------------------------------------------
# kit
# ---------------------------------------------------------------------------


@partial(
    jax.tree_util.register_dataclass,
    data_fields=["fine", "coarse", "fict_idx", "fict_src", "fict_w",
                 "initial_solid_mask"],
    meta_fields=["cfg", "n_fine", "dtype"],
)
@dataclass(frozen=True)
class BKit:
    """Block-AMR kit: two structured Kits + the IDW exchange tables."""

    fine: Kit
    coarse: Kit
    fict_idx: jax.Array        # [Nf] int32 (flat layout)
    fict_src: jax.Array        # [Nf, Kf] int32
    fict_w: jax.Array          # [Nf, Kf]
    initial_solid_mask: jax.Array  # [N] bool (flat layout)

    cfg: Config
    n_fine: int
    dtype: str

    @property
    def jdtype(self):
        return jnp.dtype(self.dtype)

    @property
    def dim(self) -> int:
        return self.fine.dim

    @property
    def axial_comp(self) -> int:
        return self.fine.axial_comp


def build_bkit(grid: ABGrid, cfg: Config, dtype: str | None = None) -> BKit:
    if dtype is None:
        dtype = "float64" if cfg.precision == "f64" else "float32"
    kit_f = build_kit(grid.fine_grid, _fine_cfg(cfg), dtype=dtype)
    kit_c = build_kit(grid.coarse_grid, _coarse_cfg(cfg), dtype=dtype)
    return BKit(
        fine=kit_f, coarse=kit_c,
        fict_idx=jnp.asarray(grid.fict_idx),
        fict_src=jnp.asarray(grid.fict_src),
        fict_w=jnp.asarray(grid.fict_w, jnp.dtype(dtype)),
        initial_solid_mask=jnp.asarray(grid.node_type == SOLID_MG),
        cfg=cfg, n_fine=grid.n_fine, dtype=dtype,
    )


# ---------------------------------------------------------------------------
# split/join plumbing
# ---------------------------------------------------------------------------


def _split(kit: BKit, a: jax.Array):
    """Flat [N, ...] -> (fine block [*fshape, ...], coarse block [*cshape, ...])."""
    nf = kit.n_fine
    extra = a.shape[1:]
    return (a[:nf].reshape(kit.fine.shape + extra),
            a[nf:].reshape(kit.coarse.shape + extra))


def _join(kit: BKit, f: jax.Array, c: jax.Array) -> jax.Array:
    nsp = len(kit.fine.shape)
    extra = f.shape[nsp:]
    return jnp.concatenate(
        [f.reshape((kit.n_fine,) + extra), c.reshape((-1,) + extra)], axis=0)


def _split_state(kit: BKit, state: State):
    kw_f, kw_c = {}, {}
    for fld in dc_fields(State):
        f, c = _split(kit, getattr(state, fld.name))
        kw_f[fld.name] = f
        kw_c[fld.name] = c
    return State(**kw_f), State(**kw_c)


def _join_state(kit: BKit, sf: State, sc: State) -> State:
    return State(**{fld.name: _join(kit, getattr(sf, fld.name),
                                    getattr(sc, fld.name))
                    for fld in dc_fields(State)})


def _per_block(fn_f, fn_c):
    """Lift per-block (state, kit, *args) -> state functions to the flat layout."""

    def wrapped(state: State, kit: BKit, *args):
        sf, sc = _split_state(kit, state)
        if fn_f is not None:
            sf = fn_f(sf, kit.fine, *args)
        if fn_c is not None:
            sc = fn_c(sc, kit.coarse, *args)
        return _join_state(kit, sf, sc)

    return wrapped


# ---------------------------------------------------------------------------
# physics ops (dispatch interface)
# ---------------------------------------------------------------------------


def tait_pressure(rho, kit: BKit):
    from .ops.ns import tait_pressure as tp
    return tp(rho, kit.fine)  # EOS constants identical across blocks


def compute_dt_ns(state: State, kit: BKit):
    """Global CFL dt: the formula (pd_ns.cpp:52-76) uses the uniform config
    dx — i.e. the FINE spacing — and the global fluid v_max; elementwise +
    reduction, so the flat state works directly."""
    from .ops.ns import compute_dt
    return compute_dt(state, kit.fine)


def ns_step(state: State, kit: BKit, dt) -> State:
    from .pallas_kernels import ns_step_auto
    return _per_block(ns_step_auto, ns_step_auto)(state, kit, dt)


def apply_inlet_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_inlet_bc)(state, kit)


def apply_outlet_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_outlet_bc)(state, kit)


def apply_wall_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_wall_bc)(state, kit)


def apply_wall_concentration_bc(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.apply_wall_concentration_bc)(state, kit)


def smooth_boundary_concentration(state: State, kit: BKit) -> State:
    from . import boundary as bc
    return _per_block(None, bc.smooth_boundary_concentration)(state, kit)


def apply_solid_surface_bc(state: State, kit: BKit) -> State:
    # elementwise — flat state works directly
    solid = state.node_type == SOLID_MG
    vel = jnp.where(solid[..., None], 0.0, state.vel)
    return replace(state, vel=vel)


def update_fictitious(state: State, kit: BKit) -> State:
    """IDW overwrite of C, rho, pressure, vel on FICTITIOUS nodes
    (grid.cpp:814-842) — the only cross-block coupling; a thin-band gather."""
    w = kit.fict_w

    def interp(a):
        return (a[kit.fict_src] * w).sum(-1)

    def interp_vec(a):
        return (a[kit.fict_src] * w[..., None]).sum(1)

    idx = kit.fict_idx
    C = state.C.at[idx].set(interp(state.C).astype(state.C.dtype))
    rho = state.rho.at[idx].set(interp(state.rho).astype(state.rho.dtype))
    p = state.pressure.at[idx].set(
        interp(state.pressure).astype(state.pressure.dtype))
    vel = state.vel.at[idx].set(interp_vec(state.vel).astype(state.vel.dtype))
    return replace(state, C=C, rho=rho, pressure=p, vel=vel)


def ard_compute_dt(state: State, kit: BKit):
    from .ops.ard import compute_dt
    return compute_dt(state, kit.fine)  # fine dx governs (uniform-cfg formula)


def ard_step(state: State, kit: BKit, dt, volume_loss_fraction=0.0) -> State:
    from .ops.ard import ard_step as ard_step_xla
    return _per_block(ard_step_xla, ard_step_xla)(
        state, kit, dt, volume_loss_fraction)


def apply_phase_change(state: State, kit: BKit):
    from .ops.ard import apply_phase_change as pc
    return pc(state, kit.fine)  # elementwise remask on the flat state


# ---------------------------------------------------------------------------
# implicit ARD
# ---------------------------------------------------------------------------


@jax.tree_util.register_dataclass
@dataclass
class ImplicitOperatorB:
    opf: object     # ops.ard_implicit.ImplicitOperator (fine block)
    opc: object     # ... (coarse block)
    unknown: jax.Array  # [N] bool flat — FLUID | SOLID rows
    fict: jax.Array     # [N] bool flat — FICTITIOUS constraint rows


def assemble(state: State, kit: BKit, volume_loss_fraction=0.0) -> ImplicitOperatorB:
    from .ops import ard_implicit as ai
    sf, sc = _split_state(kit, state)
    opf = ai.assemble(sf, kit.fine, volume_loss_fraction)
    opc = ai.assemble(sc, kit.coarse, volume_loss_fraction)
    unknown = _join(kit, opf.unknown, opc.unknown)
    return ImplicitOperatorB(opf=opf, opc=opc, unknown=unknown,
                             fict=state.node_type == FICTITIOUS)


def matvec_M(op: ImplicitOperatorB, kit: BKit, x):
    from .ops.ard_implicit import matvec_M as mv
    xf, xc = _split(kit, x)
    return _join(kit, mv(op.opf, kit.fine, xf), mv(op.opc, kit.coarse, xc))


def _matvec_M64(op: ImplicitOperatorB, kit: BKit, x64):
    """f64 twin of matvec_M for mixed-precision refinement."""

    def block(opb, kitb, xb):
        x_p = kitb.pad(xb, 0.0)
        y = opb.diag.astype(jnp.float64) * xb
        for s, _, _, _ in kitb.bond_iter():
            y = y + opb.W[s].astype(jnp.float64) * kitb.shift(x_p, s)
        return jnp.where(opb.unknown, y, 0.0)

    xf, xc = _split(kit, x64)
    return _join(kit, block(op.opf, kit.fine, xf), block(op.opc, kit.coarse, xc))


def implicit_step(state: State, op: ImplicitOperatorB, kit: BKit, dt,
                  tol: float | None = None, restart: int = 50,
                  maxiter: int = 200, x0=None):
    """(I - dt*M) with identity BC rows and IDW constraint rows
    (pd_ard_implicit.cpp:371-429, 500-535), mixed-precision refinement in
    f32 mode — the same solve as unstructured.implicit_step over block
    matvecs."""
    cfg = kit.cfg
    refine = kit.jdtype != jnp.float64 and jax.config.jax_enable_x64
    if tol is None:
        tol = 1e-10 if kit.jdtype == jnp.float64 else 1e-6
    inner_tol = tol
    if refine:
        inner_tol = max(tol, 1e-4)
    if kit.jdtype != jnp.float64:
        restart = min(restart, 25)
    dt = jnp.asarray(dt, kit.jdtype)
    C_old = state.C

    def fict_row_t(x, w):
        return x[kit.fict_idx] - (x[kit.fict_src] * w).sum(-1)

    def A(x):
        y = jnp.where(op.unknown, x - dt * matvec_M(op, kit, x), x)
        return y.at[kit.fict_idx].set(fict_row_t(x, kit.fict_w).astype(y.dtype),
                                      unique_indices=True)

    diag = _join(kit, op.opf.diag, op.opc.diag)
    inv_diag = 1.0 / (1.0 - dt * diag)

    def jacobi(x):
        return jnp.where(op.unknown, x * inv_diag, x)

    def precond(x):
        y = jacobi(x)
        for _ in range(2):
            y = y + jacobi(x - A(y))
        return y

    from .ops.gmres import gmres

    b = jnp.where(op.fict, 0.0, C_old)
    # optional Krylov-saving initial guess (see ops/ard_implicit): clamped
    # to the physical range on unknown rows, C_old elsewhere
    x0 = C_old if x0 is None else jnp.where(
        op.unknown, jnp.clip(x0, 0.0, cfg.C_solid_init), C_old)
    x, (res, _cycles) = gmres(A, b, x0, tol=inner_tol, restart=restart,
                              maxiter=maxiter, M=precond)

    if refine:
        f64 = jnp.float64
        dt64 = dt.astype(f64)
        fw64 = kit.fict_w.astype(f64)

        def A64(x64):
            y = jnp.where(op.unknown, x64 - dt64 * _matvec_M64(op, kit, x64),
                          x64)
            return y.at[kit.fict_idx].set(fict_row_t(x64, fw64),
                                          unique_indices=True)

        b64 = b.astype(f64)
        b_norm = jnp.maximum(jnp.linalg.norm(b64.ravel()), 1e-300)
        x64 = x.astype(f64)

        def refine_pass(carry):
            x64, r64, res = carry
            # right-size the correction: contract from res to tol (0.3
            # safety factor; the outer res > tol guard re-runs if short)
            tol_c = jnp.clip(0.5 * tol / jnp.maximum(res, 1e-300),
                             1e-4, 0.5)
            e, _ = gmres(A, r64.astype(kit.jdtype), jnp.zeros_like(x),
                         tol=tol_c, restart=restart, maxiter=restart * 2,
                         M=precond)
            x64n = x64 + e.astype(f64)
            r64n = b64 - A64(x64n)
            resn = jnp.linalg.norm(r64n.ravel()) / b_norm
            return x64n, r64n, resn

        def refine_if_needed(carry):
            return jax.lax.cond(carry[2] > tol, refine_pass,
                                lambda c: c, carry)

        r64 = b64 - A64(x64)
        res = jnp.linalg.norm(r64.ravel()) / b_norm
        carry = refine_if_needed((x64, r64, res))
        x64, _, res = refine_if_needed(carry)
        x = x64.astype(kit.jdtype)

    solved = op.unknown | op.fict
    C_new = jnp.where(solved, jnp.clip(x, 0.0, cfg.C_solid_init), C_old)
    return replace(state, C=C_new), res


def compute_adaptive_dt(state: State, op: ImplicitOperatorB, kit: BKit):
    cfg = kit.cfg
    MC = matvec_M(op, kit, state.C)
    solid = state.node_type == SOLID_MG
    eligible = solid & (state.C > cfg.C_thresh) & (MC < 0.0)
    rate = -MC
    t_phase = (state.C - cfg.C_thresh) / jnp.maximum(rate, 1e-30)
    t_phase = jnp.where(eligible & (t_phase > 0.0), t_phase, cfg.implicit_dt_max)
    min_t = jnp.minimum(jnp.min(t_phase), cfg.implicit_dt_max)
    dt = cfg.implicit_dt_fraction * min_t
    dt = jnp.minimum(dt, cfg.implicit_dt_max)
    dt = jnp.maximum(dt, cfg.implicit_dt_max * cfg.implicit_dt_min_frac)
    return dt


def initialize_state_b(grid: ABGrid, cfg: Config, grains=None, dtype=None) -> State:
    """Flat-layout state init (main.cpp:9-127 semantics)."""
    from .fields import initialize_state
    return initialize_state(grid, cfg, grains=grains,
                            dtype=dtype or jnp.dtype("float32"))


def generate_grains_b(grid: ABGrid, cfg: Config, seed: int = 42):
    """Grain structure on the fine block (all solid lives there), embedded
    into the flat layout. Node-for-node identical to the gather backend's
    result: both layouts enumerate the same fine lattice row-major, so the
    k-th solid/interior node — and hence every mt19937 draw — coincides."""
    from . import grains as grains_mod
    g = grains_mod.generate(grid.fine_grid, cfg, seed=seed)
    nc = grid.N_total - grid.n_fine

    class _G:
        n_grains = g.n_grains
        grain_id = np.concatenate(
            [g.grain_id.ravel(), np.full(nc, -1, np.int32)])
        is_grain_boundary = np.concatenate(
            [g.is_grain_boundary.ravel(), np.zeros(nc, bool)])
        is_precipitate = np.concatenate(
            [g.is_precipitate.ravel(), np.zeros(nc, bool)])

    return _G
