"""Boundary conditions as pure masked-array updates.

Dense-array rewrite of the reference's 8 free functions (src/boundary.cpp).
Neighbor averages ("extrapolate from fluid neighbors") become stencil-shift
sums with dynamic node-type masks; the FNM wall mirror uses the static
mirror-index table precomputed in grid.py.

One deliberate semantic cleanup: the reference's outlet BC reads neighbor
OUTLET values while other threads overwrite them (boundary.cpp:104-111, a
benign data race under OpenMP). Here all reads are from the input snapshot,
which is the race-free fixed point of the same update. For <=1e-6
diagnostics parity the cfg.gs_parity mode instead reproduces the 1-thread
reference exactly: sequential in-place sweeps in node-index order (the
_gs_* functions), using the tables precomputed in kit._gs_tables.
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp

from .fields import State
from .grid import FLUID, OUTLET, OUTSIDE, SOLID_MG
from .kit import Kit


def _shift_masked_sum(kit: Kit, value_p, pred_p):
    """sum_s value_j * pred_j and count_s pred_j over all stencil slots.

    ``value_p``/``pred_p`` are already-padded arrays; pred is 0/1 float.
    """
    if kit.use_scan:
        offs, _, _, _ = kit.stencil_jnp()
        zero = jnp.zeros(kit.shape, kit.jdtype)

        def body(acc, off):
            total, count = acc
            pj = kit.shift_dyn(pred_p, off)
            vj = kit.shift_dyn(value_p, off)
            return (total + vj * pj, count + pj), None

        (total, count), _ = jax.lax.scan(body, (zero, zero), offs)
        return total, count
    total = None
    count = None
    for s, _, _, _ in kit.bond_iter():
        pj = kit.shift(pred_p, s)
        vj = kit.shift(value_p, s)
        t = vj * pj
        total = t if total is None else total + t
        count = pj if count is None else count + pj
    return total, count


def _band_masked_sums(kit: Kit, values, pred, start: bool):
    """Neighbor sums restricted to the static inlet/outlet axial band.

    The INLET/OUTLET ghost layers occupy fixed leading/trailing rows of the
    axial array axis (kit.inlet_rows / kit.outlet_rows), so their neighbor
    averages only need a thin slab of rows — these BCs run every flow
    iteration and a full-grid sweep would cost a third of an ns_step each.

    values: list of arrays; returns (band_slice, [totals...], count) where
    each total/count has the band's shape.
    """
    mext = kit.mext
    n0 = kit.shape[0]
    if start:
        lo, hi = 0, kit.inlet_rows
        src_lo = 0
        src_hi = min(n0, hi + mext)
    else:
        lo, hi = kit.outlet_rows, n0
        src_lo = max(0, lo - mext)
        src_hi = n0
    band_n = hi - lo
    off0 = lo - src_lo
    ndim_sp = len(kit.shape)
    pads = [(mext, mext)] * ndim_sp

    pr_p = jnp.pad(pred[src_lo:src_hi], pads)

    def band_shift(Ap, s):
        off = kit.offsets[s]
        idx = (slice(mext + off[0] + off0, mext + off[0] + off0 + band_n),) + tuple(
            slice(mext + off[a], mext + off[a] + kit.shape[a])
            for a in range(1, ndim_sp)
        )
        return Ap[idx]

    totals = [None] * len(values)
    count = None
    vals_p = [jnp.pad(v[src_lo:src_hi], pads) for v in values]
    for s, _, _, _ in kit.bond_iter():
        pj = band_shift(pr_p, s)
        count = pj if count is None else count + pj
        for i, vp in enumerate(vals_p):
            t = band_shift(vp, s) * pj
            totals[i] = t if totals[i] is None else totals[i] + t
    return slice(lo, hi), totals, count


def apply_inlet_bc(state: State, kit: Kit) -> State:
    """Prescribed Poiseuille velocity, rho extrapolated, fresh SBF C
    (boundary.cpp:31-75). Neighbor averages are band-limited to the static
    inlet ghost rows."""
    cfg = kit.cfg
    if kit.inlet_rows == 0:
        return state
    inlet = kit.inlet_mask

    fluid = (state.node_type == FLUID).astype(kit.jdtype)
    band, (tot,), cnt = _band_masked_sums(kit, [state.rho], fluid, start=True)

    inlet_b = inlet[band]
    rho_avg = jnp.where(cnt > 0, tot / jnp.maximum(cnt, 1.0), cfg.rho_f)
    rho = state.rho.at[band].set(
        jnp.where(inlet_b, rho_avg.astype(state.rho.dtype), state.rho[band]))

    v_in_b = jnp.zeros_like(state.vel[band]).at[..., kit.axial_comp].set(
        kit.v_pois[band])
    vel = state.vel.at[band].set(
        jnp.where(inlet_b[..., None], v_in_b, state.vel[band]))
    C = state.C.at[band].set(
        jnp.where(inlet_b, cfg.C_liquid_init, state.C[band]))
    return replace(state, vel=vel, rho=rho, C=C)


def _gs_outlet_bc(state: State, kit: Kit) -> State:
    """Sequential in-place outlet sweep in reference node order.

    Reproduces boundary.cpp:88-131 as executed under one OpenMP thread: each
    OUTLET node's neighbor average reads the *partially updated* values of
    lower-index OUTLET neighbors (Gauss-Seidel). Arithmetic matches the
    reference exactly: velocity uses v_tot * (1/count), C uses C_tot / count.
    Only used in gs_parity mode — O(B_outlet) sequential, tiny B.
    """
    cfg = kit.cfg
    dim = kit.dim
    ax = kit.axial_comp
    dt = kit.jdtype
    Cf = state.C.reshape(-1)
    vf = state.vel.reshape(-1, dim)
    ntf = state.node_type.reshape(-1)
    idx, nbr, valid = kit.gs_out_idx, kit.gs_out_nbr, kit.gs_out_valid

    def body(b, carry):
        Cf, vf = carry
        i = idx[b]
        js = nbr[b]
        tj = ntf[js]
        sel = valid[b] & ((tj == FLUID) | (tj == OUTLET))
        selw = sel.astype(dt)
        cnt = selw.sum()
        inv_c = 1.0 / jnp.maximum(cnt, 1.0)
        v_ax = (vf[js, ax] * selw).sum() * inv_c
        C_avg = (Cf[js] * selw).sum() / jnp.maximum(cnt, 1.0)
        has = cnt > 0
        v_new = jnp.zeros((dim,), vf.dtype).at[ax].set(
            jnp.where(has, v_ax, cfg.U_in))
        return (Cf.at[i].set(jnp.where(has, C_avg, 0.0)),
                vf.at[i].set(v_new))

    Cf, vf = jax.lax.fori_loop(0, idx.shape[0], body, (Cf, vf))
    rho = jnp.where(kit.outlet_mask,
                    jnp.asarray(cfg.rho_f, state.rho.dtype), state.rho)
    return replace(state, rho=rho, C=Cf.reshape(state.C.shape),
                   vel=vf.reshape(state.vel.shape))


def apply_outlet_bc(state: State, kit: Kit) -> State:
    """Pressure outlet: rho=rho_f (=> p=0), zero-gradient v (axial only) and C
    (boundary.cpp:88-131). Band-limited to the static outlet ghost rows."""
    cfg = kit.cfg
    if cfg.gs_parity:
        return _gs_outlet_bc(state, kit)
    if kit.outlet_rows >= kit.shape[0]:
        return state
    outlet = kit.outlet_mask
    ax = kit.axial_comp

    pred = ((state.node_type == FLUID) | (state.node_type == OUTLET)).astype(kit.jdtype)
    band, (v_tot, C_tot), cnt = _band_masked_sums(
        kit, [state.vel[..., ax], state.C], pred, start=False)

    outlet_b = outlet[band]
    safe_cnt = jnp.maximum(cnt, 1.0)
    v_ax = jnp.where(cnt > 0, v_tot / safe_cnt, cfg.U_in)
    C_avg = jnp.where(cnt > 0, C_tot / safe_cnt, 0.0)

    rho = state.rho.at[band].set(
        jnp.where(outlet_b, jnp.asarray(cfg.rho_f, state.rho.dtype),
                  state.rho[band]))
    v_out_b = jnp.zeros_like(state.vel[band]).at[..., ax].set(
        v_ax.astype(state.vel.dtype))
    vel = state.vel.at[band].set(
        jnp.where(outlet_b[..., None], v_out_b, state.vel[band]))
    C = state.C.at[band].set(
        jnp.where(outlet_b, C_avg.astype(state.C.dtype), state.C[band]))
    return replace(state, rho=rho, vel=vel, C=C)


def _wall_mirror(state: State, kit: Kit, rho, vel):
    """Shared FNM mirror application (boundary.cpp:143-294).

    Velocity antisymmetric (no-slip), density symmetric; fallback (no mirror
    source) pins vel=0, rho=rho_f.

    Every wall node's mirror source is a nearby lattice node, so the
    "gather" is a handful of jnp.roll's with per-offset masks (precomputed
    in build_kit) instead of a full-array gather. Roll wrap-around never
    matters: the masks only select wall nodes
    whose true source is in-domain.
    """
    cfg = kit.cfg
    axes = tuple(range(len(kit.shape)))

    rho_out = jnp.where(kit.mirror_none_mask, cfg.rho_f, rho)
    vel_out = jnp.where(kit.mirror_none_mask[..., None], 0.0, vel)

    if kit.dim == 3:
        # One-hot matmuls over the cross-section, batched over the
        # (sharded) z axis: the mirror map is z-invariant by construction
        # (grid._build_mirror_table, 3D branch), so
        #   mirrored = (A @ G) @ S,  out = A*(1-colmask) +- mirrored.
        # The 2D roll scheme would need ~180 offset groups here (~360
        # full-array rolls per call); the matmul form needs no rolls and
        # no gather/scatter. (A gather over the kit.wm_* indices is the
        # cheaper form on a GPU: ROADMAP speed item on the wall mirror.)
        Nz = kit.shape[0]
        XS = kit.shape[1] * kit.shape[2]
        r2 = rho.reshape(Nz, XS)
        v2 = vel.reshape(Nz, XS, kit.dim)
        base_r = rho_out.reshape(Nz, XS)
        base_v = vel_out.reshape(Nz, XS, kit.dim)

        A = jnp.concatenate(
            [r2] + [v2[..., d] for d in range(kit.dim)], axis=0)
        # HIGHEST precision: a default-precision f32 matmul may round its
        # operands (bf16 passes or TF32, ~1e-3 rel); a one-hot selection
        # must be exact
        hp = jax.lax.Precision.HIGHEST
        mirrored = jnp.matmul(jnp.matmul(A, kit.wm_G, precision=hp),
                              kit.wm_S, precision=hp)  # [ (1+dim)*Nz, XS ]

        keep = 1.0 - kit.wm_colmask
        r_out = base_r * keep + mirrored[:Nz]
        v_out = jnp.stack(
            [base_v[..., d] * keep - mirrored[(1 + d) * Nz:(2 + d) * Nz]
             for d in range(kit.dim)], axis=-1)
        r_out = r_out.reshape(kit.shape)
        v_out = v_out.reshape(kit.shape + (kit.dim,))

        # Fallback set (mirror source in a different z-plane / non-invariant
        # column): a tiny flat gather/scatter, same symmetry as the primary
        # path (rho symmetric, vel antisymmetric). Static shape: empty on
        # production grids, so no gather is emitted there at all.
        if kit.wm_fb_dst.shape[0]:
            rf = r_out.reshape(-1)
            vf = v_out.reshape(-1, kit.dim)
            rf = rf.at[kit.wm_fb_dst].set(rho.reshape(-1)[kit.wm_fb_src])
            vf = vf.at[kit.wm_fb_dst].set(
                -vel.reshape(-1, kit.dim)[kit.wm_fb_src])
            r_out = rf.reshape(kit.shape)
            v_out = vf.reshape(kit.shape + (kit.dim,))
        return r_out, v_out

    for g, off in enumerate(kit.mirror_group_offsets):
        m = kit.mirror_group_masks[g]
        shift = tuple(-o for o in off)
        rho_m = jnp.roll(rho, shift, axes)
        vel_m = jnp.roll(vel, shift + (0,), axes + (len(kit.shape),))
        rho_out = jnp.where(m, rho_m, rho_out)
        vel_out = jnp.where(m[..., None], -vel_m, vel_out)

    return rho_out, vel_out


def apply_wall_bc(state: State, kit: Kit) -> State:
    rho, vel = _wall_mirror(state, kit, state.rho, state.vel)
    return replace(state, rho=rho, vel=vel)


def apply_wall_concentration_bc(state: State, kit: Kit) -> State:
    """Neumann zero-gradient C at tube walls (boundary.cpp:302-321)."""
    wall = kit.wall_mask
    fluid = (state.node_type == FLUID).astype(kit.jdtype)
    tot, cnt = _shift_masked_sum(kit, kit.pad(state.C, 0.0), kit.pad(fluid, 0.0))
    C_avg = jnp.where(cnt > 0, tot / jnp.maximum(cnt, 1.0), 0.0)
    C = jnp.where(wall, C_avg, state.C)
    return replace(state, C=C)


def _gs_smooth(state: State, kit: Kit) -> State:
    """Sequential in-place smoothing sweep in reference node order
    (boundary.cpp:332-376 under one thread): near-band FLUID nodes read the
    already-updated C of lower-index band neighbors. gs_parity mode only."""
    dt = kit.jdtype
    Cf = state.C.reshape(-1)
    ntf = state.node_type.reshape(-1)
    idx, nbr, valid = kit.gs_smo_idx, kit.gs_smo_nbr, kit.gs_smo_valid
    near_in, near_out = kit.gs_smo_near_in, kit.gs_smo_near_out
    # static per-slot axial offset sign: yj > y <=> positive axial offset
    sgn = jnp.asarray([o[0] for o in kit.offsets], jnp.int32)

    def body(b, Cf):
        i = idx[b]
        js = nbr[b]
        fl = valid[b] & (ntf[js] == FLUID)
        # reference else-if: outlet branch (yj < y) first, then inlet (yj > y)
        use = fl & ((near_out[b] & (sgn < 0)) | (near_in[b] & (sgn > 0)))
        usew = use.astype(dt)
        cnt = usew.sum()
        c_avg = (Cf[js] * usew).sum() / jnp.maximum(cnt, 1.0)
        upd = (ntf[i] == FLUID) & (cnt > 0)
        return Cf.at[i].set(jnp.where(upd, c_avg, Cf[i]))

    Cf = jax.lax.fori_loop(0, idx.shape[0], body, Cf)
    return replace(state, C=Cf.reshape(state.C.shape))


def smooth_boundary_concentration(state: State, kit: Kit) -> State:
    """Replace C of FLUID nodes within delta of inlet/outlet by the interior-
    side fluid-neighbor average (boundary.cpp:332-376).

    The interior-side test (y_j vs y_i) is static per stencil slot: the
    neighbor's axial offset sign decides it.
    """
    if kit.cfg.gs_parity:
        return _gs_smooth(state, kit)
    fluid = state.node_type == FLUID
    fluid_f = fluid.astype(kit.jdtype)
    C_p = kit.pad(state.C, 0.0)
    fl_p = kit.pad(fluid_f, 0.0)

    near_in = kit.near_inlet_mask & fluid
    near_out = kit.near_outlet_mask & fluid

    # axial array axis: 0 in 2D ([Ny, Nx] -> y first), 0 in 3D ([Nz, Ny, Nx] -> z first)
    ax_axis = 0
    zero = jnp.zeros(kit.shape, kit.jdtype)
    if kit.use_scan:
        offs, _, _, _ = kit.stencil_jnp()

        def body(acc, off):
            tot, cnt = acc
            d_ax = off[ax_axis]
            fj = kit.shift_dyn(fl_p, off)
            Cj = kit.shift_dyn(C_p, off)
            sel = jnp.where(d_ax > 0, jnp.where(near_in, fj, 0.0),
                            jnp.where(d_ax < 0,
                                      jnp.where(near_out, fj, 0.0), 0.0))
            return (tot + Cj * sel, cnt + sel), None

        (tot, cnt), _ = jax.lax.scan(body, (zero, zero), offs)
    else:
        tot = zero
        cnt = zero
        for s, _, _, _ in kit.bond_iter():
            d_ax = kit.offsets[s][ax_axis]
            if d_ax == 0:
                continue
            fj = kit.shift(fl_p, s)
            Cj = kit.shift(C_p, s)
            if d_ax > 0:   # neighbor deeper toward outlet -> usable near inlet
                sel = jnp.where(near_in, fj, 0.0)
            else:          # neighbor deeper toward inlet -> usable near outlet
                sel = jnp.where(near_out, fj, 0.0)
            tot = tot + Cj * sel
            cnt = cnt + sel

    C_sm = jnp.where(cnt > 0, tot / jnp.maximum(cnt, 1.0), state.C)
    C = jnp.where((near_in | near_out) & (cnt > 0), C_sm, state.C)
    return replace(state, C=C)


def apply_solid_surface_bc(state: State, kit: Kit) -> State:
    """Zero velocity on the Mg pin (boundary.cpp:381-390)."""
    solid = state.node_type == SOLID_MG
    vel = jnp.where(solid[..., None], 0.0, state.vel)
    return replace(state, vel=vel)
