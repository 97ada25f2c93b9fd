"""Steady-state flow solve as an on-device ``lax.while_loop``.

Rewrite of PD_NS_Solver::solve_steady (src/pd_ns.cpp:182-372) preserving the
reference's exact cadence: convergence/divergence checks on the first 10
iterations and every 100th thereafter, convergence requires iter > 100,
velocity-blowup guard at 100x U_in, dt refresh every 200 iterations, and the
early exit keeps the *pre-step* (BC-applied) buffers — the reference breaks
before swap_buffers (pd_ns.cpp:318-325).
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp

from .dispatch import is_structured, ops_for
from .fields import State
from .grid import FLUID
from .kit import Kit


def _channel_flow_corrections(state: State, kit: Kit) -> State:
    """Poiseuille-validation-only corrections (pd_ns.cpp:209-270): zero
    transverse velocity and cross-sectionally averaged density on FLUID."""
    fluid = state.node_type == FLUID
    ax = kit.axial_comp

    vel = state.vel
    for d in range(kit.dim):
        if d == ax:
            continue
        vel = vel.at[..., d].set(jnp.where(fluid, 0.0, vel[..., d]))

    # cross-sectional rho averaging: average over all non-axial array axes
    # (2D: per row j over x; 3D: per k-plane over (y, x))
    fl = fluid.astype(kit.jdtype)
    red_axes = tuple(range(1, len(kit.shape)))  # axial array axis is 0
    rho_sum = jnp.sum(state.rho * fl, axis=red_axes, keepdims=True)
    cnt = jnp.sum(fl, axis=red_axes, keepdims=True)
    rho_avg = jnp.where(cnt > 0, rho_sum / jnp.maximum(cnt, 1.0), 0.0)
    rho = jnp.where(fluid & (cnt > 0), rho_avg, state.rho)
    return replace(state, vel=vel, rho=rho)


def _select(pred, a, b):
    return jax.tree.map(lambda x, y: jnp.where(pred, x, y), a, b)


# Iterations per device execution. The flow loop is split into host-driven
# segments of this many iterations, each costing one host sync; between
# segments the host can report progress (PD_FLOW_TRACE).
FLOW_SEGMENT_ITERS = 2000


@partial(jax.jit, static_argnames=("verbose",))
def _solve_steady_segment(carry, seg_end, kit: Kit, verbose: bool = False):
    """Up to FLOW_SEGMENT_ITERS flow iterations on device (while_loop).

    Semantics are exactly the reference loop's (pd_ns.cpp:182-372): check
    cadence, early-exit buffer handling and dt refresh key off the *global*
    iteration counter carried across segments.
    """
    cfg = kit.cfg
    ops = ops_for(kit)

    def pre_bcs(st):
        st = ops.apply_inlet_bc(st, kit)
        st = ops.apply_outlet_bc(st, kit)
        st = ops.apply_wall_bc(st, kit)
        st = ops.apply_solid_surface_bc(st, kit)
        return st

    def cond(carry):
        _, it, _, _, conv, div = carry
        return (it <= jnp.minimum(seg_end, cfg.flow_max_iters)) & ~conv & ~div

    def body(carry):
        st, it, eps, dt, conv, div = carry

        st_bc = pre_bcs(st)
        st_new = ops.ns_step(st_bc, kit, dt)
        st_new = ops.apply_wall_bc(st_new, kit)  # wall BC on new buffers (pd_ns.cpp:205)
        if cfg.channel_flow_corrections and is_structured(kit):
            st_new = _channel_flow_corrections(st_new, kit)

        # --- convergence / divergence check (pd_ns.cpp:273-322) ---
        # under lax.cond: the reductions only execute on check iterations
        # (first 10 + every 100th), not every step
        do_check = (it <= 10) | (it % 100 == 0)

        def run_check(_):
            fluid = st_bc.node_type == FLUID
            dv = st_new.vel - st_bc.vel
            num = jnp.sum(jnp.where(fluid[..., None], dv * dv, 0.0))
            den = jnp.sum(jnp.where(fluid[..., None],
                                    st_bc.vel * st_bc.vel, 0.0))
            eps_c = jnp.where(den > 1e-30,
                              jnp.sqrt(num / jnp.maximum(den, 1e-300)),
                              jnp.sqrt(num))
            vmag = jnp.linalg.norm(st_new.vel, axis=-1)
            v_max_c = jnp.max(jnp.where(fluid, vmag, 0.0))
            has_nan = jnp.any(jnp.where(fluid[..., None],
                                        jnp.isnan(st_new.vel), False)) | \
                jnp.any(jnp.where(fluid, jnp.isnan(st_new.rho), False))
            return eps_c, v_max_c, has_nan

        def skip_check(_):
            z = jnp.asarray(0.0, kit.jdtype)
            return eps, z, jnp.asarray(False)

        eps_new, v_max_new, has_nan = jax.lax.cond(
            do_check, run_check, skip_check, None)

        div_new = do_check & (has_nan | (v_max_new > 100.0 * cfg.U_in))
        conv_new = do_check & (eps_new < cfg.flow_conv_tol) & (it > 100)
        eps = jnp.where(do_check, eps_new, eps)
        done = div_new | conv_new

        if verbose:
            do_print = (it <= 10) | (it % cfg.output_every_flow == 0)
            rho_fl = jnp.where(st_bc.node_type == FLUID, st_new.rho, cfg.rho_f)

            def _tell(args):
                jax.debug.print(
                    "  Flow iter {it}: eps={eps:.3e}  v_max={vm:.4e}  "
                    "rho=[{rmin:.2f},{rmax:.2f}]  dt={dt:.3e}",
                    it=args[0], eps=args[1], vm=args[2], rmin=args[3],
                    rmax=args[4], dt=args[5])
                return 0

            jax.lax.cond(
                do_print, _tell, lambda a: 0,
                (it, eps_new, v_max_new, jnp.min(rho_fl), jnp.max(rho_fl), dt))

        # on break the reference keeps the pre-step buffers (break before swap);
        # otherwise swap and refresh AMR fictitious values (pd_ns.cpp:325-328)
        st_next = _select(done, st_bc, ops.update_fictitious(st_new, kit))

        # dt refresh every 200 iterations (pd_ns.cpp:331-333)
        refresh = (it % 200 == 0) & ~done
        dt_next = jnp.where(refresh, ops.compute_dt_ns(st_next, kit), dt)

        return (st_next, it + 1, eps, dt_next, conv_new, div_new)

    return jax.lax.while_loop(cond, body, carry)


def solve_steady(state: State, kit: Kit, verbose: bool = False,
                 max_iters: int | None = None):
    """Run the flow solver to steady state (host-segmented device loops).

    Returns (state, iters, eps, converged, diverged). ``iters`` is the
    reference's loop variable at exit (last executed iteration on break,
    flow_max_iters + 1 on exhaustion). With ``verbose`` the reference's
    per-iteration telemetry line (pd_ns.cpp:304-306) is emitted from the
    device at the same cadence (first 10 iters + every output_every_flow).
    """
    cfg = kit.cfg
    ops = ops_for(kit)
    cap = cfg.flow_max_iters if max_iters is None else max_iters
    dt0 = jax.jit(ops.compute_dt_ns)(state, kit)

    # gather-based (unstructured/AMR) iterations are ~10x costlier than
    # stencil-shift ones; keep device executions equally short. The block-
    # structured AMR backend runs at stencil-shift speed -> full segments.
    from .dispatch import is_block
    seg_iters = (FLOW_SEGMENT_ITERS if is_structured(kit) or is_block(kit)
                 else FLOW_SEGMENT_ITERS // 8)

    import os
    import time as _time
    # PD_FLOW_TRACE / verbose only: the trace path forces a device sync
    # per segment (int(it) transfer) and unconditional stdout, which is
    # pure overhead in production runs (round-2 ADVICE, low)
    trace = bool(os.environ.get("PD_FLOW_TRACE")) or verbose

    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(1.0, kit.jdtype),
             dt0, jnp.asarray(False), jnp.asarray(False))
    seg_end = 0
    t_seg = _time.time()
    while True:
        seg_end = min(seg_end + seg_iters, cap)
        carry = _solve_steady_segment(
            carry, jnp.asarray(seg_end, jnp.int32), kit, verbose)
        _, it, eps_c, _, conv, div = carry
        if trace:
            # host-side progress telemetry; int(it) also fences the
            # segment
            print(f"    [flow] iter {int(it) - 1}  eps={float(eps_c):.3e}  "
                  f"({_time.time() - t_seg:.1f}s/seg)", flush=True)
            t_seg = _time.time()
        if bool(conv) or bool(div) or int(it) > cap:
            break

    st, it, eps, _, conv, div = carry
    # exit bookkeeping: broken iterations report the iteration that broke
    iters = jnp.where(conv | div, it - 1, it)
    st = replace(st, pressure=jax.jit(ops.tait_pressure)(st.rho, kit))
    return st, iters, eps, conv, div


def coarse_warm_start(state: State, grid, kit: Kit, cfg):
    """Coarse-grid warm start for the INITIAL steady flow solve
    (cfg.flow_warm_start = coarsening ratio; uniform structured grids and
    the block-AMR backend — the coarse solve is always uniform at
    cfg.dx * ratio, and the interpolation below only needs grid.pos,
    which both layouts expose ([..., dim] structured, [N, dim] flat).

    The cold start costs thousands of iterations developing the wake
    around the wire from a plain Poiseuille profile (pd_ns.cpp:182-339 at
    flagship scale: ~6,400). The same wake develops on a dx*N grid for
    ~N^(dim+1)-fold less work (N^dim fewer nodes, CFL dt scales with dx),
    so: solve steady flow on the coarse twin of the SAME geometry, then
    trilinearly interpolate (rho, vel) onto the fine lattice as the fine
    solve's starting point. Only FLUID nodes are overwritten — solid,
    wall, inlet/outlet and OUTSIDE keep their initialization (BCs rebuild
    them every iteration anyway). The fine solve's convergence gate is
    UNCHANGED; the converged answer is the same within flow_conv_tol.

    Returns (state, coarse_iters). No-op (state, 0) if the coarse solve
    diverges or the geometry degenerates at the coarse spacing.
    """
    import copy as _copy

    import numpy as np
    from scipy.ndimage import map_coordinates

    from .fields import initialize_state
    from .grid import build_grid
    from .kit import build_kit

    ratio = int(cfg.flow_warm_start)
    ccfg = _copy.copy(cfg)
    ccfg.dx = cfg.dx * ratio
    ccfg.use_amr = 0
    ccfg.flow_warm_start = 0
    ccfg.compute_derived()

    cgrid = build_grid(ccfg)
    # degenerate coarse geometry (e.g. the wire thinner than dx_coarse)
    if not (cgrid.node_type == 1).any():  # SOLID_MG
        print("  Warm start skipped: no solid nodes at coarse spacing")
        return state, 0
    ckit = build_kit(cgrid, ccfg, dtype=kit.dtype)
    cstate = initialize_state(cgrid, ccfg, grains=None, dtype=kit.jdtype)

    cstate, it, eps, conv, div = solve_steady(cstate, ckit)
    if bool(div):
        print("  Warm start skipped: coarse solve diverged")
        return state, 0
    print(f"  Warm start: coarse ({ratio}x dx, {cgrid.N_total} nodes) solve "
          f"{int(it)} iters, eps={float(eps):.3e}, converged={bool(conv)}")

    # trilinear sample of the coarse fields at the fine node positions
    # (host, one-time). Coarse index space: i_d = (pos_d - origin_d) / dx_c.
    pos = grid.pos  # [..., dim], components (x, y[, z])
    coords = [
        (pos[..., d] - cgrid.origin[d]) / ccfg.dx
        for d in range(grid.dim)
    ][::-1]  # array layout is [z,]y,x -> reverse component order

    def interp(a):
        return map_coordinates(np.asarray(a, np.float64), coords,
                               order=1, mode="nearest")

    rho_i = interp(cstate.rho)
    vel_i = np.stack([interp(cstate.vel[..., d]) for d in range(grid.dim)],
                     axis=-1)

    fluid = np.asarray(state.node_type) == FLUID
    rho = np.where(fluid, rho_i, np.asarray(state.rho, np.float64))
    vel = np.where(fluid[..., None], vel_i, np.asarray(state.vel, np.float64))
    ops = ops_for(kit)
    rho_j = jnp.asarray(rho, kit.jdtype)
    return replace(state, rho=rho_j, vel=jnp.asarray(vel, kit.jdtype),
                   pressure=jax.jit(ops.tait_pressure)(rho_j, kit)), int(it)


def poiseuille_l2_error(state: State, grid, cfg) -> float:
    """Poiseuille validation at the upstream station (pd_ns.cpp:341-368).

    2D only, matching the reference. Returns the relative L2 error, or NaN
    when no sample nodes exist.
    """
    import numpy as np

    y_check = -cfg.L_upstream / 2.0
    nt = np.asarray(state.node_type)
    vel = np.asarray(state.vel)
    py = grid.pos[..., 1]
    px = grid.pos[..., 0]

    sel = (nt == FLUID) & (np.abs(py - y_check) <= 0.6 * cfg.dx)
    r_norm = px / cfg.R_tube
    sel &= np.abs(r_norm) <= 1.0
    if not sel.any():
        return float("nan")
    v_ana = 1.5 * cfg.U_in * (1.0 - r_norm[sel] ** 2)
    v_num = vel[..., 1][sel]
    err = np.sqrt(np.sum((v_num - v_ana) ** 2) / np.maximum(np.sum(v_ana**2), 1e-30))
    return float(err)
