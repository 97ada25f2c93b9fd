"""Implicit (backward-Euler) bi-material PD transport — matrix-free GMRES.

Dense-array rewrite of PD_ARD_ImplicitSolver (src/pd_ard_implicit.cpp). The
reference assembles an Eigen sparse matrix once per coupling cycle and
solves (I - dt*M) C_new = C_old + dt*bc_rhs with GMRES + IncompleteLUT.
Here M is never assembled: its action is a stencil application with per-slot
weight fields W[s] and a diagonal, precomputed once per cycle from frozen
velocity/node-type/salt masks (same bond physics incl. the per-bond M-matrix
upwind stabilization of pd_ard_implicit.cpp:254-288).

Two structural simplifications with identical algebra:

* Full-grid unknowns: instead of compacting FLUID/SOLID nodes into a dense
  unknown vector (pd_ard_implicit.cpp:44-60), BC nodes (INLET/OUTLET) keep
  identity rows with b = their current C. Eliminating those rows recovers
  exactly the reference's dt*bc_rhs split (pd_ard_implicit.cpp:296-343,
  352-362) — same solution, no scatter/gather.
* ILU -> Jacobi preconditioning: IncompleteLUT is inherently sequential,
  a poor fit for a data-parallel device. A = I - dt*M is strictly
  diagonally dominant with non-positive off-diagonals (the stated purpose
  of the upwind clamp), so diagonal preconditioning converges robustly.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import jax
import jax.numpy as jnp

from ..fields import State
from ..grid import FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG, WALL, FICTITIOUS
from ..kit import Kit
from .ard import compute_salt_blocked, micro_d_factor


@jax.tree_util.register_dataclass
@dataclass
class ImplicitOperator:
    """Frozen PD transport operator M (one coupling cycle)."""

    W: jax.Array        # [S, *shape] off-diagonal stencil weights (C_j coeffs)
    diag: jax.Array     # [*shape] diagonal of M
    unknown: jax.Array  # [*shape] bool — FLUID | SOLID rows


def assemble(state: State, kit: Kit, volume_loss_fraction=0.0) -> ImplicitOperator:
    """Build per-slot weights of M (pd_ard_implicit.cpp:104-346).

    Velocity, node types, GB/precipitate flags and the salt-blocking mask are
    frozen for the cycle, exactly as the reference's once-per-cycle assemble.
    """
    cfg = kit.cfg

    nt = state.node_type
    i_fluid = nt == FLUID
    i_solid = nt == SOLID_MG
    unknown = i_fluid | i_solid

    salt_blocked = compute_salt_blocked(state, kit)

    decay = micro_d_factor(cfg, volume_loss_fraction, kit.jdtype)

    vel_i = jnp.where(i_fluid[..., None], state.vel, 0.0)
    D_s_i = jnp.where(state.is_gb, cfg.D_gb,
                      jnp.where(state.is_precip, cfg.D_precip, cfg.D_grain)) * decay

    nt_p = kit.pad(nt, OUTSIDE)
    gb_p = kit.pad(state.is_gb, False)
    precip_p = kit.pad(state.is_precip, False)
    blocked_p = kit.pad(salt_blocked, False)

    div_coeff = kit.alpha / kit.V_H
    beta_i = kit.beta_lap

    zero = jnp.zeros(kit.shape, kit.jdtype)

    def slot_weight(shift, xi, e_ij, vol):
        nt_j = shift(nt_p)
        valid = (nt_j != WALL) & (nt_j != OUTSIDE)
        V_j = vol * valid.astype(kit.jdtype)

        j_fluid = (nt_j == FLUID) | (nt_j == INLET) | (nt_j == OUTLET) | (nt_j == FICTITIOUS)
        j_solid = nt_j == SOLID_MG

        ll = i_fluid & j_fluid
        ss = i_solid & j_solid
        iface = (i_fluid & j_solid) | (i_solid & j_fluid)

        D_s_j = jnp.where(shift(gb_p), cfg.D_gb,
                          jnp.where(shift(precip_p), cfg.D_precip,
                                    cfg.D_grain)) * decay
        solid_D = jnp.where(i_solid, D_s_i, D_s_j)
        solid_blocked = jnp.where(i_solid, salt_blocked, shift(blocked_p))
        D_iface = jnp.where(
            solid_blocked, 0.0,
            2.0 * cfg.D_liquid * solid_D / (cfg.D_liquid + solid_D + 1e-30),
        )
        D_avg = jnp.where(ll, cfg.D_liquid, jnp.where(iface, D_iface, 0.0))

        inv_xi = 1.0 / xi
        inv_xi2 = inv_xi * inv_xi

        # diffusion weight (all bond types), pd_ard_implicit.cpp:274-276
        w_diff = beta_i * D_avg * inv_xi2 * V_j

        # advection + per-bond upwind stabilization on LL bonds
        # (pd_ard_implicit.cpp:279-288): w = (w_diff + max(0, w_adv - w_diff)) - w_adv
        v_dot_e = zero
        for d in range(kit.dim):
            v_dot_e = v_dot_e + vel_i[..., d] * e_ij[d]
        w_adv = div_coeff * v_dot_e * inv_xi * V_j
        w_stab = jnp.maximum(0.0, w_adv - w_diff)
        w_ll = (w_diff + w_stab) - w_adv

        w = jnp.where(ll, w_ll, w_diff)
        # rows: only unknowns; bonds: skip solid-solid
        return jnp.where(unknown & ~ss, w, 0.0)

    if kit.use_scan:
        offs, dists, evecs, vols = kit.stencil_jnp()

        def body(diag, xs):
            off, xi, ev, vol = xs
            w = slot_weight(lambda Ap: kit.shift_dyn(Ap, off), xi,
                            [ev[d] for d in range(kit.dim)], vol)
            return diag - w, w

        diag, W = jax.lax.scan(body, zero, (offs, dists, evecs, vols))
    else:
        Ws = []
        diag = zero
        for s, xi, e_ij, vol in kit.bond_iter():
            w = slot_weight(lambda Ap: kit.shift(Ap, s), xi, e_ij, vol)
            diag = diag - w  # diag -= w_ii_bond (symmetric per bond)
            Ws.append(w)
        W = jnp.stack(Ws)

    return ImplicitOperator(W=W, diag=diag, unknown=unknown)


def matvec_M(op: ImplicitOperator, kit: Kit, x: jax.Array) -> jax.Array:
    """y = M x over unknown rows (zero elsewhere).

    GMRES's hot op, applied tens of times per implicit transport step. 3D
    float32 kits on a GPU take the Triton kernel
    (pallas_kernels.matvec_triton); everything else the XLA stencil sum."""
    from ..pallas_kernels import matvec_triton, use_kernels
    if use_kernels(kit) and x.dtype == jnp.float32:
        return matvec_triton(op, kit, x)

    x_p = kit.pad(x, 0.0)
    y = op.diag * x
    if kit.use_scan:
        offs, _, _, _ = kit.stencil_jnp()

        def body(y, xs):
            W_s, off = xs
            return y + W_s * kit.shift_dyn(x_p, off), None

        y, _ = jax.lax.scan(body, y, (op.W, offs))
    else:
        for s, _, _, _ in kit.bond_iter():
            y = y + op.W[s] * kit.shift(x_p, s)
    return jnp.where(op.unknown, y, 0.0)


def implicit_step(state: State, op: ImplicitOperator, kit: Kit, dt,
                  tol: float | None = None, restart: int = 50,
                  maxiter: int = 200, x0=None):
    """Solve (I - dt*M) C_new = C_old with GMRES (pd_ard_implicit.cpp:371-429).

    Returns (new_state, residual_norm). BC rows are identity with b = current
    C (algebraically identical to the reference's RHS split). The result is
    clamped to [0, C_solid_init] on unknown rows only, as in the reference.

    Tolerance: the reference's 1e-10 in f64 mode; 1e-6 in f32 performance
    mode (1e-10 is below f32 round-off, and an unreachable tol would burn
    every restart cycle on every step).
    """
    cfg = kit.cfg
    refine = kit.jdtype != jnp.float64 and jax.config.jax_enable_x64
    if tol is None:
        tol = 1e-10 if kit.jdtype == jnp.float64 else 1e-6
    inner_tol = tol
    if refine:
        # the f32 attainable residual floors near eps32*dt*||M|| ~ 1e-4;
        # asking the inner solve for more burns every restart cycle on an
        # unreachable target (~200 matvecs/step at 1M nodes). Solve to the
        # floor and let the f64-residual refinement passes close the rest.
        inner_tol = max(tol, 1e-4)
    if kit.jdtype != jnp.float64 and restart == 50:
        # shorter cycles keep the f32 Krylov basis well-conditioned
        # (adjusts the default only — an explicit caller value wins)
        restart = 25
    dt = jnp.asarray(dt, kit.jdtype)
    C_old = state.C

    def A(x):
        return jnp.where(op.unknown, x - dt * matvec_M(op, kit, x), x)

    # Truncated-Neumann (polynomial) preconditioner on the Jacobi-scaled
    # system: y_{n+1} = y_n + D^{-1}(x - A y_n), 2 refinement sweeps.
    # Replaces the reference's IncompleteLUT (sequential, a poor fit for a
    # data-parallel device); at stiff dt (~60 s) plain Jacobi stalls near
    # 1e-4 relative residual while 2 Neumann sweeps reach the tolerance in
    # <= 3 restart cycles.
    inv_diag = 1.0 / (1.0 - dt * op.diag)

    def jacobi(x):
        return jnp.where(op.unknown, x * inv_diag, x)

    def precond(x):
        y = jacobi(x)
        for _ in range(2):
            y = y + jacobi(x - A(y))
        return y

    from .gmres import gmres

    def solve_correction(r32, tol_c):
        return gmres(A, r32, jnp.zeros_like(r32), tol=tol_c, restart=restart,
                     maxiter=restart * 2, M=precond)

    b = C_old
    # optional Krylov-saving initial guess (e.g. the caller's linear
    # extrapolation 2*C_n - C_{n-1} at a near-constant dt): the solve is
    # residual-controlled to the same tolerance either way, the better
    # start just reaches it in fewer Arnoldi steps. Clamped to the
    # physical range so an extrapolation overshoot cannot seed the basis
    # with out-of-range values; BC rows must carry C_old (identity rows).
    if x0 is None:
        x0 = C_old
    else:
        x0 = jnp.where(op.unknown,
                       jnp.clip(x0, 0.0, cfg.C_solid_init), C_old)
    x, (res, _cycles) = gmres(A, b, x0, tol=inner_tol, restart=restart,
                              maxiter=maxiter, M=precond)

    # Mixed-precision iterative refinement (f32 mode only): the attainable
    # f32 residual is floored near eps32 * ||A|| * ||x|| / ||b|| ~ 1e-4 at
    # stiff dt (dt*||M|| ~ 1e4) no matter how well GMRES converges, because
    # b - A(x) itself is computed in f32. Computing the residual with an
    # f64 operator and solving the (well-scaled) correction in f32 recovers
    # ILU-in-f64-strength accuracy at the cost of a few f64 matvecs per
    # step — the reference reaches 1e-10 via Eigen GMRES+ILUT in double
    # (pd_ard_implicit.cpp:399-417).
    if refine:
        f64 = jnp.float64
        diag64 = op.diag.astype(f64)
        dt64 = dt.astype(f64)
        W64 = op.W.astype(f64)

        def A64(x64):
            x_p = kit.pad(x64, 0.0)
            y = diag64 * x64
            if kit.use_scan:
                offs, _, _, _ = kit.stencil_jnp()

                def body(y, xs):
                    W_s, off = xs
                    return (y + W_s.astype(f64) * kit.shift_dyn(x_p, off),
                            None)

                y, _ = jax.lax.scan(body, y, (op.W, offs))
            else:
                for s, _, _, _ in kit.bond_iter():
                    y = y + W64[s] * kit.shift(x_p, s)
            Mx = jnp.where(op.unknown, y, 0.0)
            return jnp.where(op.unknown, x64 - dt64 * Mx, x64)

        b64 = b.astype(f64)
        b_norm = jnp.maximum(jnp.linalg.norm(b64.ravel()), 1e-300)
        # accumulate the refined solution in f64: an f32-*stored* x cannot
        # have f64-residual below ~eps32 * dt * ||M|| ~ 1e-4 regardless of
        # solver quality; each refinement multiplies the residual by the
        # inner solve's relative accuracy (~1e-2), so two passes reach 1e-8
        x64 = x.astype(f64)

        def refine_pass(carry):
            x64, r64, res = carry
            # correction solve in f32 on the f64-accurate residual; GMRES
            # normalizes internally so the small scale is benign. The
            # correction only needs to contract the residual from `res` to
            # `tol` — asking for the fixed 100x (tol 1e-2) burned a full
            # restart cycle at moderate dt when a handful of Arnoldi steps
            # already sufficed (the 0.5 safety factor covers the Givens
            # estimate's optimism vs the true f64 residual; the outer
            # res > tol guard re-runs the pass if it falls short).
            tol_c = jnp.clip(0.5 * tol / jnp.maximum(res, 1e-300),
                             1e-4, 0.5)
            e, _ = solve_correction(r64.astype(kit.jdtype), tol_c)
            x64n = x64 + e.astype(f64)
            r64n = b64 - A64(x64n)
            resn = jnp.linalg.norm(r64n.ravel()) / b_norm
            return x64n, r64n, resn

        def refine_if_needed(carry):
            return jax.lax.cond(carry[2] > tol, refine_pass,
                                lambda c: c, carry)

        r64 = b64 - A64(x64)
        res = jnp.linalg.norm(r64.ravel()) / b_norm
        carry = (x64, r64, res)
        carry = refine_if_needed(carry)
        carry = refine_if_needed(carry)
        x64, _, res = carry
        x = x64.astype(kit.jdtype)

    C_new = jnp.where(op.unknown, jnp.clip(x, 0.0, cfg.C_solid_init), C_old)
    return replace(state, C=C_new), res


def compute_adaptive_dt(state: State, op: ImplicitOperator, kit: Kit) -> jax.Array:
    """Adaptive dt from per-solid time-to-threshold (pd_ard_implicit.cpp:438-489).

    dC/dt for a solid row is (M C)_i — the full-grid matvec already includes
    the INLET/OUTLET "BC" columns the reference adds separately.
    """
    cfg = kit.cfg
    MC = matvec_M(op, kit, state.C)

    solid = state.node_type == SOLID_MG
    eligible = solid & (state.C > cfg.C_thresh) & (MC < 0.0)
    rate = -MC
    t_phase = (state.C - cfg.C_thresh) / jnp.maximum(rate, 1e-30)
    t_phase = jnp.where(eligible & (t_phase > 0.0) & (rate >= 1e-30),
                        t_phase, cfg.implicit_dt_max)
    min_t = jnp.minimum(jnp.min(t_phase), cfg.implicit_dt_max)

    dt = cfg.implicit_dt_fraction * min_t
    dt = jnp.minimum(dt, cfg.implicit_dt_max)
    dt = jnp.maximum(dt, cfg.implicit_dt_max * cfg.implicit_dt_min_frac)
    return dt
