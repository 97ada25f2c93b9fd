"""PD Navier-Stokes: Tait EOS, CFL dt, and the weakly compressible step.

Dense-array rewrite of the reference flow solver (src/pd_ns.cpp). The hot
bond loop (pd_ns.cpp:86-179) — nonlocal mass divergence, delta-SPH density
diffusion, momentum convection / pressure gradient / viscous Laplacian —
becomes a sum over stencil-shifted dense arrays (see kit.py). Summation
runs in the reference's stencil order, so the floating-point reduction
order matches the serial CSR loop exactly (invalid slots contribute an
exact +0.0).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..fields import State
from ..grid import FLUID, OUTSIDE, SOLID_MG
from ..kit import Kit


def tait_pressure(rho: jax.Array, kit: Kit) -> jax.Array:
    """Tait EOS with density-ratio clamp (pd_ns.cpp:36-50)."""
    cfg = kit.cfg
    B = cfg.rho_f * cfg.c0 * cfg.c0 / cfg.gamma_eos
    ratio = jnp.clip(rho / cfg.rho_f, 0.5, 2.0)
    return B * (jnp.power(ratio, cfg.gamma_eos) - 1.0)


def fluid_vmax(state: State, kit: Kit) -> jax.Array:
    """max |v| over FLUID nodes (pd_ns.cpp:52-62)."""
    fluid = state.node_type == FLUID
    vmag = jnp.linalg.norm(state.vel, axis=-1)
    return jnp.max(jnp.where(fluid, vmag, 0.0))


def compute_dt(state: State, kit: Kit) -> jax.Array:
    """CFL timestep (pd_ns.cpp:52-76): min of acoustic, viscous, density-diffusive."""
    cfg = kit.cfg
    v_max = fluid_vmax(state, kit)
    dt_cfl = cfg.dx / (cfg.c0 + v_max + 1e-30)
    nu = cfg.mu_f / cfg.rho_f
    dt_visc = 0.25 * cfg.dx * cfg.dx / (nu + 1e-30)
    D_v = cfg.eta_density * cfg.c0 * cfg.delta
    dt_dens = 0.25 * cfg.dx * cfg.dx / (D_v + 1e-30)
    return cfg.cfl_factor * jnp.minimum(dt_cfl, jnp.minimum(dt_visc, dt_dens))


def ns_step(state: State, kit: Kit, dt) -> State:
    """One explicit PD-NS step (pd_ns.cpp:78-180).

    Returns a new State with updated rho/vel on FLUID nodes (all other node
    types pass through — their values come from BCs / IDW, pd_ns.cpp:88-97)
    and pressure = Tait(rho_in) as computed at step entry (pd_ns.cpp:79).

    The bond sums run Python-unrolled in 2D (reference summation order,
    good XLA fusion) and as a lax.scan over stencil slots in 3D (see
    Kit.use_scan for why the 178-slot unrolled form is unusable there).
    """
    cfg = kit.cfg
    dim = kit.dim
    dt = jnp.asarray(dt, kit.jdtype)

    pressure = tait_pressure(state.rho, kit)

    rho_i = state.rho
    vel_i = state.vel
    p_i = pressure

    # Pad once; every bond is a (static or dynamic) slice of these.
    rho_p = kit.pad(rho_i, 0.0)
    vel_p = kit.pad(vel_i, 0.0)
    p_p = kit.pad(p_i, 0.0)
    nt_p = kit.pad(state.node_type, OUTSIDE)

    inv_VH = 1.0 / kit.V_H
    beta_l = kit.beta_lap
    D_v = cfg.eta_density * cfg.c0 * cfg.delta
    dens_diff_coeff = beta_l * D_v

    zero = jnp.zeros(kit.shape, kit.jdtype)

    def slot_sums(shift, xi, e_ij, vol, acc):
        (mass_conv, mass_diff, mom_conv, mom_pres, mom_visc) = acc
        nt_j = shift(nt_p)
        valid = (nt_j != OUTSIDE).astype(kit.jdtype)
        V_j = vol * valid

        rho_j = shift(rho_p)
        vel_j = shift(vel_p)
        p_j = shift(p_p)

        inv_xi = 1.0 / xi
        inv_xi2 = inv_xi * inv_xi

        # Mass: PD divergence of (rho v) (pd_ns.cpp:130-133)
        flux_diff_dot_e = zero
        for d in range(dim):
            flux_diff_dot_e = flux_diff_dot_e + (
                rho_j * vel_j[..., d] - rho_i * vel_i[..., d]
            ) * e_ij[d]
        mass_conv = mass_conv + flux_diff_dot_e * (inv_xi) * V_j

        # Density diffusion: PD Laplacian of rho (pd_ns.cpp:135-136)
        mass_diff = mass_diff + dens_diff_coeff * (rho_j - rho_i) * inv_xi2 * V_j

        mom_conv = list(mom_conv)
        mom_pres = list(mom_pres)
        mom_visc = list(mom_visc)
        for d in range(dim):
            # Momentum convection: PD divergence of (rho v v) (pd_ns.cpp:138-145)
            conv_d = zero
            for dp in range(dim):
                conv_d = conv_d + (
                    rho_j * vel_j[..., d] * vel_j[..., dp]
                    - rho_i * vel_i[..., d] * vel_i[..., dp]
                ) * e_ij[dp]
            mom_conv[d] = mom_conv[d] + conv_d * inv_xi * V_j

            # Pressure gradient (pd_ns.cpp:148-151)
            mom_pres[d] = mom_pres[d] + (p_j - p_i) * e_ij[d] * inv_xi * V_j

            # Viscous Laplacian (pd_ns.cpp:153-156)
            mom_visc[d] = mom_visc[d] + (vel_j[..., d] - vel_i[..., d]) * inv_xi2 * V_j
        return (mass_conv, mass_diff, tuple(mom_conv), tuple(mom_pres),
                tuple(mom_visc))

    acc0 = (zero, zero, (zero,) * dim, (zero,) * dim, (zero,) * dim)
    if kit.use_scan:
        offs, dists, evecs, vols = kit.stencil_jnp()

        def body(acc, xs):
            off, xi, ev, vol = xs
            acc = slot_sums(lambda Ap: kit.shift_dyn(Ap, off),
                            xi, [ev[d] for d in range(dim)], vol, acc)
            return acc, None

        acc, _ = jax.lax.scan(body, acc0, (offs, dists, evecs, vols))
    else:
        acc = acc0
        for s, xi, e_ij, vol in kit.bond_iter():
            acc = slot_sums(lambda Ap: kit.shift(Ap, s), xi, e_ij, vol, acc)

    mass_conv, mass_diff, mom_conv, mom_pres, mom_visc = acc

    # Density update with clamp (pd_ns.cpp:159-168)
    rho_new = rho_i + dt * (-(kit.alpha * inv_VH) * mass_conv + mass_diff)
    rho_new = jnp.clip(rho_new, 0.5 * cfg.rho_f, 2.0 * cfg.rho_f)

    # Velocity update (pd_ns.cpp:170-178)
    inv_rho = 1.0 / rho_i
    vel_new = jnp.stack(
        [
            vel_i[..., d]
            + dt * inv_rho * (
                -(kit.alpha * inv_VH) * mom_conv[d]
                - (kit.alpha * inv_VH) * mom_pres[d]
                + cfg.mu_f * beta_l * mom_visc[d]
            )
            for d in range(dim)
        ],
        axis=-1,
    )

    fluid = state.node_type == FLUID
    rho_out = jnp.where(fluid, rho_new, rho_i)
    vel_out = jnp.where(fluid[..., None], vel_new, vel_i)

    return State(
        rho=rho_out, vel=vel_out, pressure=pressure, C=state.C,
        node_type=state.node_type, phase=state.phase, D_map=state.D_map,
        grain_id=state.grain_id, is_gb=state.is_gb, is_precip=state.is_precip,
    )
