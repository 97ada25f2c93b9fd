"""Explicit PD advection-reaction-diffusion transport (bi-material bonds).

Dense-array rewrite of PD_ARD_Solver (src/pd_ard.cpp). Bond classification
(liquid-liquid / interface / solid-solid-skip), the salt-layer blocking mask,
volume-loss micro-diffusivity decay, artificial diffusion, and non-
conservative advection all become stencil-shift masked sums. Phase change is
a pure device-side remask — no neighbor rebuild, because the lattice
topology never changes (see SURVEY §3 stack 5).
"""

from __future__ import annotations

from dataclasses import replace

import jax
import jax.numpy as jnp

from ..fields import State
from ..grid import FLUID, INLET, OUTLET, OUTSIDE, SOLID_MG, WALL, FICTITIOUS
from ..kit import Kit


def compute_salt_blocked(state: State, kit: Kit) -> jax.Array:
    """Salt-layer blocking (pd_ard.cpp:58-73 / pd_ard_implicit.cpp:68-87):
    a SOLID node with ANY FLUID neighbor at C >= C_sat has all its interface
    bonds disabled."""
    cfg = kit.cfg
    nt_p = kit.pad(state.node_type, OUTSIDE)
    C_p = kit.pad(state.C, 0.0)
    if kit.use_scan:
        offs, _, _, _ = kit.stencil_jnp()

        def body(blocked, off):
            nt_j = kit.shift_dyn(nt_p, off)
            C_j = kit.shift_dyn(C_p, off)
            return blocked | ((nt_j == FLUID) & (C_j >= cfg.C_sat)), None

        blocked, _ = jax.lax.scan(
            body, jnp.zeros(kit.shape, bool), offs)
    else:
        blocked = jnp.zeros(kit.shape, bool)
        for s, _, _, _ in kit.bond_iter():
            nt_j = kit.shift(nt_p, s)
            C_j = kit.shift(C_p, s)
            blocked = blocked | ((nt_j == FLUID) & (C_j >= cfg.C_sat))
    return blocked & (state.node_type == SOLID_MG)


def micro_d_factor(cfg, volume_loss_fraction, dtype) -> jax.Array:
    """Volume-loss-dependent scaling of the solid micro-diffusivities.

    Decay term: Hermann et al. 2022 Eq. 42, ``10^(-V_L/corrosion_decay_l)``
    (pd_ard.cpp:75-79). Acceleration term (EXTENSION, disabled by default,
    absent from all reference configs): ``10^(+V_L/corrosion_accel_l)`` —
    exposure-driven amplification fitted to the super-linear Reimers
    volume-loss kinetics (see the 3D two-anchor calibration,
    docs/runs/calib_3d/REPORT.md). Both terms compose multiplicatively.
    """
    vl = jnp.asarray(volume_loss_fraction, dtype)
    factor = jnp.asarray(1.0, dtype)
    if cfg.corrosion_decay_l > 0.0:
        factor = factor * jnp.power(10.0, -vl / cfg.corrosion_decay_l)
    if cfg.corrosion_accel_l > 0.0:
        factor = factor * jnp.power(10.0, vl / cfg.corrosion_accel_l)
    return factor


def compute_dt(state: State, kit: Kit) -> jax.Array:
    """Explicit transport CFL (pd_ard.cpp:34-53)."""
    cfg = kit.cfg
    fluid = state.node_type == FLUID
    vmag = jnp.linalg.norm(state.vel, axis=-1)
    v_max = jnp.max(jnp.where(fluid, vmag, 0.0))
    D_max = max(cfg.D_liquid, cfg.D_grain, cfg.D_gb)
    D_eff_max = D_max + cfg.alpha_art_diff * v_max * cfg.dx
    dt_diff = 0.25 * cfg.dx * cfg.dx / (D_eff_max + 1e-30)
    dt_adv = cfg.dx / (v_max + 1e-30)
    return cfg.cfl_factor_corr * jnp.minimum(dt_diff, dt_adv)


def ard_step(state: State, kit: Kit, dt, volume_loss_fraction=0.0) -> State:
    """One explicit forward-Euler transport step (pd_ard.cpp:55-191)."""
    cfg = kit.cfg
    dt = jnp.asarray(dt, kit.jdtype)

    nt = state.node_type
    i_fluid = nt == FLUID
    i_solid = nt == SOLID_MG
    active = i_fluid | i_solid  # other types pass through (pd_ard.cpp:85-89)

    salt_blocked = compute_salt_blocked(state, kit)

    # Hermann et al. 2022 Eq. 42 decay (pd_ard.cpp:75-79) + accel extension
    decay = micro_d_factor(cfg, volume_loss_fraction, kit.jdtype)

    C_i = state.C
    vel_i = jnp.where(i_fluid[..., None], state.vel, 0.0)
    vmag = jnp.linalg.norm(state.vel, axis=-1)
    vmag_i = jnp.where(i_fluid, vmag, 0.0)

    # solid-side micro-diffusivity of node i (GB > precipitate > grain)
    D_s_i = jnp.where(state.is_gb, cfg.D_gb,
                      jnp.where(state.is_precip, cfg.D_precip, cfg.D_grain)) * decay

    nt_p = kit.pad(nt, OUTSIDE)
    C_p = kit.pad(C_i, 0.0)
    vel_p = kit.pad(state.vel, 0.0)
    vmag_p = kit.pad(vmag, 0.0)
    gb_p = kit.pad(state.is_gb, False)
    precip_p = kit.pad(state.is_precip, False)
    blocked_p = kit.pad(salt_blocked, False)

    div_coeff = kit.alpha / kit.V_H
    beta_i = kit.beta_lap

    zero = jnp.zeros(kit.shape, kit.jdtype)

    def slot_sums(shift, xi, e_ij, vol, acc):
        diff_sum, adv_sum = acc
        nt_j = shift(nt_p)
        C_j = shift(C_p)

        # transport bonds exclude WALL and OUTSIDE neighbors (pd_ard.cpp:120)
        valid = (nt_j != WALL) & (nt_j != OUTSIDE)
        V_j = vol * valid.astype(kit.jdtype)

        j_fluid = (nt_j == FLUID) | (nt_j == INLET) | (nt_j == OUTLET) | (nt_j == FICTITIOUS)
        j_solid = nt_j == SOLID_MG

        ll = i_fluid & j_fluid                  # liquid-liquid
        ss = i_solid & j_solid                  # skipped (pd_ard.cpp:134)
        iface = (i_fluid & j_solid) | (i_solid & j_fluid)

        # interface micro-diffusivity from the solid side (pd_ard.cpp:143-161)
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

        # artificial diffusion on liquid-liquid bonds (pd_ard.cpp:164-170)
        vj_mag = shift(vmag_p)
        D_art = jnp.where(ll, cfg.alpha_art_diff * jnp.maximum(vmag_i, vj_mag) * cfg.dx, 0.0)

        inv_xi = 1.0 / xi
        inv_xi2 = inv_xi * inv_xi
        bond_on = (~ss).astype(kit.jdtype)

        diff_sum = diff_sum + beta_i * (D_avg + D_art) * (C_j - C_i) * inv_xi2 * V_j * bond_on

        # non-conservative advection, LL bonds only (pd_ard.cpp:178-181)
        vi_dot_e = zero
        for d in range(kit.dim):
            vi_dot_e = vi_dot_e + vel_i[..., d] * e_ij[d]
        adv_sum = adv_sum + jnp.where(ll, (C_j - C_i) * vi_dot_e * inv_xi * V_j, 0.0)
        return diff_sum, adv_sum

    if kit.use_scan:
        offs, dists, evecs, vols = kit.stencil_jnp()

        def body(acc, xs):
            off, xi, ev, vol = xs
            return slot_sums(lambda Ap: kit.shift_dyn(Ap, off), xi,
                             [ev[d] for d in range(kit.dim)], vol, acc), None

        (diff_sum, adv_sum), _ = jax.lax.scan(
            body, (zero, zero), (offs, dists, evecs, vols))
    else:
        diff_sum = zero
        adv_sum = zero
        for s, xi, e_ij, vol in kit.bond_iter():
            diff_sum, adv_sum = slot_sums(
                lambda Ap: kit.shift(Ap, s), xi, e_ij, vol,
                (diff_sum, adv_sum))

    C_new = C_i + dt * (diff_sum - div_coeff * adv_sum)
    C_new = jnp.maximum(C_new, 0.0)  # physical clamp (pd_ard.cpp:188-190)
    C_out = jnp.where(active, C_new, C_i)
    return replace(state, C=C_out)


def apply_phase_change(state: State, kit: Kit):
    """Dissolve solid nodes below C_thresh — device-side remask
    (pd_ard.cpp:193-212). Returns (new_state, n_dissolved)."""
    cfg = kit.cfg
    dissolve = (state.phase == 0) & (state.node_type == SOLID_MG) & (state.C < cfg.C_thresh)
    n = jnp.sum(dissolve.astype(jnp.int32))

    node_type = jnp.where(dissolve, jnp.uint8(FLUID), state.node_type)
    phase = jnp.where(dissolve, jnp.uint8(1), state.phase)
    D_map = jnp.where(dissolve, cfg.D_liquid, state.D_map)
    rho = jnp.where(dissolve, cfg.rho_f, state.rho)
    vel = jnp.where(dissolve[..., None], 0.0, state.vel)
    C = jnp.where(dissolve, cfg.C_thresh, state.C)

    return replace(state, node_type=node_type, phase=phase, D_map=D_map,
                   rho=rho, vel=vel, C=C), n
