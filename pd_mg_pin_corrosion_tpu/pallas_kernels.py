"""Triton kernels (Pallas, ``backend="triton"``) for the 3D stencil hot ops.

The 3D flow cell spends its time in two stencil sums over S = 178 slots:
the PD-NS bond sums of every flow iteration (ops/ns.ns_step) and the
implicit-transport matvec y = diag*x + sum_s W_s * x(. + off_s) of every
GMRES step (ops/ard_implicit.matvec_M). The XLA forms visit the slots one
at a time and read-modify-write every accumulator in device memory per
slot. These kernels keep the accumulators in registers instead: each
program takes a contiguous block of interior nodes, loops over all slots
inside the block (loads at a fixed flat offset per slot into the padded
field, which mostly hit L1/L2) and writes each output once. The matvec
streams the weight stack W in its own [S, N] layout, so one matvec reads
W once.

Both kernels have the XLA path as their reference (tests/test_pallas.py,
chip_smoke.py). ``use_kernels`` decides which path a kit takes.
"""

from __future__ import annotations

from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .fields import State
from .grid import FLUID, OUTSIDE
from .kit import Kit
from .ops.ns import ns_step as ns_step_xla
from .ops.ns import tait_pressure

# interior nodes per program, warps per program (powers of two), and
# stencil slots per trip of the in-kernel slot loop. Chosen on an H100 at
# the params_3d.cfg geometry; the other variants tried (NS 128/4/1 and
# 256/8/4, matvec 256/4/4, 512/4/8 and 2048/8/2) were within 10 %.
# Unrolling all 178 slots instead made Triton's compile run for minutes.
NS_BLOCK, NS_WARPS, NS_UNROLL = 256, 4, 2
MV_BLOCK, MV_WARPS, MV_UNROLL = 1024, 4, 4


def use_kernels(kit: Kit, platform: str | None = None) -> bool:
    """The Triton kernels serve 3D float32 kits on one GPU; every other
    case (f64, 2D, CPU, a sharded kit) takes the XLA path.

    ``platform`` defaults to the default backend's (``jax.default_backend()``).
    """
    platform = platform or jax.default_backend()
    return (platform == "gpu" and kit.dim == 3
            and kit.jdtype == jnp.float32 and not kit.multi_device)


def _padded_index(kit: Kit, n):
    """Flat interior index -> flat index into the kit.pad-ed field."""
    _, ny, nx = kit.shape
    m = kit.mext
    k = n // (ny * nx)
    r = n - k * (ny * nx)
    j = r // nx
    i = r - j * nx
    return ((k + m) * (ny + 2 * m) + (j + m)) * (nx + 2 * m) + (i + m)


def _slot_tables(kit: Kit):
    """Per-slot flat offsets into the padded field [S] int32 and bond
    constants [S, 5] = (xi, vol, e_x, e_y, e_z) in float32, as the XLA
    scan form rounds them (Kit.stencil_jnp)."""
    _, ny, nx = kit.shape
    m = kit.mext
    offs = [(dk * (ny + 2 * m) + dj) * (nx + 2 * m) + di
            for dk, dj, di in kit.offsets]
    consts = [(xi, vol, *e) for _, xi, e, vol in kit.bond_iter()]
    return (jnp.asarray(offs, jnp.int32), jnp.asarray(consts, jnp.float32))


def _slot_loop(n_slots: int, unroll: int, body, carry):
    """body(s, carry) over slots 0..n_slots-1 in order: a loop whose every
    trip runs ``unroll`` slots, then the remainder."""
    def trip(t, c):
        for u in range(unroll):
            c = body(t * unroll + u, c)
        return c

    carry = jax.lax.fori_loop(0, n_slots // unroll, trip, carry)
    for s in range(n_slots - n_slots % unroll, n_slots):
        carry = body(s, carry)
    return carry


def _block_nodes(n_total: int, block: int):
    """(block slice, node indices clamped into range, live mask)."""
    start = pl.program_id(0) * block
    n = start + jnp.arange(block, dtype=jnp.int32)
    live = n < n_total
    return pl.ds(start, block), jnp.minimum(n, n_total - 1), live


def _ns_kernel(kit: Kit, block: int, unroll: int, offs_ref, bond_ref, dt_ref,
               rho_ref, vx_ref, vy_ref, vz_ref, p_ref, act_ref,
               rho_out, vx_out, vy_out, vz_out):
    """PD-NS bond sums (pd_ns.cpp:86-179) for one block of interior nodes,
    slot by slot in stencil order with ops/ns.ns_step's per-slot
    arithmetic; the 11 accumulators stay in registers."""
    cfg = kit.cfg
    sl, n, live = _block_nodes(rho_out.shape[0], block)
    p = _padded_index(kit, n)
    vel_refs = (vx_ref, vy_ref, vz_ref)

    rho_i = rho_ref[p]
    v_i = [r[p] for r in vel_refs]
    p_i = p_ref[p]
    m_i = [rho_i * v for v in v_i]

    D_v = cfg.eta_density * cfg.c0 * cfg.delta
    dens_coeff = kit.beta_lap * D_v

    def slot(s, acc):
        mass_conv, mass_diff, mom_conv, mom_pres, mom_visc = acc
        q = p + offs_ref[s]
        xi = bond_ref[s, 0]
        e = [bond_ref[s, 2 + d] for d in range(3)]
        V_j = bond_ref[s, 1] * act_ref[q]
        rho_j = rho_ref[q]
        v_j = [r[q] for r in vel_refs]
        p_j = p_ref[q]
        inv_xi = 1.0 / xi
        inv_xi2 = inv_xi * inv_xi

        m_j = [rho_j * v for v in v_j]
        flux = sum((m_j[d] - m_i[d]) * e[d] for d in range(3))
        mass_conv = mass_conv + flux * inv_xi * V_j
        mass_diff = mass_diff + dens_coeff * (rho_j - rho_i) * inv_xi2 * V_j
        mom_conv = tuple(
            mom_conv[d] + sum((m_j[d] * v_j[dp] - m_i[d] * v_i[dp]) * e[dp]
                              for dp in range(3)) * inv_xi * V_j
            for d in range(3))
        mom_pres = tuple(mom_pres[d] + (p_j - p_i) * e[d] * inv_xi * V_j
                         for d in range(3))
        mom_visc = tuple(mom_visc[d] + (v_j[d] - v_i[d]) * inv_xi2 * V_j
                         for d in range(3))
        return mass_conv, mass_diff, mom_conv, mom_pres, mom_visc

    zero = jnp.zeros((block,), jnp.float32)
    acc = (zero, zero, (zero,) * 3, (zero,) * 3, (zero,) * 3)
    mass_conv, mass_diff, mom_conv, mom_pres, mom_visc = _slot_loop(
        kit.S, unroll, slot, acc)

    dt = dt_ref[0]
    a_inv_VH = kit.alpha / kit.V_H
    rho_new = rho_i + dt * (-a_inv_VH * mass_conv + mass_diff)
    rho_new = jnp.clip(rho_new, 0.5 * cfg.rho_f, 2.0 * cfg.rho_f)
    plgpu.store(rho_out.at[sl], rho_new, mask=live)
    inv_rho = 1.0 / rho_i
    for d, out in enumerate((vx_out, vy_out, vz_out)):
        v_new = v_i[d] + dt * inv_rho * (
            -a_inv_VH * mom_conv[d] - a_inv_VH * mom_pres[d]
            + cfg.mu_f * kit.beta_lap * mom_visc[d])
        plgpu.store(out.at[sl], v_new, mask=live)


@partial(jax.jit, static_argnames=("interpret",))
def ns_step_triton(state: State, kit: Kit, dt, *,
                   interpret: bool = False) -> State:
    """Drop-in for ops.ns.ns_step on 3D float32 kits.

    ``interpret`` runs the kernel in the Pallas interpreter (tests only).
    """
    N = state.rho.size
    pressure = tait_pressure(state.rho, kit)
    act = (kit.pad(state.node_type, OUTSIDE) != OUTSIDE).astype(jnp.float32)
    fields = [kit.pad(f, 0.0).ravel() for f in
              (state.rho, state.vel[..., 0], state.vel[..., 1],
               state.vel[..., 2], pressure)]
    dt_arr = jnp.asarray(dt, jnp.float32).reshape(1)
    rho_new, *vel_new = pl.pallas_call(
        partial(_ns_kernel, kit, NS_BLOCK, NS_UNROLL),
        out_shape=[jax.ShapeDtypeStruct((N,), jnp.float32)] * 4,
        grid=(pl.cdiv(N, NS_BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NS_WARPS),
        interpret=interpret,
        name="ns_bonds_3d",
    )(*_slot_tables(kit), dt_arr, *fields, act.ravel())

    fluid = state.node_type == FLUID
    vel = jnp.stack([v.reshape(kit.shape) for v in vel_new], axis=-1)
    return replace(state,
                   rho=jnp.where(fluid, rho_new.reshape(kit.shape), state.rho),
                   vel=jnp.where(fluid[..., None], vel, state.vel),
                   pressure=pressure)


def ns_step_auto(state: State, kit: Kit, dt) -> State:
    """The Triton kernel where ``use_kernels`` says so, XLA otherwise."""
    if use_kernels(kit):
        return ns_step_triton(state, kit, dt)
    return ns_step_xla(state, kit, dt)


def _matvec_kernel(kit: Kit, block: int, unroll: int, offs_ref, x_ref, w_ref,
                   diag_ref, y_ref):
    """y = diag*x + sum_s W_s * x(. + off_s) for one block of interior
    nodes, summed in stencil order as the XLA matvec does."""
    sl, n, live = _block_nodes(y_ref.shape[0], block)
    p = _padded_index(kit, n)

    def slot(s, y):
        w = plgpu.load(w_ref.at[s, sl], mask=live, other=0.0)
        return y + w * x_ref[p + offs_ref[s]]

    y = plgpu.load(diag_ref.at[sl], mask=live, other=0.0) * x_ref[p]
    plgpu.store(y_ref.at[sl], _slot_loop(kit.S, unroll, slot, y), mask=live)


@partial(jax.jit, static_argnames=("interpret",))
def matvec_triton(op, kit: Kit, x: jax.Array, *,
                  interpret: bool = False) -> jax.Array:
    """Drop-in for ops.ard_implicit.matvec_M on 3D float32 kits.

    ``interpret`` runs the kernel in the Pallas interpreter (tests only).
    """
    N = x.size
    y = pl.pallas_call(
        partial(_matvec_kernel, kit, MV_BLOCK, MV_UNROLL),
        out_shape=jax.ShapeDtypeStruct((N,), jnp.float32),
        grid=(pl.cdiv(N, MV_BLOCK),),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=MV_WARPS),
        interpret=interpret,
        name="implicit_matvec_3d",
    )(_slot_tables(kit)[0], kit.pad(x, 0.0).ravel(), op.W.reshape(kit.S, N),
      op.diag.ravel())
    return jnp.where(op.unknown, y.reshape(kit.shape), 0.0)
