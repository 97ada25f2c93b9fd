"""Coupled corrosion driver: flow steady solves + ARD stepping + phase change.

Rewrite of CoupledSolver::run (src/coupling.cpp:82-302). Structure preserved:

* Phase 1 — flow re-solve only when dissolution changed the geometry
  (``need_flow_solve``), entirely on device via lax.while_loop.
* Phase 2 — corrosion with frozen velocity. Implicit path: operator
  (re)assembled once per cycle, adaptive dt per step, early exit at the
  first node crossing C_thresh. Explicit path: fixed dt, fused device chunks
  between output points.
* Phase 3 — phase change as a device-side remask; NO neighbor rebuild
  (the reference's full CSR rebuild at coupling.cpp:267-271 recreates
  byte-identical topology — here bond masks are recomputed from node_type
  every step, so the rebuild is structurally unnecessary).

Diagnostics CSVs are schema-identical to the reference
(coupling.cpp:55-80): diagnostics.csv
``time_s,time_h,pin_mass_loss_pct,solid_nodes,v_max,C_max_fluid`` and
mass_loss.csv ``time_h,pin_mass_loss_pct``.

New capability vs the reference: checkpoint/resume (cfg.checkpoint_every /
cfg.resume_from; the reference has none — SURVEY §5).
"""

from __future__ import annotations

import os
import time
from dataclasses import replace
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from .dispatch import ops_for
from .fields import State
from .grid import FLUID, SOLID_MG
from .io_vtk import VTKWriter
from .solvers import FLOW_SEGMENT_ITERS, _solve_steady_segment, solve_steady


# ---------------------------------------------------------------------------
# Device-side diagnostics (coupling.cpp:20-53)
# ---------------------------------------------------------------------------

@jax.jit
def diagnostics(state: State, kit):
    """(pin_mass_loss_pct, solid_nodes, v_max, C_max_fluid)."""
    init_solid = kit.initial_solid_mask
    n0 = jnp.sum(init_solid.astype(kit.jdtype))
    C_solid_sum = jnp.sum(jnp.where(init_solid, state.C, 0.0))
    loss = jnp.maximum((1.0 - C_solid_sum / (n0 + 1e-30)) * 100.0, 0.0)

    solid_count = jnp.sum((state.node_type == SOLID_MG).astype(jnp.int32))
    fluid = state.node_type == FLUID
    vmag = jnp.linalg.norm(state.vel, axis=-1)
    v_max = jnp.max(jnp.where(fluid, vmag, 0.0))
    C_max = jnp.max(jnp.where(fluid, state.C, 0.0))
    return loss, solid_count, v_max, C_max


@jax.jit
def volume_loss_fraction(state: State, kit):
    """Normalized volume loss over initially-solid nodes (coupling.cpp:157-163)."""
    init_solid = kit.initial_solid_mask
    n0 = jnp.sum(init_solid.astype(kit.jdtype))
    C_solid_sum = jnp.sum(jnp.where(init_solid, state.C, 0.0))
    return jnp.maximum(1.0 - C_solid_sum / (n0 + 1e-30), 0.0)


# ---------------------------------------------------------------------------
# Fused inner steps
# ---------------------------------------------------------------------------

@jax.jit
def assemble_operator(state: State, kit, vol_loss):
    return ops_for(kit).assemble(state, kit, vol_loss)


def _implicit_inner_core(state: State, op, kit, C_prev=None):
    """One implicit corrosion step: adaptive dt -> BCs -> GMRES -> smoothing
    -> fictitious refresh (AMR) -> dissolution flag + diagnostics
    (coupling.cpp:174-212).

    ``C_prev`` (the concentration before the PREVIOUS step) enables the
    cfg.implicit_extrapolate_x0 Krylov-saving GMRES start 2*C_n - C_{n-1};
    callers that thread it hold the knob's gate — with the knob off the
    graph is unchanged."""
    ops = ops_for(kit)
    dt = ops.compute_adaptive_dt(state, op, kit)
    state = ops.apply_inlet_bc(state, kit)
    state = ops.apply_outlet_bc(state, kit)
    state = ops.apply_wall_concentration_bc(state, kit)
    x0 = None
    if C_prev is not None and kit.cfg.implicit_extrapolate_x0:
        x0 = 2.0 * state.C - C_prev
    state, res = ops.implicit_step(state, op, kit, dt, x0=x0)
    state = ops.smooth_boundary_concentration(state, kit)
    state = ops.update_fictitious(state, kit)

    n_below = jnp.sum(
        ((state.node_type == SOLID_MG) & (state.C < kit.cfg.C_thresh))
        .astype(jnp.int32))
    diag = diagnostics(state, kit)
    return state, dt, n_below, res, diag


implicit_inner_step = jax.jit(_implicit_inner_core)


@partial(jax.jit, static_argnames=("max_steps",))
def implicit_inner_chunk(state: State, op, kit, t0, total_steps0, T_final,
                         batch, diag_every, max_steps: int,
                         output_every=jnp.asarray(2**30, jnp.int32),
                         k0=jnp.asarray(0, jnp.int32),
                         launch_cap=jnp.asarray(2**30, jnp.int32)):
    """Up to ``max_steps`` implicit corrosion steps fused in ONE device
    while_loop, with the reference's inner-loop exit conditions
    (coupling.cpp:174-213) evaluated on device: stop at ``max_steps``, at
    ``T_final``, or after the step on which >= ``batch`` solid nodes
    crossed C_thresh. Diagnostics rows for steps where
    ``(total_steps0 + k) % diag_every == 0`` are buffered on device in
    (t, loss, solid, v_max, C_max) form.

    ``output_every``: the chunk additionally exits when the global step
    count lands on a VTI output boundary, so the host can write the
    snapshot at exactly the step the step-at-a-time loop would have —
    fusing stays output-cadence-exact instead of requiring per-step VTI
    to be disabled.

    Trajectory-identical to calling ``implicit_inner_step`` step-at-a-time
    (same op sequence; t accumulates in the same f64 arithmetic the host
    loop uses under x64). Returns
    ``(state, t, steps_done, dissolved, max_res, rows, n_rows)``.
    """
    f64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    rows0 = jnp.zeros((max_steps, 5), f64)
    # trace-time gate: with the knob off the carry and graph are unchanged
    extrap = bool(kit.cfg.implicit_extrapolate_x0)

    def cond(c):
        t, k, dissolved = c[1], c[2], c[3]
        at_output = (k > 0) & (((total_steps0 + k) % output_every) == 0)
        # launch_cap bounds ONE device execution; the host loop
        # re-launches to finish the cycle budget, so semantics are
        # unchanged
        return ((k0 + k < max_steps) & (k < launch_cap) & (t < T_final)
                & jnp.logical_not(dissolved) & jnp.logical_not(at_output))

    def body(c):
        state, t, k, _, max_res, rows, n_rows = c[:7]
        C_prev = c[7] if extrap else None
        C_pre = state.C
        state, dt, n_below, res, diag = _implicit_inner_core(
            state, op, kit, C_prev)
        t = t + dt.astype(f64)
        k = k + 1
        dissolved = n_below >= batch
        max_res = jnp.maximum(max_res, res.astype(f64))
        write = ((total_steps0 + k) % diag_every) == 0
        row = jnp.stack([t] + [diag[i].astype(f64) for i in range(4)])
        rows = jax.lax.cond(write, lambda r: r.at[n_rows].set(row),
                            lambda r: r, rows)
        n_rows = n_rows + write.astype(jnp.int32)
        out = (state, t, k, dissolved, max_res, rows, n_rows)
        return out + ((C_pre,) if extrap else ())

    init = (state, jnp.asarray(t0, f64), jnp.asarray(0, jnp.int32),
            jnp.asarray(False), jnp.asarray(0.0, f64), rows0,
            jnp.asarray(0, jnp.int32))
    if extrap:
        # seed C_prev = C so the first step's extrapolation is a no-op
        init = init + (state.C,)
    return jax.lax.while_loop(cond, body, init)[:7]


# Micro-op phases of the fused coupled loop (coupled_cycles_chunk)
_PH_CYCLE_START = 0   # [flow re-solve if needed] + operator assemble
_PH_INNER = 1         # one implicit corrosion step (op valid)
_PH_PHASE_CHANGE = 2  # dissolution remask pending (cycle end)


@partial(jax.jit, static_argnames=("max_cycles", "max_inner", "flow_cap",
                                   "flow_cap_init"))
def coupled_cycles_chunk(state: State, kit, op, t0, total_steps0, T_final,
                         batch, diag_every, need_flow0,
                         max_cycles: int, max_inner: int, flow_cap: int,
                         phase0=jnp.asarray(0, jnp.int32),
                         inner_k0=jnp.asarray(0, jnp.int32),
                         step_cap=jnp.asarray(2**30, jnp.int32),
                         flow_iter_cap=jnp.asarray(2**30, jnp.int32),
                         output_every=jnp.asarray(2**30, jnp.int32),
                         flow_stride=jnp.asarray(2**30, jnp.int32),
                         flow_solves0=jnp.asarray(0, jnp.int32),
                         cycle_cap=jnp.asarray(2**30, jnp.int32),
                         flow_cap_init: int | None = None,
                         f_it0=jnp.asarray(0, jnp.int32),
                         f_eps0=jnp.asarray(0.0),
                         f_dt0=jnp.asarray(0.0)):
    """Up to ``max_cycles`` FULL coupling cycles fused in ONE device
    execution — the "dissolve-and-continue" loop (round-3 roadmap #1),
    restructured (round 4) as a resumable MICRO-OP state machine so a
    launch can pause and resume at ANY point of a cycle:

    each while_loop iteration executes exactly one micro-op —
    ``_PH_CYCLE_START`` ([flow re-solve if needed] + assemble, the op
    joins the carry), ``_PH_INNER`` (one implicit corrosion step), or
    ``_PH_PHASE_CHANGE`` (dissolution remask) — and the loop exits
    between micro-ops whenever a launch budget (``step_cap`` implicit
    steps / ``flow_iter_cap`` flow iterations per execution) or a host-I/O
    boundary is hit:

    * ``output_every``: the step landing on the global VTI cadence
      (coupling.cpp:198-204) sets ``exit_output`` — the host writes the
      snapshot at exactly that state (pre-phase-change when the same
      step also ends the cycle, matching the reference's write-then-
      phase-change order) and re-enters with the carried (op, phase,
      inner_k). Fused cycles are output-cadence-exact; the round-3
      implementation had to skip per-step VTI entirely.
    * ``flow_stride``: a flow re-solve landing on the flow.pvd cadence
      (coupling.cpp:139-147, host path's flow_output_stride) sets
      ``exit_flow`` for the same treatment. ``flow_solves0`` is the
      global pre-launch solve count the stride is computed against.

    Budgets are now exact to one micro-op (the round-3 version could
    overshoot by a full worst-case cycle — max_inner steps + flow_cap
    iterations — because it only checked at cycle boundaries).

    Trajectory-identical to the host-driven path: the flow re-solve uses
    the same ``_solve_steady_segment`` body (reference check cadence,
    early-exit buffers, dt refresh — pd_ns.cpp:182-372) capped at
    ``flow_cap`` iterations (= the host path's flow_max_iters_resolve
    cap), one inner step is ``_implicit_inner_core`` with
    ``implicit_inner_chunk``'s exit conditions (coupling.cpp:174-213),
    and the operator is assembled once per cycle and carried across
    launch boundaries (re-assembling mid-cycle would change the frozen
    coefficients the reference keeps for the whole cycle).
    """
    ops = ops_for(kit)
    f64 = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
    rows0 = jnp.zeros((max_cycles * max_inner, 5), f64)
    eps0 = jnp.asarray(0.0, kit.jdtype)

    # flow solves run in FLOW_SEGMENT_ITERS sub-segments, ONE per
    # cycle_start micro-op, with (f_it, f_eps, f_dt) carried across
    # micro-ops AND launches — exactly solve_steady's host segmentation
    # (same 2000-iteration boundaries, check cadence and dt-refresh
    # points), so the solve sequence is bit-identical to the host path's.
    # This makes the uncapped INITIAL solve fusable too (no standalone
    # solve program to compile and load): the first solve of a run
    # (global count 0) uses the flow_cap_init budget (cfg.flow_max_iters),
    # re-solves keep flow_cap (the host path's flow_max_iters_resolve cap,
    # one segment).
    _SEG = FLOW_SEGMENT_ITERS
    cap_init = flow_cap if flow_cap_init is None else flow_cap_init

    def cycle_start(c):
        def with_flow(c):
            st = c["state"]
            fresh = c["f_it"] == 0
            it0 = jnp.where(fresh, jnp.asarray(1, jnp.int32), c["f_it"])
            eps_c = jnp.where(fresh, jnp.asarray(1.0, kit.jdtype),
                              c["f_eps"])
            dt0 = jnp.where(fresh, ops.compute_dt_ns(st, kit), c["f_dt"])
            is_initial = (flow_solves0 + c["flow_solves"]) == 0
            cap_total = jnp.where(is_initial, cap_init, flow_cap)
            seg_end = jnp.minimum(it0 + (_SEG - 1), cap_total)
            carry = (st, it0, eps_c, dt0,
                     jnp.asarray(False), jnp.asarray(False))
            st2, it, eps, dt2, conv, div = _solve_steady_segment(
                carry, seg_end, kit)
            dflow = it - it0
            done = conv | div | (it > cap_total)

            def finish(_):
                stf = ops.update_fictitious(st2, kit)  # coupling.cpp:139
                vol_loss = volume_loss_fraction(stf, kit)
                new_op = ops.assemble(stf, kit, vol_loss)
                flow_solves = c["flow_solves"] + 1
                # host path writes flow VTI when (count - 1) % stride == 0
                # after incrementing; assemble doesn't touch state, so
                # exiting after it hands the host the identical post-solve
                # snapshot state
                gcount = flow_solves0 + flow_solves
                exit_flow = ((gcount - 1) % flow_stride) == 0
                return {
                    **c, "state": stf, "op": new_op,
                    "phase": jnp.asarray(_PH_INNER, jnp.int32),
                    "inner_k": jnp.asarray(0, jnp.int32),
                    "need_flow": jnp.asarray(False),
                    "flow_iters": c["flow_iters"] + dflow,
                    "flow_solves": flow_solves,
                    "eps_last": eps.astype(kit.jdtype),
                    "diverged": c["diverged"] | div,
                    "exit_flow": exit_flow,
                    "f_it": jnp.asarray(0, jnp.int32),
                    "f_eps": eps.astype(kit.jdtype), "f_dt": dt2,
                }

            def keep_going(_):
                # segment done, solve not converged: stay in CYCLE_START;
                # the outer cond exits the launch when the flow budget is
                # spent and the host re-enters with the carried f_*
                return {
                    **c, "state": st2,
                    "flow_iters": c["flow_iters"] + dflow,
                    "f_it": it, "f_eps": eps.astype(kit.jdtype),
                    "f_dt": dt2,
                }

            return jax.lax.cond(done, finish, keep_going, None)

        def without_flow(c):
            vol_loss = volume_loss_fraction(c["state"], kit)
            new_op = ops.assemble(c["state"], kit, vol_loss)
            return {
                **c, "op": new_op,
                "phase": jnp.asarray(_PH_INNER, jnp.int32),
                "inner_k": jnp.asarray(0, jnp.int32),
                "need_flow": jnp.asarray(False),
            }

        return jax.lax.cond(c["need_flow"], with_flow, without_flow, c)

    def _one_inner(c):
        C_pre = c["state"].C
        state, dt, n_below, res, diag = _implicit_inner_core(
            c["state"], c["op"], kit, c.get("C_prev"))
        t = c["t"] + dt.astype(f64)
        steps = c["steps"] + 1
        inner_k = c["inner_k"] + 1
        dissolved = n_below >= batch
        max_res = jnp.maximum(c["max_res"], res.astype(f64))
        gstep = total_steps0 + steps
        write = (gstep % diag_every) == 0
        row = jnp.stack([t] + [diag[i].astype(f64) for i in range(4)])
        rows = jax.lax.cond(write, lambda r: r.at[c["n_rows"]].set(row),
                            lambda r: r, c["rows"])
        inner_done = dissolved | (inner_k >= max_inner) | (t >= T_final)
        extra = {"C_prev": C_pre} if "C_prev" in c else {}
        return {
            **c, **extra, "state": state, "t": t, "steps": steps,
            "inner_k": inner_k, "rows": rows,
            "n_rows": c["n_rows"] + write.astype(jnp.int32),
            "max_res": max_res,
            "phase": jnp.where(inner_done, _PH_PHASE_CHANGE, _PH_INNER)
            .astype(jnp.int32),
            "exit_output": (gstep % output_every) == 0,
        }

    def inner_step(c):
        """The whole inner-step window in ONE switch dispatch: a nested
        while_loop over _one_inner that exits at EXACTLY the conditions
        the outer cond would stop a per-step dispatch at (phase leaves
        _PH_INNER, the step budget is exhausted, or a step lands on the
        VTI output cadence). With per-step switch dispatch XLA copies the
        big carried buffers (op, state) across the 3-way switch every
        micro-op; the nested pure while_loop passes them through without
        copies, so the tax is paid once per window instead of per step."""
        def w_cond(s):
            return ((s["phase"] == _PH_INNER) & (s["steps"] < step_cap)
                    & ~s["exit_output"])
        return jax.lax.while_loop(w_cond, _one_inner, c)

    def phase_change(c):
        state, n_dissolved = ops.apply_phase_change(c["state"], kit)
        return {
            **c, "state": state,
            "phase": jnp.asarray(_PH_CYCLE_START, jnp.int32),
            "cycles": c["cycles"] + 1,
            "dissolved": c["dissolved"] + n_dissolved.astype(jnp.int32),
            "need_flow": n_dissolved > 0,
            "any_solid": jnp.any(state.node_type == SOLID_MG),
        }

    def cond(c):
        # a pending mid-cycle phase (op carried) must be allowed to finish
        # even past T_final — the reference applies phase change after the
        # inner loop unconditionally (coupling.cpp:256)
        # cycle_cap (dynamic, <= max_cycles) forces a CYCLE-BOUNDARY exit
        # when the host has a checkpoint due: with output-boundary exits
        # every implicit_output_every steps, launches otherwise almost
        # never end with phase == CYCLE_START, and the fused branch's
        # cycle-boundary-only checkpoints would never fire (observed: 13
        # cycles, checkpoint_every=4, zero checkpoints written before a
        # device hang cost the whole run)
        more = ((c["cycles"] < jnp.minimum(max_cycles, cycle_cap))
                & c["any_solid"] & ~c["diverged"]
                & ((c["t"] < T_final) | (c["phase"] != _PH_CYCLE_START)))
        budget = (c["steps"] < step_cap) & (c["flow_iters"] < flow_iter_cap)
        return more & budget & ~c["exit_output"] & ~c["exit_flow"]

    def body(c):
        c = dict(c, exit_output=jnp.asarray(False), exit_flow=jnp.asarray(False))
        return jax.lax.switch(c["phase"],
                              [cycle_start, inner_step, phase_change], c)

    init = {
        "state": state, "op": op, "t": jnp.asarray(t0, f64),
        "phase": jnp.asarray(phase0, jnp.int32),
        "inner_k": jnp.asarray(inner_k0, jnp.int32),
        "steps": jnp.asarray(0, jnp.int32),
        "rows": rows0, "n_rows": jnp.asarray(0, jnp.int32),
        "need_flow": jnp.asarray(need_flow0),
        "cycles": jnp.asarray(0, jnp.int32),
        "dissolved": jnp.asarray(0, jnp.int32),
        "flow_iters": jnp.asarray(0, jnp.int32),
        "flow_solves": jnp.asarray(0, jnp.int32),
        "eps_last": eps0,
        "diverged": jnp.asarray(False),
        "max_res": jnp.asarray(0.0, f64),
        "any_solid": jnp.asarray(True),
        "exit_output": jnp.asarray(False),
        "exit_flow": jnp.asarray(False),
        # in-progress segmented flow solve (0 = none), resumable across
        # launches like (phase, inner_k)
        "f_it": jnp.asarray(f_it0, jnp.int32),
        "f_eps": jnp.asarray(f_eps0, kit.jdtype),
        "f_dt": jnp.asarray(f_dt0, kit.jdtype),
    }
    if kit.cfg.implicit_extrapolate_x0:
        # Krylov-saving GMRES start (see _implicit_inner_core). Seeded
        # with the entry C: the first step of each launch extrapolates
        # from itself (a no-op guess) — at 200-step launches the loss is
        # negligible and the carry needs no resume plumbing.
        init["C_prev"] = state.C
    return jax.lax.while_loop(cond, body, init)


@partial(jax.jit, static_argnames=("n_steps",))
def explicit_chunk(state: State, kit, dt, vol_loss, n_steps: int):
    """n explicit corrosion steps fused on device (coupling.cpp:232-252)."""
    ops = ops_for(kit)

    def body(s, _):
        s = ops.apply_inlet_bc(s, kit)
        s = ops.apply_outlet_bc(s, kit)
        s = ops.apply_wall_concentration_bc(s, kit)
        s = ops.ard_step(s, kit, dt, vol_loss)
        return s, None

    state, _ = jax.lax.scan(body, state, length=n_steps)
    return state


# ---------------------------------------------------------------------------
# Orchestrator
# ---------------------------------------------------------------------------

class CoupledSolver:
    def __init__(self):
        self.writer = VTKWriter()
        self.flow_writer = VTKWriter()
        self.frame_count = 0
        self.total_implicit_steps = 0
        self.total_dissolved = 0
        self.dissolved_since_flow = 0
        self.flow_solve_count = 0
        self._prof = False
        self.phase_s = {}

    # ------------------------------------------------------------------
    def _filename(self, cfg, prefix, time_s):
        ext = ".vtu" if cfg.use_amr else ".vti"
        return f"{cfg.output_dir}/{prefix}_{self.frame_count:06d}_t{time_s:.1f}s{ext}"

    def _write_state(self, cfg, grid, state, prefix, t, pvd_writer):
        t_ph = time.time()
        fname = self._filename(cfg, prefix, t)
        if cfg.use_amr:
            self.writer.write_vtu(fname, grid, state, cfg)
        else:
            self.writer.write(fname, grid, state, cfg)
        pvd_writer.add_timestep(t, fname)
        self.frame_count += 1
        self._phase("io_vtk", t_ph)

    def _init_csv(self, cfg):
        with open(f"{cfg.output_dir}/diagnostics.csv", "w") as f:
            f.write("time_s,time_h,pin_mass_loss_pct,solid_nodes,v_max,C_max_fluid\n")
        with open(f"{cfg.output_dir}/mass_loss.csv", "w") as f:
            f.write("time_h,pin_mass_loss_pct\n")

    def _resume_csv(self, cfg, t_corr):
        """On resume, PRESERVE the existing CSV history: keep every row at
        or before the checkpoint time and drop rows written after it
        (outputs from the killed run past the checkpoint), so appending
        continues a monotone, gap-free curve. A missing file just gets its
        header. (Round-2 VERDICT weak #1: the unconditional _init_csv here
        truncated the flagship run's history on every resume.)"""
        specs = [("diagnostics.csv",
                  "time_s,time_h,pin_mass_loss_pct,solid_nodes,v_max,C_max_fluid\n",
                  1.0),
                 ("mass_loss.csv", "time_h,pin_mass_loss_pct\n", 3600.0)]
        for name, header, t_div in specs:
            path = f"{cfg.output_dir}/{name}"
            kept = []
            if os.path.exists(path):
                with open(path) as f:
                    rows = f.readlines()[1:]
                for row in rows:
                    try:
                        t_row = float(row.split(",", 1)[0]) * t_div
                    except ValueError:
                        continue
                    if t_row <= t_corr + 1e-6:
                        kept.append(row)
            with open(path, "w") as f:
                f.write(header)
                f.writelines(kept)
            if kept:
                print(f"  Resume: kept {len(kept)} {name} rows up to "
                      f"t={t_corr:.1f} s")

    def _write_diagnostics(self, cfg, t, diag):
        loss, solid, v_max, C_max = (float(diag[0]), int(diag[1]),
                                     float(diag[2]), float(diag[3]))
        print(f"  t={t:.1f} s ({t / 3600.0:.2f} h)  pin_mass_loss={loss:.2f}%  "
              f"solid={solid}  v_max={v_max:.3e}  C_max_fluid={C_max:.4f}")
        with open(f"{cfg.output_dir}/diagnostics.csv", "a") as f:
            f.write(f"{t:.6e},{t / 3600.0:.6e},{loss:.6e},{solid},"
                    f"{v_max:.6e},{C_max:.6e}\n")
        with open(f"{cfg.output_dir}/mass_loss.csv", "a") as f:
            f.write(f"{t / 3600.0:.6f},{loss:.6f}\n")

    # ------------------------------------------------------------------
    # ------------------------------------------------------------------
    def _phase(self, name, t0, fence=None):
        """Cumulative per-phase wall-clock (PD_PHASE_TIMERS=1).

        ``fence`` waits for that pytree's device work first, so the
        elapsed time attributes to this phase, not the next one. Off by
        default: the fences are extra syncs production runs shouldn't
        pay.
        """
        if not self._prof:
            return
        if fence is not None:
            jax.block_until_ready(fence)
        self.phase_s[name] = self.phase_s.get(name, 0.0) + (time.time() - t0)

    def _report_phases(self, total):
        if not self._prof or not self.phase_s:
            return
        print("  [Timer] phase breakdown:")
        acc = 0.0
        for name, s in sorted(self.phase_s.items(), key=lambda kv: -kv[1]):
            print(f"    {name:16s} {s:9.2f} s  ({100.0 * s / total:5.1f} %)")
            acc += s
        print(f"    {'(untimed)':16s} {total - acc:9.2f} s  "
              f"({100.0 * (total - acc) / total:5.1f} %)")

    def run(self, grid, state: State, kit, cfg) -> State:
        ops = ops_for(kit)
        t_start = time.time()
        self._prof = bool(os.environ.get("PD_PHASE_TIMERS"))
        self.phase_s = {}
        os.makedirs(cfg.output_dir, exist_ok=True)
        self.writer.set_pvd_path(f"{cfg.output_dir}/simulation.pvd")
        self.flow_writer.set_pvd_path(f"{cfg.output_dir}/flow.pvd")

        t_corr = 0.0
        cycle = 0
        ckpt_cycle = 0  # cycle count at the last fused-branch checkpoint

        # checkpoint/resume (new capability)
        from .checkpoint import (cfg_items_json, fingerprint,
                                 grid_fingerprint, load_checkpoint,
                                 save_checkpoint)
        fp = fingerprint(cfg, grid)
        fp_grid = grid_fingerprint(grid)
        cfg_json = cfg_items_json(cfg)
        if cfg.resume_from:
            # PD_RESUME_FORCE (fingerprint-schema migrations) downgrades
            # a cfg-hash mismatch to a warning + key diff; the grid portion
            # of the fingerprint is still verified (load_checkpoint).
            force = bool(os.environ.get("PD_RESUME_FORCE"))
            state, t_corr, meta = load_checkpoint(
                cfg.resume_from, state, fp, force=force, fp_grid=fp_grid,
                cfg_json=cfg_json)
            self.total_implicit_steps = meta.get("total_implicit_steps", 0)
            self.total_dissolved = meta.get("total_dissolved", 0)
            cycle = meta.get("cycle", 0)
            ckpt_cycle = cycle
            # continue (not restart) the CSV curves and PVD collections
            self._resume_csv(cfg, t_corr)
            n_sim = self.writer.load_pvd(f"{cfg.output_dir}/simulation.pvd",
                                         t_max=t_corr)
            n_flow = self.flow_writer.load_pvd(f"{cfg.output_dir}/flow.pvd",
                                               t_max=t_corr)
            # pre-frame_count checkpoints: every snapshot added exactly one
            # entry to one of the two collections, so their combined count
            # is the next collision-free frame number
            self.frame_count = meta.get("frame_count", n_sim + n_flow)
            self.flow_solve_count = meta.get("flow_solve_count", n_flow)
            print(f"Resumed from {cfg.resume_from} at t={t_corr:.1f} s "
                  f"(frame {self.frame_count}, {n_sim}+{n_flow} PVD entries)")
        else:
            self._init_csv(cfg)

        n_init_solid = int(np.asarray(kit.initial_solid_mask).sum())
        print(f"Initial solid nodes: {n_init_solid}")
        if cfg.use_implicit:
            print(f"Using IMPLICIT ARD solver (dt_max={cfg.implicit_dt_max:.1f} s, "
                  f"fraction={cfg.implicit_dt_fraction:.2f})")
        else:
            print("Using EXPLICIT ARD solver")

        self._write_state(cfg, grid, state, "state", t_corr, self.writer)

        need_flow_solve = True
        self.dissolved_since_flow = 0

        # Fused dissolve-and-continue mode (coupled_fused_cycles > 0): after
        # the host-driven first cycle (uncapped initial flow solve), run
        # whole [flow -> assemble -> step-to-dissolution -> phase-change]
        # cycles on device, coupled_fused_cycles per execution. The round-4
        # micro-op state machine exits at every VTI/flow-snapshot boundary
        # and at exact launch budgets, carrying (op, phase, inner_k) across
        # launches — per-step output no longer disables fusing.
        fused_cycles = (int(cfg.coupled_fused_cycles)
                        if cfg.use_implicit else 0)
        flow_cap_fused = (cfg.flow_max_iters_resolve
                          if cfg.flow_max_iters_resolve > 0
                          else min(cfg.flow_max_iters, 10000))
        fused_step_cap = jnp.asarray(
            cfg.coupled_launch_steps if cfg.coupled_launch_steps > 0
            else 2**30, jnp.int32)
        fused_flow_cap = jnp.asarray(
            cfg.coupled_launch_flow_iters if cfg.coupled_launch_flow_iters > 0
            else 2**30, jnp.int32)
        fused_out_every = jnp.asarray(
            min(max(cfg.implicit_output_every, 1), 2**30), jnp.int32)
        fused_flow_stride = jnp.asarray(
            max(cfg.flow_output_stride, 1), jnp.int32)
        fused_phase = 0   # micro-op resume point (carried across launches)
        fused_inner_k = 0
        fused_op = None   # operator carried across launch boundaries
        fused_f_it = 0    # in-progress segmented flow solve (0 = none)
        fused_f_eps = 0.0
        fused_f_dt = 0.0

        while t_corr < cfg.T_final or fused_phase != 0:
            if fused_cycles > 0:
                if fused_op is None:
                    # cycle 1 runs fused too (round 5): the machine's
                    # segmented flow solve handles the uncapped initial
                    # solve across launches, so the standalone solve and
                    # implicit-chunk programs are never compiled. Warm
                    # start stays host-side.
                    from .dispatch import is_block
                    if (cycle == 0 and cfg.flow_warm_start
                            and self.total_dissolved == 0
                            and (not cfg.use_amr or is_block(kit))):
                        from .solvers import coarse_warm_start
                        state, _ = coarse_warm_start(state, grid, kit, cfg)
                    # carry template for the first launch: a throwaway
                    # assemble (phase 0 rebuilds it on device before use)
                    fused_op = assemble_operator(
                        state, kit, volume_loss_fraction(state, kit))
                    # first-launch marker: the chunk compile at production
                    # sizes is many minutes of otherwise-silent XLA work,
                    # and watchdogs key off log growth
                    print("Launching fused coupled-cycles chunk "
                          "(first launch compiles; may take minutes at "
                          "production sizes)...", flush=True)
                t_ph = time.time()
                # force the launch to end AT the cycle boundary where a
                # checkpoint falls due (cycle-boundary-only saves would
                # otherwise be preempted forever by output/budget exits)
                ckpt_cap = (max(1, cfg.checkpoint_every
                                - (cycle - ckpt_cycle))
                            if cfg.checkpoint_every else 2**30)
                out = coupled_cycles_chunk(
                    state, kit, fused_op, t_corr, self.total_implicit_steps,
                    cfg.T_final, max(cfg.dissolution_batch, 1),
                    max(cfg.diagnostic_every, 1),
                    jnp.asarray(bool(need_flow_solve)),
                    fused_cycles, cfg.corrosion_steps_per_check,
                    flow_cap_fused,
                    phase0=jnp.asarray(fused_phase, jnp.int32),
                    inner_k0=jnp.asarray(fused_inner_k, jnp.int32),
                    step_cap=fused_step_cap, flow_iter_cap=fused_flow_cap,
                    output_every=fused_out_every,
                    flow_stride=fused_flow_stride,
                    flow_solves0=jnp.asarray(self.flow_solve_count,
                                             jnp.int32),
                    cycle_cap=jnp.asarray(ckpt_cap, jnp.int32),
                    flow_cap_init=cfg.flow_max_iters,
                    # explicit dtypes: a python 0 here traces weak-typed,
                    # a device scalar from the previous launch strong-typed
                    # — two avals would compile the machine TWICE
                    f_it0=jnp.asarray(fused_f_it, jnp.int32),
                    f_eps0=jnp.asarray(fused_f_eps, kit.jdtype),
                    f_dt0=jnp.asarray(fused_f_dt, kit.jdtype))
                n_cyc = int(out["cycles"])  # fences the chunk
                if self._prof:
                    # per-launch wall attribution (host-side only): where
                    # the run's dominant phase actually spends its time
                    print(f"  [launch] {time.time() - t_ph:.2f}s: "
                          f"{int(out['steps'])} steps, "
                          f"{int(out['flow_iters'])} flow iters, "
                          f"t={float(out['t']):.1f}s", flush=True)
                self._phase("coupled_chunk", t_ph)
                state = out["state"]
                fused_op = out["op"]
                fused_phase = int(out["phase"])
                fused_inner_k = int(out["inner_k"])
                fused_f_it = out["f_it"]    # device scalars: exact
                fused_f_eps = out["f_eps"]  # round-trip, no host cast
                fused_f_dt = out["f_dt"]
                t_corr = float(out["t"])
                cycle += n_cyc
                k = int(out["steps"])
                self.total_implicit_steps += k
                n_dissolved = int(out["dissolved"])
                self.total_dissolved += n_dissolved
                self.flow_solve_count += int(out["flow_solves"])
                need_flow_solve = bool(out["need_flow"])
                self.dissolved_since_flow = (n_dissolved if need_flow_solve
                                             else 0)
                gmres_tol = 1e-10 if kit.jdtype == jnp.float64 else 1e-6
                if float(out["max_res"]) > 100.0 * gmres_tol:
                    print(f"WARNING: GMRES did not converge in at least one "
                          f"step (max |res|={float(out['max_res']):.2e})")
                if bool(out["diverged"]):
                    print("WARNING: flow solve diverged inside fused chunk")
                for r in np.asarray(out["rows"])[:int(out["n_rows"])]:
                    self._write_diagnostics(cfg, float(r[0]),
                                            (r[1], r[2], r[3], r[4]))
                # host-I/O boundary exits: the state is exactly the one the
                # step-at-a-time loop would snapshot (same frame numbering)
                if bool(out["exit_output"]):
                    self._write_state(cfg, grid, state, "corr", t_corr,
                                      self.writer)
                if bool(out["exit_flow"]):
                    self._write_state(cfg, grid, state, "flow", t_corr,
                                      self.flow_writer)
                print(f"=== Fused chunk: {n_cyc} cycles, {k} implicit steps, "
                      f"{int(out['flow_iters'])} flow iters in "
                      f"{int(out['flow_solves'])} re-solves "
                      f"(last eps={float(out['eps_last']):.2e}), "
                      f"{n_dissolved} dissolved, t={t_corr:.1f} s "
                      f"({t_corr / 3600.0:.2f} h), "
                      f"max GMRES |res|={float(out['max_res']):.2e} ===")

                # one checkpoint per >= checkpoint_every cycles, and only at
                # cycle boundaries (a mid-cycle save would lose the carried
                # op/phase/inner_k on resume; capped launches can return far
                # fewer cycles than fused_cycles — a 1M-node checkpoint per
                # launch would dominate IO)
                if (cfg.checkpoint_every and n_cyc > 0 and fused_phase == 0
                        and int(fused_f_it) == 0
                        and cycle - ckpt_cycle >= cfg.checkpoint_every):
                    ckpt_cycle = cycle
                    t_ph = time.time()
                    # snapshots referenced by this checkpoint must be on
                    # disk before it (async binary VTI writes)
                    self.writer.flush()
                    save_checkpoint(
                        f"{cfg.output_dir}/checkpoint.npz", state, t_corr,
                        {"cycle": cycle,
                         "total_implicit_steps": self.total_implicit_steps,
                         "total_dissolved": self.total_dissolved,
                         "frame_count": self.frame_count,
                         "flow_solve_count": self.flow_solve_count},
                        fp, fp_grid=fp_grid, cfg_json=cfg_json)
                    self._phase("checkpoint", t_ph)

                if not bool(out["any_solid"]):
                    print(f"\n=== All solid nodes dissolved at "
                          f"t={t_corr:.1f} s ({t_corr / 3600.0:.2f} h) ===")
                    break
                continue

            cycle += 1
            print(f"\n=== Coupling cycle {cycle}, t={t_corr:.1f} s "
                  f"({t_corr / 3600.0:.2f} h) ===")

            # --- Phase 1: steady flow (only when geometry changed) ---
            if need_flow_solve:
                print(f"  Flow re-solve triggered ({self.dissolved_since_flow} "
                      f"nodes dissolved since last flow solve)")
                verbose_flow = bool(os.environ.get("PD_VERBOSE_FLOW"))
                t_ph = time.time()
                is_resolve = cycle > 1 or self.total_dissolved > 0
                cap = (cfg.flow_max_iters_resolve
                       if is_resolve and cfg.flow_max_iters_resolve > 0
                       else None)
                # warm start: uniform grids and the block-AMR backend (the
                # interpolation only needs grid.pos; the gather backend's
                # per-node tables are not worth the extra path)
                from .dispatch import is_block
                if (not is_resolve and cfg.flow_warm_start
                        and (not cfg.use_amr or is_block(kit))):
                    from .solvers import coarse_warm_start
                    state, _ = coarse_warm_start(state, grid, kit, cfg)
                state, iters, eps, conv, div = solve_steady(
                    state, kit, verbose=verbose_flow, max_iters=cap)
                state = ops.update_fictitious(state, kit)  # coupling.cpp:139
                state.rho.block_until_ready()
                print(f"  Flow: {int(iters)} iters, eps={float(eps):.3e}, "
                      f"converged={bool(conv)}, diverged={bool(div)}")
                # in-path Poiseuille validation (pd_ns.cpp:341-368)
                if cfg.dim == 2 and not cfg.use_amr and not bool(div):
                    from .solvers import poiseuille_l2_error
                    err = poiseuille_l2_error(state, grid, cfg)
                    if np.isfinite(err):
                        print(f"  Poiseuille validation (upstream): "
                              f"L2 rel error = {err:.3e}")
                self._phase("flow_solve", t_ph)
                self.dissolved_since_flow = 0
                need_flow_solve = False
                self.flow_solve_count += 1
                if (self.flow_solve_count - 1) % max(cfg.flow_output_stride, 1) == 0:
                    self._write_state(cfg, grid, state, "flow", t_corr,
                                      self.flow_writer)
            else:
                print("  Skipping flow solve (no dissolution since last flow solve)")

            # --- Phase 2: corrosion with frozen velocity ---
            if cfg.use_implicit:
                t_ph = time.time()
                vol_loss = volume_loss_fraction(state, kit)
                op = assemble_operator(state, kit, vol_loss)
                self._phase("assemble", t_ph, fence=op)  # op is a pytree

                implicit_step_n = 0
                t_cycle_start = t_corr
                dissolution_occurred = False
                cycle_max_res = 0.0

                gmres_tol = 1e-10 if kit.jdtype == jnp.float64 else 1e-6
                # Fused device loop: one launch per run of steps instead of
                # one host round-trip per step. VTI cadence is preserved:
                # the device loop exits exactly at output boundaries so the
                # host writes the same snapshots at the same global steps
                # the step-at-a-time loop would.
                fused = bool(cfg.implicit_fused_chunk)
                out_every = jnp.asarray(
                    min(max(cfg.implicit_output_every, 1), 2**30), jnp.int32)
                # implicit_fused_chunk > 1 sets the per-launch step cap;
                # =1 uses a default of 50 steps per launch
                launch_cap = jnp.asarray(
                    cfg.implicit_fused_chunk if cfg.implicit_fused_chunk > 1
                    else 50, jnp.int32)
                while (fused
                       and implicit_step_n < cfg.corrosion_steps_per_check
                       and t_corr < cfg.T_final and not dissolution_occurred):
                    t_ph = time.time()
                    (state, t_dev, k, dissolved, max_res, rows,
                     n_rows) = implicit_inner_chunk(
                        state, op, kit, t_corr, self.total_implicit_steps,
                        cfg.T_final, max(cfg.dissolution_batch, 1),
                        max(cfg.diagnostic_every, 1),
                        cfg.corrosion_steps_per_check,
                        output_every=out_every,
                        k0=jnp.asarray(implicit_step_n, jnp.int32),
                        launch_cap=launch_cap)
                    k = int(k)  # fences the chunk execution
                    self._phase("implicit_chunk", t_ph)
                    t_corr = float(t_dev)
                    implicit_step_n += k
                    self.total_implicit_steps += k
                    dissolution_occurred = bool(dissolved)
                    cycle_max_res = max(cycle_max_res, float(max_res))
                    if float(max_res) > 100.0 * gmres_tol:
                        # failure-detection telemetry, aggregated per chunk
                        print(f"WARNING: GMRES did not converge in at least "
                              f"one step (max |res|={float(max_res):.2e})")
                    for r in np.asarray(rows)[:int(n_rows)]:
                        self._write_diagnostics(cfg, float(r[0]),
                                                (r[1], r[2], r[3], r[4]))
                    if (k > 0 and self.total_implicit_steps
                            % cfg.implicit_output_every == 0):
                        self._write_state(cfg, grid, state, "corr", t_corr,
                                          self.writer)
                t_ph = time.time()
                while (not fused
                       and implicit_step_n < cfg.corrosion_steps_per_check
                       and t_corr < cfg.T_final and not dissolution_occurred):
                    state, dt, n_below, res, diag = implicit_inner_step(
                        state, op, kit)
                    cycle_max_res = max(cycle_max_res, float(res))
                    if float(res) > 100.0 * gmres_tol:
                        # failure-detection telemetry (pd_ard_implicit.cpp:411-414)
                        print(f"WARNING: GMRES did not converge "
                              f"(|res|={float(res):.2e})")
                    t_corr += float(dt)
                    implicit_step_n += 1
                    self.total_implicit_steps += 1

                    if self.total_implicit_steps % cfg.diagnostic_every == 0:
                        self._write_diagnostics(cfg, t_corr, diag)
                    if self.total_implicit_steps % cfg.implicit_output_every == 0:
                        self._write_state(cfg, grid, state, "corr", t_corr,
                                          self.writer)
                    # reference: exit at the first dissolution event
                    # (coupling.cpp:207-212); dissolution_batch > 1 defers
                    # the exit until enough nodes are below threshold
                    dissolution_occurred = int(n_below) >= max(
                        cfg.dissolution_batch, 1)

                if not fused:
                    self._phase("implicit_steps", t_ph)
                print(f"  Implicit cycle: {implicit_step_n} steps, "
                      f"t={t_cycle_start:.2f} to {t_corr:.2f} s "
                      f"({t_corr / 3600.0:.4f} h), "
                      f"max GMRES |res|={cycle_max_res:.2e}")
            else:
                vol_loss = volume_loss_fraction(state, kit)
                dt_corr = float(ops.ard_compute_dt(state, kit))
                print(f"  Corrosion dt = {dt_corr:.4e} s")

                # cap single device executions (see solvers.FLOW_SEGMENT_ITERS)
                SEG = 20000
                step = 0
                while step < cfg.corrosion_steps_per_check and t_corr < cfg.T_final:
                    n_chunk = min(cfg.output_every_corr,
                                  cfg.corrosion_steps_per_check - step)
                    # respect T_final within the chunk
                    n_fit = int(max(1, min(n_chunk,
                                           np.ceil((cfg.T_final - t_corr) / dt_corr))))
                    done_in_fit = 0
                    while done_in_fit < n_fit:
                        n_sub = min(SEG, n_fit - done_in_fit)
                        state = explicit_chunk(state, kit, dt_corr, vol_loss, n_sub)
                        done_in_fit += n_sub
                    t_corr += dt_corr * n_fit
                    step += n_fit
                    # full chunks follow the reference's output cadence
                    # (coupling.cpp:242-249); a final chunk truncated by
                    # T_final still gets its diagnostics row so the run's
                    # endpoint is always logged
                    if n_fit == n_chunk or t_corr >= cfg.T_final:
                        self._write_state(cfg, grid, state, "corr", t_corr,
                                          self.writer)
                        self._write_diagnostics(cfg, t_corr,
                                                diagnostics(state, kit))

            # --- Phase 3: phase change (device remask, no rebuild) ---
            t_ph = time.time()
            state, n_dissolved = ops.apply_phase_change(state, kit)
            n_dissolved = int(n_dissolved)  # fences
            self._phase("phase_change", t_ph)
            self.total_dissolved += n_dissolved
            self.dissolved_since_flow += n_dissolved
            if n_dissolved > 0:
                print(f"  Phase change: {n_dissolved} nodes dissolved "
                      f"(total: {self.total_dissolved}, since flow: "
                      f"{self.dissolved_since_flow})")
                need_flow_solve = True
            else:
                print("  No phase changes this cycle")

            t_ph = time.time()
            if cfg.checkpoint_every and cycle % cfg.checkpoint_every == 0:
                ckpt_cycle = cycle  # keep the fused-branch gate in sync
                self.writer.flush()  # async VTI writes land before the save
                save_checkpoint(f"{cfg.output_dir}/checkpoint.npz", state, t_corr,
                                {"cycle": cycle,
                                 "total_implicit_steps": self.total_implicit_steps,
                                 "total_dissolved": self.total_dissolved,
                                 "frame_count": self.frame_count,
                                 "flow_solve_count": self.flow_solve_count},
                                fp, fp_grid=fp_grid, cfg_json=cfg_json)
            self._phase("checkpoint", t_ph)

            solid_remaining = int(jnp.sum(
                (state.node_type == SOLID_MG).astype(jnp.int32)))
            if solid_remaining == 0:
                print(f"\n=== All solid nodes dissolved at t={t_corr:.1f} s "
                      f"({t_corr / 3600.0:.2f} h) ===")
                break

        self._write_state(cfg, grid, state, "final", t_corr, self.writer)
        t_ph = time.time()
        self.writer.flush()  # join the last async VTI write before exit
        self._phase("io_vtk", t_ph)
        print(f"\n=== Simulation complete ===")
        print(f"  Final time: {t_corr:.1f} s ({t_corr / 3600.0:.2f} h)")
        total = time.time() - t_start
        print(f"  [Timer] total_simulation: {total:.3f} s")
        self._report_phases(total)
        return state
