"""Simulation configuration.

Byte-compatible parser for the reference ``key = value`` config format
(reference: src/config.cpp:16-96) with the same ~45 keys, defaults
(src/config.h:4-94) and derived quantities (src/config.cpp:98-112).

Extensions over the reference (all optional keys; absent from reference
configs, so parsing those stays byte-identical):

* ``dim``              — spatial dimension (2 or 3). The reference bakes this
                         in at compile time via ``-DPD_DIM``; here it is a
                         runtime switch.
* ``precision``        — "f32" (fast) or "f64" (parity/validation).
* ``checkpoint_every`` — write an orbax/npz checkpoint every N coupling
                         cycles (0 = off). New capability (reference has no
                         checkpoint/resume, see SURVEY §5). Round-3 change:
                         the fused-cycles branch now honors this cadence too
                         (it previously checkpointed after every chunk; at 1M
                         nodes per-launch checkpoints would dominate I/O).
                         Round-4 fix: a dynamic cycle cap forces the launch
                         that reaches the checkpoint-due cycle to END at that
                         cycle boundary, so the cadence actually fires even
                         when output/budget exits would otherwise always
                         preempt the boundary (observed on the 1M flagship:
                         zero checkpoints in 13 cycles before the fix).
* ``resume_from``      — checkpoint directory/file to resume from.
"""

from __future__ import annotations

import dataclasses
import math
import sys
from dataclasses import dataclass, field

PI = math.pi


@dataclass
class Config:
    # Grid
    dx: float = 5.0e-6
    m_ratio: int = 3

    # Geometry [m]
    R_wire: float = 40.0e-6
    L_wire: float = 400.0e-6
    R_tube: float = 150.0e-6
    L_upstream: float = 80.0e-6
    L_downstream: float = 80.0e-6

    # Fluid
    rho_f: float = 1000.0
    mu_f: float = 1.0e-3
    gamma_eos: float = 7.0
    c0: float = 0.5
    eta_density: float = 0.1

    # Flow
    Q_flow: float = 1.667e-8

    # Mg solid
    rho_m: float = 1738.0

    # Transport — bi-material PD diffusion model
    D_liquid: float = 1.0e-9
    D_grain: float = 5.0e-11
    D_gb: float = 5.0e-9
    D_precip: float = 5.0e-15
    precip_fraction: float = 0.05
    C_solid_init: float = 1.0
    C_liquid_init: float = 0.0
    C_thresh: float = 0.2
    C_sat: float = 0.9
    alpha_art_diff: float = 0.1
    corrosion_decay_l: float = 0.0
    # EXTENSION (not in the reference): exposure-driven amplification of the
    # solid micro-diffusivities, 10^(+V_L / corrosion_accel_l) — the
    # accelerating counterpart of the Hermann et al. 2022 Eq. 42 decay.
    # 0 = disabled (default; absent from every reference config, so all
    # reference workloads are unaffected). Motivation: the Reimers et al.
    # 2023 anchors are slightly SUPER-linear in time (22.86 % at 4.23 h,
    # ~50 % at 9 h = 2.19x loss over a 2.13x time span), while a constant-D
    # front on a shrinking cylinder is sub-linear — real Mg corrosion
    # accelerates with exposure (pitting/surface roughening); this folds
    # that into the same effective-diffusivity slot the decay law uses.
    corrosion_accel_l: float = 0.0

    # Grain structure
    grain_size_mean: float = 40.0e-6
    grain_size_std: float = 5.0e-6  # parsed but unused (matches reference)
    gb_width_cells: int = 1
    precip_cluster_cells: int = 0

    # Time stepping
    cfl_factor: float = 0.25
    cfl_factor_corr: float = 0.25

    # Coupling
    flow_max_iters: int = 50000
    flow_conv_tol: float = 5.0e-6
    T_final: float = 32400.0
    corrosion_steps_per_check: int = 200
    output_every_flow: int = 2000
    output_every_corr: int = 100
    output_dir: str = "output"

    # Implicit ARD solver
    use_implicit: int = 1
    implicit_dt_fraction: float = 0.5
    implicit_dt_max: float = 60.0
    implicit_output_every: int = 10
    diagnostic_every: int = 1

    # Legacy Newton keys (dead in reference too; kept for .cfg compatibility,
    # see src/config.h:79-80 and SURVEY "What NOT to carry over")
    newton_tol: float = 1.0e-8
    newton_max_iter: int = 20

    # Channel flow corrections (Poiseuille validation only)
    channel_flow_corrections: int = 0

    # AMR
    use_amr: int = 0
    amr_ratio: int = 3
    amr_buffer: float = 50.0e-6
    # AMR device backend: "structured" (two dense blocks + IDW exchange;
    # stencil-shift speed) or "gather" (round-2
    # fixed-degree padded neighbor arrays; kept for cross-validation)
    amr_backend: str = "structured"

    # ---- extensions (not present in reference configs) ----
    dim: int = 2
    precision: str = "f32"
    checkpoint_every: int = 0
    resume_from: str = ""
    # Gauss-Seidel parity mode: reproduce the reference's in-place sequential
    # outlet/smoothing sweeps (src/boundary.cpp:88-131,332-376 under one
    # OpenMP thread) instead of the functional Jacobi form. Needed only for
    # <=1e-6 diagnostics parity runs; off for production (Jacobi shares the
    # same fixed point and vectorizes).
    gs_parity: int = 0
    # Reproduce the reference's (dimensionally inconsistent) 3D PD Laplacian
    # constant beta_lap = 12/(pi*delta^2) (src/pd_ns.cpp:15). The correct
    # moment calibration in 3D is 9/(2*pi*delta^3): the second-moment of the
    # PD kernel sum_j (f_j-f_i)/xi^2 V_j over the horizon ball is
    # (2*pi*delta^3/9) * lap(f). The reference's value under-weights every
    # 3D Laplacian (viscosity, delta-SPH density diffusion, ARD diffusion)
    # by ~1e-4, which is why its own PD_DIM=3 build diverges (axial acoustic
    # mode with effectively zero damping — see docs/PARITY.md). Default is
    # the corrected constant; set 1 only for divergence-parity studies.
    legacy_3d_constants: int = 0
    # Write the post-flow-solve VTI only every Nth flow re-solve (1 =
    # reference behavior, coupling.cpp:139-147). Large 3D runs re-solve
    # flow after every dissolution event; a 1M-node ASCII VTI is ~130MB
    # and minutes of host serialization each.
    flow_output_stride: int = 1
    # Iteration budget for flow RE-solves after dissolution events (0 =
    # use flow_max_iters, the reference behavior). Warm restarts barely
    # change the field; at 1M+ 3D nodes the acoustic-ringing eps floor
    # sits above flow_conv_tol, so uncapped re-solves burn the full
    # flow_max_iters budget every cycle.
    flow_max_iters_resolve: int = 0
    # Coarse-grid warm start for the INITIAL steady flow solve: solve the
    # same problem on a dx*N grid first (8x fewer nodes in 3D, larger CFL
    # dt, ~5 % of the fine solve's cost), trilinearly interpolate
    # (rho, vel) onto the fine lattice, and start the fine solve from
    # there. The convergence gate is UNCHANGED (eps < flow_conv_tol,
    # pd_ns.cpp:273-322 cadence) — the warm start only moves the starting
    # point closer to the fixed point; the wake structure the cold start
    # spends thousands of iterations developing is already present.
    # Value = coarsening ratio (2 typical); 0 = off (reference behavior).
    # Measured on the flagship 1M grid (scripts/measure_warm_start.py):
    # fine-solve iterations 6,500 -> 3,700 (1.76x), converged fields agree
    # to rel-L2 5.9e-3 (both inside the same eps gate). Off by default
    # because the initial solve is only ~4 % of the flagship run's wall
    # (the implicit transport dominates), so the ~45 % iteration saving
    # nets only seconds there — the knob exists for flow-heavy workloads.
    # Also honored by the block-AMR backend (the coarse solve is uniform
    # at dx*ratio either way), where it is transformative: on the
    # params_amr.cfg production geometry the cold initial solve is
    # 104,200 iterations; flow_warm_start=2 replaces it with a cheap
    # 49,800-iter uniform coarse solve + 9,300 fine iterations (11.2x
    # fewer), same 1e-6 gate, fields rel-L2 3.7e-2
    # (scripts/measure_warm_start.py config/params_amr.cfg, 2026-08-21).
    flow_warm_start: int = 0
    # Exit the implicit inner loop when this many solid nodes are below
    # C_thresh (1 = the reference's exit-at-first-dissolution,
    # coupling.cpp:174-213). At 3D scale (30k+ surface nodes) dissolution
    # events are ~1 node apart in time and per-event flow re-solves make
    # the run O(events); batching them is physically benign (the reference
    # itself allows up to corrosion_steps_per_check steps between checks
    # when nothing dissolves).
    dissolution_batch: int = 1
    # Lower clamp of the adaptive implicit dt as a fraction of
    # implicit_dt_max (reference: 0.01, pd_ard_implicit.cpp:486).
    implicit_dt_min_frac: float = 0.01
    # Sub-cell 3D wall mirror: bilinear interpolation of the reflected
    # point instead of the reference's nearest-node (staircase) mirror
    # (boundary.cpp:204-249). The staircase mirror's O(dx) wall error
    # sustains a per-step velocity limit cycle (~6e-4 at 1M nodes) that
    # keeps 3D flow from converging by tolerance; the weighted mirror
    # removes the leading-order error. 0 = reference behavior.
    wall_mirror_subcell: int = 0
    # Fuse the implicit inner loop (adaptive dt -> BCs -> GMRES ->
    # smoothing -> dissolution check) into ONE device-side lax.while_loop
    # per coupling cycle, buffering diagnostics rows on device, instead of
    # one host round-trip per step. Trajectory- and CSV-identical to the
    # step-at-a-time loop (the exit conditions of coupling.cpp:174-213 are
    # evaluated on device); per-step GMRES warnings are aggregated to a
    # per-chunk maximum. VTI cadence is preserved: the device loop exits
    # exactly at implicit_output_every boundaries so the host writes the
    # same snapshots at the same steps. 0 = reference-style host loop.
    implicit_fused_chunk: int = 0
    # Fuse N WHOLE coupling cycles ([flow re-solve] -> assemble -> implicit
    # steps to the dissolution exit -> phase change) into one device
    # execution — the dissolve-and-continue loop. Removes the per-event
    # host round-trip that dominates event-dense runs (AMR production).
    # Round 4: the chunk is a resumable micro-op state machine — it exits
    # at every implicit_output_every VTI boundary and every
    # flow_output_stride flow snapshot (the host writes the identical
    # files the step-at-a-time loop would), carrying the assembled
    # operator and mid-cycle position across launches; per-step output no
    # longer disables fusing. 0 = off.
    coupled_fused_cycles: int = 0
    # Per-execution work budgets for the fused-cycles chunk: they set how
    # often the host regains control (progress output, checkpoint and
    # snapshot boundaries). Budgets are checked between micro-ops, so a
    # launch can split a cycle mid-flight and resume (semantics unchanged
    # — the op is carried). Overshoot is at most ONE micro-op: one
    # implicit step past coupled_launch_steps, or one full flow re-solve
    # (<= flow_max_iters_resolve iterations — a re-solve is a single
    # micro-op) past coupled_launch_flow_iters. 0 = uncapped.
    coupled_launch_steps: int = 0        # implicit steps per execution
    coupled_launch_flow_iters: int = 0   # flow iterations per execution
    # Start each per-step GMRES from the linear extrapolation
    # 2*C_n - C_{n-1} (clamped to [0, C_solid_init]) instead of C_n.
    # Correctness-neutral: the solve is residual-controlled to the same
    # tolerance either way (same scheme as the round-3 solver rework) —
    # the better start just reaches it in fewer Arnoldi steps. At the
    # production 3 s adaptive-dt floor consecutive steps are nearly
    # uniform, where the extrapolation is most effective. 0 = off
    # (reference semantics: Eigen GMRES starts from C_n,
    # pd_ard_implicit.cpp:399-417).
    implicit_extrapolate_x0: int = 0
    # VTI snapshot encoding: 0 = ASCII (byte-compatible with the
    # reference's vtk_writer.cpp), 1 = VTK XML appended-raw binary (~6x
    # smaller, ~50x faster serialization; a 1M-node ASCII VTI is ~130MB
    # and minutes of host formatting). Both load in ParaView and in
    # scripts/vtk_reader.py.
    vtk_binary: int = 0

    # Derived (computed by compute_derived)
    delta: float = field(default=0.0)
    U_in: float = field(default=0.0)
    dx_coarse: float = field(default=0.0)
    delta_coarse: float = field(default=0.0)

    # ------------------------------------------------------------------

    def compute_derived(self) -> "Config":
        """Derived quantities (reference: src/config.cpp:98-112)."""
        self.delta = self.m_ratio * self.dx
        self.dx_coarse = self.amr_ratio * self.dx
        self.delta_coarse = self.m_ratio * self.dx_coarse
        # Inlet velocity from volumetric flow rate through circular tube.
        self.U_in = self.Q_flow / (PI * self.R_tube * self.R_tube)
        # Weakly compressible safeguard: c0 >= 25 * U_in (Ma^2 < 0.002).
        if self.c0 < 25.0 * self.U_in:
            self.c0 = 25.0 * self.U_in
            print(f"NOTE: Increased c0 to {self.c0:.4e} (25x U_in) for stability.")
        return self

    # ------------------------------------------------------------------

    _INT_KEYS = frozenset(
        {
            "m_ratio", "gb_width_cells", "precip_cluster_cells",
            "flow_max_iters", "corrosion_steps_per_check",
            "output_every_flow", "output_every_corr", "use_implicit",
            "implicit_output_every", "diagnostic_every", "newton_max_iter",
            "channel_flow_corrections", "use_amr", "amr_ratio",
            "dim", "checkpoint_every", "gs_parity", "legacy_3d_constants",
            "flow_output_stride", "flow_max_iters_resolve", "flow_warm_start",
            "dissolution_batch", "wall_mirror_subcell", "vtk_binary",
            "implicit_fused_chunk", "coupled_fused_cycles",
            "coupled_launch_steps", "coupled_launch_flow_iters",
            "implicit_extrapolate_x0",
        }
    )
    _STR_KEYS = frozenset({"output_dir", "precision", "resume_from",
                           "amr_backend"})

    @classmethod
    def load(cls, filename: str) -> "Config":
        """Parse a ``key = value`` config file (reference: src/config.cpp:16-96).

        Strips ``#`` comments, trims whitespace, warns on unknown keys, and
        falls back to defaults (with a warning) when the file is missing.
        """
        cfg = cls()
        known = {f.name for f in dataclasses.fields(cls)}
        try:
            fh = open(filename, "r")
        except OSError:
            print(
                f"Warning: Cannot open config file '{filename}', using defaults.",
                file=sys.stderr,
            )
            return cfg.compute_derived()

        with fh:
            for line in fh:
                hash_pos = line.find("#")
                if hash_pos != -1:
                    line = line[:hash_pos]
                line = line.strip()
                if not line:
                    continue
                eq = line.find("=")
                if eq == -1:
                    continue
                key = line[:eq].strip()
                val = line[eq + 1 :].strip()
                if not key or not val:
                    continue
                if key not in known or key in ("delta", "U_in", "dx_coarse", "delta_coarse"):
                    print(f"Warning: Unknown config key '{key}'", file=sys.stderr)
                    continue
                if key in cls._STR_KEYS:
                    setattr(cfg, key, val)
                elif key in cls._INT_KEYS:
                    setattr(cfg, key, int(float(val)))
                else:
                    setattr(cfg, key, float(val))

        return cfg.compute_derived()

    def apply_overrides(self, overrides) -> "Config":
        """Apply ``key=value`` strings (CLI overrides) on top of the loaded
        config, with the same typing rules as the file parser, then
        recompute derived quantities."""
        known = {f.name for f in dataclasses.fields(self)}
        for item in overrides:
            key, _, val = item.partition("=")
            key, val = key.strip(), val.strip()
            if key not in known or key in ("delta", "U_in", "dx_coarse",
                                           "delta_coarse"):
                print(f"Warning: Unknown override key '{key}'",
                      file=sys.stderr)
                continue
            if key in self._STR_KEYS:
                setattr(self, key, val)
            elif key in self._INT_KEYS:
                setattr(self, key, int(float(val)))
            else:
                setattr(self, key, float(val))
            print(f"  Override: {key} = {val}")
        return self.compute_derived()

    # ------------------------------------------------------------------

    def print(self) -> None:
        """Pretty-print the configuration (reference: src/config.cpp:114-139)."""
        c = self
        print("=== Configuration ===")
        print(f"  DIM          = {c.dim}")
        print(f"  dx           = {c.dx:.2e} m")
        print(f"  delta        = {c.delta:.2e} m (m={c.m_ratio})")
        print(f"  R_wire       = {c.R_wire:.2e} m")
        print(f"  L_wire       = {c.L_wire:.2e} m")
        print(f"  R_tube       = {c.R_tube:.2e} m")
        print(f"  U_in         = {c.U_in:.4e} m/s")
        print(f"  rho_f        = {c.rho_f:.1f} kg/m3")
        print(f"  mu_f         = {c.mu_f:.2e} Pa.s")
        print(f"  Re_wire      = {c.rho_f * c.U_in * 2.0 * c.R_wire / c.mu_f:.2f}")
        print(f"  c0           = {c.c0:.2f} m/s (Mach ~ {c.U_in / c.c0:.4f})")
        print(f"  D_liquid     = {c.D_liquid:.2e} m2/s")
        print(f"  D_grain      = {c.D_grain:.2e} m2/s")
        print(f"  D_gb         = {c.D_gb:.2e} m2/s")
        print(f"  D_precip     = {c.D_precip:.2e} m2/s")
        print(f"  precip_frac  = {c.precip_fraction:.3f}")
        print(f"  precip_clust = {c.precip_cluster_cells} cells")
        decay = "" if c.corrosion_decay_l > 0 else " (disabled)"
        print(f"  corr_decay_l = {c.corrosion_decay_l:.3f}{decay}")
        if c.corrosion_accel_l > 0:
            print(f"  corr_accel_l = {c.corrosion_accel_l:.3f} (extension)")
        print(f"  C_sat        = {c.C_sat:.2f}")
        print(f"  T_final      = {c.T_final:.1f} s ({c.T_final / 3600.0:.2f} h)")
        print(f"  output_dir   = {c.output_dir}")
        print("=====================\n")
