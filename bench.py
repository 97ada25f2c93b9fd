"""Benchmark: PD bond-ops/sec on one device for the hot NS bond kernel,
plus the two production-path times at the flagship (3D 1M-node) geometry.

Prints one JSON line per metric, headline first, each naming the device:
1. pd_bond_ops_per_sec_per_chip — 2D flow cell at ~0.9M nodes.
2. ns3d_flow_iter_ms_1M — one steady-flow iteration (production
   _solve_steady_segment body incl. BCs and check cadence) at the
   params_3d.cfg 1.06M-node geometry.
3. implicit_step_ms_1M — one full implicit transport step (GMRES) at the
   same geometry at the production 3 s adaptive-dt floor.

A "bond-op" is one full PD-NS bond evaluation (mass divergence + delta-SPH
density diffusion + momentum convection/pressure/viscous terms — the
reference's pd_ns.cpp:115-157 inner loop body). The headline benchmark runs
the production ns_step (not a stripped kernel) under lax.fori_loop so
dispatch overhead is excluded, on a 2D grid sized to fill the chip.
"""

import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _device():
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def _emit(metric, value, unit):
    print(json.dumps({"metric": metric, "value": value, "unit": unit,
                      "device": _device()}), flush=True)


def _flagship_setup():
    """params_3d.cfg geometry (the flagship workload-5 grid, ~1.06M nodes)."""
    from pd_mg_pin_corrosion_tpu.config import Config
    from pd_mg_pin_corrosion_tpu.fields import initialize_state
    from pd_mg_pin_corrosion_tpu.grid import build_grid
    from pd_mg_pin_corrosion_tpu.kit import build_kit

    cfg = Config.load("config/params_3d.cfg")
    cfg.precision = "f32"
    cfg.compute_derived()
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=kit.jdtype)
    return grid, kit, state


def bench_ns3d_flow_iter(kit, state):
    """ms per steady-flow iteration: the production solve_steady segment
    (BCs + fused NS kernel + every-100-iters convergence machinery)."""
    from pd_mg_pin_corrosion_tpu.ops.ns import compute_dt
    from pd_mg_pin_corrosion_tpu.solvers import _solve_steady_segment

    dt = compute_dt(state, kit)
    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(1.0, kit.jdtype),
             dt, jnp.asarray(False), jnp.asarray(False))

    @jax.jit
    def seg(c, n):
        return _solve_steady_segment(c, n, kit)

    n_iters = jnp.asarray(200, jnp.int32)
    jax.block_until_ready(seg(carry, n_iters))  # compile + warm
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(seg(carry, n_iters))
        best = min(best, time.perf_counter() - t0)
    return best / 199 * 1e3  # segment runs n-1 iterations


def bench_implicit_step(kit, state):
    """ms per full implicit transport step (assemble once per cycle is NOT
    included — the reference also assembles once and steps many times)."""
    from pd_mg_pin_corrosion_tpu.ops import ard_implicit as ai

    # op is a jit argument: a ~750 MB closure constant would be embedded
    # in the compiled program
    op = jax.block_until_ready(jax.jit(lambda s: ai.assemble(s, kit))(state))

    step = jax.jit(lambda s, o, dt: ai.implicit_step(s, o, kit, dt))
    dt = jnp.asarray(3.0, kit.jdtype)  # production adaptive-dt floor
    jax.block_until_ready(step(state, op, dt))
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        jax.block_until_ready(step(state, op, dt))
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def main():
    from pd_mg_pin_corrosion_tpu.utils import setup_compile_cache
    setup_compile_cache()
    from pd_mg_pin_corrosion_tpu.config import Config
    from pd_mg_pin_corrosion_tpu.fields import initialize_state
    from pd_mg_pin_corrosion_tpu.grid import OUTSIDE, build_grid
    from pd_mg_pin_corrosion_tpu.kit import build_kit
    from pd_mg_pin_corrosion_tpu.ops.ns import compute_dt
    from pd_mg_pin_corrosion_tpu.pallas_kernels import ns_step_auto as ns_step

    # Large 2D flow-cell grid (~0.9M nodes): baseline geometry at dx=1um
    cfg = Config()
    cfg.dx = 1.0e-6
    cfg.R_wire = 40.0e-6
    cfg.L_wire = 400.0e-6
    cfg.R_tube = 150.0e-6
    cfg.L_upstream = 500.0e-6
    cfg.L_downstream = 500.0e-6
    cfg.precision = "f32"
    cfg.compute_derived()

    grid = build_grid(cfg)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=kit.jdtype)

    n_active = int((grid.node_type != OUTSIDE).sum())
    S = grid.stencil.size
    bonds_per_step = n_active * S

    dt = compute_dt(state, kit)

    @jax.jit
    def run(state, dt, n):
        def body(_, s):
            return ns_step(s, kit, dt)
        return jax.lax.fori_loop(0, n, body, state)

    def sync(s):
        return jax.block_until_ready(s.rho)

    # warmup/compile both trip counts
    n_lo, n_hi = 50, 250
    sync(run(state, dt, n_lo))
    sync(run(state, dt, n_hi))

    # two-point measurement cancels the fixed dispatch+transfer overhead
    reps = 3
    t_lo = min_time = None
    best_lo = best_hi = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        sync(run(state, dt, n_lo))
        best_lo = min(best_lo, time.perf_counter() - t0)
        t0 = time.perf_counter()
        sync(run(state, dt, n_hi))
        best_hi = min(best_hi, time.perf_counter() - t0)

    per_step = (best_hi - best_lo) / (n_hi - n_lo)
    _emit("pd_bond_ops_per_sec_per_chip", bonds_per_step / per_step,
          "bond-ops/s")

    # --- flagship-geometry production-path metrics. x64 matches cli.py's
    # production setup (f32 state + f64 refinement); enabled only after the
    # headline metric so its measurement conditions stay the same. A
    # failure here fails the run.
    jax.config.update("jax_enable_x64", True)
    _, kit3, state3 = _flagship_setup()
    _emit("ns3d_flow_iter_ms_1M", bench_ns3d_flow_iter(kit3, state3), "ms")
    _emit("implicit_step_ms_1M", bench_implicit_step(kit3, state3), "ms")


if __name__ == "__main__":
    main()
