"""CLI entry point — mirrors the reference binary (src/main.cpp:129-177):

    python -m pd_mg_pin_corrosion_tpu [params.cfg] [key=value ...]

Loads the config (default config/params.cfg), builds grid + grains + state,
and runs the coupled solver. Trailing ``key=value`` arguments override
config keys — run-specific settings like ``resume_from=.../checkpoint.npz``
belong here, not inside workload configs (which must run from a clean
checkout).
"""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv

    print("=== Peridynamic Mg-Pin Corrosion Simulation (JAX) ===")

    from .config import Config
    cfg_path = "config/params.cfg"
    overrides = []
    for a in argv:
        if "=" in a:
            overrides.append(a)
        else:
            cfg_path = a
    cfg = Config.load(cfg_path)
    if overrides:
        cfg.apply_overrides(overrides)
    print(f"  Dimension: {cfg.dim}D\n")
    cfg.print()

    t0 = time.time()

    import os

    import jax
    # x64 is always enabled: f64 arrays are needed for the GMRES
    # mixed-precision iterative refinement even in f32 production mode
    # (ops/ard_implicit.implicit_step); all state/kit arrays remain in
    # cfg.precision — enabling x64 only makes f64 *available*.
    jax.config.update("jax_enable_x64", True)

    # persistent compilation cache: the big solve graphs (steady-flow
    # while_loop, GMRES) take minutes to compile; cache them across runs
    from .utils import setup_compile_cache
    setup_compile_cache()

    # profiling hook (tracing subsystem): PD_PROFILE=<dir> captures a
    # jax.profiler trace of the whole run for xprof/tensorboard
    profile_dir = os.environ.get("PD_PROFILE", "")
    if profile_dir:
        jax.profiler.start_trace(profile_dir)
        import atexit
        atexit.register(jax.profiler.stop_trace)

    print("Building grid...")
    if cfg.use_amr and cfg.amr_backend == "structured":
        from .amr_blocks import build_amr_block_grid
        grid = build_amr_block_grid(cfg)
    elif cfg.use_amr:
        from .amr import build_amr_grid
        grid = build_amr_grid(cfg)
    else:
        from .grid import build_grid
        grid = build_grid(cfg)
        counts = grid.type_counts()
        print(f"Grid: Nx={grid.Nx} Ny={grid.Ny} Nz={grid.Nz}  N_total={grid.N_total}")
        print("Node types: " + " ".join(f"{k}={v}" for k, v in counts.items()))

    print("Generating grain structure...")
    if cfg.use_amr and cfg.amr_backend == "structured":
        from .amr_blocks import generate_grains_b
        grains = generate_grains_b(grid, cfg)
    else:
        from . import grains as grains_mod
        grains = grains_mod.generate(grid, cfg)

    print("Initializing fields...")
    from .fields import initialize_state

    if cfg.use_amr and cfg.amr_backend == "structured":
        from .amr_blocks import build_bkit
        kit = build_bkit(grid, cfg)
    elif cfg.use_amr:
        from .unstructured import build_ukit
        kit = build_ukit(grid, cfg)
    else:
        from .kit import build_kit
        kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, grains=grains, dtype=kit.jdtype)

    print(f"  [Timer] initialization: {time.time() - t0:.3f} s")

    from .coupling import CoupledSolver
    solver = CoupledSolver()
    solver.run(grid, state, kit, cfg)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
