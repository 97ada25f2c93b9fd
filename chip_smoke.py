"""Smoke test of the corrosion simulator on one NVIDIA GPU.

    python chip_smoke.py [--seed N]   # phases 0-3 on one card
    python chip_smoke.py --multi-gpu  # only the sharded dry run: 4 cards vs 1

Phase 0  requires a GPU (exits nonzero on any other platform) and prints
         the card's name and power limit.
Phase 1  compiles each Triton kernel at the config/params_3d.cfg geometry
         (1.06M nodes, 178 stencil slots), prints its memory analysis,
         compares it once with the XLA path and times both in turns.
Phase 2  runs tests/golden/parity.cfg in f64 through the CLI and compares
         diagnostics.csv with the reference binary's.
Phase 3  runs config/params_3d.cfg and config/params_implicit_test.cfg
         through the CLI in a short window (full geometry and physics),
         checks the diagnostics and the GMRES residual, and times a flow
         iteration and an implicit step with and without the kernels.

Every phase fails the script. The last line of standard output is one JSON
object naming the device; everything else goes on earlier lines.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import replace
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# f32 reorder tolerances of the kernels against the XLA path: both sum the
# same terms in stencil order, but FMA contraction and the kernel's skipped
# exact-zero terms change the last bits (density ~1e3, so atol is far below
# a unit in its last place; momentum terms cancel, hence the looser vel rtol)
NS_RHO_TOL = dict(rtol=1e-5, atol=1e-7)
NS_VEL_TOL = dict(rtol=1e-4, atol=1e-8)
MATVEC_TOL = dict(rtol=1e-4, atol=1e-6)


class _Tee(io.TextIOBase):
    """Echo writes to the real stdout and keep a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.out.write(s)
        self.buf.write(s)
        return len(s)

    def flush(self):
        self.out.flush()


def cards() -> list[str]:
    """Name and power limit of each card, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()


def card() -> str:
    """The first card's name and power limit (the card a one-card run
    uses), to print beside every time."""
    return cards()[0]


def turns(fns: dict, rounds: int = 3, reps: int = 5) -> dict:
    """Median ms of each callable, timed in alternating rounds."""
    import jax
    import numpy as np

    for f in fns.values():
        jax.block_until_ready(f())
    ts = {k: [] for k in fns}
    for _ in range(rounds):
        for k, f in fns.items():
            for _ in range(reps):
                t0 = time.perf_counter()
                jax.block_until_ready(f())
                ts[k].append(time.perf_counter() - t0)
    return {k: float(np.median(v)) * 1e3 for k, v in ts.items()}


def compiled(fn, *args):
    """(compiled executable, compile seconds)."""
    import jax

    t0 = time.perf_counter()
    exe = jax.jit(fn).lower(*args).compile()
    return exe, time.perf_counter() - t0


def xla_only():
    """Route every op to its XLA form while a function is traced."""
    from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
    return mock.patch.object(pk, "use_kernels",
                             lambda kit, platform=None: False)


def assert_close(name, got, want, tol):
    import numpy as np

    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want)
    bad = err > tol["atol"] + tol["rtol"] * np.abs(want)
    print(f"  {name}: max|diff| {err.max():.3e}, "
          f"max|ref| {np.abs(want).max():.3e}, outside rtol={tol['rtol']:g} "
          f"atol={tol['atol']:g}: {int(bad.sum())}")
    if bad.any() or not np.isfinite(got).all():
        raise AssertionError(f"{name} disagrees with the XLA path")


def flagship(seed: int):
    """params_3d.cfg kit and an f32 state with seeded perturbations."""
    import jax.numpy as jnp
    import numpy as np

    from pd_mg_pin_corrosion_tpu import (Config, build_grid, build_kit,
                                         initialize_state)

    cfg = Config.load(str(ROOT / "config/params_3d.cfg"))
    cfg.precision = "f32"
    cfg.compute_derived()
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=kit.jdtype)
    rng = np.random.default_rng(seed)
    solid = np.asarray(state.node_type) == 1
    state = replace(
        state,
        vel=state.vel + 1e-2 * jnp.asarray(
            rng.normal(size=state.vel.shape), jnp.float32),
        C=jnp.asarray(np.where(solid, 1.0, 0.3 * rng.random(kit.shape)),
                      jnp.float32))
    return kit, state


def phase1(kit, state, seed: int):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
    from pd_mg_pin_corrosion_tpu.ops import ard_implicit as ai
    from pd_mg_pin_corrosion_tpu.ops.ns import compute_dt, ns_step

    print(f"== phase 1: kernels at {kit.shape} ({state.rho.size} nodes, "
          f"S={kit.S}), f32; references at matmul precision 'highest'",
          flush=True)
    dt = compute_dt(state, kit)
    kern, t_k = compiled(lambda s, d: pk.ns_step_triton(s, kit, d), state, dt)
    print(f"ns_bonds_3d: compiled in {t_k:.1f} s; {kern.memory_analysis()}")
    with jax.default_matmul_precision("highest"):
        plain, t_p = compiled(lambda s, d: ns_step(s, kit, d), state, dt)
    print(f"  XLA ns_step: compiled in {t_p:.1f} s")
    out, ref = kern(state, dt), plain(state, dt)
    assert_close("rho", out.rho, ref.rho, NS_RHO_TOL)
    assert_close("vel", out.vel, ref.vel, NS_VEL_TOL)
    ms = turns({"triton": lambda: kern(state, dt),
                "xla": lambda: plain(state, dt)})
    print(f"  NS bond sums: triton {ms['triton']:.3f} ms, "
          f"xla {ms['xla']:.3f} ms [{card()}]", flush=True)

    op = jax.jit(lambda s: ai.assemble(s, kit))(state)
    x = jnp.asarray(np.random.default_rng(seed + 1).random(kit.shape),
                    jnp.float32)
    kern, t_k = compiled(lambda o, v: pk.matvec_triton(o, kit, v), op, x)
    print(f"implicit_matvec_3d: compiled in {t_k:.1f} s; "
          f"{kern.memory_analysis()}")
    with jax.default_matmul_precision("highest"), xla_only():
        plain, t_p = compiled(lambda o, v: ai.matvec_M(o, kit, v), op, x)
    print(f"  XLA matvec_M: compiled in {t_p:.1f} s")
    assert_close("y = M x", kern(op, x), plain(op, x), MATVEC_TOL)
    ms = turns({"triton": lambda: kern(op, x), "xla": lambda: plain(op, x)})
    print(f"  matvec: triton {ms['triton']:.3f} ms, xla {ms['xla']:.3f} ms "
          f"[{card()}]", flush=True)


def run_cli(args: list[str]) -> str:
    """cli.main in this process; returns what it printed."""
    from pd_mg_pin_corrosion_tpu import cli

    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        rc = cli.main(args)
    if rc != 0:
        raise RuntimeError(f"cli.main({args}) returned {rc}")
    return tee.buf.getvalue()


def read_csv(path):
    import numpy as np

    return np.atleast_1d(np.genfromtxt(path, delimiter=",", names=True))


def phase2(tmp: Path):
    import numpy as np

    print("== phase 2: tests/golden/parity.cfg in f64 vs the reference binary",
          flush=True)
    out = tmp / "parity"
    run_cli([str(ROOT / "tests/golden/parity.cfg"), "precision=f64",
             "gs_parity=1", "implicit_output_every=1000000000",
             f"output_dir={out}"])
    ref = read_csv(ROOT / "tests/golden/parity_diagnostics_ref.csv")
    ours = read_csv(out / "diagnostics.csv")
    if len(ours) != len(ref):
        raise AssertionError(f"parity: {len(ours)} rows, reference {len(ref)}")
    np.testing.assert_array_equal(ours["solid_nodes"], ref["solid_nodes"])
    for col, rtol in [("time_s", 1e-9), ("pin_mass_loss_pct", 1e-6),
                      ("v_max", 1e-6), ("C_max_fluid", 1e-6)]:
        rel = np.max(np.abs(ours[col] - ref[col])
                     / np.maximum(np.abs(ref[col]), 1e-300))
        print(f"  {col}: max rel diff {rel:.3e} (gate {rtol:g})")
        np.testing.assert_allclose(ours[col], ref[col], rtol=rtol)
    print(f"  parity: {len(ours)} rows match", flush=True)


def check_run(name: str, outdir: Path, log: str, tol: float, min_steps: int):
    """Diagnostics finite, at least min_steps rows, GMRES residual <= tol."""
    import numpy as np

    rows = read_csv(outdir / "diagnostics.csv")
    vals = np.array([list(r) for r in rows], float)
    if len(rows) < min_steps or not np.isfinite(vals).all():
        raise AssertionError(f"{name}: {len(rows)} diagnostics rows, "
                             f"finite={np.isfinite(vals).all()}")
    res = [float(r) for r in re.findall(r"max GMRES \|res\|=(\S+?)(?:,| ===|$)",
                                        log, re.M)]
    if not res or max(res) > tol:
        raise AssertionError(f"{name}: GMRES residuals {res} vs tol {tol:g}")
    if "WARNING" in log:
        raise AssertionError(f"{name}: the run printed a warning")
    print(f"  {name}: {len(rows)} finite diagnostics rows, last "
          f"{dict(zip(rows.dtype.names, rows[-1].tolist()))}, "
          f"max GMRES |res| {max(res):.2e} <= {tol:g}", flush=True)


def time_flow(kit, state, kernels: bool, n: int = 200):
    """(compile s, executable, args) of the production flow segment."""
    import jax
    import jax.numpy as jnp

    from pd_mg_pin_corrosion_tpu import solvers
    from pd_mg_pin_corrosion_tpu.ops.ns import compute_dt

    carry = (state, jnp.asarray(1, jnp.int32), jnp.asarray(1.0, kit.jdtype),
             compute_dt(state, kit), jnp.asarray(False), jnp.asarray(False))
    end = jnp.asarray(n, jnp.int32)
    ctx = contextlib.nullcontext() if kernels else xla_only()
    with ctx:
        seg, t_c = compiled(
            lambda c, e: solvers._solve_steady_segment.__wrapped__(c, e, kit),
            carry, end)
    return t_c, seg, (carry, end)


def phase3(kit, state, tmp: Path):
    import jax
    import jax.numpy as jnp

    from pd_mg_pin_corrosion_tpu.ops import ard_implicit as ai

    print("== phase 3: main path through the CLI", flush=True)
    out = tmp / "flow3d"
    t0 = time.time()
    log = run_cli([str(ROOT / "config/params_3d.cfg"), "flow_max_iters=3000",
                   "T_final=480", f"output_dir={out}"])
    launches = re.findall(r"=== Fused chunk: (\d+) cycles, (\d+) implicit "
                          r"steps, (\d+) flow iters", log)
    cycles, steps, flow_iters = (sum(int(x[i]) for x in launches)
                                 for i in range(3))
    if cycles < 1 or steps < 4 or flow_iters < 1:
        raise AssertionError("params_3d window: no full coupling cycle ran")
    print(f"  params_3d window: {cycles} cycle(s), {steps} implicit steps, "
          f"{flow_iters} flow iterations in {len(launches)} launches, "
          f"{time.time() - t0:.1f} s wall (compilation included)")
    check_run("params_3d", out, log, 1e-6, steps)

    out = tmp / "implicit2d"
    t0 = time.time()
    log = run_cli([str(ROOT / "config/params_implicit_test.cfg"),
                   "flow_max_iters=2000", "T_final=600", f"output_dir={out}"])
    print(f"  params_implicit_test window in {time.time() - t0:.1f} s wall")
    check_run("params_implicit_test", out, log, 1e-6, 4)

    # ms per flow iteration and per implicit step at the flagship geometry,
    # kernels against the XLA path, in turns
    n = 200
    flows = {}
    for kernels, name in [(True, "triton"), (False, "xla")]:
        t_c, seg, args = time_flow(kit, state, kernels, n)
        print(f"  flow segment ({name}): compiled in {t_c:.1f} s")
        flows[name] = (seg, args)
    ms = turns({k: (lambda s=s, a=a: s(*a)) for k, (s, a) in flows.items()},
               rounds=2, reps=2)
    print("  ms per flow iteration: " + ", ".join(
        f"{k} {v / (n - 1):.3f}" for k, v in ms.items()) + f" [{card()}]")

    op = jax.jit(lambda s: ai.assemble(s, kit))(state)
    dt = jnp.asarray(60.0, kit.jdtype)  # the window's adaptive dt (dt_max)
    steps = {}
    for kernels, name in [(True, "triton"), (False, "xla")]:
        ctx = contextlib.nullcontext() if kernels else xla_only()
        with ctx:
            exe, t_c = compiled(lambda s, o, d: ai.implicit_step(s, o, kit, d),
                                state, op, dt)
        new, res = exe(state, op, dt)
        print(f"  implicit step ({name}): compiled in {t_c:.1f} s, "
              f"GMRES |res| {float(res):.2e}")
        if not float(res) <= 1e-6 or not bool(jnp.isfinite(new.C).all()):
            raise AssertionError(f"implicit step ({name}) did not converge")
        steps[name] = exe
    ms = turns({k: (lambda e=e: e(state, op, dt)) for k, e in steps.items()},
               rounds=2, reps=2)
    print("  ms per implicit step (dt 60 s): " + ", ".join(
        f"{k} {v:.3f}" for k, v in ms.items()) + f" [{card()}]", flush=True)


def phase_multi():
    import numpy as np

    import __graft_entry__ as g

    n = 4
    jax = g._ensure_n_devices(n)
    print(f"== multi-gpu: sharded dry run on {n} cards vs the same problem "
          f"on 1", flush=True)
    for dim in (2, 3):
        multi = g._dryrun_dim(jax, n, dim)
        single = g._dryrun_dim(jax, 1, dim, pad_to=n)
        np.testing.assert_array_equal(multi["chunk_counts"],
                                      single["chunk_counts"])
        for key, tol in [("step_rho", dict(rtol=1e-6, atol=0.0)),
                         ("step_vel", dict(rtol=1e-5, atol=1e-9)),
                         ("implicit_C", dict(rtol=0.0, atol=1e-5)),
                         ("chunk_C", dict(rtol=0.0, atol=1e-4))]:
            assert_close(f"{dim}D {key} (4 cards vs 1)", multi[key],
                         single[key], tol)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the 4-card sharded dry run against 1 card")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random perturbations in phase 1")
    args = ap.parse_args(argv)

    try:
        import jax
        import pd_mg_pin_corrosion_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the simulator: {e}", file=sys.stderr)
        return 2
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {dev.platform}",
              file=sys.stderr)
        return 1
    jax.config.update("jax_enable_x64", True)
    from pd_mg_pin_corrosion_tpu.utils import setup_compile_cache
    print(f"== phase 0: {len(jax.devices())} x {dev.device_kind}; "
          f"compile cache {setup_compile_cache()}")
    for c in cards():
        print(f"card: {c}", flush=True)

    t0 = time.time()
    if args.multi_gpu:
        phase_multi()
    else:
        kit, state = flagship(args.seed)
        phase1(kit, state, args.seed)
        with tempfile.TemporaryDirectory() as tmp:
            phase2(Path(tmp))
            phase3(kit, state, Path(tmp))
    print(f"chip_smoke: all phases passed in {time.time() - t0:.1f} s "
          f"[{card()}]")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
