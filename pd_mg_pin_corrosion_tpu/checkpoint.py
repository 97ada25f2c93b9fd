"""Checkpoint / resume — a capability the reference lacks entirely
(its only resilience is crash-safe PVD rewriting; SURVEY §5).

State pytree + simulation clock + counters go into a single .npz written
atomically (tmp + rename), so a killed run restarts from the last coupling
cycle instead of t=0.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os

import jax.numpy as jnp
import numpy as np

from .fields import State

# config keys that may legitimately differ between the writing and resuming
# run (IO/cadence settings and the stop time — none affect whether the
# stored state is compatible with the resuming run's physics)
_IO_KEYS = frozenset({
    "output_dir", "resume_from", "checkpoint_every", "implicit_output_every",
    "diagnostic_every", "output_every_flow", "output_every_corr", "T_final",
    # loop-cadence caps: they shape how the run proceeds from here, not
    # whether the stored state is compatible with this grid/physics
    "flow_max_iters", "flow_max_iters_resolve", "flow_output_stride",
    # initial-solve warm start: only moves the starting point of a solve
    # that runs to the same convergence gate; resumed runs never redo the
    # initial solve anyway
    "flow_warm_start",
    "corrosion_steps_per_check", "dissolution_batch",
    "implicit_fused_chunk", "coupled_fused_cycles",
    "coupled_launch_steps", "coupled_launch_flow_iters",
    # snapshot encoding: pure IO, no bearing on state compatibility
    "vtk_binary",
})


def cfg_items_json(cfg) -> str:
    """The physics-relevant config keys as a canonical JSON string
    (IO/cadence keys excluded). Stored alongside the fingerprint so a
    mismatch can be *explained* (key-level diff), not just detected."""
    cfg_items = {
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(cfg) if f.name not in _IO_KEYS
    }
    return json.dumps(cfg_items, sort_keys=True, default=str)


def grid_fingerprint(grid) -> str:
    """Hash of the grid identity alone (shape + node_type bytes)."""
    h = hashlib.sha256()
    h.update(np.int64(grid.node_type.size).tobytes())
    h.update(np.asarray(grid.node_type.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(grid.node_type).tobytes())
    return h.hexdigest()


def fingerprint(cfg, grid) -> str:
    """Hash of the physics config + grid identity. Stored in every
    checkpoint and verified on resume: a state restored onto a different
    grid or parameter set silently produces garbage otherwise."""
    h = hashlib.sha256()
    h.update(cfg_items_json(cfg).encode())
    h.update(np.int64(grid.node_type.size).tobytes())
    h.update(np.asarray(grid.node_type.shape, np.int64).tobytes())
    h.update(np.ascontiguousarray(grid.node_type).tobytes())
    return h.hexdigest()


def _diff_cfg_json(stored_json: str, current_json: str) -> str:
    """Human-readable key diff between two cfg_items_json strings."""
    try:
        a, b = json.loads(stored_json), json.loads(current_json)
    except Exception:
        return "(cfg diff unavailable)"
    lines = []
    for k in sorted(set(a) | set(b)):
        va, vb = a.get(k, "<absent>"), b.get(k, "<absent>")
        if va != vb:
            lines.append(f"    {k}: checkpoint={va!r}  current={vb!r}")
    return "\n".join(lines) if lines else "(no differing keys)"


def save_checkpoint(path: str, state: State, t_corr: float, meta: dict,
                    fp: str = "", fp_grid: str = "",
                    cfg_json: str = "") -> None:
    arrays = {f.name: np.asarray(getattr(state, f.name))
              for f in dataclasses.fields(State)}
    tmp = path + ".tmp"
    # uncompressed: zlib over ~50 MB of 1M-node state costs seconds per
    # save (14+ saves per flagship run), the rotating single file makes
    # the 2-3x size irrelevant, and np.load reads both formats
    np.savez(tmp, t_corr=t_corr, meta=json.dumps(meta),
             fingerprint=fp, fp_grid=fp_grid, cfg_json=cfg_json,
             **arrays)
    # numpy appends .npz to names without it
    actual_tmp = tmp if tmp.endswith(".npz") else tmp + ".npz"
    os.replace(actual_tmp, path)
    print(f"  Checkpoint written: {path} (t={t_corr:.1f} s)")


def load_checkpoint(path: str, template: State, fp: str = "",
                    force: bool = False, fp_grid: str = "",
                    cfg_json: str = ""):
    """Returns (state, t_corr, meta). ``template`` supplies dtypes.

    If both the checkpoint and the caller provide a fingerprint, they must
    match — resuming with a mismatched config/grid is refused. ``force``
    downgrades a *config* mismatch to a loud warning with a key-level diff,
    but a *grid* mismatch (shape/node_type hash, when both sides record one)
    is always fatal: state arrays from a different grid are garbage, not a
    migration concern.
    """
    with np.load(path, allow_pickle=False) as z:
        stored_fp = str(z["fingerprint"]) if "fingerprint" in z else ""
        stored_fpg = str(z["fp_grid"]) if "fp_grid" in z else ""
        stored_cj = str(z["cfg_json"]) if "cfg_json" in z else ""
        if fp and stored_fp and fp != stored_fp:
            diff = (_diff_cfg_json(stored_cj, cfg_json)
                    if stored_cj and cfg_json else "(cfg diff unavailable)")
            if fp_grid and stored_fpg and fp_grid != stored_fpg:
                raise ValueError(
                    f"checkpoint {path} was written for a DIFFERENT GRID "
                    f"(grid fingerprint {stored_fpg[:12]}… != "
                    f"{fp_grid[:12]}…); refusing to resume even under force")
            if not force:
                raise ValueError(
                    f"checkpoint {path} was written for a different "
                    f"config/grid (fingerprint {stored_fp[:12]}… != expected "
                    f"{fp[:12]}…); refusing to resume.\n"
                    f"  Differing config keys:\n{diff}")
            print(f"WARNING: resuming {path} despite config fingerprint "
                  f"mismatch (PD_RESUME_FORCE). Differing keys:\n{diff}")
        kwargs = {}
        for f in dataclasses.fields(State):
            ref = getattr(template, f.name)
            kwargs[f.name] = jnp.asarray(z[f.name], ref.dtype)
        t_corr = float(z["t_corr"])
        meta = json.loads(str(z["meta"]))
    return State(**kwargs), t_corr, meta
