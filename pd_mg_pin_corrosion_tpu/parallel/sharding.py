"""Multi-chip scale-out: spatial domain decomposition over a device mesh.

The reference is a single-process OpenMP code with no distributed backend
(SURVEY §2 parallelism inventory). The scale-out here: shard
every per-node field along the *axial* array axis (axis 0: y in 2D, z in 3D)
across a 1-D mesh. Because all PD bond kernels are stencil shifts
(pad + static slice), XLA's SPMD partitioner lowers the horizon-wide
neighbor reads into halo exchanges between devices automatically — the
PD horizon delta = m*dx bounds the halo at m+1 lattice layers, so
communication is a fixed-size neighbor exchange per step.

Reductions (convergence eps, v_max, diagnostics) become XLA all-reduces.
No code changes in the physics: the same jitted functions run single-chip
or multi-chip depending on the input shardings.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..fields import State


AXIS = "axial"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the axial spatial axis, on the default backend's
    devices. Raises when the backend has fewer than ``n_devices``: a CPU
    mesh is never swapped in (the tests give the CPU backend virtual
    devices through xla_force_host_platform_device_count)."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None and len(devices) < n_devices:
            raise ValueError(
                f"requested {n_devices} devices, the "
                f"{jax.default_backend()} backend has {len(devices)}")
        devices = devices[: n_devices or len(devices)]
    return Mesh(np.asarray(devices), (AXIS,))


def state_sharding(mesh: Mesh) -> State:
    """A State-shaped pytree of NamedShardings: every field sharded along
    the leading (axial) spatial axis, trailing axes replicated."""

    def spec_for(ndim_extra: int) -> NamedSharding:
        return NamedSharding(mesh, P(AXIS, *([None] * ndim_extra)))

    # all State fields are [*spatial] or [*spatial, dim]; sharding the first
    # axis covers both 2D ([Ny, Nx]) and 3D ([Nz, Ny, Nx]) layouts
    return State(
        rho=spec_for(1), vel=spec_for(2), pressure=spec_for(1), C=spec_for(1),
        node_type=spec_for(1), phase=spec_for(1), D_map=spec_for(1),
        grain_id=spec_for(1), is_gb=spec_for(1), is_precip=spec_for(1),
    )


def shard_state(state: State, mesh: Mesh) -> State:
    """Place a host State onto the mesh with axial-slab sharding."""
    shardings = state_sharding(mesh)
    return jax.tree.map(jax.device_put, state, shardings)


def shard_kit(kit, mesh: Mesh):
    """Shard the Kit's per-node constant arrays the same way (the flat
    mirror table stays replicated — it is gathered by global index)."""
    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    return dataclasses.replace(
        kit,
        multi_device=True,  # static: routes dispatch off single-device kernels
        inlet_mask=put(kit.inlet_mask, P(AXIS, None)),
        outlet_mask=put(kit.outlet_mask, P(AXIS, None)),
        wall_mask=put(kit.wall_mask, P(AXIS, None)),
        near_inlet_mask=put(kit.near_inlet_mask, P(AXIS, None)),
        near_outlet_mask=put(kit.near_outlet_mask, P(AXIS, None)),
        v_pois=put(kit.v_pois, P(AXIS, None)),
        initial_solid_mask=put(kit.initial_solid_mask, P(AXIS, None)),
    )
