"""Triton kernels (pallas_kernels.py) against the XLA path, and the rules
around them: which path a kit takes, the GMRES recombination's precision,
the device mesh and the compile-cache placement.

The kernel-logic tests run here in the Pallas interpreter on a small 3D
grid. Tests marked ``gpu`` compile the kernels for the card; each decides
inside the ``gpu`` fixture whether one is present and skips otherwise.
chip_smoke.py runs the same comparisons at the flagship geometry.
"""

from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pd_mg_pin_corrosion_tpu import Config, build_grid, build_kit, initialize_state
from pd_mg_pin_corrosion_tpu import pallas_kernels as pk
from pd_mg_pin_corrosion_tpu.ops import ard_implicit as ai
from pd_mg_pin_corrosion_tpu.ops.ns import compute_dt, ns_step

# f32 reorder tolerances: kernel and XLA path sum the same terms in stencil
# order, but FMA contraction and the kernel's skipped exact-zero terms move
# the last bits (momentum terms cancel, hence the looser velocity rtol)
RHO_TOL = dict(rtol=1e-5, atol=1e-7)
VEL_TOL = dict(rtol=1e-4, atol=1e-8)
MATVEC_TOL = dict(rtol=1e-4, atol=1e-6)


def _small_3d(m_ratio=2, precision="f32"):
    """Small 3D flow cell with perturbed velocity and concentration."""
    cfg = Config()
    cfg.dim = 3
    cfg.dx = 8e-6
    cfg.m_ratio = m_ratio
    cfg.R_wire = 16e-6
    cfg.L_wire = 64e-6
    cfg.R_tube = 48e-6
    cfg.L_upstream = 32e-6
    cfg.L_downstream = 32e-6
    cfg.precision = precision
    cfg.compute_derived()
    grid = build_grid(cfg)
    kit = build_kit(grid, cfg)
    state = initialize_state(grid, cfg, dtype=kit.jdtype)
    rng = np.random.default_rng(11)
    state = replace(
        state,
        vel=state.vel + 1e-2 * jnp.asarray(rng.normal(size=state.vel.shape),
                                           kit.jdtype),
        C=jnp.asarray(np.where(np.asarray(state.node_type) == 1, 1.0,
                               0.3 * rng.random(kit.shape)), kit.jdtype))
    return kit, state


@pytest.fixture(scope="module")
def small3d():
    return _small_3d()


@pytest.fixture
def gpu():
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run on the card: see README)")


def _check_ns(out, ref):
    np.testing.assert_allclose(np.asarray(out.rho), np.asarray(ref.rho),
                               **RHO_TOL)
    np.testing.assert_allclose(np.asarray(out.vel), np.asarray(ref.vel),
                               **VEL_TOL)
    np.testing.assert_array_equal(np.asarray(out.pressure),
                                  np.asarray(ref.pressure))


def test_ns_kernel_interpret_matches_xla(small3d):
    kit, state = small3d
    dt = compute_dt(state, kit)
    ref = jax.jit(lambda s: ns_step(s, kit, dt))(state)
    out = pk.ns_step_triton(state, kit, dt, interpret=True)
    _check_ns(out, ref)


def test_matvec_kernel_interpret_matches_xla(small3d):
    kit, state = small3d
    op = jax.jit(lambda s: ai.assemble(s, kit))(state)
    x = jnp.asarray(np.random.default_rng(5).random(kit.shape), jnp.float32)
    ref = jax.jit(lambda o, v: ai.matvec_M(o, kit, v))(op, x)
    out = pk.matvec_triton(op, kit, x, interpret=True)
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), **MATVEC_TOL)


def test_implicit_step_through_kernel_route(small3d, monkeypatch):
    """matvec_M's kernel route inside the whole GMRES solve (interpreted):
    same converged answer as the XLA route, to the solve's own tolerance."""
    kit, state = small3d
    op = jax.jit(lambda s: ai.assemble(s, kit))(state)
    dt = jnp.asarray(5.0, jnp.float32)
    ref, res_ref = ai.implicit_step(state, op, kit, dt)

    calls = []
    kernel = pk.matvec_triton

    def interpreted(op, kit, x):
        calls.append(x.shape)
        return kernel(op, kit, x, interpret=True)

    monkeypatch.setattr(pk, "use_kernels", lambda kit, platform=None: True)
    monkeypatch.setattr(pk, "matvec_triton", interpreted)
    out, res = ai.implicit_step(state, op, kit, dt)
    assert calls, "the kernel route was not taken"
    assert float(res) <= 1e-6 and float(res_ref) <= 1e-6
    # both solves reach relative residual 1e-6 on the same system
    np.testing.assert_allclose(np.asarray(out.C), np.asarray(ref.C),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("platform,dtype,dim,multi,expected", [
    ("gpu", "float32", 3, False, True),    # the flagship path
    ("cpu", "float32", 3, False, False),   # no card: XLA
    ("gpu", "float64", 3, False, False),   # f64 takes XLA by rule
    ("gpu", "float32", 2, False, False),   # 2D: XLA's unrolled sum
    ("gpu", "float32", 3, True, False),    # sharded kit: XLA SPMD
])
def test_kernel_choice(small3d, platform, dtype, dim, multi, expected):
    kit, _ = small3d
    kit = replace(kit, dtype=dtype, dim=dim, multi_device=multi)
    assert pk.use_kernels(kit, platform) is expected


def test_dispatch_on_cpu_is_xla(small3d):
    """On this backend ns_step_auto is exactly the XLA step."""
    kit, state = small3d
    assert not pk.use_kernels(kit)
    dt = compute_dt(state, kit)
    out = jax.jit(lambda s: pk.ns_step_auto(s, kit, dt))(state)
    ref = jax.jit(lambda s: ns_step(s, kit, dt))(state)
    np.testing.assert_array_equal(np.asarray(out.rho), np.asarray(ref.rho))
    np.testing.assert_array_equal(np.asarray(out.vel), np.asarray(ref.vel))


def test_gmres_recombination_at_highest_precision():
    """The Krylov recombination w - sum_k c_k V_k in f32 against an f64
    reference: with the contraction pinned to HIGHEST the error stays at f32
    rounding (a TF32 contraction would be ~1e-3 relative)."""
    from pd_mg_pin_corrosion_tpu.ops.gmres import gmres

    rng = np.random.default_rng(2)
    n = 64
    Q, _ = np.linalg.qr(rng.normal(size=(n, n)))
    A = (Q @ np.diag(np.linspace(1.0, 30.0, n)) @ Q.T).astype(np.float32)
    x_true = rng.normal(size=n).astype(np.float32)
    b = jnp.asarray(A @ x_true)
    Am = jnp.asarray(A)
    x, (res, _) = gmres(lambda v: jnp.dot(Am, v, precision="highest"), b,
                        jnp.zeros_like(b), tol=1e-6, restart=40, maxiter=200)
    assert float(res) < 1e-6
    # f64 reference solve; forward error <= cond * residual ~ 30 * 1e-6
    x64 = np.linalg.solve(A.astype(np.float64), np.asarray(b, np.float64))
    np.testing.assert_allclose(np.asarray(x, np.float64), x64,
                               rtol=0, atol=1e-4)

    # every contraction gmres itself emits (the operator here has none)
    text = str(jax.make_jaxpr(lambda v: gmres(
        lambda u: jnp.sum(Am * u, axis=1), v, jnp.zeros_like(v), tol=1e-6,
        restart=4, maxiter=4))(b))
    dots = text.split("dot_general[")[1:]
    assert dots
    assert all("precision=(Precision.HIGHEST, Precision.HIGHEST)" in d[:200]
               for d in dots)


def test_make_mesh_raises_without_enough_devices():
    from pd_mg_pin_corrosion_tpu.parallel.sharding import make_mesh

    have = len(jax.devices())
    assert make_mesh(have).devices.size == have
    with pytest.raises(ValueError, match="requested"):
        make_mesh(have + 1)


@pytest.mark.parametrize("env_dir", [None, "from-env"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    from pd_mg_pin_corrosion_tpu import utils

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = utils.setup_compile_cache()
            assert got == str(utils.CHECKOUT_CACHE_DIR)
            assert jax.config.jax_compilation_cache_dir == got
            # inside the checkout, beside the package
            assert (utils.CHECKOUT_CACHE_DIR.parent / "pd_mg_pin_corrosion_tpu"
                    ).is_dir()
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
            jax.config.update("jax_compilation_cache_dir", None)
            assert utils.setup_compile_cache() == path
            assert jax.config.jax_compilation_cache_dir is None  # JAX reads it
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


@pytest.mark.gpu
def test_kernels_compiled_match_xla(gpu):
    kit, state = _small_3d(m_ratio=3)
    assert pk.use_kernels(kit)
    dt = compute_dt(state, kit)
    _check_ns(pk.ns_step_triton(state, kit, dt),
              jax.jit(lambda s: ns_step(s, kit, dt))(state))
    op = jax.jit(lambda s: ai.assemble(s, kit))(state)
    x = jnp.asarray(np.random.default_rng(5).random(kit.shape), jnp.float32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pk, "use_kernels", lambda kit, platform=None: False)
        ref = jax.jit(lambda o, v: ai.matvec_M(o, kit, v))(op, x)
    np.testing.assert_allclose(np.asarray(pk.matvec_triton(op, kit, x)),
                               np.asarray(ref), **MATVEC_TOL)
