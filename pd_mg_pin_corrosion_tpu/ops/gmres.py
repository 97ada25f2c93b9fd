"""Restarted GMRES on device (right-preconditioned, Arnoldi + least squares).

Replaces jax.scipy.sparse.linalg.gmres for the implicit transport solve.
Two reasons to own it:

* jax.scipy's gmres wraps lax.custom_linear_solve, which eagerly builds the
  transposed operator — impossible for a Pallas matvec (no transpose rule).
* The reference logs GMRES iteration counts and residuals
  (pd_ard_implicit.cpp:416-417); this implementation returns them.

Algorithm: classic restarted GMRES(m) with CGS2 Arnoldi (classical
Gram-Schmidt, fully reorthogonalized — batched-contraction form, see the
inline note), Givens-rotation QR of the Hessenberg maintained per step so a
cycle exits at the first iteration whose least-squares residual estimate
meets the target (back-substitution replaces the dense lstsq), and restart
cycles driven by a lax.while_loop on the true residual ||b - Ax|| / ||b||.
Matches Eigen's GMRES semantics (restart m, maxiter total inner iterations,
relative tolerance) with Jacobi instead of ILU preconditioning.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def gmres(A, b, x0, *, tol, restart: int, maxiter: int, M=None):
    """Solve A x = b. Returns (x, info) with info = (residual, n_cycles).

    A: linear operator (function), M: right preconditioner (function).
    ``tol`` may be a Python float or a traced scalar (the refinement path
    right-sizes correction solves with a data-dependent tolerance).
    ``maxiter`` counts total inner iterations as in Eigen
    (pd_ard_implicit.cpp:399-401): cycles = ceil(maxiter / restart).
    """
    if M is None:
        M = lambda v: v

    # All vector operations preserve the operand's natural array shape (and
    # hence its sharding under SPMD) — the Krylov basis carries the field
    # shape on trailing axes; raveling/reshaping sharded fields scrambles
    # layouts and was observed to break convergence on device meshes.
    shape = b.shape
    m = restart
    n_cycles = max(1, -(-maxiter // restart))

    # f64 Gram-Schmidt scalars with f32 vectors: the Arnoldi dot products
    # and the small Hessenberg least-squares run in float64 (when x64 is
    # enabled) while Krylov vectors stay in the operand dtype. At stiff dt
    # the f32 accumulation error over ~1e6-element reductions is what holds
    # the attainable residual near 1e-4; f64 accumulation removes that floor
    # at negligible cost (scalar reductions are a tiny fraction of the
    # matvec traffic). Under x64-off this degrades gracefully to f32.
    sdt = jnp.float64 if jax.config.jax_enable_x64 else b.dtype

    def vdot(a, c):
        return jnp.sum(a * c, dtype=sdt)

    def norm(a):
        return jnp.sqrt(vdot(a, a))

    b_norm = norm(b)
    safe_b = jnp.maximum(b_norm, 1e-300)

    taxes = tuple(range(1, 1 + len(shape)))

    def basis_dots(V, w):
        """(m+1,) projections <V[k], w> in sdt."""
        return jnp.sum(V * w, axis=taxes, dtype=sdt)

    def basis_axpy(c, V, w):
        """w - sum_k c[k] * V[k] (c in sdt, vectors in operand dtype).

        HIGHEST precision: on a GPU the default f32 contraction may run in
        TF32 (~3 decimal digits), which would cost the recombination the
        digits the CGS2 reorthogonalization exists to keep."""
        return w - jnp.tensordot(c.astype(b.dtype), V, axes=([0], [0]),
                                 precision=jax.lax.Precision.HIGHEST)

    def arnoldi_cycle(x):
        r_s = b - A(x)
        beta = norm(r_s)  # sdt scalar
        inv_beta = jnp.where(beta > 1e-30, 1.0 / jnp.maximum(beta, 1e-300),
                             0.0).astype(b.dtype)

        V = jnp.zeros((m + 1,) + shape, b.dtype)
        V = V.at[0].set(r_s * inv_beta)

        basis_idx = jnp.arange(m + 1)
        col_idx = jnp.arange(m)

        def step(carry):
            V, R, g, cs, sn, j, done = carry
            w = A(M(V[j]))

            # CGS2 — classical Gram-Schmidt with one full reorthogonalization
            # pass against v_0..v_j. Numerically equivalent to MGS with
            # reorthogonalization ("twice is enough"), but each sweep is TWO
            # large fused contractions over the whole basis (a masked
            # (m+1)-row batched dot + a basis recombination) instead of
            # 2*(m+1) sequential dot+axpy micro-kernels, whose launch and
            # slicing overhead can outweigh the matvec+preconditioner they
            # orthogonalize. Dot products
            # accumulate in sdt; vectors stay in the operand dtype. Rows
            # beyond j are exact zeros, but the mask keeps them out of the
            # coefficients regardless of breakdown handling.
            mask = basis_idx <= j

            def cgs_sweep(w, h):
                coefs = jnp.where(mask, basis_dots(V, w), 0.0)
                w = basis_axpy(coefs, V, w)
                return w, h + coefs

            w, hcol = cgs_sweep(w, jnp.zeros(m + 1, sdt))
            w, hcol = cgs_sweep(w, hcol)
            h_last = norm(w)
            hcol = hcol.at[j + 1].set(h_last)
            inv_h = jnp.where(h_last > 1e-30,
                              1.0 / jnp.maximum(h_last, 1e-300),
                              0.0).astype(b.dtype)
            # happy breakdown: keep a zero vector; the masked triangular
            # solve below ignores columns past the exit point
            V = V.at[j + 1].set(w * inv_h)

            # Givens QR of the new Hessenberg column (scalar sdt work):
            # apply the accumulated rotations, then zero the subdiagonal
            # with a new rotation. |g[j+1]| is then the exact least-squares
            # residual norm — checked each step so the cycle can exit as
            # soon as the target is reached instead of always burning all
            # m Arnoldi steps (each one a matvec + preconditioner + CGS2
            # pass; the refinement correction solves at tol 1e-2 typically
            # need only a handful).
            #
            # The naive form is a fori_loop of m dependent 2x2 rotations —
            # pure scalar latency, serialized step by step. But the carried
            # value is a first-order linear recurrence: with t_0 = h_0 and,
            # for i < j,
            #   h'_i    = cs_i t_i + sn_i h_{i+1}
            #   t_{i+1} = -sn_i t_i + cs_i h_{i+1}
            # so t solves t_{i+1} = a_i t_i + d_i with a_i = -sn_i and
            # d_i = cs_i h_{i+1} — an associative_scan in log2(m) steps.
            applied = col_idx < j
            a_seq = jnp.where(applied, -sn, 1.0)
            d_seq = jnp.where(applied, cs * hcol[1:], 0.0)

            def compose(p, q):
                (a1, d1), (a2, d2) = p, q
                return a2 * a1, a2 * d1 + d2

            A_cum, D_cum = jax.lax.associative_scan(
                compose, (a_seq, d_seq))
            t = jnp.concatenate([hcol[:1], A_cum * hcol[0] + D_cum])
            rotated = (jnp.concatenate([cs, jnp.ones(1, sdt)]) * t
                       + jnp.concatenate([sn, jnp.zeros(1, sdt)])
                       * jnp.concatenate([hcol[1:], jnp.zeros(1, sdt)]))
            hcol = jnp.where(basis_idx < j, rotated,
                             jnp.where(basis_idx == j, t, hcol))
            denom = jnp.sqrt(hcol[j] ** 2 + hcol[j + 1] ** 2)
            c_new = jnp.where(denom > 1e-300, hcol[j] / jnp.maximum(denom, 1e-300), 1.0)
            s_new = jnp.where(denom > 1e-300, hcol[j + 1] / jnp.maximum(denom, 1e-300), 0.0)
            cs = cs.at[j].set(c_new)
            sn = sn.at[j].set(s_new)
            hcol = hcol.at[j].set(denom).at[j + 1].set(0.0)
            g_next = -s_new * g[j]
            g = g.at[j + 1].set(g_next).at[j].set(c_new * g[j])
            R = R.at[:, j].set(hcol)
            done = (jnp.abs(g_next) / safe_b) < tol
            return (V, R, g, cs, sn, j + 1, done)

        def step_cond(carry):
            _, _, _, _, _, j, done = carry
            return (j < m) & jnp.logical_not(done)

        R0 = jnp.zeros((m + 1, m), sdt)
        g0 = jnp.zeros(m + 1, sdt).at[0].set(beta)
        cs0 = jnp.ones(m, sdt)
        sn0 = jnp.zeros(m, sdt)
        V, R, g, cs, sn, j_end, _ = jax.lax.while_loop(
            step_cond, step,
            (V, R0, g0, cs0, sn0, jnp.asarray(0, jnp.int32),
             beta / safe_b < tol))

        # back-substitute R[:m,:m] y = g[:m] on the first j_end columns;
        # unused columns get a unit diagonal and zero RHS so y there is 0
        used = col_idx < j_end
        pair = used[None, :] & used[:, None]
        Rm = jnp.where(pair, R[:m, :], 0.0) + jnp.diag(
            jnp.where(used, 0.0, 1.0))
        y = jax.scipy.linalg.solve_triangular(
            Rm, jnp.where(used, g[:m], 0.0), lower=False)
        # solution update sum_k y[k] V[k] == 0 - (-y_ext) . V with y_ext[m]=0
        y_ext = jnp.concatenate([y, jnp.zeros(1, sdt)])
        dx = M(basis_axpy(-y_ext, V, jnp.zeros(shape, b.dtype)))
        return x + dx

    def cond(carry):
        x, k, res = carry
        return (k < n_cycles) & (res > tol)

    def body(carry):
        x, k, res = carry
        x_new = arnoldi_cycle(x)
        res_new = norm(b - A(x_new)) / safe_b
        # monotone restarts: never accept a cycle that increased the residual
        # (possible under finite-precision basis loss)
        better = res_new < res
        x = jax.tree.map(lambda a, c: jnp.where(better, a, c), x_new, x)
        res = jnp.minimum(res_new, res)
        return (x, k + 1, res)

    res0 = norm(b - A(x0)) / safe_b
    x, k, res = jax.lax.while_loop(
        cond, body, (x0, jnp.asarray(0, jnp.int32), res0))
    return x, (res, k)
