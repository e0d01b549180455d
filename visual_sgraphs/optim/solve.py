"""Levenberg-Marquardt solver with Schur elimination, dense on the device.

Replaces g2o's ``SparseOptimizer`` + ``BlockSolver`` + LM algorithm
(orb_slam3/Thirdparty/g2o/g2o/core) for every solve in the reference's
``Optimizer.cc``.  Design:

- the *reduced* tangent space (poses, planes, rooms, doors, markers —
  everything except landmarks) is one dense vector of dimension D; its
  Hessian is a dense (D, D) matrix assembled by block scatter-add;
- the eliminated family (map points) contributes through the Schur
  complement ``S = H - Pᵀ Hxx⁻¹ P`` computed as one big matmul
  ``S = H - BᵀB`` with ``B = Hxx^{-1/2} P`` — one dense contraction
  instead of g2o's per-landmark sparse block updates;
- LM accept/reject is a masked state update inside ``lax.scan`` — fixed
  iteration count, no data-dependent control flow, one compile per shape.

Chi2 outlier gating (the reference's between-round ``setLevel(1)`` marking,
Optimizer.cc:1256-1341, 2290-2380) is folded into the per-iteration weights:
a gated factor drops out of the normal equations but is re-tested at every
linearization, so inliers can recover exactly as in the 4-round schedule.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import jax
import jax.numpy as jnp

from visual_sgraphs.optim.graph import (
    FactorBatch,
    GraphProblem,
    VarFamily,
    batch_chi2,
    linearize_batch,
)

Array = jax.Array


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OptimizeResult:
    values: Mapping[str, Array]  # optimized per-family value tables
    cost: Array  # final robust cost
    initial_cost: Array
    lam: Array  # final damping
    accepted: Array  # (iters,) bool history


def _family_col_indices(problem: GraphProblem, name: str, idx: Array) -> Array:
    """Global reduced-tangent column indices (m, t) for rows ``idx`` of a
    reduced family."""
    fam = problem.families[name]
    off = problem.offsets()[name]
    t = fam.tangent_dim
    return off + idx[:, None] * t + jnp.arange(t)[None, :]


def _huber_cost(chi2: Array, delta: float | None) -> Array:
    if delta is None:
        return chi2
    d2 = delta * delta
    return jnp.where(chi2 <= d2, chi2, 2.0 * delta * jnp.sqrt(
        jnp.maximum(chi2, 1e-12)) - d2)


def problem_cost(problem: GraphProblem,
                 values: Mapping[str, Array]) -> Array:
    """Total robust cost at ``values`` (gated items excluded)."""
    fams = {
        k: dataclasses.replace(problem.families[k], values=values[k])
        for k in problem.families
    }
    total = jnp.zeros((), next(iter(values.values())).dtype)
    for batch in problem.factors:
        chi2 = batch_chi2(batch, fams)
        total = total + jnp.sum(
            jnp.where(batch.valid, _huber_cost(chi2, batch.huber), 0.0)
        )
    return total


def _assemble(problem: GraphProblem, values: Mapping[str, Array]):
    """Linearize every factor batch and scatter into the dense reduced system
    plus the eliminated family's block-diagonal system."""
    fams = {
        k: dataclasses.replace(problem.families[k], values=values[k])
        for k in problem.families
    }
    D = problem.reduced_dim()
    dtype = next(iter(values.values())).dtype
    H = jnp.zeros((D, D), dtype)
    g = jnp.zeros((D,), dtype)

    elim = problem.eliminated
    if elim is not None:
        ef = problem.families[elim]
        N, te = ef.n, ef.tangent_dim
        Hxx = jnp.zeros((N, te, te), dtype)
        bx = jnp.zeros((N, te), dtype)
        P = jnp.zeros((N * te, D), dtype)
    else:
        Hxx = bx = P = None

    for batch in problem.factors:
        r, jacs, w = linearize_batch(batch, fams)
        names = batch.families
        for i, ni in enumerate(names):
            Ji = jacs[i]
            idx_i = batch.var_idx[:, i]
            gi = jnp.einsum("mri,mr->mi", Ji, r) * w[:, None]
            if ni == elim:
                bx = bx.at[idx_i].add(gi)
            else:
                cols_i = _family_col_indices(problem, ni, idx_i)
                g = g.at[cols_i].add(gi)
            for j, nj in enumerate(names):
                if j < i:
                    continue
                Jj = jacs[j]
                idx_j = batch.var_idx[:, j]
                block = jnp.einsum("mri,mrj->mij", Ji, Jj) * w[:, None, None]
                if ni == elim and nj == elim:
                    Hxx = Hxx.at[idx_i].add(block)
                elif ni == elim:
                    cols_j = _family_col_indices(problem, nj, idx_j)
                    te = problem.families[elim].tangent_dim
                    rows_e = idx_i[:, None] * te + jnp.arange(te)[None, :]
                    P = P.at[rows_e[:, :, None], cols_j[:, None, :]].add(block)
                elif nj == elim:
                    cols_i = _family_col_indices(problem, ni, idx_i)
                    te = problem.families[elim].tangent_dim
                    rows_e = idx_j[:, None] * te + jnp.arange(te)[None, :]
                    P = P.at[rows_e[:, :, None], cols_i[:, None, :]].add(
                        jnp.swapaxes(block, -1, -2)
                    )
                else:
                    cols_i = _family_col_indices(problem, ni, idx_i)
                    cols_j = _family_col_indices(problem, nj, idx_j)
                    H = H.at[cols_i[:, :, None], cols_j[:, None, :]].add(block)
                    if i != j:
                        H = H.at[cols_j[:, :, None], cols_i[:, None, :]].add(
                            jnp.swapaxes(block, -1, -2)
                        )
    return H, g, Hxx, bx, P


def _reduced_fixed_mask(problem: GraphProblem) -> Array:
    parts = []
    for k in problem.reduced_names():
        fam = problem.families[k]
        parts.append(jnp.repeat(~fam.fixed, fam.tangent_dim))
    return jnp.concatenate(parts) if parts else jnp.zeros((0,), bool)


def _solve_step(problem: GraphProblem, values, lam, free_mask):
    """One damped Gauss-Newton step: returns per-family deltas."""
    H, g, Hxx, bx, P = _assemble(problem, values)
    D = H.shape[0]
    dtype = H.dtype
    eps = jnp.asarray(1e-8 if dtype == jnp.float64 else 1e-5, dtype)

    # Marquardt-style damping on the diagonal
    diag = jnp.clip(jnp.diagonal(H), 1e-6, None)
    H = H + jnp.diag(lam * diag + eps)

    if problem.eliminated is not None:
        ef = problem.families[problem.eliminated]
        te = ef.tangent_dim
        dxx_shape = (ef.n, te)
        eyee = jnp.eye(te, dtype=dtype)
        dHxx = jnp.clip(jnp.diagonal(Hxx, axis1=-2, axis2=-1), 1e-6, None)
        Hxx = Hxx + (lam * dHxx + eps)[..., None] * eyee
        # B = L^-1 P with Hxx = L Lᵀ, per landmark
        L = jnp.linalg.cholesky(Hxx)
        P3 = P.reshape(ef.n, te, D)
        B = jax.vmap(
            lambda Li, Pi: jax.scipy.linalg.solve_triangular(Li, Pi, lower=True)
        )(L, P3)
        c = jax.vmap(
            lambda Li, bi: jax.scipy.linalg.solve_triangular(Li, bi, lower=True)
        )(L, bx)
        S = H - jnp.einsum("nrd,nre->de", B, B)
        rhs = -g + jnp.einsum("nrd,nr->d", B, c)
    else:
        S, rhs = H, -g
        dxx_shape = None

    # clamp out fixed variables: identity rows/cols, zero rhs
    fm = free_mask.astype(dtype)
    S = S * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
    rhs = rhs * fm

    cf = jax.scipy.linalg.cho_factor(S, lower=True)
    dxr = jax.scipy.linalg.cho_solve(cf, rhs)
    dxr = jnp.where(jnp.isfinite(dxr), dxr, 0.0) * fm

    deltas: dict[str, Array] = {}
    offs = problem.offsets()
    for k in problem.reduced_names():
        fam = problem.families[k]
        t = fam.tangent_dim
        deltas[k] = jax.lax.dynamic_slice_in_dim(
            dxr, offs[k], fam.n * t
        ).reshape(fam.n, t)

    if problem.eliminated is not None:
        ef = problem.families[problem.eliminated]
        te = ef.tangent_dim
        # dx_x = -Hxx^{-1}(bx + P dxr) = -L^-T (c + B dxr)
        y = c + jnp.einsum("nrd,d->nr", B, dxr)
        dxe = -jax.vmap(
            lambda Li, yi: jax.scipy.linalg.solve_triangular(
                Li.T, yi, lower=False
            )
        )(L, y)
        dxe = jnp.where(jnp.isfinite(dxe), dxe, 0.0)
        dxe = jnp.where(ef.fixed[:, None], 0.0, dxe)
        deltas[problem.eliminated] = dxe
    return deltas


def _retract_all(problem: GraphProblem, values, deltas):
    out = {}
    for k, fam in problem.families.items():
        d = jnp.where(fam.fixed[:, None], 0.0, deltas[k])
        out[k] = jax.vmap(fam.retract)(values[k], d)
    return out


def optimize(
    problem: GraphProblem,
    iters: int = 10,
    lam0: float = 1e-4,
    lam_up: float = 10.0,
    lam_down: float = 0.5,
) -> OptimizeResult:
    """Run ``iters`` LM iterations (fixed schedule, jit-friendly).

    Mirrors the reference's fixed iteration budgets (PoseOptimization 4x10,
    LocalBundleAdjustment 10, GBA 10 — BASELINE.md) but with per-iteration
    accept/reject damping instead of plain Gauss-Newton.
    """
    values0 = {k: f.values for k, f in problem.families.items()}
    free_mask = _reduced_fixed_mask(problem)
    cost0 = problem_cost(problem, values0)
    dtype = cost0.dtype

    def step(carry, _):
        values, lam, cost = carry
        deltas = _solve_step(problem, values, lam, free_mask)
        cand = _retract_all(problem, values, deltas)
        cand_cost = problem_cost(problem, cand)
        accept = (cand_cost < cost) & jnp.isfinite(cand_cost)
        new_values = jax.tree.map(
            lambda a, b: jnp.where(accept, b, a), values, cand
        )
        new_lam = jnp.where(accept, lam * lam_down, lam * lam_up)
        new_lam = jnp.clip(new_lam, 1e-10, 1e6)
        new_cost = jnp.where(accept, cand_cost, cost)
        return (new_values, new_lam, new_cost), accept

    init = (values0, jnp.asarray(lam0, dtype), cost0)
    (values, lam, cost), accepted = jax.lax.scan(
        step, init, None, length=iters
    )
    return OptimizeResult(
        values=values, cost=cost, initial_cost=cost0, lam=lam,
        accepted=accepted,
    )


def gate_masks(problem: GraphProblem,
               values: Mapping[str, Array]) -> list[Array]:
    """Per-batch inlier masks at ``values``: original validity AND chi2 within
    the batch's gate (batches without a gate keep their validity)."""
    fams = {
        k: dataclasses.replace(problem.families[k], values=values[k])
        for k in problem.families
    }
    masks = []
    for batch in problem.factors:
        if batch.chi2_gate is None:
            masks.append(batch.valid)
        else:
            chi2 = batch_chi2(batch, fams)
            masks.append(batch.valid & (chi2 <= batch.chi2_gate))
    return masks


def optimize_rounds(
    problem: GraphProblem,
    rounds: int = 4,
    iters: int = 10,
    **kw,
) -> tuple[OptimizeResult, list[Array]]:
    """Round-structured solve with chi2 outlier gating between rounds.

    The reference's PoseOptimization runs 4 rounds of 10 LM iterations,
    re-marking outliers after each round against the original edge set so
    items can recover (Optimizer.cc:1255-1341); local BA does one round then
    a chi2 erase (Optimizer.cc:2287-2380).  ``rounds`` here reproduces that
    schedule; returns the final result and the per-batch inlier masks.

    Gating always re-tests the *original* ``valid`` set, so a measurement
    gated in round 1 can re-enter in round 3 once the state improved.
    """
    original_valid = [b.valid for b in problem.factors]
    result = None
    for _ in range(rounds):
        result = optimize(problem, iters=iters, **kw)
        masks = gate_masks(
            dataclasses.replace(
                problem,
                factors=[
                    dataclasses.replace(b, valid=v)
                    for b, v in zip(problem.factors, original_valid)
                ],
            ),
            result.values,
        )
        problem = dataclasses.replace(
            problem,
            families={
                k: dataclasses.replace(problem.families[k],
                                       values=result.values[k])
                for k in problem.families
            },
            factors=[
                dataclasses.replace(b, valid=m)
                for b, m in zip(problem.factors, masks)
            ],
        )
    return result, [b.valid for b in problem.factors]
