"""Landmark-sharded bundle adjustment over a device mesh.

The BA normal equations Schur-reduce landmark-by-landmark: with landmark n
observed by keyframes k ∈ obs(n),

    S  =  H_pp  −  Σ_n  W_nᵀ Hxx_n⁻¹ W_n,      rhs analogous,

where every term of the Σ only involves landmark n's own observations.
Sharding by LANDMARK therefore makes the whole reduction local: each device
owns a contiguous landmark range (covisibility-contiguous when landmarks are
ordered by creation keyframe, which the map naturally is), computes its
partial dense reduced system (6K, 6K) **without ever materializing the
(3N, 6K) coupling matrix**, and ONE ``psum`` over the mesh completes the
global S — the single collective per iteration.  The
reduced camera solve is replicated (small, dense); landmark back-
substitution is again local to each shard.

Per-device memory is O(N_local·O²) for the pairwise Schur blocks plus the
replicated (6K, 6K) reduced system — at N=65k, O=8, K=256 that is ~150 MB,
versus the O(N·K) dense coupling of a naive layout (~19 GB).

Observations are stored grouped per landmark: ``obs_kf (N, O)`` keyframe
ids (−1 = empty slot), ``obs_uvr (N, O, 3)`` pixel coordinates (u, v, u_r;
u_r < 0 means mono), ``obs_valid (N, O)``.  ``group_observations`` builds
these from flat (obs_kf, obs_pt, uv) lists; ``global_ba_sharded`` builds
them straight from a ``MapState`` and serves as the GBA backend of
``SlamSystem`` (LoopClosing::RunGlobalBundleAdjustment, LoopClosing.cc:2141).

No counterpart exists in the reference (it is single-process, SURVEY §2.7)
— this is the multi-device capability the rebuild adds.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from visual_sgraphs.core import cameras, lie

AXIS = "ba_shard"


def make_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (AXIS,))


# ---------------------------------------------------------------------------
# observation grouping
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=("n_pt", "max_obs"))
def group_observations(obs_kf, obs_pt, uvr, valid, n_pt: int,
                       max_obs: int = 8):
    """Flat observation lists -> per-landmark (N, O) tables.

    Each observation lands in its landmark's next free slot (rank within
    the landmark = how many earlier list entries share the point, computed
    with one sort + run-position pass — no host loop).  Overflow beyond
    ``max_obs`` is dropped (report it via the returned count if it matters).
    """
    m = obs_kf.shape[0]
    pt = jnp.where(valid, obs_pt, n_pt)  # invalid -> overflow bucket
    order = jnp.argsort(pt, stable=True)
    pt_sorted = pt[order]
    pos = jnp.arange(m, dtype=jnp.int32)
    first = jnp.searchsorted(pt_sorted, pt_sorted, side="left")
    rank_sorted = pos - first.astype(jnp.int32)
    rank = jnp.zeros((m,), jnp.int32).at[order].set(rank_sorted)
    keep = valid & (rank < max_obs) & (obs_pt >= 0) & (obs_pt < n_pt)
    row = jnp.where(keep, obs_pt, n_pt)
    col = jnp.where(keep, rank, 0)
    out_kf = jnp.full((n_pt + 1, max_obs), -1, jnp.int32).at[row, col].set(
        jnp.where(keep, obs_kf, -1)
    )[:n_pt]
    out_uvr = jnp.zeros((n_pt + 1, max_obs, 3), uvr.dtype).at[row, col].set(
        jnp.where(keep[:, None], uvr, 0.0)
    )[:n_pt]
    out_valid = jnp.zeros((n_pt + 1, max_obs), bool).at[row, col].set(
        keep
    )[:n_pt]
    n_dropped = jnp.sum((valid & (rank >= max_obs)).astype(jnp.int32))
    return out_kf, out_uvr, out_valid, n_dropped


# ---------------------------------------------------------------------------
# per-landmark local reduction
# ---------------------------------------------------------------------------


def _landmark_terms(kf_pose, X_w, kf_idx, uvr, ovalid, cam_K, bf, huber):
    """All Schur terms of ONE landmark: per-observation residuals r (O, 3),
    pose Jacobians Jp (O, 3, 6), point Jacobians Jx (O, 3, 3), weights."""
    O = kf_idx.shape[0]
    fx, fy, cx, cy = cam_K[0], cam_K[1], cam_K[2], cam_K[3]
    T = kf_pose[jnp.maximum(kf_idx, 0)]  # (O, 7)
    R = jax.vmap(lie.quat_to_matrix)(T[:, :4])  # (O, 3, 3)
    p = jnp.einsum("oij,j->oi", R, X_w) + T[:, 4:7]  # (O, 3)
    z = jnp.maximum(p[:, 2], 1e-6)
    inv_z = 1.0 / z
    u_hat = fx * p[:, 0] * inv_z + cx
    v_hat = fy * p[:, 1] * inv_z + cy
    has_ur = uvr[:, 2] > 0
    ur_hat = u_hat - bf * inv_z
    # depth-noise-aware disparity weight (sigma_z ~ z^2): recover the
    # measured range from the observed disparity and downweight far rows
    # (see pose_only_gn; the reference's ThDepth close/far split)
    disp = jnp.maximum(uvr[:, 0] - uvr[:, 2], 1e-3)
    z_meas = jnp.where(has_ur, bf / disp, 1.0)
    w_ur = jnp.minimum(1.0, (2.5 / jnp.maximum(z_meas, 0.1)) ** 2)
    r = jnp.stack([
        u_hat - uvr[:, 0],
        v_hat - uvr[:, 1],
        jnp.where(has_ur, (ur_hat - uvr[:, 2]) * w_ur, 0.0),
    ], axis=1)  # (O, 3)
    chi2 = jnp.sum(r * r, axis=1)
    ok = ovalid & (kf_idx >= 0) & (p[:, 2] > 0.05)
    w = jnp.where(ok, 1.0, 0.0) * jnp.minimum(
        1.0, huber / jnp.sqrt(jnp.maximum(chi2, 1e-12))
    )
    # d uv / d p (O, 3, 3)
    zero = jnp.zeros_like(z)
    Jp_p = jnp.stack([
        jnp.stack([fx * inv_z, zero, -fx * p[:, 0] * inv_z * inv_z], 1),
        jnp.stack([zero, fy * inv_z, -fy * p[:, 1] * inv_z * inv_z], 1),
        jnp.stack([fx * inv_z, zero,
                   (-fx * p[:, 0] + bf) * inv_z * inv_z], 1)
        * (has_ur * w_ur)[:, None],
    ], axis=1)
    # pose tangent: dp/dxi = [I | -hat(p)] (O, 3, 6)
    hatp = jax.vmap(lie.hat)(p)
    Jx_pose = jnp.concatenate([
        jnp.broadcast_to(jnp.eye(3, dtype=p.dtype), (O, 3, 3)), -hatp
    ], axis=2)
    Jp = jnp.einsum("oij,ojk->oik", Jp_p, Jx_pose)  # (O, 3, 6) pose jac
    Jx = jnp.einsum("oij,ojk->oik", Jp_p, R)  # (O, 3, 3) point jac
    cost = jnp.sum(w * chi2)
    return r, Jp, Jx, w, cost


def _local_reduced_system(kf_pose, pt_shard, kf_tab, uvr_tab, val_tab,
                          cam_K, bf, lam, huber):
    """This shard's partial dense reduced system + landmark factor cache.

    Returns (S_partial (6K, 6K), rhs_partial (6K,), L (n, 3, 3) cholesky of
    damped Hxx, c (n, 3) = L⁻¹ bx, C (n, O, 3, 6) = L⁻¹ Wᵀ, cost)."""
    K = kf_pose.shape[0]
    n, O = kf_tab.shape
    r, Jp, Jx, w, cost = jax.vmap(
        lambda X, ki, uv, ov: _landmark_terms(
            kf_pose, X, ki, uv, ov, cam_K, bf, huber
        )
    )(pt_shard, kf_tab, uvr_tab, val_tab)
    # r (n,O,3)  Jp (n,O,3,6)  Jx (n,O,3,3)  w (n,O)
    cost = jnp.sum(cost)

    Hpp = jnp.einsum("nori,norj,no->noij", Jp, Jp, w)  # (n, O, 6, 6)
    Hxx = jnp.einsum("nori,norj,no->nij", Jx, Jx, w)  # (n, 3, 3)
    W = jnp.einsum("nori,norj,no->noij", Jp, Jx, w)  # (n, O, 6, 3)
    gp = jnp.einsum("nori,nor,no->noi", Jp, r, w)  # (n, O, 6)
    bx = jnp.einsum("nori,nor,no->ni", Jx, r, w)  # (n, 3)

    dtype = r.dtype
    eye3 = jnp.eye(3, dtype=dtype)
    dx = jnp.clip(jnp.diagonal(Hxx, axis1=-2, axis2=-1), 1e-6, None)
    Hxx = Hxx + (lam * dx + 1e-5)[..., None] * eye3
    Hinv = _inv3x3(Hxx)  # (n, 3, 3) closed-form adjugate inverse:
    # element-wise work that fuses, where batched tiny Cholesky and
    # triangular solves lower to loops over the batch

    kf_safe = jnp.maximum(kf_tab, 0)  # (n, O)
    slot_ok = val_tab & (kf_tab >= 0)

    # one-hot observation->keyframe assignment: every contraction below is
    # a dense matmul instead of a scatter-add (O(n·O·K) work against the
    # scatter's O(n·O); which wins on the GPU is open)
    E = (
        (kf_safe[..., None] == jnp.arange(K, dtype=jnp.int32))
        & slot_ok[..., None]
    ).astype(dtype)  # (n, O, K)

    HIGH = jax.lax.Precision.HIGHEST  # a float32 matmul on the GPU may
    # run in TF32 (10-bit mantissa); the Schur factors span ~8 orders of
    # magnitude (W ~ 1e3, Hinv ~ 1e-5) and that truncation stalls GN
    # diagonal H_pp blocks: S1[k] = Σ_{n, a->k} Hpp[n, a]
    S1 = jnp.einsum("nak,naij->kij", E, Hpp, precision=HIGH)  # (K, 6, 6)
    # pairwise Schur blocks via two assembled factors:
    #   S2[(k,r),(m,s)] = Σ_{n,i} X[(n,i),(k,r)] · Y[(n,i),(m,s)]
    # with X from (W Hinv) and Y from W.  Both factor builds and the big
    # contraction are expressed as dot_generals whose MINOR dim stays K
    # and whose batch/contraction dims avoid any large transposed copy (a
    # per-landmark Ce (n, K, 3, 6) intermediate would be 1.2 GB at
    # N=32k/K=128).
    WH = jnp.einsum("nari,nij->narj", W, Hinv,
                    precision=HIGH)  # (n, O, 6, 3)

    def _factor4(M):
        # (n, O, 6, 3) -> A[n, (i,r), k] = Σ_{a->k} M[n,a,r,i]
        M18 = jnp.transpose(M, (0, 1, 3, 2)).reshape(n, O, 18)  # [i*6+r]
        A = jax.lax.dot_general(
            M18, E, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.float32, precision=HIGH,
        )  # (n, 18, K)
        return A.reshape(n, 3, 6, K)

    X4 = _factor4(WH)
    Y4 = _factor4(W)
    S2 = jax.lax.dot_general(
        X4, Y4, (((0, 1), (0, 1)), ((), ())),
        preferred_element_type=jnp.float32,
        precision=HIGH,
    )  # (r, k, s, m)
    S2 = jnp.transpose(S2, (1, 0, 3, 2)).reshape(6 * K, 6 * K)
    S = -0.5 * (S2 + S2.T)  # symmetric by construction; enforce exactly
    kk = jnp.arange(K)
    S = S.reshape(K, 6, K, 6).at[kk, :, kk, :].add(S1)
    # rhs[k] = Σ_{a->k} (−gp_a + W_a Hinv bx)
    hb = jnp.einsum("nij,nj->ni", Hinv, bx, precision=HIGH)  # (n, 3)
    Wb = jnp.einsum("nari,ni->nar", W, hb, precision=HIGH)  # (n, O, 6)
    rhs = jnp.einsum("nak,nar->kr", E, Wb - gp, precision=HIGH)
    return S.reshape(6 * K, 6 * K), rhs.reshape(6 * K), Hinv, bx, W, cost


def _inv3x3(M):
    """Closed-form batched 3x3 inverse (adjugate / determinant)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C_ = b * f - c * e
    D = f * g - d * i
    E_ = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I_ = a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / jnp.where(jnp.abs(det) > 1e-12, det, 1e-12)
    adj = jnp.stack([
        jnp.stack([A, B, C_], axis=-1),
        jnp.stack([D, E_, F], axis=-1),
        jnp.stack([G, H, I_], axis=-1),
    ], axis=-2)
    return adj * inv_det[..., None, None]


def _back_substitute(Hinv, bx, W, kf_tab, val_tab, dxr6):
    """Per-landmark update given the reduced solve:
    dx_n = −Hxx⁻¹ (bx + Σ_a W_aᵀ dxi_{kf_a})."""
    kf_safe = jnp.maximum(kf_tab, 0)
    slot_ok = val_tab & (kf_tab >= 0)
    dpose = dxr6[kf_safe] * slot_ok[..., None]  # (n, O, 6)
    y = bx + jnp.einsum("nari,nar->ni", W, dpose)
    dxe = -jnp.einsum("nij,nj->ni", Hinv, y)
    return jnp.where(jnp.isfinite(dxe), dxe, 0.0)


# ---------------------------------------------------------------------------
# sharded solver
# ---------------------------------------------------------------------------


def _step_body(kf_pose, pt_shard, kf_tab, uvr_tab, val_tab, valid_pt,
               cam_K, fixed_kf, lam, bf, huber, iters: int, single: bool):
    K = kf_pose.shape[0]

    def one_iter(carry, _):
        pose, pts = carry
        S, rhs, Hinv, bx_l, W_l, cost = _local_reduced_system(
            pose, pts, kf_tab, uvr_tab, val_tab, cam_K,
            bf.astype(pts.dtype), lam.astype(pts.dtype), huber,
        )
        if not single:
            # ONE collective completes the global reduced system
            S = jax.lax.psum(S, AXIS)
            rhs = jax.lax.psum(rhs, AXIS)
            cost = jax.lax.psum(cost, AXIS)
        # replicated damped solve over keyframe tangents
        diag = jnp.clip(jnp.diagonal(S), 1e-6, None)
        S = S + jnp.diag(lam * diag + 1e-5)
        free = jnp.repeat(~fixed_kf, 6).astype(S.dtype)
        S = S * free[:, None] * free[None, :] + jnp.diag(1.0 - free)
        rhs = rhs * free
        cf = jax.scipy.linalg.cho_factor(S, lower=True)
        dxr = jax.scipy.linalg.cho_solve(cf, rhs)
        dxr = jnp.where(jnp.isfinite(dxr), dxr, 0.0) * free
        dxr6 = dxr.reshape(K, 6)
        new_pose = jax.vmap(lie.se3_boxplus)(
            pose, jnp.where(fixed_kf[:, None], 0.0, dxr6)
        )
        new_pose = jax.vmap(lie.se3_normalize)(new_pose)
        # local landmark back-substitution
        dxe = _back_substitute(Hinv, bx_l, W_l, kf_tab, val_tab, dxr6)
        new_pts = pts + jnp.where(valid_pt[:, None], dxe, 0.0)
        return (new_pose, new_pts), cost

    (pose, pts), costs = jax.lax.scan(
        one_iter, (kf_pose, pt_shard), None, length=iters
    )
    return pose, pts, costs


_single_solver = jax.jit(_step_body, static_argnames=("iters", "single"))


@functools.lru_cache(maxsize=8)
def _mesh_solver(mesh: Mesh, iters: int):
    """Per-mesh jitted shard_map solver (cached so repeat GBAs re-trace
    nothing)."""
    body = functools.partial(_step_body, iters=iters, single=False)
    return jax.jit(jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(AXIS), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
                  P(), P(), P(), P(), P()),
        out_specs=(P(), P(AXIS), P()),
        check_vma=False,
    ))


def sharded_ba_grouped(
    kf_pose, pt_pos, kf_tab, uvr_tab, val_tab, cam_K,
    fixed_kf, valid_pt, mesh: Mesh, iters: int = 10, lam=1e-4,
    bf: float = 0.0, huber: float = 2.45,
):
    """Gauss-Newton loop with landmarks sharded over ``mesh``.

    ``pt_pos/kf_tab/uvr_tab/val_tab/valid_pt`` are sharded along N (pad N
    to a multiple of the mesh size); poses are replicated.  Returns
    (kf_pose, pt_pos, costs (iters,)).
    """
    dt = pt_pos.dtype
    args = (kf_pose, pt_pos, kf_tab, uvr_tab, val_tab, valid_pt,
            cam_K, fixed_kf, jnp.asarray(lam, dt), jnp.asarray(bf, dt),
            jnp.asarray(huber, dt))
    if mesh.devices.size == 1:
        # one-device mesh: nothing to partition and no psum to run — call
        # the body directly through a module-level cached jit
        return _single_solver(*args, iters=iters, single=True)
    return _mesh_solver(mesh, iters)(*args)


def _pad_to(x, n, fill=0):
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    shape = (pad,) + x.shape[1:]
    return jnp.concatenate([x, jnp.full(shape, fill, x.dtype)], axis=0)


def sharded_ba(
    kf_pose, pt_pos, obs_kf, obs_pt, uv, valid, cam_K,
    fixed_kf, valid_pt, mesh: Mesh, iters: int = 10, lam=1e-4,
    max_obs: int = 8, bf: float = 0.0,
):
    """Flat-observation front end: group per landmark, pad N to the mesh,
    run the landmark-sharded solver.  Returns (pose, points, costs)."""
    n_pt = pt_pos.shape[0]
    if uv.shape[-1] == 2:
        uvr = jnp.concatenate(
            [uv, jnp.full(uv.shape[:-1] + (1,), -1.0, uv.dtype)], axis=-1
        )
    else:
        uvr = uv
    kf_tab, uvr_tab, val_tab, _ = group_observations(
        obs_kf, obs_pt, uvr, valid, n_pt, max_obs
    )
    n_dev = mesh.devices.size
    n_pad = -(-n_pt // n_dev) * n_dev
    pose, pts, costs = sharded_ba_grouped(
        kf_pose,
        _pad_to(pt_pos, n_pad),
        _pad_to(kf_tab, n_pad, -1),
        _pad_to(uvr_tab, n_pad),
        _pad_to(val_tab, n_pad, False),
        cam_K, fixed_kf,
        _pad_to(valid_pt, n_pad, False),
        mesh, iters=iters, lam=lam, bf=bf,
    )
    return pose, pts[:n_pt], costs


def global_ba_sharded(m, cam_K, cam_bf, mesh: Mesh, iters: int = 10,
                      max_obs: int = 8):
    """Distributed GBA straight from a ``MapState`` — the multi-chip backend
    of LoopClosing::RunGlobalBundleAdjustment (LoopClosing.cc:2141).
    Returns the updated map."""
    K, F = m.K, m.F
    obs = m.kf_obs_pt  # (K, F)
    ok = m.kf_kp_valid & m.kf_valid[:, None] & (obs >= 0)
    safe = jnp.maximum(obs, 0)
    ok = ok & m.pt_valid[safe]
    kf_rows = jnp.broadcast_to(
        jnp.arange(K, dtype=jnp.int32)[:, None], obs.shape
    )
    uv = m.kf_uv.reshape(-1, 2)
    depth = m.kf_depth.reshape(-1)
    ur = jnp.where(
        depth > 0, uv[:, 0] - cam_bf / jnp.maximum(depth, 1e-3), -1.0
    )
    uvr = jnp.concatenate([uv, ur[:, None]], axis=1)
    fixed = (~m.kf_valid) | (jnp.arange(K) == 0)
    pose, pts, costs = sharded_ba(
        m.kf_pose, m.pt_pos, kf_rows.reshape(-1), safe.reshape(-1),
        uvr, ok.reshape(-1), cam_K, fixed, m.pt_valid, mesh,
        iters=iters, max_obs=max_obs, bf=float(cam_bf),
    )
    return m._replace(
        kf_pose=jnp.where(fixed[:, None], m.kf_pose, pose),
        pt_pos=jnp.where(m.pt_valid[:, None], pts, m.pt_pos),
    ), costs
