"""The fused per-cycle program for the B-frame pipeline: ONE device
dispatch per batch.

The batched tracking loop alternates two kinds of work: the keyframe
pipeline for a frame chosen out of batch k-1 (insert + fuse + cull + local
BA + scene graph + place-recognition query — slam/kf_program.py) and the
tracking scan over batch k (slam/tracking.make_frame_scan).  Dispatching
them separately costs two host→device round trips per cycle and leaves the
host's decision work serialized between them; composing them under one
``jax.jit`` makes the whole cycle a single program — the scan consumes the
keyframe program's output map directly on device, so tracking always sees
the freshest map (the reference's tracking/mapping thread handoff,
LocalMapping.cc:58, with zero staleness) while the host only resolves one
prefetched scalar readback and issues one dispatch per B frames.

The chosen keyframe's pose is recomposed inside the program from its
relative pose (T_rel = T_cw · T_ref⁻¹ captured at its own batch's scan)
onto the CURRENT reference-keyframe row, so local-BA shifts and host-side
loop corrections that landed since its batch was tracked propagate into
the inserted keyframe exactly like the reference's pose update on the
current keyframe inside CorrectLoop (LoopClosing.cc:977-1008).

Compile-variant policy (the round-3 lesson): only ``sg_cfg`` presence and
``loop_on`` are static — everything that changes per cycle (insert a
keyframe or not, BA/cull/maintenance cadence, semantics provided) is a
RUNTIME boolean lowered to ``lax.cond``, so at most two variants of this
program (loop detection off → on) ever compile in a run.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from visual_sgraphs.core import lie


@functools.lru_cache(maxsize=None)
def make_cycle_program(
    cam,               # CameraConfig (hashable)
    orb,               # OrbConfig (hashable)
    n_window: int,
    fx_radius: float,
    fine_radius: float,
    batch: int,
    sg_cfg,            # SceneGraphConfig or None
    loop_on: bool,
    lba_iters: int,
    cull_min_obs: int,
    cull_min_found_ratio: float,
    cull_kf_redundancy: float,
    min_gap: int,
    top_n: int,
    quarantine: int = 3,
):
    from visual_sgraphs.slam import mapping, tracking
    from visual_sgraphs.slam.kf_program import make_kf_program

    scan = tracking.make_frame_scan(
        cam, orb, n_window, 4096, fx_radius, fine_radius, True, batch,
    )
    kf_prog = make_kf_program(
        sg_cfg, loop_on, n_window, lba_iters, cull_min_obs,
        cull_min_found_ratio, cull_kf_redundancy, min_gap, top_n,
        quarantine,
    )

    def cycle(m, sg, db, vocab,
              frames_prev, results_prev, packeds_prev, T_rels_prev,
              insert_kf, i_kf, kf_slot, ref_old, depths_prev,
              sem_img, conf_img, key,
              grays, depths, tss, velocity, cam_K, cam_bf, min_inliers,
              do_lba, do_cull, do_maint):
        # fold the previous batch's per-frame found/visible statistics
        # (MapPoint mnFound/mnVisible bookkeeping, Tracking::TrackLocalMap)
        acc = packeds_prev[:, 1].astype(jnp.int32) >= min_inliers
        slots = jnp.where(acc[:, None], results_prev.slot_pt, -1)
        vis = jnp.where(acc[:, None], results_prev.vis_pt, -1)
        m = mapping.apply_found_stats(m, slots, vis)

        frame_i = jax.tree.map(lambda x: x[i_kf], frames_prev)
        slot_i = results_prev.slot_pt[i_kf]
        # recompose the keyframe's tracked pose onto the current
        # reference row (absorbs BA shifts / loop corrections since
        # its batch was dispatched)
        pose_kf = lie.se3_normalize(lie.se3_multiply(
            T_rels_prev[i_kf], m.kf_pose[ref_old]
        ))
        no_slots = jnp.full((1, slots.shape[1]), -1, jnp.int32)
        no_vis = jnp.full((1, vis.shape[1]), -1, jnp.int32)

        def run_kf(operand):
            mm, ss, dd = operand
            return kf_prog(
                mm, ss, dd, vocab, frame_i, pose_kf, slot_i, kf_slot,
                no_slots, no_vis, depths_prev[i_kf], sem_img, conf_img,
                key, cam_K, cam_bf, do_lba, do_cull, do_maint,
            )

        def skip_kf(operand):
            mm, ss, dd = operand
            return (mm, ss, dd, ref_old,
                    jnp.zeros((2 * top_n + 3,), jnp.float32),
                    jnp.stack([ref_old.astype(jnp.float32),
                               mm.n_kf.astype(jnp.float32),
                               mm.n_pt.astype(jnp.float32),
                               jnp.asarray(-1.0, jnp.float32),
                               jnp.asarray(0.0, jnp.float32)]))

        m, sg, db, kf, packed_det, board = jax.lax.cond(
            insert_kf, run_kf, skip_kf, (m, sg, db)
        )

        # re-anchor the tracking chain on the (post-BA / post-correction)
        # reference row, then track the new batch against the fresh map
        T_last = lie.se3_normalize(lie.se3_multiply(
            T_rels_prev[-1], m.kf_pose[ref_old]
        ))
        frames, results, T_rels, packeds, T_out, vel_out = scan(
            m, grays, depths, tss, T_last, velocity, kf, cam_K,
            min_inliers, cam_bf,
        )
        return (m, sg, db, kf, packed_det, board,
                frames, results, T_rels, packeds, T_out, vel_out)

    return jax.jit(cycle)
