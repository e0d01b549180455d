"""Checkpoint / resume: full-state serialization with integrity checksum.

Replaces the reference's boost::serialization Atlas archive
(System::SaveAtlas/LoadAtlas, System.cc:1161/1217, MD5 via
CalculateCheckSum :1280) — and goes further: the reference's checkpoint
covers only the ORB-SLAM3 core state (scene-graph entities are *not*
serialized, SURVEY §5.4); here the archive is the complete session — active
map, every stashed Atlas map with its place-recognition database, the scene
graph, IMU pipeline state, trajectory and all host-side tracking counters —
so a resumed session continues exactly where it stopped, including
mid-multi-map recovery.

Format: one ``.npz`` with a flattened pytree (every leaf a numpy array) plus
a JSON manifest (with a ``version`` field checked on load) and an embedded
MD5 of the payload bytes.
"""

from __future__ import annotations

import hashlib
import io as _io
import json

import jax
import numpy as np

FORMAT_VERSION = 4


def _put_tree(arrays: dict, tag: str, tree) -> int:
    leaves, _ = jax.tree.flatten(tree)
    for i, leaf in enumerate(leaves):
        arrays[f"{tag}.{i}"] = np.asarray(leaf)
    return len(leaves)


def _get_tree(data, manifest_key_n: int, tag: str, template):
    import jax.numpy as jnp

    leaves = [jnp.asarray(data[f"{tag}.{i}"]) for i in range(manifest_key_n)]
    _, treedef = jax.tree.flatten(template)
    return jax.tree.unflatten(treedef, leaves)


# MapState field order of format v2 archives (before kf_seq / pt_first_seq
# / the retirement ledger were added in v3)
_V2_MAP_FIELDS = (
    "kf_pose", "kf_valid", "kf_timestamp", "kf_uv", "kf_depth", "kf_level",
    "kf_angle", "kf_desc", "kf_kp_valid", "kf_obs_pt", "pt_pos", "pt_valid",
    "pt_desc", "pt_first_kf", "pt_visible", "pt_found", "n_kf", "n_pt",
)


def _get_sg(data, n_leaves: int, tag: str, template, version: int):
    """Load a SceneGraphState; v<=3 archives predate the per-plane voxel
    membership table (``pl_vox``, appended as the LAST field), which the
    upgrade fills with its empty default — membership repopulates from
    live observations."""
    import jax.numpy as jnp

    if version >= 4:
        return _get_tree(data, n_leaves, tag, template)
    leaves = [jnp.asarray(data[f"{tag}.{i}"]) for i in range(n_leaves)]
    leaves.append(jnp.full_like(template.pl_vox, -1))
    _, treedef = jax.tree.flatten(template)
    return jax.tree.unflatten(treedef, leaves)


def _get_map(data, n_leaves: int, tag: str, template, version: int):
    """Load a MapState; v<=2 archives predate the slot-reuse fields and
    are upgraded in place (append-only maps: slot index == sequence)."""
    import jax.numpy as jnp

    if version >= 3:
        return _get_tree(data, n_leaves, tag, template)
    leaves = [jnp.asarray(data[f"{tag}.{i}"]) for i in range(n_leaves)]
    fields = dict(zip(_V2_MAP_FIELDS, leaves))
    m = template._replace(**fields)
    K = m.K
    kf_seq = jnp.where(
        fields["kf_valid"], jnp.arange(K, dtype=jnp.int32), -1
    )
    return m._replace(
        kf_seq=kf_seq,
        pt_first_seq=fields["pt_first_kf"].astype(jnp.int32),
    )


def _put_db(arrays: dict, manifest: dict, tag: str, db, vocab) -> None:
    if db is None:
        return
    arrays[f"{tag}.bow"] = np.asarray(db.bow)
    arrays[f"{tag}.has_word"] = np.asarray(db.has_word)
    arrays[f"{tag}.valid"] = np.asarray(db.valid)
    if vocab is not None:
        arrays[f"{tag}.idf"] = np.asarray(vocab.idf)
        manifest[f"{tag}_vocab_levels"] = len(vocab.centers)
        for i, c in enumerate(vocab.centers):
            arrays[f"{tag}.level_{i}"] = np.asarray(c)


def _get_db(data, manifest: dict, tag: str):
    import jax.numpy as jnp

    from visual_sgraphs.place.database import PlaceDB
    from visual_sgraphs.place.vocab import VocabTree

    if f"{tag}.bow" not in data:
        return None, None
    db = PlaceDB(
        bow=jnp.asarray(data[f"{tag}.bow"]),
        has_word=jnp.asarray(data[f"{tag}.has_word"]),
        valid=jnp.asarray(data[f"{tag}.valid"]),
    )
    vocab = None
    vtag, levels_key = tag, f"{tag}_vocab_levels"
    if f"{vtag}.idf" not in data and tag == "db" and "vocab.idf" in data:
        # version-1 archives stored the active vocab under 'vocab.*' with
        # manifest['vocab_levels']; without this fallback the restored BoW
        # rows would be scored against a freshly retrained (different) vocab
        vtag, levels_key = "vocab", "vocab_levels"
    if f"{vtag}.idf" in data:
        vocab = VocabTree(
            centers=tuple(
                jnp.asarray(data[f"{vtag}.level_{i}"])
                for i in range(manifest[levels_key])
            ),
            idf=jnp.asarray(data[f"{vtag}.idf"]),
        )
    return db, vocab


def save_checkpoint(path: str, system, scenegraph=None, loop_db=None):
    """Write the full session state. ``system``: SlamSystem."""
    system.flush()
    arrays = {}
    manifest = {"version": FORMAT_VERSION}

    manifest["map_leaves"] = _put_tree(arrays, "map", system.map)

    sg = scenegraph if scenegraph is not None else system.scenegraph
    if sg is not None:
        manifest["sg_leaves"] = _put_tree(arrays, "sg", sg.state)

    lc = loop_db if loop_db is not None else getattr(system, "loop_closer",
                                                    None)
    if lc is not None and lc.db is not None:
        _put_db(arrays, manifest, "db", lc.db, lc.vocab)

    # ---- Atlas stashed maps (multi-map elastic recovery state)
    stashed = getattr(system, "atlas", None)
    if stashed is not None:
        manifest["atlas_n_maps_created"] = system.atlas.n_maps_created
        manifest["atlas_stashed"] = []
        for j, (epoch, m, db, vocab, sg_state) in enumerate(
            system.atlas.stashed
        ):
            entry = {"epoch": epoch,
                     "map_leaves": _put_tree(arrays, f"stash{j}.map", m)}
            if db is not None:
                _put_db(arrays, manifest, f"stash{j}.db", db, vocab)
                entry["has_db"] = True
            if sg_state is not None:
                entry["sg_leaves"] = _put_tree(
                    arrays, f"stash{j}.sg", sg_state
                )
            manifest["atlas_stashed"].append(entry)

    # ---- IMU pipeline state
    if getattr(system, "imu", None) is not None:
        imu = system.imu
        manifest["imu_state_leaves"] = _put_tree(
            arrays, "imu.state", imu.export_state()
        )

    traj = system.trajectory
    if traj:
        arrays["traj.ts"] = np.asarray([r[0] for r in traj])
        arrays["traj.epoch"] = np.asarray(
            [r[1] for r in traj], np.int32
        )
        arrays["traj.ref"] = np.asarray(
            [r[2] for r in traj], np.int32
        )
        arrays["traj.seq"] = np.asarray(
            [r[3] for r in traj], np.int32
        )
        arrays["traj.rel"] = np.stack(
            [np.asarray(r[4]) for r in traj]
        )
        arrays["traj.tracked"] = np.asarray(
            [r[5] for r in traj], bool
        )
    arrays["state.last_pose"] = np.asarray(system.last_pose)
    arrays["state.velocity"] = np.asarray(system.velocity)
    arrays["state.ref_kf"] = np.asarray(system.ref_kf)
    manifest["host"] = {
        "ref_kf_host": system.ref_kf_host,
        "n_kf_host": system.n_kf_host,
        "epoch": system.epoch,
        "frames_since_kf": system.frames_since_kf,
        "peak_inliers": system.peak_inliers,
        "last_kf_inliers": system.last_kf_inliers,
        "lost_frames": system.lost_frames,
    }

    buf = _io.BytesIO()
    np.savez_compressed(buf, **arrays)
    payload = buf.getvalue()
    manifest["md5"] = hashlib.md5(payload).hexdigest()
    with open(path, "wb") as f:
        head = json.dumps(manifest).encode()
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        f.write(payload)
    return manifest["md5"]


def load_checkpoint(path: str, system, scenegraph=None, loop_closer=None):
    """Restore state saved by ``save_checkpoint`` into ``system`` (and the
    optional scene-graph manager / loop closer).  Verifies the MD5 before
    touching any state (LoadAtlas's corruption check, System.cc:1230)."""
    import jax.numpy as jnp

    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        manifest = json.loads(f.read(n))
        payload = f.read()
    if hashlib.md5(payload).hexdigest() != manifest["md5"]:
        raise ValueError(f"checkpoint {path}: MD5 mismatch (corrupt file)")
    version = manifest.get("version", 1)
    if version > FORMAT_VERSION:
        raise ValueError(
            f"checkpoint {path}: format v{version} is newer than this "
            f"library's v{FORMAT_VERSION}"
        )
    data = np.load(_io.BytesIO(payload))

    system.map = _get_map(data, manifest["map_leaves"], "map", system.map,
                          version)

    sg = scenegraph if scenegraph is not None else system.scenegraph
    if sg is not None and "sg_leaves" in manifest:
        sg.state = _get_sg(data, manifest["sg_leaves"], "sg", sg.state,
                           version)

    lc = loop_closer if loop_closer is not None else getattr(
        system, "loop_closer", None)
    if lc is not None and "db.bow" in data:
        lc.db, vocab = _get_db(data, manifest, "db")
        if vocab is not None:
            lc.vocab = vocab

    # ---- Atlas stashed maps
    if "atlas_stashed" in manifest and getattr(system, "atlas", None) \
            is not None:
        system.atlas.stashed = []
        system.atlas.n_maps_created = manifest.get(
            "atlas_n_maps_created", 1
        )
        from visual_sgraphs.slam.atlas import StashedMap

        for j, entry in enumerate(manifest["atlas_stashed"]):
            m = _get_map(data, entry["map_leaves"], f"stash{j}.map",
                         system.map, version)
            db = vocab = None
            if entry.get("has_db"):
                db, vocab = _get_db(data, manifest, f"stash{j}.db")
            sg_state = None
            if "sg_leaves" in entry and sg is not None:
                sg_state = _get_sg(
                    data, entry["sg_leaves"], f"stash{j}.sg", sg.state,
                    version,
                )
            system.atlas.stashed.append(
                StashedMap(entry["epoch"], m, db, vocab, sg_state)
            )

    if "imu_state_leaves" in manifest and getattr(system, "imu", None) \
            is not None:
        system.imu.import_state(_get_tree(
            data, manifest["imu_state_leaves"], "imu.state",
            system.imu.export_state(),
        ))

    if "traj.ts" in data:
        if "traj.epoch" in data:
            seqs = (data["traj.seq"] if "traj.seq" in data
                    else data["traj.ref"])  # v2: slot == seq (append-only)
            system.trajectory = [
                (float(t), int(e), int(r), int(s), jnp.asarray(p), bool(k))
                for t, e, r, s, p, k in zip(
                    data["traj.ts"], data["traj.epoch"], data["traj.ref"],
                    seqs, data["traj.rel"], data["traj.tracked"],
                )
            ]
        else:  # legacy v1 layout: (ts, pose, tracked) triples
            system.trajectory = [
                (float(t), 0, 0, 0, jnp.asarray(p), bool(k))
                for t, p, k in zip(
                    data["traj.ts"], data["traj.pose"], data["traj.tracked"]
                )
            ]
    system.last_pose = jnp.asarray(data["state.last_pose"])
    system.velocity = jnp.asarray(data["state.velocity"])
    system.ref_kf = jnp.asarray(data["state.ref_kf"])
    host = manifest.get("host")
    if host is not None:
        system.ref_kf_host = host["ref_kf_host"]
        system.n_kf_host = host["n_kf_host"]
        system.epoch = host["epoch"]
        system.frames_since_kf = host["frames_since_kf"]
        system.peak_inliers = host["peak_inliers"]
        system.last_kf_inliers = host["last_kf_inliers"]
        system.lost_frames = host["lost_frames"]
    else:
        system.ref_kf_host = int(system.ref_kf)
        system.n_kf_host = int(system.map.n_kf)
    from visual_sgraphs.slam.system import TrackState

    if int(system.map.n_kf) > 0:
        system.state = TrackState.OK
    # the host's keyframe-slot allocation mirror must match the restored map
    system._sync_kf_mirror()
    return manifest
