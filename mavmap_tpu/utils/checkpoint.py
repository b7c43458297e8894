"""Map-state checkpoint / resume.

The reference has no checkpointing beyond the feature cache (SURVEY §5.4);
this adds full save/restore of the reconstruction state (poses, points,
tracks, pair graph) so long mapping runs survive preemption. Format: one
.npz per checkpoint.
"""

import json

import numpy as np


def save_map(mapper, path):
    """Serialize a SequentialMapper's reconstruction state to `path`.npz."""
    if hasattr(mapper, "flush_ba"):
        mapper.flush_ba()
    s = mapper.store
    track_pids = list(s.tracks.keys())
    track_flat = np.concatenate(
        [np.asarray(s.tracks[p], np.int64) for p in track_pids]
    ) if track_pids else np.zeros(0, np.int64)
    track_lens = np.asarray([len(s.tracks[p]) for p in track_pids], np.int64)

    # Loop-detector persistence (counterpart of the reference's idf
    # save/load, voc_tree_inv_file.cc:331-344): the per-image
    # quantizations rebuild the whole retrieval DB on load without any
    # voc-tree descent, so a resumed run can close loops against
    # pre-checkpoint images immediately.
    loop_kw = {}
    det = getattr(mapper, "loop_detector", None)
    if det is not None:
        idxs, words = det.saved_words()
        loop_kw["loop_idxs"] = np.asarray(idxs, np.int64)
        loop_kw["loop_words_lens"] = np.asarray(
            [len(words[i]) for i in idxs], np.int64)
        loop_kw["loop_words_flat"] = (
            np.concatenate([np.asarray(words[i], np.int64) for i in idxs])
            if idxs else np.zeros(0, np.int64))

    np.savez_compressed(
        path,
        **loop_kw,
        camera_params=s.camera_params,
        camera_models=s.camera_models,
        image_rvecs=s.image_rvecs,
        image_tvecs=s.image_tvecs,
        image_cameras=s.image_cameras,
        image_registered=s.image_registered,
        point2D_xy=s.point2D_xy,
        point2D_xy_norm=s.point2D_xy_norm,
        point2D_image=s.point2D_image,
        point2D_point3D=s.point2D_point3D,
        image_point2D_start=np.asarray(s.image_point2D_start, np.int64),
        point3D_xyz=s.point3D_xyz,
        point3D_valid=s.point3D_valid,
        point3D_tri=s.point3D_tri,
        point3D_error=s.point3D_error,
        point3D_fixed=s.point3D_fixed,
        point3D_track_len=s.point3D_track_len,
        track_pids=np.asarray(track_pids, np.int64),
        track_flat=track_flat,
        track_lens=track_lens,
        idx_to_id=json.dumps(
            {int(k): int(v) for k, v in mapper.image_idx_to_id.items()}
        ),
        pair_graph=np.asarray(sorted(mapper.pair_graph), np.int64).reshape(-1, 2),
        num_proc_images=mapper.num_proc_images,
    )


def load_map(mapper, path):
    """Restore state saved by `save_map` into a fresh SequentialMapper
    (constructed with the same image/camera tables and provider)."""
    d = np.load(path, allow_pickle=False)
    s = mapper.store
    s.camera_params = d["camera_params"]
    s.camera_models = d["camera_models"]
    s.image_rvecs = d["image_rvecs"]
    s.image_tvecs = d["image_tvecs"]
    s.image_cameras = d["image_cameras"]
    s.image_registered = d["image_registered"]
    # Load into the capacity-doubling point2D buffers (the public
    # point2D_* attributes are views; assigning them directly would
    # desynchronize later appends).
    n_p2d = len(d["point2D_xy"])
    s._p2d_len = 0
    s._reserve_p2d(n_p2d)
    s._b_xy[:n_p2d] = d["point2D_xy"]
    s._b_xy_norm[:n_p2d] = d["point2D_xy_norm"]
    s._b_image[:n_p2d] = d["point2D_image"]
    s._b_p3d[:n_p2d] = d["point2D_point3D"]
    s._p2d_len = n_p2d
    s._refresh_p2d_views()
    s.image_point2D_start = [tuple(r) for r in d["image_point2D_start"]]
    n_p3 = len(d["point3D_xyz"])
    s._p3_len = 0
    s.reserve_points3D(n_p3)
    s.point3D_xyz[:] = d["point3D_xyz"]
    s.point3D_valid[:] = d["point3D_valid"]
    s.point3D_tri[:] = d["point3D_tri"]
    s.point3D_error[:] = d["point3D_error"]
    s.point3D_fixed[:] = d["point3D_fixed"]
    s.point3D_track_len[:] = d["point3D_track_len"]

    tracks = {}
    off = 0
    flat = d["track_flat"]
    for pid, ln in zip(d["track_pids"], d["track_lens"]):
        tracks[int(pid)] = [int(x) for x in flat[off : off + int(ln)]]
        off += int(ln)

    if hasattr(s, "_idx"):
        # Native backend: replay the correspondence graph into the C++ core
        # (pids are reassigned; payload rows are remapped to match).
        old_xyz = s.point3D_xyz.copy()
        old_err = s.point3D_error.copy()
        old_fixed = s.point3D_fixed.copy()
        old_tri = s.point3D_tri.copy()
        for image_id, (start, n) in enumerate(s.image_point2D_start):
            s._idx.add_image(image_id, n)
        n_new = 0
        for old_pid, track in tracks.items():
            if len(track) < 2 or not s.point3D_valid[old_pid]:
                continue
            new_pid = None
            for a, b in zip(track[:-1], track[1:]):
                new_pid = s._idx.add_correspondence(int(a), int(b))
            n_new = max(n_new, new_pid + 1)
            s._grow_payload(new_pid)
            s.point3D_xyz[new_pid] = old_xyz[old_pid]
            s.point3D_error[new_pid] = old_err[old_pid]
            s.point3D_fixed[new_pid] = old_fixed[old_pid]
            if old_tri[old_pid]:
                s._idx.set_tri(new_pid, True)
        s._dirty = True
        s._sync()
    else:
        s.tracks = tracks

    mapper.image_idx_to_id = {
        int(k): int(v) for k, v in json.loads(str(d["idx_to_id"])).items()
    }
    mapper.image_id_to_idx = {v: k for k, v in mapper.image_idx_to_id.items()}
    mapper.pair_graph = set((int(a), int(b)) for a, b in d["pair_graph"])
    mapper.num_proc_images = int(d["num_proc_images"])
    # Restore loop-detector state: saved quantizations re-index without
    # any voc-tree descent; images missing from the checkpoint (detector
    # enabled after the save) fall back to re-quantization.
    if mapper.loop_detector is not None:
        det = mapper.loop_detector
        if "loop_idxs" in d:
            flat = d["loop_words_flat"]
            off = 0
            for idx, ln in zip(d["loop_idxs"], d["loop_words_lens"]):
                det.restore_image(int(idx), mapper._features(int(idx)),
                                  flat[off:off + int(ln)])
                off += int(ln)
        for idx in sorted(mapper.image_idx_to_id.keys()):
            if idx not in det._idx_to_slot and idx not in det._pending:
                det.add_image(idx, mapper._features(idx))
    return mapper
