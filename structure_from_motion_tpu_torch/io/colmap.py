"""COLMAP text-model export: cameras.txt / images.txt / points3D.txt (port
of ``structure_from_motion_tpu/io/colmap.py``; the same text for the same
poses and track store).

The reference's only persisted outputs are pickles of its own in-memory
structures (``view_pose.pkl`` / ``tri_pts.pkl``, written by its whole-
pipeline ``__main__``; see ``ba_processor.py:443-546`` and the golden files
under ``test_dataset/upenn/results/``) — unusable by any other tool. This
exporter writes the de-facto SfM interchange format instead, so a
reconstruction can go straight into COLMAP's GUI/model_aligner, OpenMVS
densification, Nerfstudio/3DGS pipelines, etc.

Format (COLMAP "text model", one directory with three files):

``cameras.txt``    CAMERA_ID MODEL WIDTH HEIGHT PARAMS[]
``images.txt``     two lines per image:
                   IMAGE_ID QW QX QY QZ TX TY TZ CAMERA_ID NAME
                   X Y POINT3D_ID  (one triple per 2D observation)
``points3D.txt``   POINT3D_ID X Y Z R G B ERROR (IMAGE_ID POINT2D_IDX)*

Conventions: COLMAP stores world-to-camera rotations as Hamilton
quaternions (qw qx qy qz) with translation ``t = -R_w2c @ C``. This
framework stores cam-to-world rotations R with camera centers C (the
reference's ``cam_pose`` convention, ``view_processor.py:56``), so the
export is ``q_colmap = conj(q_ours)``, ``t = -R^T @ C``.

Host-side, float64 on the CPU — runs once at the end of a reconstruction.
The track store (an ``SfMState`` on any device) is brought to the host once.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from structure_from_motion_tpu_torch.utils.rotations import quat_to_rotation, rotation_to_quat


def _w2c(rots: np.ndarray, locs: np.ndarray):
    """Cam-to-world (R, C) -> world-to-camera (q, t), COLMAP layout."""
    R = np.asarray(rots, np.float64)
    C = np.asarray(locs, np.float64)
    q = rotation_to_quat(torch.as_tensor(np.swapaxes(R, -1, -2).copy())).numpy()  # (V, 4) wxyz
    # canonical sign (qw >= 0): COLMAP tooling expects a deterministic rep
    q = q * np.where(q[:, :1] < 0, -1.0, 1.0)
    t = -np.einsum("vji,vj->vi", R, C)  # R^T is w2c
    return q, t


def export_colmap_text(
    out_dir: str,
    locs,
    rots,
    K,
    image_size: tuple[int, int],
    image_names: list[str] | None = None,
    state=None,
) -> dict:
    """Write a COLMAP text model.

    ``locs`` (F,3) camera centers and ``rots`` (F,3,3) cam-to-world
    rotations — exactly :meth:`IncrementalSfM.poses` output. ``K``: (3,3)
    shared intrinsics, or (V,3,3) per-view rows (``state.K``) for
    heterogeneous input; when rows differ each image gets its own PINHOLE
    camera entry (archived frames, whose per-view K is no longer held,
    inherit the oldest live slot's K). ``image_size`` is (width, height)
    in pixels.

    With ``state`` (an ``SfMState``) the export includes the sparse map and
    full observation tracks; the live window's device slots are assumed to
    be the LAST ``min(F, max_views)`` trajectory entries (archived/evicted
    frames keep their poses but have no surviving observations — their
    POINTS2D lines are empty, which COLMAP accepts). Returns counts.
    """
    os.makedirs(out_dir, exist_ok=True)
    locs = np.asarray(locs, np.float64)
    rots = np.asarray(rots, np.float64)
    K = np.asarray(K, np.float64)
    F = locs.shape[0]
    w, h = int(image_size[0]), int(image_size[1])
    if image_names is None:
        image_names = [f"frame{i:06d}.png" for i in range(F)]

    if state is not None:
        # the port's SfMState holds tensors: one host copy of the fields read here
        state = type(state)(*(v.detach().cpu().numpy() if torch.is_tensor(v) else v
                              for v in state))

    q, t = _w2c(rots, locs)

    # live view count: slots 0..n_live-1 of the state hold the LAST n_live
    # trajectory entries. cam_valid is the truth — the K/cam arrays are
    # CAPACITY-sized, and in slide mode rows past the window hold stale
    # constructor values, so min(F, K.shape[0]) would misassign intrinsics
    # and observations whenever window_size < capacity.max_views
    if state is not None:
        n_live = int(min(F, np.asarray(state.cam_valid).sum()))
    else:
        n_live = int(min(F, K.shape[0])) if K.ndim == 3 else F

    # resolve per-image intrinsics: live slots are the LAST n_live images;
    # archived frames (whose per-view K is no longer held) inherit the
    # oldest live slot's K
    if K.ndim == 3:
        per_image_K = np.broadcast_to(K[0], (F, 3, 3)).copy()
        if n_live:
            per_image_K[F - n_live:] = K[:n_live]
    else:
        per_image_K = np.broadcast_to(K, (F, 3, 3))
    shared = bool(np.allclose(per_image_K, per_image_K[0]))
    # camera id per image: one shared camera (the common case, and the
    # reference's assumption) or one per image when intrinsics vary
    cam_id = [1] * F if shared else list(range(1, F + 1))

    with open(os.path.join(out_dir, "cameras.txt"), "w") as fh:
        fh.write("# Camera list with one line of data per camera:\n")
        fh.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        for ci, Ki in (
            [(1, per_image_K[0])] if shared else zip(cam_id, per_image_K)
        ):
            fh.write(
                f"{ci} PINHOLE {w} {h} {Ki[0, 0]:.10g} {Ki[1, 1]:.10g} "
                f"{Ki[0, 2]:.10g} {Ki[1, 2]:.10g}\n"
            )

    # -- gather observations per image + tracks per point -------------------
    # obs2d[i] = list of (x, y, point3d_id); track[p] = list of
    # (image_id, point2d_idx)
    obs2d: list[list] = [[] for _ in range(F)]
    tracks: dict[int, list] = {}
    pts_xyz = np.zeros((0, 3))
    pt_ids: np.ndarray = np.zeros((0,), np.int64)
    pt_err: dict[int, list] = {}
    if state is not None:
        slot_to_image = np.arange(F - n_live, F)  # live slot -> trajectory id
        pv = np.asarray(state.pt_valid)
        pts_xyz = np.asarray(state.points, np.float64)[pv]
        pt_ids = np.nonzero(pv)[0].astype(np.int64)
        ov = np.asarray(state.obs_valid)
        o_cam = np.asarray(state.obs_cam)[ov]
        o_pt = np.asarray(state.obs_pt)[ov]
        o_uv = np.asarray(state.obs_uv, np.float64)[ov]
        live_cam_ok = np.asarray(state.cam_valid)[o_cam]
        keep = live_cam_ok & pv[o_pt]
        o_cam, o_pt, o_uv = o_cam[keep], o_pt[keep], o_uv[keep]
        # reprojection error per observation (pixel): COLMAP's ERROR column
        img = slot_to_image[o_cam]
        Rw2c = np.swapaxes(rots[img], -1, -2)
        Xc = np.einsum("oij,oj->oi", Rw2c, np.asarray(state.points, np.float64)[o_pt] - locs[img])
        z = np.where(np.abs(Xc[:, 2]) < 1e-12, 1e-12, Xc[:, 2])
        homog = np.concatenate([Xc[:, :2] / z[:, None], np.ones_like(z[:, None])], 1)
        proj = np.einsum("oij,oj->oi", per_image_K[img], homog)
        err = np.linalg.norm(proj[:, :2] - o_uv, axis=1)
        for c, p, (x, y), e in zip(img, o_pt, o_uv, err):
            i = int(c)
            pid = int(p) + 1
            tracks.setdefault(int(p), []).append((i + 1, len(obs2d[i])))
            pt_err.setdefault(int(p), []).append(float(e))
            obs2d[i].append((float(x), float(y), pid))

    with open(os.path.join(out_dir, "images.txt"), "w") as fh:
        fh.write("# Image list with two lines of data per image:\n")
        fh.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        fh.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        for i in range(F):
            fh.write(
                f"{i + 1} "
                + " ".join(f"{v:.12g}" for v in (*q[i], *t[i]))
                + f" {cam_id[i]} {image_names[i]}\n"
            )
            fh.write(
                " ".join(f"{x:.6g} {y:.6g} {pid}" for x, y, pid in obs2d[i])
                + "\n"
            )

    with open(os.path.join(out_dir, "points3D.txt"), "w") as fh:
        fh.write("# 3D point list with one line of data per point:\n")
        fh.write(
            "#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, "
            "TRACK[] as (IMAGE_ID, POINT2D_IDX)\n"
        )
        for xyz, p in zip(pts_xyz, pt_ids):
            tr = tracks.get(int(p), [])
            err = float(np.mean(pt_err[int(p)])) if int(p) in pt_err else -1.0
            fh.write(
                f"{int(p) + 1} "
                + " ".join(f"{v:.12g}" for v in xyz)
                + f" 128 128 128 {err:.6g} "
                + " ".join(f"{im} {k}" for im, k in tr)
                + "\n"
            )

    return {
        "images": F,
        "points": int(pts_xyz.shape[0]),
        "observations": int(sum(len(o) for o in obs2d)),
    }


def read_colmap_text(model_dir: str):
    """Parse a COLMAP text model back into arrays (the inverse of
    :func:`export_colmap_text`; also reads models written by COLMAP itself).

    Returns a dict with ``locs`` (F,3) cam-to-world centers, ``rots``
    (F,3,3) cam-to-world rotations, ``K`` (3,3) (the first camera),
    ``Ks`` (F,3,3) per-image intrinsics resolved through each image's
    CAMERA_ID, ``names``, ``points`` (P,3), ``point_ids`` (P,), and
    ``tracks`` (point_id -> [(image_id, point2d_idx), ...]).
    """
    with open(os.path.join(model_dir, "cameras.txt")) as fh:
        cam_rows = [l.split() for l in fh if l.strip() and not l.startswith("#")]

    def _parse_camera(c):
        model, params = c[1], [float(v) for v in c[4:]]
        Kc = np.eye(3)
        if model == "PINHOLE":
            Kc[0, 0], Kc[1, 1], Kc[0, 2], Kc[1, 2] = params[:4]
        elif model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            Kc[0, 0] = Kc[1, 1] = params[0]
            Kc[0, 2], Kc[1, 2] = params[1], params[2]
        else:
            raise ValueError(f"unsupported COLMAP camera model {model!r}")
        return int(c[0]), Kc

    cameras = dict(_parse_camera(c) for c in cam_rows)
    K = cameras[min(cameras)]

    names, qs, ts, ids, img_cam = [], [], [], [], []
    with open(os.path.join(model_dir, "images.txt")) as fh:
        rows = [l.rstrip("\n") for l in fh if not l.startswith("#")]
    for i in range(0, len(rows) - 1, 2):
        f = rows[i].split()
        if len(f) < 10:
            continue
        ids.append(int(f[0]))
        qs.append([float(v) for v in f[1:5]])
        ts.append([float(v) for v in f[5:8]])
        img_cam.append(int(f[8]))
        names.append(f[9])
    order = np.argsort(ids)
    q = np.asarray(qs, np.float64)[order]
    t = np.asarray(ts, np.float64)[order]
    names = [names[i] for i in order]
    Ks = np.stack([cameras[img_cam[i]] for i in order]) if len(order) else np.zeros((0, 3, 3))
    R_w2c = quat_to_rotation(torch.as_tensor(q)).numpy()
    rots = np.swapaxes(R_w2c, -1, -2)  # cam-to-world
    locs = -np.einsum("vij,vj->vi", rots, t)

    pts, pids, tracks = [], [], {}
    with open(os.path.join(model_dir, "points3D.txt")) as fh:
        for line in fh:
            if line.startswith("#") or not line.strip():
                continue
            f = line.split()
            pid = int(f[0])
            pids.append(pid)
            pts.append([float(v) for v in f[1:4]])
            tr = f[8:]
            tracks[pid] = [
                (int(tr[k]), int(tr[k + 1])) for k in range(0, len(tr), 2)
            ]
    return {
        "locs": locs,
        "rots": rots,
        "K": K,
        "Ks": Ks,
        "names": names,
        "points": np.asarray(pts, np.float64).reshape(-1, 3),
        "point_ids": np.asarray(pids, np.int64),
        "tracks": tracks,
    }
