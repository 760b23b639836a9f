"""Plotting helpers (port of ``structure_from_motion_tpu/utils/
visualization.py``): epipolar-line plots, a side-by-side match plot and the
X-Z trajectory scatter. Host numpy; matplotlib is imported inside the
functions, so the module imports on a machine without it and a call there
raises ``ImportError``."""

from __future__ import annotations

import numpy as np


def plot_epipolar_lines(F, img_ref, img_que, ref_pts, que_pts, out_path=None):
    """Draw correspondences and the epipolar lines F·x_ref on the que image
    (and F^T·x_que on the ref image). Returns the matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    F = np.asarray(F)
    ref_pts = np.asarray(ref_pts)
    que_pts = np.asarray(que_pts)

    fig, axes = plt.subplots(1, 2, figsize=(14, 6))

    def draw(ax, img, pts, lines, title):
        ax.imshow(img, cmap="gray")
        h, w = img.shape[:2]
        for (x, y), (a, b, c) in zip(pts, lines):
            ax.plot(x, y, "o", color="lime", markersize=3)
            if abs(b) > 1e-9:
                xs = np.array([0.0, w])
                ys = -(a * xs + c) / b
                ax.plot(xs, ys, "-", color="red", linewidth=0.5)
        ax.set_xlim(0, w)
        ax.set_ylim(h, 0)
        ax.set_title(title)

    ref_h = np.hstack([ref_pts, np.ones((len(ref_pts), 1))])
    que_h = np.hstack([que_pts, np.ones((len(que_pts), 1))])
    draw(axes[0], img_ref, ref_pts, que_h @ F, "ref image, lines F^T x_que")
    draw(axes[1], img_que, que_pts, ref_h @ F.T, "que image, lines F x_ref")
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
    return fig


def plot_matches(
    img_ref, img_que, ref_pts, que_pts, mask=None, out_path=None,
    max_draw=200,
):
    """Side-by-side correspondence plot: the two images concatenated with a
    line per match (the reference's track visualisation,
    ``key_tracker.py:455-551``, without its per-track colour table).
    ``mask`` selects which matches to draw; at most ``max_draw`` lines are
    drawn (uniform stride) so dense match sets stay readable. Returns the
    matplotlib figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    img_ref = np.asarray(img_ref)
    img_que = np.asarray(img_que)
    ref_pts = np.asarray(ref_pts)
    que_pts = np.asarray(que_pts)
    if mask is not None:
        keep = np.asarray(mask).astype(bool)
        ref_pts, que_pts = ref_pts[keep], que_pts[keep]
    if len(ref_pts) > max_draw:
        stride = len(ref_pts) // max_draw + 1
        ref_pts, que_pts = ref_pts[::stride], que_pts[::stride]

    h = max(img_ref.shape[0], img_que.shape[0])
    w1 = img_ref.shape[1]
    canvas = np.zeros((h, w1 + img_que.shape[1]), np.float32)
    canvas[: img_ref.shape[0], :w1] = img_ref
    canvas[: img_que.shape[0], w1:] = img_que

    fig, ax = plt.subplots(figsize=(14, 6))
    ax.imshow(canvas, cmap="gray")
    colors = plt.cm.hsv(np.linspace(0, 1, max(len(ref_pts), 2)))
    for i, ((x1, y1), (x2, y2)) in enumerate(zip(ref_pts, que_pts)):
        ax.plot(
            [x1, x2 + w1], [y1, y2], "-", color=colors[i], linewidth=0.6
        )
        ax.plot(x1, y1, "o", color=colors[i], markersize=2)
        ax.plot(x2 + w1, y2, "o", color=colors[i], markersize=2)
    ax.set_axis_off()
    ax.set_title(f"{len(ref_pts)} matches")
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
    return fig


def plot_reconstruction_xz(locs, rots, points=None, out_path=None, lims=(-20, 20, -20, 30)):
    """The reference's result visualisation: camera centers + map points on
    the X-Z plane (ba_processor.py:507-544 /
    upenn_result_visualization_xz_plane.png)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    locs = np.asarray(locs)
    fig, ax = plt.subplots(figsize=(8, 8))
    colors = plt.cm.tab10(np.linspace(0, 1, max(len(locs), 2)))
    for i, C in enumerate(locs):
        ax.scatter(C[0], C[2], marker="v", s=160, color=colors[i % len(colors)])
        ax.scatter(C[0], C[2], marker=".", s=60, color="black")
        ax.annotate(str(i), (C[0], C[2]), textcoords="offset points", xytext=(6, 6))
    if points is not None and len(points):
        pts = np.asarray(points)
        ax.scatter(pts[:, 0], pts[:, 2], s=2, color="darkseagreen", alpha=0.6)
    ax.set_xlabel("X")
    ax.set_ylabel("Z")
    ax.set_xlim(lims[0], lims[1])
    ax.set_ylim(lims[2], lims[3])
    ax.set_title("cameras + map, X-Z plane")
    if out_path:
        fig.savefig(out_path, dpi=110, bbox_inches="tight")
    return fig
