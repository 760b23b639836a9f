"""DoG detector + 128-d rotated-grid descriptor (port of
``structure_from_motion_tpu/ops/features.py`` for ``detector="dog"``,
``sampling="rotated"``).

Same pipeline as the JAX frontend: optional 2x bilinear upsample, Gaussian
scale space (kernel B1 on the card, every octave), DoG candidate response
(kernel B2) with an 8x8 block argmax and an exact per-octave top-k, the
cross-octave merge, the 3-D subpixel fit, 36-bin orientation histograms with
a second peak, the duplication/re-rank, and the descriptors.

Differences that do not change the numbers the JAX package ships on its
accelerator: the TPU workarounds (band-matmul/conv blur, ``blur_precision``,
``topk="approx"``, ``grad_pack``, the selection-matmul downsample) are not
ported; the gradient buffer is a flat per-pixel ``(rows, 2)`` layout sampled
with four gathers, the same values and zero-outside-image semantics as the
JAX package's packed samplers. ``grad_dtype="bf16"`` is honoured: gradients
are differenced and stored in bfloat16, as in the JAX package.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from structure_from_motion_tpu.config import FrontendConfig
from structure_from_motion_tpu_torch.device import clamp_index, stable_topk
from structure_from_motion_tpu_torch.ops.blur_cuda import blur_levels
from structure_from_motion_tpu_torch.ops.features_cuda import candidate_response
from structure_from_motion_tpu_torch.ops.linalg import inv3x3

_BORDER = 8


class Keypoints(NamedTuple):
    xy: torch.Tensor  # (K, 2) (x, y) in full-resolution pixels
    scale: torch.Tensor  # (K,) sigma in full-resolution pixels
    angle: torch.Tensor  # (K,) orientation, radians
    response: torch.Tensor  # (K,) |DoG|
    mask: torch.Tensor  # (K,) bool


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / np.sum(k)).astype(np.float32)


def _upsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres; at the borders the
    out-of-image tap is dropped, as ``jax.image.resize(..., "linear")``
    renormalises it away."""
    H, W = img.shape
    return F.interpolate(
        img[None, None], size=(2 * H, 2 * W), mode="bilinear", align_corners=False
    )[0, 0]


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    return blur_levels(img.contiguous(), [_gaussian_kernel1d(sigma)])[0]


def _blur_levels(base: torch.Tensor, rel_sigmas: list) -> torch.Tensor:
    """(H, W) level 0 -> (L+1, H, W): level i = gaussian(base, rel_sigmas[i-1])."""
    out = blur_levels(base.contiguous(), [_gaussian_kernel1d(s) for s in rel_sigmas])
    return torch.cat([base[None], out])


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    return img[::2, ::2].contiguous()


def _octave_candidates(gauss: torch.Tensor, cfg: FrontendConfig, per_octave_k: int):
    """(S+3, H, W) gaussian stack -> (dog, xx, yy, s_idx, response, ok):
    integer candidate positions of one octave."""
    dog = (gauss[1:] - gauss[:-1]).contiguous()
    S = dog.shape[0] - 2
    h, w = dog.shape[1], dog.shape[2]
    resp3 = candidate_response(dog, cfg.contrast_threshold, cfg.edge_threshold, _BORDER)
    B = cfg.topk_block
    if B > 1 and h % B == 0 and w % B == 0:
        # strongest candidate per (layer, BxB block), then an exact top-k
        hb, wb = h // B, w // B
        r4 = resp3.reshape(S, h, wb, B)
        ax1 = torch.argmax(r4, dim=3)
        r5 = r4.amax(dim=3).reshape(S, hb, B, wb)
        ax2 = torch.argmax(r5, dim=2)
        cand = r5.amax(dim=2).reshape(-1)
        k = min(per_octave_k, cand.numel())
        top_resp, ci = stable_topk(cand, k)
        s_idx = ci // (hb * wb)
        remb = ci % (hb * wb)
        yb, xb = remb // wb, remb % wb
        yy = yb * B + ax2[s_idx, yb, xb]
        xx = xb * B + ax1[s_idx, yy, xb]
    else:
        resp = resp3.reshape(-1)
        k = min(per_octave_k, resp.numel())
        top_resp, top_idx = stable_topk(resp, k)
        s_idx = top_idx // (h * w)
        rem = top_idx % (h * w)
        yy, xx = rem // w, rem % w
    ok = top_resp > 0.0
    if k < per_octave_k:
        pad = per_octave_k - k
        xx, yy, s_idx, top_resp, ok = (
            torch.cat([t, t.new_zeros(pad)]) for t in (xx, yy, s_idx, top_resp, ok)
        )
    return dog, xx, yy, s_idx, top_resp, ok


def _subpixel_offset_3d(flat, obase, h, w, hw, s_layers, s_idx, yy, xx):
    """3-D (x, y, scale) quadratic refinement at the selected candidates over
    the flat concatenation of every octave's DoG stack: two relocation
    rounds, then a fit whose offsets are clipped to +-0.5. Returns
    (dx, dy, ds, moved_x, moved_y, moved_s)."""
    border = 2
    trip = torch.tensor(
        [(ds, dy, dx) for ds in (-1, 0, 1) for dy in (-1, 0, 1) for dx in (-1, 0, 1)],
        device=flat.device,
    ).T
    offs = trip[0][None] * hw[:, None] + trip[1][None] * w[:, None] + trip[2][None]
    n_flat = flat.shape[0]
    eye = torch.eye(3, dtype=flat.dtype, device=flat.device) * 1e-12

    def fit(s_i, y_i, x_i):
        base = obase + (1 + s_i) * hw + y_i * w + x_i
        vals = flat[clamp_index(base[:, None] + offs, n_flat)]  # (n, 27)

        def tap(ds, dy, dx):
            return vals[:, (ds + 1) * 9 + (dy + 1) * 3 + (dx + 1)]

        c = tap(0, 0, 0)
        gx = 0.5 * (tap(0, 0, 1) - tap(0, 0, -1))
        gy = 0.5 * (tap(0, 1, 0) - tap(0, -1, 0))
        gs = 0.5 * (tap(1, 0, 0) - tap(-1, 0, 0))
        hxx = tap(0, 0, 1) - 2 * c + tap(0, 0, -1)
        hyy = tap(0, 1, 0) - 2 * c + tap(0, -1, 0)
        hss = tap(1, 0, 0) - 2 * c + tap(-1, 0, 0)
        hxy = 0.25 * (tap(0, 1, 1) - tap(0, 1, -1) - tap(0, -1, 1) + tap(0, -1, -1))
        hxs = 0.25 * (tap(1, 0, 1) - tap(1, 0, -1) - tap(-1, 0, 1) + tap(-1, 0, -1))
        hys = 0.25 * (tap(1, 1, 0) - tap(1, -1, 0) - tap(-1, 1, 0) + tap(-1, -1, 0))
        g = torch.stack([gx, gy, gs], dim=-1)
        Hm = torch.stack(
            [
                torch.stack([hxx, hxy, hxs], dim=-1),
                torch.stack([hxy, hyy, hys], dim=-1),
                torch.stack([hxs, hys, hss], dim=-1),
            ],
            dim=-2,
        )
        delta = -torch.einsum("nij,nj->ni", inv3x3(Hm + eye), g)
        return torch.where(torch.isfinite(delta), delta, torch.zeros_like(delta))

    s_i, y_i, x_i = s_idx, yy, xx
    for _ in range(2):  # relocation rounds
        move = torch.round(fit(s_i, y_i, x_i).clamp(-1.0, 1.0)).long()
        x_i = torch.minimum(torch.clamp(x_i + move[:, 0], min=border), w - 1 - border)
        y_i = torch.minimum(torch.clamp(y_i + move[:, 1], min=border), h - 1 - border)
        s_i = torch.clamp(s_i + move[:, 2], 0, s_layers - 1)
    delta = fit(s_i, y_i, x_i).clamp(-0.5, 0.5)
    return delta[:, 0], delta[:, 1], delta[:, 2], x_i - xx, y_i - yy, s_i - s_idx


def _gradient(a: torch.Tensor, dim: int) -> torch.Tensor:
    """``jnp.gradient`` along ``dim``: central differences inside, one-sided
    at the edges, computed in ``a``'s dtype."""
    n = a.shape[dim]
    upper = a.narrow(dim, 1, 1) - a.narrow(dim, 0, 1)
    lower = a.narrow(dim, n - 1, 1) - a.narrow(dim, n - 2, 1)
    inner = (a.narrow(dim, 2, n - 2) - a.narrow(dim, 0, n - 2)) * 0.5
    return torch.cat([upper, inner, lower], dim)


def _flat_gradients(grad_octs: list, dtype: str = "f32") -> torch.Tensor:
    """(rows, 2) per-pixel (gx, gy) of every octave's (L, H, W) stack,
    concatenated; differenced and stored in bfloat16 for ``dtype="bf16"``."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    outs = []
    for g in grad_octs:
        g = g.to(dt)
        outs.append(torch.stack([_gradient(g, 2), _gradient(g, 1)], dim=-1).reshape(-1, 2))
    return torch.cat(outs)


class _FlatPyramid(NamedTuple):
    g2: torch.Tensor  # (rows, 2) per-pixel (gx, gy)
    base: torch.Tensor  # (n,) flat row offset of each keypoint's octave
    h: torch.Tensor  # (n,) octave image height
    w: torch.Tensor  # (n,) octave image width
    hw: torch.Tensor  # (n,) h * w


def _octave_lut(stacks: list, oct_idx: torch.Tensor):
    """(base, h, w, h*w) per entry of ``oct_idx``: the flat offset and image
    size of its octave's (L, h, w) stack in the concatenation of ``stacks``."""
    bases = np.cumsum([0] + [s.numel() for s in stacks])[:-1]
    table = torch.tensor(
        [[int(b), s.shape[1], s.shape[2], s.shape[1] * s.shape[2]] for b, s in zip(bases, stacks)],
        dtype=torch.long, device=oct_idx.device,
    )
    return table[oct_idx].unbind(-1)


def _flat_pyramid(grad_octs: list, oct_idx: torch.Tensor, g2: torch.Tensor) -> _FlatPyramid:
    return _FlatPyramid(g2, *_octave_lut(grad_octs, oct_idx))


def _bilinear_sample(pyr: _FlatPyramid, s: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor):
    """Bilinear (gx, gy) at float coords (n, T) of level ``s`` of each
    keypoint's octave; taps outside the octave image are zero. -> (n, T, 2) f32."""
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = (sx - x0)[..., None]
    fy = (sy - y0)[..., None]
    x0i, y0i = x0.long(), y0.long()
    h, w = pyr.h[:, None], pyr.w[:, None]
    start = (pyr.base + s * pyr.hw)[:, None]

    def tap(yy, xx):
        inb = ((yy >= 0) & (yy < h) & (xx >= 0) & (xx < w))[..., None]
        yc = torch.minimum(yy.clamp_min(0), h - 1)
        xc = torch.minimum(xx.clamp_min(0), w - 1)
        idx = start + yc * w + xc
        v = pyr.g2[clamp_index(idx, pyr.g2.shape[0])].float()
        return torch.where(inb, v, torch.zeros_like(v))

    v00 = tap(y0i, x0i)
    v01 = tap(y0i, x0i + 1)
    v10 = tap(y0i + 1, x0i)
    v11 = tap(y0i + 1, x0i + 1)
    return (
        v00 * (1 - fy) * (1 - fx)
        + v01 * (1 - fy) * fx
        + v10 * fy * (1 - fx)
        + v11 * fy * fx
    )


def _hist_peaks(mag_w: torch.Tensor, ang: torch.Tensor):
    """36-bin weighted orientation histogram -> (angle1, angle2, has2)."""
    bins = 36
    b = torch.floor((ang + math.pi) / (2 * math.pi) * bins).long() % bins
    onehot = F.one_hot(b, bins).to(torch.float32)  # (n, T, 36)
    hist = torch.bmm(mag_w[:, None, :], onehot)[:, 0]  # (n, 36)
    hist = (torch.roll(hist, 1, 1) + hist + torch.roll(hist, -1, 1)) / 3.0
    left = torch.roll(hist, 1, 1)
    right = torch.roll(hist, -1, 1)

    def peak_angle(p):
        l = torch.gather(left, 1, p[:, None])[:, 0]  # noqa: E741
        r = torch.gather(right, 1, p[:, None])[:, 0]
        v = torch.gather(hist, 1, p[:, None])[:, 0]
        denom = l - 2 * v + r
        off = torch.where(denom.abs() > 1e-12, 0.5 * (l - r) / denom, torch.zeros_like(denom))
        off = off.clamp(-0.5, 0.5)
        return (p.to(torch.float32) + 0.5 + off) / bins * 2 * math.pi - math.pi

    peak1 = torch.argmax(hist, dim=1)
    v1 = hist.amax(dim=1)
    is_local_max = (hist >= left) & (hist >= right)
    d = (torch.arange(bins, device=hist.device)[None, :] - peak1[:, None]).abs()
    near1 = torch.minimum(d, bins - d) <= 1
    cand = torch.where(is_local_max & ~near1, hist, torch.full_like(hist, -1.0))
    peak2 = torch.argmax(cand, dim=1)
    v2 = cand.amax(dim=1)
    return peak_angle(peak1), peak_angle(peak2), v2 >= 0.8 * v1


def _orientation_peaks(pyr, s_lvl, x, y, sig):
    """Dominant orientations (angle1, angle2, has2) from a 16x16 sample grid
    over a 4.5-sigma window with a 2.25-sigma Gaussian weight."""
    G = 16
    lin = (torch.arange(G, dtype=torch.float32, device=x.device) - (G - 1) / 2.0) / ((G - 1) / 2.0)
    gyy, gxx = torch.meshgrid(lin, lin, indexing="ij")
    gxx, gyy = gxx.reshape(-1)[None], gyy.reshape(-1)[None]
    rad = 4.5 * sig
    sx = x[:, None] + rad[:, None] * gxx
    sy = y[:, None] + rad[:, None] * gyy
    g = _bilinear_sample(pyr, s_lvl, sx, sy)
    gxs, gys = g[..., 0], g[..., 1]
    mag = torch.sqrt(gxs * gxs + gys * gys)
    ang = torch.atan2(gys, gxs)
    wgt = torch.exp(-(gxx * gxx + gyy * gyy) / (2 * 0.5**2))
    return _hist_peaks(mag * wgt, ang)


def _spatial_weights(D: int, device) -> torch.Tensor:
    """(D*D, 16) bilinear weights of each sample of the D x D grid on the
    4x4 descriptor cells."""
    pos = (np.arange(D) + 0.5) / (D / 4) - 0.5
    wrow = np.maximum(0.0, 1.0 - np.abs(pos[:, None] - np.arange(4)[None, :]))
    spatial = np.einsum("ya,xb->yxab", wrow, wrow).reshape(D * D, 16)
    return torch.tensor(spatial, dtype=torch.float32, device=device)


def _descriptors_for(pyr, s_lvl, x, y, sig, angle, valid):
    """128-d descriptor on a rotated 16x16 grid: 4x4 cells x 8 orientation
    bins, Gaussian-windowed, L2 -> clip 0.2 -> L2, scaled by 512."""
    n = x.shape[0]
    D, step = 16, 0.75
    dlin = (torch.arange(D, dtype=torch.float32, device=x.device) - (D - 1) / 2.0) * step
    dyy_g, dxx_g = torch.meshgrid(dlin, dlin, indexing="ij")
    dxx_g, dyy_g = dxx_g.reshape(-1)[None], dyy_g.reshape(-1)[None]
    gridx = dxx_g * sig[:, None]
    gridy = dyy_g * sig[:, None]
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    rx = x[:, None] + ca * gridx - sa * gridy
    ry = y[:, None] + sa * gridx + ca * gridy
    g = _bilinear_sample(pyr, s_lvl, rx, ry)
    gxd, gyd = g[..., 0], g[..., 1]
    magd = torch.sqrt(gxd * gxd + gyd * gyd)
    angd = torch.atan2(gyd, gxd) - angle[:, None]
    ob = torch.remainder(angd + 2 * math.pi, 2 * math.pi) / (2 * math.pi) * 8.0
    b0 = torch.floor(ob).long() % 8
    frac = ob - torch.floor(ob)
    w_desc = magd * torch.exp(-(dxx_g * dxx_g + dyy_g * dyy_g) / (2 * (0.5 * D * step) ** 2))
    orient = F.one_hot(b0, 8).to(torch.float32) * (1 - frac)[..., None] + F.one_hot(
        (b0 + 1) % 8, 8
    ).to(torch.float32) * frac[..., None]  # (n, 256, 8)
    spatial = _spatial_weights(D, x.device)
    desc = torch.einsum("nkb,kc,nk->ncb", orient, spatial, w_desc).reshape(n, 128)
    desc = desc / torch.linalg.norm(desc, dim=1, keepdim=True).clamp_min(1e-9)
    desc = desc.clamp(max=0.2)
    desc = desc / torch.linalg.norm(desc, dim=1, keepdim=True).clamp_min(1e-9)
    desc = desc * 512.0
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def detect_and_describe(img: torch.Tensor, cfg: FrontendConfig):
    """(H, W) image -> (Keypoints, (max_keypoints, 128) descriptors) for the
    DoG detector with rotated-grid sampling."""
    if cfg.detector != "dog" or cfg.sampling != "rotated":
        raise ValueError("the port's frontend covers detector='dog', sampling='rotated'")
    img = img.to(torch.float32)
    img = img / img.max().clamp_min(1e-6)
    S = cfg.scales_per_octave
    n_levels = S + 3
    k_per_level = 2.0 ** (1.0 / S)
    sigmas = [cfg.sigma0 * (k_per_level**i) for i in range(n_levels)]
    rel_sigmas = [
        math.sqrt(max(sigmas[i] ** 2 - sigmas[0] ** 2, 1e-6)) for i in range(1, n_levels)
    ]
    per_octave_k = cfg.max_keypoints
    dev = img.device

    if cfg.upsample_first_octave:
        img = _upsample2x(img)
        base = _blur(img, math.sqrt(max(cfg.sigma0**2 - 1.0, 0.01)))
    else:
        base = _blur(img, cfg.sigma0)
    gauss_octs, dog_octs, cands = [], [], []
    for _ in range(cfg.num_octaves):
        gauss = _blur_levels(base, rel_sigmas)
        gauss_octs.append(gauss)
        dog, *cand = _octave_candidates(gauss, cfg, per_octave_k)
        dog_octs.append(dog)
        cands.append(cand)
        base = _downsample2(gauss[S])
    xi, yi, s_idx, resp, ok = (torch.cat(c) for c in zip(*cands))
    oct_idx = torch.arange(cfg.num_octaves, device=dev).repeat_interleave(per_octave_k)

    # global top-k merge across octaves
    top_score, top_idx = stable_topk(torch.where(ok, resp, torch.full_like(resp, -1.0)),
                                     cfg.max_keypoints)
    xi, yi = xi[top_idx], yi[top_idx]
    s_idx, oct_sel = s_idx[top_idx], oct_idx[top_idx]
    resp_sel = resp[top_idx]
    mask = top_score > 0.0

    # 3-D subpixel fit for the merged winners over the flat DoG stacks
    dog_flat = torch.cat([d.reshape(-1) for d in dog_octs])
    ox, oy, soff, mx, my, ms = _subpixel_offset_3d(
        dog_flat, *_octave_lut(dog_octs, oct_sel), S, s_idx, yi, xi
    )
    s_idx = s_idx + ms
    x = (xi + mx).to(torch.float32) + ox
    y = (yi + my).to(torch.float32) + oy
    # clamp BEFORE the sigma lookup: relocation can drive s_idx to -1, and a
    # negative index would wrap to the coarsest sigma
    s_idx = s_idx.clamp(0, n_levels - 1)
    sig = torch.tensor(sigmas, dtype=torch.float32, device=dev)[s_idx] * torch.pow(
        torch.tensor(k_per_level, dtype=torch.float32, device=dev), soff
    )
    s_lvl = torch.round(s_idx.to(torch.float32) + soff).long().clamp(0, S)

    # orientation peaks; only levels [0, S] are ever sampled
    grad_octs = [g[: S + 1] for g in gauss_octs]
    g2 = _flat_gradients(grad_octs, cfg.grad_dtype)
    angle1, angle2, has2 = _orientation_peaks(_flat_pyramid(grad_octs, oct_sel, g2), s_lvl,
                                              x, y, sig)

    # a strong keypoint's second orientation displaces the weakest detection;
    # the stable top-k keeps the primary ahead of its equal-response duplicate
    def dup(a):
        return torch.cat([a, a])

    score2 = torch.where(
        torch.cat([mask, mask & has2]), dup(resp_sel), torch.full_like(dup(resp_sel), -1.0)
    )
    top2, idx2 = stable_topk(score2, cfg.max_keypoints)
    x, y, sig, s_lvl = dup(x)[idx2], dup(y)[idx2], dup(sig)[idx2], dup(s_lvl)[idx2]
    oct_sel, resp_sel = dup(oct_sel)[idx2], dup(resp_sel)[idx2]
    angle = torch.cat([angle1, angle2])[idx2]
    mask = top2 > 0.0

    desc = _descriptors_for(_flat_pyramid(grad_octs, oct_sel, g2), s_lvl, x, y, sig, angle, mask)
    scale_fr = torch.exp2(oct_sel.to(torch.float32)) * (0.5 if cfg.upsample_first_octave else 1.0)
    kps = Keypoints(
        xy=torch.stack([x * scale_fr, y * scale_fr], dim=1),
        scale=sig * scale_fr,
        angle=angle,
        response=resp_sel,
        mask=mask,
    )
    return kps, desc
