"""DoG detector + 128-d SIFT-like descriptor, and Harris corners +
steered-BRIEF codes (port of ``structure_from_motion_tpu/ops/features.py``).

Same pipeline as the JAX frontend: optional 2x bilinear upsample, Gaussian
scale space (kernel B1 on the card, every octave), DoG candidate response
(kernel B2, the 8x8 block argmax fused in) and an exact per-octave top-k, the
cross-octave merge, the 3-D subpixel fit, 36-bin orientation histograms with
a second peak, the duplication/re-rank, and the descriptors: with
``sampling="rotated"`` from two 16x16 passes (the orientation window, then
the rotated descriptor grid), with ``sampling="shared"`` from ONE unrotated
G x G grid whose samples serve both, each sample's offset rotated into the
descriptor frame when it is binned.
``detector="harris"`` runs the JAX package's ORB analogue: Harris response
(its three structure-tensor blurs are three lanes of ONE B1 launch), 5x5
NMS, intensity-centroid angle and +-1 steered-BRIEF codes on a dyadic
pyramid, every blur through B1.

Every function takes an (H, W) image or a (B, H, W) lane stack: the lanes
share each kernel launch (one B1 launch a level group, one B2 launch an
octave, for all lanes), and every per-keypoint stage runs on the lanes'
keypoints flattened together, each lane reading its own pyramid through its
own flat offsets. Lane ``b`` of a stack gives what the (H, W) call on image
``b`` gives for every valid keypoint (a masked padding row may read other
taps at the end of the flat pyramid).

Differences that do not change the numbers the JAX package ships on its
accelerator: the TPU workarounds (band-matmul/conv blur, ``blur_precision``,
``topk="approx"``, ``grad_pack``, the selection-matmul downsample) are not
ported; the gradient buffer is a flat per-pixel ``(rows, 2)`` layout sampled
with four gathers, the same values and zero-outside-image semantics as the
JAX package's packed samplers. ``grad_dtype="bf16"`` is honoured: gradients
are differenced and stored in bfloat16, as in the JAX package. The shared
grid's sampler (the JAX package's 64-pixel chunks and weighted one-hot strip
contraction are a TPU memory layout) samples the buffer directly with the
JAX package's arithmetic: the bilinear weights cast to the buffer's dtype,
the four taps summed in f32 and the sum rounded to that dtype.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from structure_from_motion_tpu_torch.config import FrontendConfig
from structure_from_motion_tpu_torch.device import clamp_index, repeat_each, stable_topk
from structure_from_motion_tpu_torch.ops.blur_cuda import blur_levels
from structure_from_motion_tpu_torch.ops.features_cuda import (
    BLOCK,
    block_argmax,
    candidate_block_max,
    candidate_response,
)
from structure_from_motion_tpu_torch.ops.linalg import inv3x3

_BORDER = 8


class Keypoints(NamedTuple):
    xy: torch.Tensor  # ([B,] K, 2) (x, y) in full-resolution pixels
    scale: torch.Tensor  # ([B,] K) sigma in full-resolution pixels
    angle: torch.Tensor  # ([B,] K) orientation, radians
    response: torch.Tensor  # ([B,] K) |DoG| (Harris response for "harris")
    mask: torch.Tensor  # ([B,] K) bool


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / np.sum(k)).astype(np.float32)


def _upsample2x(img: torch.Tensor) -> torch.Tensor:
    """2x bilinear upsample with half-pixel centres; at the borders the
    out-of-image tap is dropped, as ``jax.image.resize(..., "linear")``
    renormalises it away. (H, W) or (B, H, W)."""
    H, W = img.shape[-2:]
    return F.interpolate(
        img.reshape(-1, 1, H, W), size=(2 * H, 2 * W), mode="bilinear", align_corners=False
    ).reshape(img.shape[:-2] + (2 * H, 2 * W))


def _blur(img: torch.Tensor, sigma: float) -> torch.Tensor:
    """Gaussian blur of an (H, W) image or a (B, H, W) stack (one B1 launch)."""
    return blur_levels(img.contiguous(), [_gaussian_kernel1d(sigma)]).select(-3, 0)


def _blur_levels(base: torch.Tensor, rel_sigmas: list) -> torch.Tensor:
    """([B,] H, W) level 0 -> ([B,] L+1, H, W): level i = gaussian(base,
    rel_sigmas[i-1])."""
    out = blur_levels(base.contiguous(), [_gaussian_kernel1d(s) for s in rel_sigmas])
    return torch.cat([base.unsqueeze(-3), out], dim=-3)


def _downsample2(img: torch.Tensor) -> torch.Tensor:
    return img[..., ::2, ::2].contiguous()


def _octave_candidates(gauss: torch.Tensor, cfg: FrontendConfig, per_octave_k: int):
    """([B,] S+3, H, W) gaussian stack -> (dog, xx, yy, s_idx, response, ok):
    integer candidate positions of one octave, ([B,] per_octave_k) each."""
    dog = (gauss[..., 1:, :, :] - gauss[..., :-1, :, :]).contiguous()
    lead = dog.shape[:-3]
    h, w = dog.shape[-2:]
    args = (cfg.contrast_threshold, cfg.edge_threshold, _BORDER)
    B = cfg.topk_block
    if B > 1 and h % B == 0 and w % B == 0:
        # strongest candidate per (layer, BxB block), then an exact top-k;
        # at B = 8 the (S, h, w) response map is never stored
        hb, wb = h // B, w // B
        if B == BLOCK:
            cand, pos = candidate_block_max(dog, *args)
        else:
            cand, pos = block_argmax(candidate_response(dog, *args), B)
        cand = cand.reshape(lead + (-1,))
        k = min(per_octave_k, cand.shape[-1])
        top_resp, ci = stable_topk(cand, k)
        p = torch.gather(pos.reshape(lead + (-1,)), -1, ci).long()
        s_idx = ci // (hb * wb)
        remb = ci % (hb * wb)
        yy = (remb // wb) * B + p // B
        xx = (remb % wb) * B + p % B
    else:
        resp = candidate_response(dog, *args).reshape(lead + (-1,))
        k = min(per_octave_k, resp.shape[-1])
        top_resp, top_idx = stable_topk(resp, k)
        s_idx = top_idx // (h * w)
        rem = top_idx % (h * w)
        yy, xx = rem // w, rem % w
    ok = top_resp > 0.0
    if k < per_octave_k:
        pad = per_octave_k - k
        xx, yy, s_idx, top_resp, ok = (
            torch.cat([t, t.new_zeros(lead + (pad,))], dim=-1)
            for t in (xx, yy, s_idx, top_resp, ok)
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
    """(rows, 2) per-pixel (gx, gy) of every octave's ([B,] L, H, W) stack,
    concatenated; differenced and stored in bfloat16 for ``dtype="bf16"``."""
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    outs = []
    for g in grad_octs:
        g = g.to(dt)
        outs.append(torch.stack([_gradient(g, -1), _gradient(g, -2)], dim=-1).reshape(-1, 2))
    return torch.cat(outs)


class _FlatPyramid(NamedTuple):
    g2: torch.Tensor  # (rows, 2) per-pixel (gx, gy)
    base: torch.Tensor  # (n,) flat row offset of each keypoint's octave (and lane)
    h: torch.Tensor  # (n,) octave image height
    w: torch.Tensor  # (n,) octave image width
    hw: torch.Tensor  # (n,) h * w


def _octave_lut(stacks: list, oct_idx: torch.Tensor):
    """(base, h, w, h*w) per entry of ``oct_idx``: the flat offset and image
    size of its octave's ([B,] L, h, w) stack in the concatenation of
    ``stacks``. For lane stacks ``oct_idx`` is (B, n) and each base moves
    to the entry's own lane; everything comes back flattened to (B * n,)."""
    bases = np.cumsum([0] + [s.numel() for s in stacks])[:-1]
    table = torch.tensor(
        [[int(b), s.shape[-2], s.shape[-1], s.shape[-2] * s.shape[-1]]
         for b, s in zip(bases, stacks)],
        dtype=torch.long, device=oct_idx.device,
    )
    base, h, w, hw = table[oct_idx].unbind(-1)
    if oct_idx.dim() == 2:  # a lane's stack follows the previous lane's
        lane_numel = torch.tensor([s[0].numel() for s in stacks], dtype=torch.long,
                                  device=oct_idx.device)[oct_idx]
        lane = torch.arange(oct_idx.shape[0], device=oct_idx.device)[:, None]
        base = base + lane * lane_numel
    return base.reshape(-1), h.reshape(-1), w.reshape(-1), hw.reshape(-1)


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


def _bilinear_sample_shared(pyr: _FlatPyramid, s: torch.Tensor, sx: torch.Tensor,
                            sy: torch.Tensor) -> torch.Tensor:
    """Bilinear (gx, gy) of the shared grid's samples, the arithmetic of the
    JAX package's chunked sampler: each tap's weight cast to the buffer's
    dtype (bf16 under ``grad_dtype="bf16"``), zero outside the octave image,
    the four weighted taps summed in f32 in the order of that sampler's
    contraction and the sum rounded to the buffer's dtype. All samples of a
    grid row share one ``sy`` by construction (one y offset a row).
    -> (n, T, 2) f32."""
    dt = pyr.g2.dtype
    x0 = torch.floor(sx)
    y0 = torch.floor(sy)
    fx = sx - x0
    fy = sy - y0
    x0i, y0i = x0.long(), y0.long()
    h, w = pyr.h[:, None], pyr.w[:, None]
    start = (pyr.base + s * pyr.hw)[:, None]

    def tap(yy, xx, wt):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        idx = start + torch.minimum(yy.clamp_min(0), h - 1) * w \
            + torch.minimum(xx.clamp_min(0), w - 1)
        v = pyr.g2[clamp_index(idx, pyr.g2.shape[0])].float()
        wq = torch.where(inb, wt, torch.zeros_like(wt)).to(dt).float()
        return v * wq[..., None]

    acc = (tap(y0i, x0i, (1.0 - fx) * (1.0 - fy)) + tap(y0i, x0i + 1, fx * (1.0 - fy))
           + tap(y0i + 1, x0i, (1.0 - fx) * fy) + tap(y0i + 1, x0i + 1, fx * fy))
    return acc.to(dt).float()


def _shared_offsets(G: int, step: float, device):
    """(dxs, dys) (G*G,) sigma-unit offsets of the shared grid, row-major."""
    lin = (np.arange(G, dtype=np.float32) - (G - 1) / 2.0) * step
    gy, gx = np.meshgrid(lin, lin, indexing="ij")
    return (torch.as_tensor(gx.reshape(-1), device=device),
            torch.as_tensor(gy.reshape(-1), device=device))


def _sample_shared_grid(pyr: _FlatPyramid, s_lvl, x, y, sig, G: int, step: float):
    """ONE unrotated G x G grid (offsets in sigma units) serving both the
    orientation histogram and the descriptor (``sampling="shared"``):
    cv2-SIFT's structure, an unrotated window whose samples' offsets are
    rotated into the descriptor frame when binned, so a second-orientation
    duplicate reuses the same samples. -> (samples (n, G*G, 2), dxs, dys)."""
    dxs, dys = _shared_offsets(G, step, x.device)
    sx = x[:, None] + sig[:, None] * dxs[None, :]
    sy = y[:, None] + sig[:, None] * dys[None, :]
    return _bilinear_sample_shared(pyr, s_lvl, sx, sy), dxs, dys


def _orientation_from_samples(g: torch.Tensor, dxs: torch.Tensor, dys: torch.Tensor):
    """Orientation peaks from the shared samples: the 36-bin histogram of
    :func:`_orientation_peaks` with its 2.25-sigma Gaussian window in the
    grid's sigma units."""
    gxs, gys = g[..., 0], g[..., 1]
    mag = torch.sqrt(gxs * gxs + gys * gys)
    ang = torch.atan2(gys, gxs)
    wgt = torch.exp(-(dxs * dxs + dys * dys)[None, :] / (2 * 2.25**2))
    return _hist_peaks(mag * wgt, ang)


def _descriptors_from_samples(g, dxs, dys, angle, valid) -> torch.Tensor:
    """128-d descriptor from the shared unrotated samples: each sample's
    offset rotated into the descriptor frame (cell units: a cell spans 3
    sigma), hat weights on the 4x4 cells from the rotated coordinates (a
    sample outside their span weighs nothing, cv2-SIFT's in-window test),
    gradient angles shifted by -angle, then the trilinear binning, the
    6-sigma Gaussian window and L2 -> clip 0.2 -> L2 x 512 of
    :func:`_descriptors_for`."""
    n = g.shape[0]
    gxd, gyd = g[..., 0], g[..., 1]
    magd = torch.sqrt(gxd * gxd + gyd * gyd)
    angd = torch.atan2(gyd, gxd) - angle[:, None]
    ca, sa = torch.cos(angle)[:, None], torch.sin(angle)[:, None]
    u = (ca * dxs[None, :] + sa * dys[None, :]) / 3.0 + 1.5
    v = (-sa * dxs[None, :] + ca * dys[None, :]) / 3.0 + 1.5
    cells = torch.arange(4, dtype=torch.float32, device=g.device)
    wu = (1.0 - (u[..., None] - cells).abs()).clamp_min(0.0)  # (n, K, 4)
    wv = (1.0 - (v[..., None] - cells).abs()).clamp_min(0.0)
    w = magd * torch.exp(-(dxs * dxs + dys * dys)[None, :] / (2 * 6.0**2))
    ob = torch.remainder(angd + 2 * math.pi, 2 * math.pi) / (2 * math.pi) * 8.0
    b0 = torch.floor(ob).long() % 8
    frac = ob - torch.floor(ob)
    orient = F.one_hot(b0, 8).to(torch.float32) * (1 - frac)[..., None] + F.one_hot(
        (b0 + 1) % 8, 8
    ).to(torch.float32) * frac[..., None]  # (n, K, 8)
    desc = torch.einsum("nkv,nku,nkb,nk->nvub", wv, wu, orient, w).reshape(n, 128)
    desc = desc / torch.linalg.norm(desc, dim=1, keepdim=True).clamp_min(1e-9)
    desc = desc.clamp(max=0.2)
    desc = desc / torch.linalg.norm(desc, dim=1, keepdim=True).clamp_min(1e-9)
    desc = desc * 512.0
    return torch.where(valid[:, None], desc, torch.zeros_like(desc))


def _detect_dog(img: torch.Tensor, cfg: FrontendConfig):
    """DoG + rotated-grid descriptors of an (H, W) image or a (B, H, W)
    stack (keypoint tensors ([B,] K, ...))."""
    lead = img.shape[:-2]
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
        base = _downsample2(gauss.select(-3, S))
    xi, yi, s_idx, resp, ok = (torch.cat(c, dim=-1) for c in zip(*cands))
    oct_idx = repeat_each(torch.arange(cfg.num_octaves, device=dev), per_octave_k)
    oct_idx = oct_idx.expand(lead + oct_idx.shape)

    def take(t, idx):
        return torch.gather(t, -1, idx)

    # global top-k merge across octaves
    top_score, top_idx = stable_topk(torch.where(ok, resp, torch.full_like(resp, -1.0)),
                                     cfg.max_keypoints)
    xi, yi = take(xi, top_idx), take(yi, top_idx)
    s_idx, oct_sel = take(s_idx, top_idx), take(oct_idx, top_idx)
    resp_sel = take(resp, top_idx)
    mask = top_score > 0.0

    # the per-keypoint stages run on every lane's keypoints flattened
    # together, each reading its own lane's stacks through its flat offsets
    def flat(t):
        return t.reshape(-1)

    def unflat(t):
        return t.reshape(lead + (cfg.max_keypoints,))

    # 3-D subpixel fit for the merged winners over the flat DoG stacks
    dog_flat = torch.cat([d.reshape(-1) for d in dog_octs])
    ox, oy, soff, mx, my, ms = (unflat(t) for t in _subpixel_offset_3d(
        dog_flat, *_octave_lut(dog_octs, oct_sel), S, flat(s_idx), flat(yi), flat(xi)))
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
    grad_octs = [g[..., : S + 1, :, :] for g in gauss_octs]
    g2 = _flat_gradients(grad_octs, cfg.grad_dtype)
    pyr = _flat_pyramid(grad_octs, oct_sel, g2)
    shared = cfg.sampling == "shared"
    if shared:
        # the JAX package's sampler reads each grid row from two 64-pixel
        # chunks; its configurations are held to the span that allows
        sig_max = sigmas[S] * k_per_level**0.5
        if (cfg.shared_grid - 1) * cfg.shared_grid_step * sig_max + 2 > 64:
            raise ValueError("shared grid span exceeds the 64-px chunk invariant")
        g_smp, dxs, dys = _sample_shared_grid(pyr, flat(s_lvl), flat(x), flat(y), flat(sig),
                                              cfg.shared_grid, cfg.shared_grid_step)
        peaks = _orientation_from_samples(g_smp, dxs, dys)
    else:
        peaks = _orientation_peaks(pyr, flat(s_lvl), flat(x), flat(y), flat(sig))
    angle1, angle2, has2 = (unflat(t) for t in peaks)

    # a strong keypoint's second orientation displaces the weakest detection;
    # the stable top-k keeps the primary ahead of its equal-response duplicate
    def dup(a):
        return torch.cat([a, a], dim=-1)

    score2 = torch.where(
        torch.cat([mask, mask & has2], dim=-1), dup(resp_sel), torch.full_like(dup(resp_sel), -1.0)
    )
    top2, idx2 = stable_topk(score2, cfg.max_keypoints)
    x, y, sig, s_lvl = (take(dup(t), idx2) for t in (x, y, sig, s_lvl))
    oct_sel, resp_sel = take(dup(oct_sel), idx2), take(dup(resp_sel), idx2)
    angle = take(torch.cat([angle1, angle2], dim=-1), idx2)
    mask = top2 > 0.0

    if shared:
        # the winners' samples exist already: a duplicate re-bins its
        # primary's samples under its own angle, with no further gathers
        K2 = g_smp.shape[-2]
        smp = g_smp.reshape(lead + (cfg.max_keypoints, K2, 2))
        idx = idx2[..., None, None].expand(idx2.shape + (K2, 2))
        desc = _descriptors_from_samples(
            torch.gather(torch.cat([smp, smp], dim=-3), -3, idx).reshape(-1, K2, 2), dxs, dys,
            flat(angle), flat(mask))
    else:
        desc = _descriptors_for(_flat_pyramid(grad_octs, oct_sel, g2), flat(s_lvl), flat(x),
                                flat(y), flat(sig), flat(angle), flat(mask))
    scale_fr = torch.exp2(oct_sel.to(torch.float32)) * (0.5 if cfg.upsample_first_octave else 1.0)
    kps = Keypoints(
        xy=torch.stack([x * scale_fr, y * scale_fr], dim=-1),
        scale=sig * scale_fr,
        angle=angle,
        response=resp_sel,
        mask=mask,
    )
    return kps, desc.reshape(lead + (cfg.max_keypoints, 128))


# ---------------------------------------------------------------------------
# Harris + steered BRIEF: the binary-descriptor family (the JAX package's ORB
# analogue). Codes are +-1 floats, so Hamming distance is one product.
# ---------------------------------------------------------------------------

_HARRIS_BORDER = 20  # the BRIEF patch's support


def _harris_response(img: torch.Tensor, k: float = 0.04, sigma: float = 1.5) -> torch.Tensor:
    """Harris corner response of an (H, W) image or a (B, H, W) stack; the
    three structure-tensor products are three lanes of one B1 launch."""
    ix = 0.5 * (torch.roll(img, -1, -1) - torch.roll(img, 1, -1))
    iy = 0.5 * (torch.roll(img, -1, -2) - torch.roll(img, 1, -2))
    prods = torch.stack([ix * ix, iy * iy, ix * iy], dim=-3)  # ([B,] 3, H, W)
    sm = _blur(prods.reshape((-1,) + img.shape[-2:]), sigma).reshape(prods.shape)
    ixx, iyy, ixy = sm.unbind(-3)
    det = ixx * iyy - ixy * ixy
    tr = ixx + iyy
    return det - k * tr * tr


def _octave_harris(img: torch.Tensor, per_octave_k: int):
    """Harris corners of one octave image: 5x5 NMS, a 20 px border and an
    exact top-k. Returns (x, y, response, valid) in octave pixels,
    ([B,] per_octave_k) each."""
    lead = img.shape[:-2]
    h, w = img.shape[-2:]
    resp = _harris_response(img)
    # max_pool2d pads with -inf, as reduce_window's -inf init does
    nms = F.max_pool2d(resp.reshape(-1, 1, h, w), 5, stride=1, padding=2).reshape(resp.shape)
    rows = torch.arange(h, device=img.device)[:, None]
    cols = torch.arange(w, device=img.device)[None, :]
    b = _HARRIS_BORDER
    bm = (rows >= b) & (rows < h - b) & (cols >= b) & (cols < w - b)
    is_peak = (resp >= nms) & (resp > 0.0) & bm
    flat = torch.where(is_peak, resp, torch.zeros_like(resp)).reshape(lead + (-1,))
    k = min(per_octave_k, flat.shape[-1])
    top_resp, top_idx = stable_topk(flat, k)
    yy = (top_idx // w).to(torch.float32)
    xx = (top_idx % w).to(torch.float32)
    ok = top_resp > 0.0
    if k < per_octave_k:
        pad = lead + (per_octave_k - k,)
        xx, yy, top_resp, ok = (torch.cat([t, t.new_zeros(pad)], dim=-1)
                                for t in (xx, yy, top_resp, ok))
    return xx, yy, top_resp, ok


def _sample_image(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of an (H, W) image at float coords (n, T), or of a
    (B, H, W) stack at (B, n, T) (each lane its own image); zero outside."""
    h, w = img.shape[-2:]
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = img.reshape(-1)
    lane = 0
    if img.dim() == 3:
        lane = (torch.arange(img.shape[0], device=img.device) * (h * w)).reshape(
            (-1,) + (1,) * (x.dim() - 1))

    def tap(yy, xx):
        inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
        v = flat[lane + yy.clamp(0, h - 1) * w + xx.clamp(0, w - 1)]
        return torch.where(inb, v, torch.zeros_like(v))

    return (tap(y0i, x0i) * (1 - fy) * (1 - fx) + tap(y0i, x0i + 1) * (1 - fy) * fx
            + tap(y0i + 1, x0i) * fy * (1 - fx) + tap(y0i + 1, x0i + 1) * fy * fx)


def _intensity_centroid_angle(img, x, y, radius: float = 7.0) -> torch.Tensor:
    """ORB's orientation: arctan2 of the intensity centroid moments of a
    15x15 circular patch."""
    G = 15
    lin = torch.arange(G, dtype=torch.float32, device=img.device) - (G - 1) / 2.0
    gy, gx = torch.meshgrid(lin, lin, indexing="ij")
    circ = ((gx**2 + gy**2) <= ((G - 1) / 2.0) ** 2).to(torch.float32).reshape(-1)
    gx, gy = gx.reshape(-1), gy.reshape(-1)
    sx = x[..., None] + gx * (2 * radius / (G - 1))
    sy = y[..., None] + gy * (2 * radius / (G - 1))
    vals = _sample_image(img, sx, sy) * circ
    return torch.atan2((vals * gy).sum(-1), (vals * gx).sum(-1))


def _brief_pattern(n_bits: int, patch: float, seed: int = 7) -> np.ndarray:
    """The static rBRIEF test pattern: ``n_bits`` point pairs (px, py, qx,
    qy) ~ N(0, (patch/5)^2) clipped to the patch, from numpy's
    ``default_rng(seed)`` exactly as the JAX package draws it."""
    rng = np.random.default_rng(seed)
    pts = rng.normal(scale=patch / 5.0, size=(n_bits, 4)).astype(np.float32)
    return np.clip(pts, -patch / 2.0, patch / 2.0)


def _brief_describe(img, x, y, angle, valid, n_bits: int, patch: float = 31.0) -> torch.Tensor:
    """Steered-BRIEF +-1 codes, bit i = sign(I(R p_i) - I(R q_i)), with the
    steering angle quantised to pi/15 so that orientation noise leaves the
    pattern exactly unchanged."""
    pat = torch.as_tensor(_brief_pattern(n_bits, patch), device=img.device)
    step = math.pi / 15.0
    angle = torch.round(angle / step) * step
    ca, sa = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
    xs, ys = x[..., None], y[..., None]
    px = ca * pat[:, 0] - sa * pat[:, 1] + xs
    py = sa * pat[:, 0] + ca * pat[:, 1] + ys
    qx = ca * pat[:, 2] - sa * pat[:, 3] + xs
    qy = sa * pat[:, 2] + ca * pat[:, 3] + ys
    bits = torch.where(_sample_image(img, px, py) > _sample_image(img, qx, qy), 1.0, -1.0)
    return torch.where(valid[..., None], bits, torch.zeros_like(bits))


def _detect_harris_brief(img: torch.Tensor, cfg: FrontendConfig):
    """Harris + steered BRIEF over a dyadic pyramid, then a global top-k."""
    lead = img.shape[:-2]
    per_octave_k = cfg.max_keypoints
    outs = []
    level = _blur(img, 1.0)
    for o in range(cfg.num_octaves):
        x, y, resp, ok = _octave_harris(level, per_octave_k)
        angle = _intensity_centroid_angle(level, x, y)
        # BRIEF compares single samples: it reads a smoother image than
        # detection does
        desc = _brief_describe(_blur(level, 2.0), x, y, angle, ok, cfg.descriptor_dim)
        outs.append((x * 2.0**o, y * 2.0**o, resp, ok, angle, desc))
        level = _blur(_downsample2(level), 1.0)
    x, y, resp, ok, angle = (torch.cat(t, dim=-1) for t in list(zip(*outs))[:5])
    desc = torch.cat([o[5] for o in outs], dim=-2)
    top_score, top_idx = stable_topk(torch.where(ok, resp, torch.full_like(resp, -1.0)),
                                     cfg.max_keypoints)

    def take(t):
        return torch.gather(t, -1, top_idx)

    kps = Keypoints(
        xy=torch.stack([take(x), take(y)], dim=-1),
        scale=torch.ones(lead + (cfg.max_keypoints,), dtype=torch.float32, device=img.device),
        angle=take(angle),
        response=take(resp),
        mask=top_score > 0.0,
    )
    return kps, torch.gather(desc, -2, top_idx[..., None].expand(top_idx.shape + desc.shape[-1:]))


def detect_and_describe(img: torch.Tensor, cfg: FrontendConfig):
    """(H, W) image -> (Keypoints, (max_keypoints, D) descriptors); a
    (B, H, W) lane stack -> the same with a leading lane axis, every kernel
    launched once for all lanes. ``cfg.detector`` picks DoG with the 128-d
    descriptor (``cfg.sampling``: rotated grids or one shared grid) or Harris
    with steered-BRIEF +-1 codes (match those with ``metric="hamming"``)."""
    if cfg.detector not in ("dog", "harris"):
        raise ValueError(f"unknown detector {cfg.detector!r}")
    if cfg.sampling not in ("rotated", "shared"):
        raise ValueError(f"unknown sampling {cfg.sampling!r}")
    img = img.to(torch.float32)
    img = img / img.amax(dim=(-2, -1), keepdim=True).clamp_min(1e-6)
    if cfg.detector == "harris":
        return _detect_harris_brief(img, cfg)
    return _detect_dog(img, cfg)
