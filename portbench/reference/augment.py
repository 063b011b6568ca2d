"""The synchronized training augmentation, from its definition.

One draw per sample, shared by the (shadow, matte, shadow-free) streams:
scale U[1-s, 1+s], angle U[-a, a] degrees, a horizontal flip when
U[0, 1) <= 0.5, crop offsets uniform over the valid range; the uint8
group is scaled about its center by linear interpolation, rotated about
its center by three shears (x-shear by -tan(t/2), y-shear by sin t,
x-shear by -tan(t/2)), each a per-row linear interpolation on a zero
border, cropped, flipped, and mapped to [-1, 1].

The draws follow the program's derivation of randomness from the seed:
a generator per (seed, epoch, step, stream), seeded from numpy's
``SeedSequence([seed, epoch, step, stream])``, drawing on the card in
the order scale, angle, flip, row offset, column offset.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

STREAMS = {"shuffle": 1, "augment": 2, "dropout_g1": 3, "dropout_g2": 4}


def derive_seed(seed, epoch, step, stream) -> int:
    ss = np.random.SeedSequence([seed, epoch, step, STREAMS[stream]])
    return int(ss.generate_state(1, np.uint64)[0]) & (2 ** 63 - 1)


def generator(seed, epoch, step, stream, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(derive_seed(seed, epoch, step, stream))
    return g


def _off_range(dim, crop):
    if dim > crop:
        return 0, dim - crop
    if dim == crop:
        return 0, 1
    return -(crop - dim), 0


def draw_params(gen, batch, h, w, scale, angle, crop, device, flip_prob=0.5):
    def uniform(lo, hi):
        return lo + torch.rand(batch, generator=gen, device=device) * (hi - lo)

    s = uniform(1.0 - scale, 1.0 + scale)
    a = uniform(-angle, angle)
    flip = torch.rand(batch, generator=gen, device=device) <= flip_prob
    row = torch.randint(*_off_range(h, crop), (batch,), generator=gen, device=device)
    col = torch.randint(*_off_range(w, crop), (batch,), generator=gen, device=device)
    return {"scale": s, "angle": a, "flip": flip, "row_off": row, "col_off": col}


def _interp_matrix(s, n):
    """(B, n, n): output index i takes source (i - c) / s + c, c the
    center, by hat weights (a zero border)."""
    i = torch.arange(n, dtype=torch.float32, device=s.device)
    c = (n - 1) / 2.0
    src = (i[None, :] - c) / s[:, None] + c
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - i[None, None, :]), 0.0, 1.0)


def shear_rows(img, shifts, out_w, pad):
    """out[b, c, r, j] = img[b, c, r, shifts[b, r] + j] by linear
    interpolation, the image zero-bordered by ``pad`` columns; the start
    column is clamped to the bordered image."""
    b, c, h, w0 = img.shape
    src = shifts + pad
    fl = torch.floor(src)
    k = torch.clamp(fl, 0, w0 + 2 * pad - out_w - 1).long()
    f = (src - fl)[:, None, :, None]
    padded = F.pad(img, (pad, pad))
    idx = (k[:, None, :, None] + torch.arange(out_w, device=img.device)).expand(b, c, h, out_w)
    return torch.gather(padded, 3, idx) * (1.0 - f) + torch.gather(padded, 3, idx + 1) * f


def geometry(h, w, max_angle):
    t = math.radians(min(abs(max_angle), 89.0))
    margin = -(-(math.ceil(math.tan(t / 2.0) * h / 2.0) + 2) // 4) * 4
    wx = w + 2 * margin
    return margin, wx, 2 * margin, math.ceil(math.sin(t) * wx / 2.0) + 4, 4


def shear_shifts(params, h, w, crop, max_angle):
    """The three passes' (shifts, out_w, pad, source width), after the
    flip has moved the column offset."""
    theta = torch.deg2rad(params["angle"].float())
    a, b = -torch.tan(theta / 2.0), torch.sin(theta)
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    margin, wx, pad1, pad2, pad3 = geometry(h, w, max_angle)
    dev = theta.device
    ro = params["row_off"].float()
    co = torch.where(params["flip"], (w - crop) - params["col_off"], params["col_off"]).float()
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    s1 = a[:, None] * (rows[None, :] - cy) - margin
    cols = torch.arange(wx, dtype=torch.float32, device=dev) - margin
    s2 = b[:, None] * (cols[None, :] - cx) + ro[:, None]
    rows_c = torch.arange(crop, dtype=torch.float32, device=dev)[None, :] + ro[:, None]
    s3 = a[:, None] * (rows_c - cy) + co[:, None] + margin
    return [(s1, wx, pad1, w), (s2, crop, pad2, h), (s3, crop, pad3, wx)]


def augment(streams_u8, params, crop, max_angle):
    """(B, H, W, C) uint8 streams -> float32 (B, C, crop, crop) each, in
    [-1, 1]."""
    splits = [s.shape[-1] for s in streams_u8]
    x = torch.cat(list(streams_u8), -1).permute(0, 3, 1, 2).float()
    _, _, h, w = x.shape
    s = params["scale"].float()
    x = torch.matmul(_interp_matrix(s, h)[:, None], x)
    x = torch.matmul(x, _interp_matrix(s, w).transpose(1, 2)[:, None])
    (s1, w1, p1, _), (s2, w2, p2, _), (s3, w3, p3, _) = shear_shifts(
        params, h, w, crop, max_angle)
    x = shear_rows(x, s1, w1, p1).transpose(2, 3)
    x = shear_rows(x, s2, w2, p2).transpose(2, 3)
    x = shear_rows(x, s3, w3, p3)
    x = torch.where(params["flip"][:, None, None, None], x.flip(-1), x)
    return torch.split(x * (2.0 / 255.0) - 1.0, splits, dim=1)
