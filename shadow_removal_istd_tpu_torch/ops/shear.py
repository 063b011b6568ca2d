"""Per-row fractional shear and the fast (3-shear) augmentation path,
with the shear's CUDA kernel and its plain version.

Port of ``shadow_removal_istd_tpu/ops/pallas_shear.py``. A rotation
decomposes into three shears, R(t) = ShearX(-tan(t/2)) . ShearY(sin t) .
ShearX(-tan(t/2)), and a shear is a per-row constant fractional
translation: :func:`hshear`. The vertical shear runs as a horizontal one
on the transposed image; the passes before it write their output
transposed (``transpose_out``), so no transpose copy runs between them.

Layout: images are (B, C, H, W) f32 throughout (the JAX functions take
and return NHWC at their ends; the port's models take NCHW, so
:func:`shear_rotate_crop` and :func:`fused_augment_shear` return NCHW).
A CUDA tensor goes to the kernel (``csrc/hshear.cu``); a CPU tensor to
:func:`hshear_plain`, which is the kernel's spec.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch
import torch.nn.functional as F

from shadow_removal_istd_tpu_torch.ops import _build


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _taps(img: torch.Tensor, shifts: torch.Tensor, out_w: int,
          pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Check the arguments; (kint int32, frac f32), each (B, H), formed
    as the JAX ``hshear`` forms them: ``src = shift + pad``, ``kint =
    clip(floor(src), 0, W0 + 2*pad - out_w - 1)``, ``frac = src -
    floor(src)`` from the UNCLIPPED ``src``."""
    if img.dim() != 4 or img.dtype != torch.float32:
        raise ValueError(f"img must be (B, C, H, W) float32, got "
                         f"{tuple(img.shape)} {img.dtype}")
    bsz, _, h, w0 = img.shape
    if (shifts.shape != (bsz, h) or shifts.dtype != torch.float32
            or shifts.device != img.device):
        raise ValueError(f"shifts must be ({bsz}, {h}) float32 on "
                         f"{img.device}, got {tuple(shifts.shape)} "
                         f"{shifts.dtype} on {shifts.device}")
    hi = w0 + 2 * pad - out_w - 1
    if out_w < 1 or pad < 0 or hi < 0:
        raise ValueError(f"out_w={out_w} must be in [1, W0 + 2*pad) with "
                         f"pad={pad} >= 0 and W0={w0}")
    src = shifts + pad
    fl = torch.floor(src)
    kint = torch.clamp(fl, 0, hi).to(torch.int32)
    return kint, src - fl


def _lerp_plain(img: torch.Tensor, kint: torch.Tensor, frac: torch.Tensor,
                out_w: int, pad: int) -> torch.Tensor:
    bsz, c, h, _ = img.shape
    padded = F.pad(img, (pad, pad))
    idx = (kint.long()[:, None, :, None]
           + torch.arange(out_w, device=img.device)).expand(bsz, c, h, out_w)
    a = torch.gather(padded, 3, idx)
    b = torch.gather(padded, 3, idx + 1)
    f = frac[:, None, :, None]
    return a * (1.0 - f) + b * f


def _layout(out: torch.Tensor, transpose_out: bool) -> torch.Tensor:
    return out.transpose(2, 3).contiguous() if transpose_out else out


def hshear_plain(img: torch.Tensor, shifts: torch.Tensor, out_w: int,
                 pad: int, *, transpose_out: bool = False) -> torch.Tensor:
    """The kernel's spec in plain PyTorch: zero-pad the rows by ``pad``,
    gather columns ``k+j`` and ``k+j+1``, lerp in the JAX order
    ``a*(1-f) + b*f`` (separate ops, so the card rounds as the kernel);
    with ``transpose_out``, then laid out as (B, C, out_w, H)."""
    kint, frac = _taps(img, shifts, out_w, pad)
    return _layout(_lerp_plain(img, kint, frac, out_w, pad), transpose_out)


@functools.cache
def _kernel_fn():
    """The kernel's C entry point (built on first use), typed once."""
    fn = _build.load("hshear").srit_hshear
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    return fn


def hshear(img: torch.Tensor, shifts: torch.Tensor, out_w: int,
           pad: int, *, transpose_out: bool = False) -> torch.Tensor:
    """Batched horizontal fractional shear.

    img: (B, C, H, W0) float32, UNPADDED. shifts: (B, H) float32, the
    source x of output column 0 of each row in image coordinates (values
    in [-pad, W0 + pad - out_w] reach into a zero border of ``pad``
    columns). Returns (B, C, H, out_w): ``out[..., r, j]`` samples source
    column ``shifts[r] + j`` linearly; with ``transpose_out`` the same
    values as (B, C, out_w, H), the layout the next pass of
    :func:`shear_rotate_crop` shears (the kernel writes it directly).

    CUDA tensors launch the kernel (counted in ``hshear.launches``); CPU
    tensors take :func:`hshear_plain`; any other device raises."""
    kint, frac = _taps(img, shifts, out_w, pad)
    kind = img.device.type
    if kind == "cpu":
        return _layout(_lerp_plain(img, kint, frac, out_w, pad),
                       transpose_out)
    if kind != "cuda":
        raise ValueError(f"hshear runs on cuda or cpu, not {kind}")
    if not img.is_contiguous():
        raise ValueError("hshear's kernel takes a contiguous img")
    out = launch(img, kint.contiguous(), frac.contiguous(), out_w, pad,
                 transpose_out)
    _HSHEAR.launches += 1
    return out


def launch(img: torch.Tensor, kint: torch.Tensor, frac: torch.Tensor,
           out_w: int, pad: int, transpose_out: bool = False
           ) -> torch.Tensor:
    """One kernel launch on formed taps (contiguous CUDA tensors, as
    :func:`hshear` checks and forms them); uncounted, for timing the
    kernel alone. The C entry picks its instance by shape and alignment
    (16-byte or 4-byte input copies; float4 or scalar stores)."""
    bsz, c, h, w0 = img.shape
    shape = (bsz, c, out_w, h) if transpose_out else (bsz, c, h, out_w)
    out = torch.empty(shape, dtype=torch.float32, device=img.device)
    with torch.cuda.device(img.device):
        rc = _kernel_fn()(img.data_ptr(), kint.data_ptr(), frac.data_ptr(),
                          out.data_ptr(), bsz, c, h, w0, out_w, pad,
                          int(transpose_out),
                          torch.cuda.current_stream(img.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"hshear kernel launch failed (cudaError {rc})")
    return out


hshear.launches = 0
_HSHEAR = hshear    # owns the count even where `hshear` is wrapped


def _scale_matrix(s: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n, n) center-anchored linear-interp resampling matrices for
    per-sample isotropic scale ``s`` (hat weights; zero border)."""
    i = torch.arange(n, dtype=torch.float32, device=s.device)
    center = (n - 1) / 2.0
    src = (i[None, :] - center) / s[:, None] + center          # (B, n)
    return torch.clamp(1.0 - torch.abs(src[:, :, None] - i[None, None, :]),
                       0.0, 1.0)


def scale_center(img: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Per-sample center scale of (B, C, H, W) f32 via two batched
    matmuls (run them in full f32: TF32 off on the card)."""
    _, _, h, w = img.shape
    wr = _scale_matrix(s, h)                                   # (B, H, H)
    wc = _scale_matrix(s, w)                                   # (B, W, W)
    x = torch.matmul(wr[:, None], img)                 # rows: sum_i wr*img
    return torch.matmul(x, wc.transpose(1, 2)[:, None])        # columns


def shear_geometry(h: int, w: int, max_angle_deg: float
                   ) -> tuple[int, int, int, int, int]:
    """``(margin, wx, pad1, pad2, pad3)`` of :func:`shear_rotate_crop`
    (the JAX sizing, exactly): the worst-case shifts at ``max_angle_deg``
    size the three passes' zero borders and the intermediate canvas,
    widened by ``margin`` on both sides to ``wx`` columns."""
    t_max = math.radians(min(abs(max_angle_deg), 89.0))
    a_max = math.tan(t_max / 2.0)
    b_max = math.sin(t_max)
    margin = _round_up(math.ceil(a_max * h / 2.0) + 2, 4)
    wx = w + 2 * margin
    return margin, wx, 2 * margin, math.ceil(b_max * wx / 2.0) + 4, 4


def shear_rotate_crop(img: torch.Tensor, angle_deg: torch.Tensor,
                      row_off: torch.Tensor, col_off: torch.Tensor,
                      crop: int, max_angle_deg: float = 15.0
                      ) -> torch.Tensor:
    """Rotation about the image center + crop via three shear passes.

    img: (B, C, H, W) float32; angle_deg/row_off/col_off: (B,);
    ``max_angle_deg`` is the static bound on |angle_deg| that sizes the
    zero padding. Returns (B, C, crop, crop)."""
    _, _, h, w = img.shape
    theta = torch.deg2rad(angle_deg.float())
    a = -torch.tan(theta / 2.0)                 # x-shear coefficient
    b = torch.sin(theta)                        # y-shear coefficient
    cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
    margin, wx, pad1, pad2, pad3 = shear_geometry(h, w, max_angle_deg)
    dev = img.device
    ro = row_off.float()

    # pass 1: x-shear onto the expanded canvas (true x = c - margin),
    # written transposed for pass 2
    rows = torch.arange(h, dtype=torch.float32, device=dev)
    s1 = a[:, None] * (rows[None, :] - cy) - margin            # (B, H)
    x = hshear(img.contiguous(), s1, wx, pad1,
               transpose_out=True)                             # (B,C,Wx,H)

    # pass 2: y-shear as an x-shear of the transpose, cropping rows,
    # written transposed back for pass 3
    cols = torch.arange(wx, dtype=torch.float32, device=dev) - margin
    s2 = b[:, None] * (cols[None, :] - cx) + ro[:, None]       # (B, Wx)
    x = hshear(x, s2, crop, pad2, transpose_out=True)          # (B,C,crop,Wx)

    # pass 3: final x-shear + column crop off the expanded canvas
    rows_c = torch.arange(crop, dtype=torch.float32, device=dev)
    abs_rows = rows_c[None, :] + ro[:, None]
    s3 = (a[:, None] * (abs_rows - cy) + col_off.float()[:, None]
          + margin)                                            # (B, crop)
    return hshear(x, s3, crop, pad3)


def fused_augment_shear(stacked_u8: torch.Tensor, params: dict,
                        crop: int, max_angle_deg: float = 15.0
                        ) -> torch.Tensor:
    """Scale -> rotate -> flip -> crop -> [-1, 1], the reference's
    transform order.

    stacked_u8: (B, H, W, C) uint8 (channel-concatenated streams, as they
    are stored). params: ``ops/augment.sample_augment_params``'s dict.
    Returns (B, C, crop, crop) float32 in [-1, 1]."""
    _, _, w, _ = stacked_u8.shape
    x = stacked_u8.permute(0, 3, 1, 2).float()
    x = scale_center(x, params["scale"].float())
    # flip before crop: crop(flip(J), ro, co) == flip_cols(crop(J, ro,
    # W - crop - co))
    flip = params["flip"]
    co = torch.where(flip, (w - crop) - params["col_off"], params["col_off"])
    out = shear_rotate_crop(x, params["angle"], params["row_off"], co, crop,
                            max_angle_deg=max_angle_deg)
    out = torch.where(flip[:, None, None, None], out.flip(-1), out)
    return out * (2.0 / 255.0) - 1.0
