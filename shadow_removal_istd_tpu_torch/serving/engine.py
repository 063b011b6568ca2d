"""Serving inference engine: bucketed stacked G1+G2 on one device.

Port of ``shadow_removal_istd_tpu/serving/engine.py::InferenceEngine``:

- **Any generator key.** ``mnet``, ``unet``, ``denseunet`` or ``stcgan``
  (pix2pix), each with its own default bucket multiple; UNet's up-convs
  run on the decoder kernel (K1), as MNet's decoder does.
- **Shape buckets.** Every request size is padded up to a bucket
  (multiples of ``pad_multiple`` per spatial dim) and the batch to a
  power of two, with pad value 128, i.e. ~0 after the reference's
  ``(x/255 - .5)*2`` normalization.
- **uint8 in, uint8 out.** Normalize -> G1 -> concat -> G2 ->
  denormalize -> uint8 all run on the device, which lays the answers out
  NHWC; the host moves uint8 only.
- **Page-locked staging** (replicas on a card): a dispatch's padded batch
  is assembled in a page-locked block from PyTorch's caching host
  allocator (the images copied in, 128 written only where they leave
  room) and uploaded by DMA with ``non_blocking``; the answers come back
  by DMA into page-locked blocks from the same allocator, and each
  request's answer is a crop view of them. The bytes cross the bus once
  each way, and no host pass touches them but the images' copy into the
  input block. A block is never written again while an answer views it:
  the allocator takes it back once the dispatch's last answer is
  dropped. On the CPU the answers are views of the outputs themselves.
- **bf16 by default.** Every float parameter and buffer is cast to
  bfloat16 (BatchNorm statistics included), as the JAX engine casts
  every leaf; ``dtype="float32"`` keeps exact-eval numerics.
- **int8** (``dtype="int8"``, the MNet nearest-upsample configuration):
  f32 master modules, BatchNorm folded, activation scales calibrated on
  ``calib_images`` (else seeded noise, with a warning), int8 packs
  (``models/quant.py``) whose convs run on the int8 kernels
  (``ops/int8_conv.py``) with bf16 elementwise work between them. The
  packs are built once the weights land (``set_variables``,
  ``load_weights``: a hot reload re-quantizes), or at the first
  ``infer_group`` of an engine that serves its random weights.

- **Several devices** (``devices``): a replica of the stacked pair on
  each device (a count: the first N cards, or N CPU replicas with
  ``device="cpu"``; a list may name one card twice). A coalesced batch
  is padded to a multiple of the replicas, each replica takes an equal
  slice on its device, and its answers land in its slice of the
  dispatch's output blocks. The JAX engine shards the batch over a data
  mesh the same way.

Weights load from the JAX package's per-network flax msgpack files or
from ``.npz`` files of the same tree.

:class:`ArtifactEngine` serves a ``torch.export`` artifact
(``tools/export.py``) with the same bucket, batch and uint8 surface,
running no model class: the graph carries the weights, and its decoder
steps are the registered op ``srit::decoder_upsample`` (the K1 kernels
on the card). Both engines share :class:`_EngineCore`, as in the JAX
package.
"""

from __future__ import annotations

import logging
import math

import numpy as np
import torch

from shadow_removal_istd_tpu_torch import resolve_device
from shadow_removal_istd_tpu_torch.engine.steps import infer_step
from shadow_removal_istd_tpu_torch.models import get_generator
from shadow_removal_istd_tpu_torch.models.layers import init_weights_
from shadow_removal_istd_tpu_torch.models.quant import (
    calibrate_mnet,
    fold_mnet,
    make_stacked_int8,
    quantize_mnet,
)
from shadow_removal_istd_tpu_torch.ops.augment import (
    denormalize,
    float_to_uint8,
)
from shadow_removal_istd_tpu_torch.parallel.pipeline import place
from shadow_removal_istd_tpu_torch.tools.convert import (
    flax_tree_to_torch,
    unflatten_tree,
)
from shadow_removal_istd_tpu_torch.tools.export import (
    input_signature,
    load_program,
)
from shadow_removal_istd_tpu_torch.utils.msgpack_codec import from_bytes
from shadow_removal_istd_tpu_torch.utils.profiling import (
    annotate,
    recording,
    span,
)

# Spatial divisibility each generator needs at its default depth (MNet,
# UNet and DenseUNet raise on indivisible sizes; the pix2pix 'stcgan' G
# pads internally but is bucketed anyway to bound the shapes it sees)
_DEFAULT_PAD = {"mnet": 32, "unet": 16, "denseunet": 32, "stcgan": 32}
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.float32}   # int8 keeps f32 master weights


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _to_u8(t: torch.Tensor) -> torch.Tensor:
    """[-1, 1] NCHW -> contiguous uint8 NHWC, through f32."""
    u8 = float_to_uint8(denormalize(t.float()))
    return u8.permute(0, 2, 3, 1).contiguous()


def _host_block(shape: tuple, pinned: bool) -> torch.Tensor:
    """A fresh uint8 host tensor, page-locked from PyTorch's caching host
    allocator where ``pinned`` (its contents are stale bytes)."""
    return torch.empty(shape, dtype=torch.uint8, pin_memory=pinned)


def _assemble(batch: np.ndarray, imgs: list[np.ndarray]) -> None:
    """Pad ``imgs`` into ``batch`` (bp, bh, bw, 3) with 128, writing
    every byte once: each image into its corner, 128 into its margins
    right and below and into the rows past the images."""
    bh, bw = batch.shape[1:3]
    for i, im in enumerate(imgs):
        h, w = im.shape[:2]
        batch[i, :h, :w] = im
        if w < bw:
            batch[i, :h, w:] = 128
        if h < bh:
            batch[i, h:] = 128
    batch[len(imgs):] = 128


def _pinned_allocs() -> int | None:
    """Page-locked blocks PyTorch's caching host allocator has made so
    far, where this torch counts them."""
    stats = getattr(torch.cuda, "host_memory_stats", None)
    return None if stats is None else stats().get("num_host_alloc")


def serving_devices(devices, device: torch.device) -> list[torch.device]:
    """The replicas' devices: ``[device]`` for None or 1; a count N: the
    first N cards (``device`` on the card) or N times the CPU; a list:
    its devices."""
    if devices is None:
        return [device]
    if isinstance(devices, int):
        if devices < 1:
            raise ValueError(f"devices must be >= 1, got {devices}")
        if device.type != "cuda":
            return [device] * devices
        if devices > torch.cuda.device_count():
            raise ValueError(f"devices={devices}: the host has "
                             f"{torch.cuda.device_count()} cards")
        return [torch.device("cuda", i) for i in range(devices)]
    return [resolve_device(d) for d in devices]


class _EngineCore:
    """The bucketed dispatch both engines share: pad a same-bucket group
    to a device batch, split it over the replicas, run the stacked
    forward, crop each image's answer back.

    Subclasses provide ``bucket_of(h, w)``, ``max_batch``, ``devices``
    and ``_stacked(x_u8, replica) -> (matte_u8, shadow_free_u8)``, NHWC
    uint8 in and contiguous NHWC uint8 out; ``fixed_batch`` (a
    pinned-batch artifact) fixes the device batch."""

    fixed_batch: int | None = None

    def infer_group(self, imgs: list[np.ndarray]
                    ) -> list[tuple[np.ndarray, np.ndarray]]:
        """Run one batched dispatch over same-bucket images.

        ``imgs``: HxWx3 uint8 BGR arrays whose sizes map to ONE bucket.
        Returns per image ``(matte HxW uint8, shadow_free HxWx3 uint8
        BGR)`` cropped back to the original size: views of the dispatch's
        output blocks, which no later dispatch writes.

        Where the replicas are on cards, the host's work is the images'
        copy into a page-locked input block (128 only in the margins and
        spare rows), enqueueing the DMA copies each way, and waiting on
        an event recorded after the copies into the page-locked output
        blocks (one replica's slice each). On the CPU the answers view the
        forward's NHWC outputs. While tracing is on
        (``utils/profiling.py``) it records the spans ``engine.assemble``,
        ``engine.upload``, ``engine.forward`` (the launch),
        ``engine.download`` (the copies to the host, which wait for the
        forward) and ``engine.unpack`` (the crops), and on the caller's
        span the padded batch, ``staging`` (``"pinned"`` or ``"none"``)
        and, where this torch counts them, ``pinned_allocs``: the new
        page-locked blocks the dispatch made."""
        if not imgs:
            return []
        buckets = {self.bucket_of(im.shape[0], im.shape[1]) for im in imgs}
        if len(buckets) != 1:
            raise ValueError(f"mixed buckets in one group: {buckets}")
        bh, bw = buckets.pop()
        n = len(imgs)
        nd = len(self.devices)
        if self.fixed_batch is not None:
            if n > self.fixed_batch:
                raise ValueError(f"group of {n} exceeds the artifact's "
                                 f"pinned batch {self.fixed_batch}")
            bp = self.fixed_batch
        else:
            bp = min(_next_pow2(n), max(self.max_batch, n))
            bp = math.ceil(bp / nd) * nd      # equal per-replica slices
        pinned = any(d.type == "cuda" for d in self.devices)
        annotate(padded=bp, staging="pinned" if pinned else "none")
        allocs = _pinned_allocs() if pinned and recording() else None
        with span("engine.assemble"):
            block = _host_block((bp, bh, bw, 3), pinned)
            _assemble(block.numpy(), imgs)
        b = bp // nd
        # every replica's work is enqueued before any answer is read
        outs = []
        for j, d in enumerate(self.devices):
            with span("engine.upload"):
                x = block[j * b:(j + 1) * b].to(d, non_blocking=pinned)
            with span("engine.forward"):
                outs.append(self._stacked(x, j))
        del block, x    # the allocator reuses it once the uploads finish
        with span("engine.download"):
            if nd == 1 and not pinned:
                m_host, y_host = outs[0]
            else:
                m_host = _host_block((bp, bh, bw, 1), pinned)
                y_host = _host_block((bp, bh, bw, 3), pinned)
                done = []
                for j, (d, (m, y)) in enumerate(zip(self.devices, outs)):
                    m_host[j * b:(j + 1) * b].copy_(m, non_blocking=pinned)
                    y_host[j * b:(j + 1) * b].copy_(y, non_blocking=pinned)
                    if d.type == "cuda":
                        done.append(torch.cuda.Event())
                        done[-1].record(torch.cuda.current_stream(d))
                for event in done:
                    event.synchronize()
        with span("engine.unpack"):
            m_np, y_np = m_host.numpy(), y_host.numpy()
            answers = [(m_np[i, :im.shape[0], :im.shape[1], 0],
                        y_np[i, :im.shape[0], :im.shape[1]])
                       for i, im in enumerate(imgs)]
        if allocs is not None:
            annotate(pinned_allocs=_pinned_allocs() - allocs)
        return answers

    def warmup(self, sizes: list[tuple[int, int]],
               batch_sizes: list[int] | None = None) -> None:
        """Run the (bucket, batch) grid once so first requests don't pay
        the kernel build and cuDNN's algorithm search."""
        for h, w in sizes:
            for b in (batch_sizes or [1, self.max_batch]):
                dummy = np.full((h, w, 3), 128, np.uint8)
                self.infer_group([dummy] * b)


class InferenceEngine(_EngineCore):
    """Stacked shadow-removal inference over shape buckets.

    Thread-safety: ``infer_group`` may be called from one thread at a
    time (the serving batcher funnels all device work through one
    thread); construction and weight loading are not thread-safe.
    """

    def __init__(self, net_g: str = "mnet", *, ngf: int = 64,
                 droprate: float = 0.0, nn_upconv: bool = True,
                 use_selu: bool = False, activation: str = "tanh",
                 dtype: str = "bfloat16", split_skip: bool = True,
                 pad_multiple: int | None = None, max_batch: int = 8,
                 devices=None, seed: int = 0,
                 calib_images: list[np.ndarray] | None = None,
                 device: str | torch.device = "cuda"):
        if dtype not in _DTYPES:
            raise ValueError(
                f"dtype must be float32|bfloat16|int8, got {dtype}")
        if dtype == "int8" and (net_g.lower() != "mnet" or not nn_upconv
                                or use_selu):
            # the PTQ fold supports the MNet nearest-upsample family
            # (models/quant.py)
            raise ValueError(
                "dtype=int8 supports the MNet nearest-upsample "
                "configuration (net_g=mnet, nn_upconv, no SELU); "
                "serve other configurations in bfloat16")
        self.device = resolve_device(device)
        self.devices = serving_devices(devices, self.device)
        if dtype == "int8" and len(self.devices) > 1:
            raise ValueError("dtype=int8 is single-device; combine with "
                             "--devices via bfloat16 instead")
        self.device = self.devices[0]
        self.dtype = dtype
        self.net_g = net_g.lower()
        self._g_kw = dict(ngf=ngf, drop_rate=droprate, no_conv_t=nn_upconv,
                          use_selu=use_selu, activation=activation)
        if self.net_g == "mnet":
            self._g_kw["split_skip"] = split_skip
        self.activation = activation
        self._calib_u8 = calib_images
        self._int8_fn = None    # built from the weights that land
        # G1: shadow image -> matte; G2: image ++ matte -> shadow-free
        g1, g2 = self._new_pair()
        gen = torch.Generator().manual_seed(seed)
        init_weights_(g1, gen)
        init_weights_(g2, gen)
        self._adopt(g1, g2)
        self.pad_multiple = int(pad_multiple or _DEFAULT_PAD[self.net_g])
        self.max_batch = int(max_batch)

    # -- weights ------------------------------------------------------

    def _new_pair(self):
        return (get_generator(self.net_g, in_channels=3, out_channels=1,
                              **self._g_kw),
                get_generator(self.net_g, in_channels=4, out_channels=3,
                              **self._g_kw))

    def _adopt(self, g1, g2) -> None:
        for g in (g1, g2):
            g.to(device=self.device, dtype=_DTYPES[self.dtype])
            g.eval().requires_grad_(False)
            if hasattr(g, "freeze"):   # MNet: the weights are fixed now
                g.freeze()
        self.g1, self.g2 = g1, g2
        # one replica of the pair per device (the first is g1, g2)
        self.replicas = [(place(g1, d), place(g2, d)) for d in self.devices]

    def set_variables(self, v1: dict, v2: dict) -> None:
        """Adopt JAX variable trees ``{"params", "batch_stats"}`` per net
        (nested dicts of numpy arrays) through ``tools/convert.py``.
        Atomic: both trees load into fresh modules before either is
        swapped in, so a bad tree leaves the engine unchanged."""
        g1, g2 = self._new_pair()
        flax_tree_to_torch(v1, g1)
        flax_tree_to_torch(v2, g2)
        self._adopt(g1, g2)
        self._maybe_quantize()

    @staticmethod
    def _read_tree(path: str) -> dict:
        if path.endswith(".msgpack"):
            with open(path, "rb") as f:
                return from_bytes(f.read())
        with np.load(path, allow_pickle=False) as z:
            return unflatten_tree({tuple(k.split("/")): z[k]
                                   for k in z.files})

    def load_weights(self, g1_path: str, g2_path: str) -> None:
        """Load per-network weight files: the JAX package's flax msgpack
        files (``G1_MNet_best.msgpack``, ``{"params", "batch_stats"}``),
        or ``.npz`` files whose keys are the flax variable paths joined
        by ``/`` (e.g. ``params/_Down_0/BatchNorm_0/scale``). Atomic, as
        :meth:`set_variables`."""
        self.set_variables(self._read_tree(g1_path),
                           self._read_tree(g2_path))

    # -- int8 serving -------------------------------------------------

    def _calib_batches(self) -> list[torch.Tensor]:
        """[-1, 1] f32 calibration batches for the activation scales.

        Real images (``calib_images``) give representative ranges, each
        padded into its bucket with 128 as served; without them seeded
        noise is used, loudly, because underestimated scales clip real
        activations."""
        if self._calib_u8:
            out = []
            for im in self._calib_u8:
                bh, bw = self.bucket_of(im.shape[0], im.shape[1])
                pad = np.full((1, bh, bw, 3), 128, np.uint8)
                pad[0, :im.shape[0], :im.shape[1]] = im
                x = pad.astype(np.float32) * (2.0 / 255.0) - 1.0
                out.append(torch.from_numpy(x).permute(0, 3, 1, 2)
                           .to(self.device))
            return out
        logging.getLogger(__name__).warning(
            "int8 serving calibrated on synthetic noise — pass real "
            "images (calib_images / --int8-calib) for representative "
            "activation scales")
        gen = torch.Generator().manual_seed(11)
        return [(torch.rand((2, 3, 256, 256), generator=gen) * 2 - 1)
                .to(self.device)]

    @torch.inference_mode()
    def _maybe_quantize(self) -> None:
        """(Re)build the int8 stacked fn from the CURRENT f32 weights:
        called after every weight swap, so a hot reload re-quantizes."""
        if self.dtype != "int8":
            return
        f1, f2 = fold_mnet(self.g1), fold_mnet(self.g2)
        batches = self._calib_batches()
        s1, m1 = calibrate_mnet(f1, batches, activation=self.activation,
                                return_outputs=True)
        g2_in = [torch.cat([x, m], 1) for x, m in zip(batches, m1)]
        s2 = calibrate_mnet(f2, g2_in, activation=self.activation)
        self._int8_fn = make_stacked_int8(
            quantize_mnet(f1, s1), quantize_mnet(f2, s2),
            activation=self.activation)

    # -- inference ----------------------------------------------------

    @torch.inference_mode()
    def _stacked(self, x_u8: torch.Tensor, replica: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        # reference normalization: uint8/255 in [0,1], then (x-.5)*2
        x = x_u8.permute(0, 3, 1, 2).float() * (2.0 / 255.0) - 1.0
        if self.dtype == "int8":
            if self._int8_fn is None:   # serving its random weights
                self._maybe_quantize()
            m, y = self._int8_fn(x)
        else:
            m, y = infer_step(*self.replicas[replica], x)
        return _to_u8(m), _to_u8(y)

    def bucket_of(self, h: int, w: int) -> tuple[int, int]:
        m = self.pad_multiple
        return (math.ceil(h / m) * m, math.ceil(w / m) * m)


class ArtifactEngine(_EngineCore):
    """Serve a ``torch.export`` artifact (``tools/export.py``) directly.

    No model class runs on this path: the artifact carries the stacked
    graph with the trained weights inside; this engine wraps it with
    :class:`InferenceEngine`'s uint8-in/uint8-out device pipeline
    (normalize before the graph, quantize after) and its bucket/batcher
    surface. The input signature ``(b, h, w, 3)`` and its dtype come
    from the artifact: every request must fit inside the exported
    (H, W) (smaller images are mid-gray padded and cropped back), and a
    pinned batch fixes the device batch. Weights are part of the
    artifact, so there is no ``load_weights``: serve a new artifact
    instead. Raises without a card unless ``device="cpu"``."""

    def __init__(self, path: str, *, max_batch: int = 8,
                 device: str | torch.device = "cuda"):
        self.device = resolve_device(device)
        self.devices = [self.device]
        ep = load_program(path, self.device)
        (b, h, w, c), self._in_dtype = input_signature(ep)
        if c != 3:
            raise ValueError(f"expected an NHWC/3 artifact, got "
                             f"{(b, h, w, c)}")
        self.height, self.width = int(h), int(w)
        self.fixed_batch = b if isinstance(b, int) else None
        self.max_batch = self.fixed_batch or int(max_batch)
        self.dtype = str(self._in_dtype).removeprefix("torch.")
        self._fn = ep.module()

    @torch.inference_mode()
    def _stacked(self, x_u8: torch.Tensor, replica: int = 0
                 ) -> tuple[torch.Tensor, torch.Tensor]:
        x = x_u8.float() * (2.0 / 255.0) - 1.0
        m, y = self._fn(x.to(self._in_dtype))
        # NHWC already: the artifact's outputs are the JAX interface
        return (float_to_uint8(denormalize(m.float())).contiguous(),
                float_to_uint8(denormalize(y.float())).contiguous())

    def bucket_of(self, h: int, w: int) -> tuple[int, int]:
        if h > self.height or w > self.width:
            raise ValueError(
                f"image {h}x{w} exceeds the artifact's exported "
                f"{self.height}x{self.width}; re-export with a larger "
                "--shape")
        return (self.height, self.width)
