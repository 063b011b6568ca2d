#!/usr/bin/env python3
"""GPU smoke run of the PyTorch/CUDA port (``shadow_removal_istd_tpu_torch``).

Run from the repository root on a machine with one CUDA card (Hopper,
``nvcc`` under ``$CUDA_HOME`` or ``/usr/local/cuda``)::

    python3 chip_smoke.py

Phases; any failure exits non-zero before the result line is printed:

1. build: compiles ``csrc/decoder_upsample.cu`` for ``sm_90a``, prints
   the card, its power limit and the compiler's register report;
2. kernel vs plain: the decoder kernel against its plain PyTorch version
   on the card at every MNet decoder step of a 256x256 and a 480x640
   input at ngf 64, batch 2, f32 and bf16, one-part and split-skip
   two-part forms (max abs 2e-5 in f32, 3e-2 in bf16);
3. serving: ``InferenceEngine`` (ngf 64, bf16, split-skip, seeded random
   weights) behind ``ShadowRemovalServer`` on loopback answers 4
   concurrent 480x640 PNG requests and one 256x256 (rows in all five PNG
   filter types, as clients' encoders choose them; the host's decode
   time per request is printed); replies decode to the right shapes,
   the kernel's launch count rises by 10 per stacked forward, and the
   kernel path's uint8 output is within 2 gray levels of the same
   engine forced onto the plain decoder;
4. timings (CUDA events): each decoder step's kernel output on the timed
   inputs held to its plain version (3e-2, bf16), then its time beside
   the plain version's, a cuDNN convolution of the same step and its
   bound, and stacked img/s at 256x256, batch 32, bf16.

The second-to-last line is the kernels' JSON summary, the line before it
``nvidia-smi``'s name and power limit, and the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import http.client
import importlib.util
import json
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

import numpy as np
import torch

PEAK_BF16 = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s
NGF = 64
DEVICE = "cuda"
TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
SOURCE = "shadow_removal_istd_tpu_torch/csrc/decoder_upsample.cu"
REPLACES = "shadow_removal_istd_tpu/ops/pallas_decoder.py:61"


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def decoder_steps(h: int, w: int, ngf: int = NGF):
    """The MNet decoder steps of an HxW input: (label, H, W, part
    channels, Co, final). ``final`` steps run without LeakyReLU and BN;
    the final step has Co 1 in G1 and 3 in G2."""
    f = [ngf, 2 * ngf, 4 * ngf, 8 * ngf]
    steps = [(f"{h // 32}x{w // 32} {f[3]}->{f[3]}", h // 32, w // 32,
              (f[3],), f[3], False)]
    for lvl in (2, 1, 0):
        s = 2 ** (lvl + 2)
        steps.append((f"{h // s}x{w // s} ({f[lvl + 1]}+{f[lvl + 1]})->"
                      f"{f[lvl]}", h // s, w // s, (f[lvl + 1],) * 2,
                      f[lvl], False))
    for co in (1, 3):
        steps.append((f"{h // 2}x{w // 2} ({ngf}+{ngf})->{co}", h // 2,
                      w // 2, (ngf, ngf), co, True))
    return steps


def step_inputs(n, h, w, parts, co, final, dtype, gen):
    """Random step inputs on the card; weights at LeCun scale so outputs
    stay O(1) at every width."""
    xs = [torch.randn(n, c, h, w, device=DEVICE, generator=gen).to(dtype)
          .contiguous(memory_format=torch.channels_last) for c in parts]
    ci = sum(parts)
    w4 = (torch.randn(2, 2, ci, 4 * co, device=DEVICE, generator=gen)
          / (4 * ci) ** 0.5).to(dtype)
    if final:
        return xs, w4, None, None
    s4 = (torch.rand(co, device=DEVICE, generator=gen) + 0.5).repeat(4)
    b4 = (torch.randn(co, device=DEVICE, generator=gen) * 0.1).repeat(4)
    return xs, w4, s4, b4


def step_cost(n, h, w, parts, co, final, elt):
    """(FLOPs, bytes) a decoder step must do and move: each input read
    once, each output written once."""
    ci = sum(parts)
    flops = 32 * n * h * w * ci * co
    nbytes = (n * h * w * ci * elt + 16 * ci * co * elt
              + (0 if final else 2 * 4 * co * 4) + n * 4 * h * w * co * elt)
    return flops, nbytes


def time_ms(fn, iters: int = 20) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_build():
    from shadow_removal_istd_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path, log = _build.build("decoder_upsample")
    _build.load("decoder_upsample")
    print(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if any(k in line for k in ("registers", "spill", "smem")):
            print(f"[ptxas] {line.strip()}")
    libs = ", ".join(
        f"{m} {'present' if importlib.util.find_spec(m) else 'absent'}"
        for m in ("cv2", "PIL"))
    print(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}"
          f", cuda {torch.version.cuda}, ninja "
          f"{shutil.which('ninja') or 'absent'}, {libs}")
    print(f"[card] {nvidia_smi()}")


def phase_kernel_vs_plain() -> dict:
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )

    gen = torch.Generator(device=DEVICE).manual_seed(0)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for h, w in ((256, 256), (480, 640)):
        for label, sh, sw, parts, co, final in decoder_steps(h, w):
            for dtype in (torch.float32, torch.bfloat16):
                xs, w4, s4, b4 = step_inputs(2, sh, sw, parts, co, final,
                                             dtype, gen)
                forms = [("concat", [torch.cat(xs, 1).contiguous(
                    memory_format=torch.channels_last)])]
                if len(xs) == 2:
                    forms.append(("split", xs))
                for form, args in forms:
                    kw = dict(leaky=not final, zero_pad=False)
                    got = decoder_upsample(args, w4, s4, b4, **kw)
                    want = decoder_upsample_plain(args, w4, s4, b4, **kw)
                    torch.cuda.synchronize()
                    err = (got.float() - want.float()).abs().max().item()
                    ok = err <= TOL[dtype] and got.shape == want.shape
                    worst[dtype] = max(worst[dtype], err)
                    print(f"[check] {h}x{w} step {label:<24} "
                          f"{str(dtype)[6:]:<8} {form:<6} max_abs_err "
                          f"{err:.3e} (tol {TOL[dtype]:.0e}) "
                          f"{'ok' if ok else 'FAIL'}")
                    if not ok:
                        raise SystemExit(f"kernel disagrees at {h}x{w} "
                                         f"{label} {dtype} {form}")
    # the ConvTranspose form (zero padding), f32, at the 16x16 step
    xs, w4, s4, b4 = step_inputs(2, 16, 16, (512, 512), 256, False,
                                 torch.float32, gen)
    got = decoder_upsample(xs, w4, s4, b4, leaky=True, zero_pad=True)
    want = decoder_upsample_plain(xs, w4, s4, b4, leaky=True, zero_pad=True)
    err = (got - want).abs().max().item()
    print(f"[check] zero-pad (ConvTranspose) form 16x16 f32 max_abs_err "
          f"{err:.3e}")
    if err > TOL[torch.float32]:
        raise SystemExit("kernel disagrees in the zero-pad form")
    return worst


def _post(addr, body, path="/v1/unshadow"):
    conn = http.client.HTTPConnection(*addr, timeout=300)
    try:
        conn.request("POST", path, body=body)
        resp = conn.getresponse()
        return resp.status, resp.read()
    finally:
        conn.close()


def phase_serving() -> int:
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )
    from shadow_removal_istd_tpu_torch.serving import (
        InferenceEngine,
        ShadowRemovalServer,
    )
    from shadow_removal_istd_tpu_torch.utils.image_io import (
        imdecode_color,
        png_decode,
        png_encode,
    )

    t0 = time.perf_counter()
    engine = InferenceEngine("mnet", ngf=NGF, dtype="bfloat16",
                             split_skip=True, max_batch=8, seed=0,
                             device=DEVICE)
    engine.warmup([(480, 640), (256, 256)], batch_sizes=[1, 4])
    print(f"[serve] engine ngf {NGF} bf16 split-skip built and warmed in "
          f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    imgs = [rng.integers(0, 256, (480, 640, 3), dtype=np.uint8)
            for _ in range(4)] + [rng.integers(0, 256, (256, 256, 3),
                                               dtype=np.uint8)]
    # RGB PNGs whose rows cycle through all five filter types, as a
    # client's libpng picks them adaptively (Average and Paeth included)
    bodies = [png_encode(np.ascontiguousarray(im[..., ::-1]),
                         np.arange(im.shape[0]) % 5) for im in imgs]
    for name, decode in (("server's decoder", imdecode_color),
                         ("stdlib codec", png_decode)):
        decode(bodies[0])
        t0 = time.perf_counter()
        for body in bodies[:4]:
            decode(body)
        print(f"[serve] host decode of one 480x640 request, {name}: "
              f"{(time.perf_counter() - t0) / 4 * 1e3:.2f} ms")
    srv = ShadowRemovalServer(engine, port=0, window_ms=50.0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        decoder_upsample.launches = 0
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=len(bodies)) as pool:
            replies = list(pool.map(lambda b: _post(srv.address, b), bodies))
        wall = time.perf_counter() - t0
        launches = decoder_upsample.launches
        snap = srv.stats.snapshot()
    finally:
        srv.shutdown()
        thread.join(timeout=10)
    for im, (status, body) in zip(imgs, replies):
        if status != 200:
            raise SystemExit(f"request failed with HTTP {status}: {body!r}")
        out = imdecode_color(body)
        if out.shape != im.shape:
            raise SystemExit(f"reply shape {out.shape} != {im.shape}")
    print(f"[serve] {len(replies)} concurrent requests (4x 480x640, "
          f"1x 256x256) answered in {wall:.3f} s; batches "
          f"{snap['batches']}, kernel launches {launches}")
    if launches == 0 or launches != 10 * snap["batches"]:
        raise SystemExit(f"expected 10 kernel launches per stacked "
                         f"forward, got {launches} for {snap['batches']}")
    got = engine.infer_group(imgs[:4])
    with mock.patch.object(layers, "decoder_upsample",
                           decoder_upsample_plain):
        want = engine.infer_group(imgs[:4])
    diff = max(int(np.abs(g.astype(np.int16) - p).max())
               for gp, pp in zip(got, want) for g, p in zip(gp, pp))
    print(f"[serve] kernel vs plain decoder, 480x640 batch 4 uint8: max "
          f"diff {diff} gray levels (limit 2)")
    if diff > 2:
        raise SystemExit("kernel path disagrees with the plain decoder")
    return launches


def phase_timings(worst_err: dict, launches: int) -> dict:
    from shadow_removal_istd_tpu_torch.models import layers
    from shadow_removal_istd_tpu_torch.ops.decoder import (
        decoder_upsample,
        decoder_upsample_plain,
    )
    from shadow_removal_istd_tpu_torch.serving import InferenceEngine

    gen = torch.Generator(device=DEVICE).manual_seed(1)
    dt = torch.bfloat16
    totals = {}
    for (h, w), n in (((256, 256), 32), ((480, 640), 4)):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                   ops_ms=0.0, bytes_ms=0.0)
        for label, sh, sw, parts, co, final in decoder_steps(h, w):
            xs, w4, s4, b4 = step_inputs(n, sh, sw, parts, co, final, dt,
                                         gen)
            kw = dict(leaky=not final, zero_pad=False)
            # the timed inputs, held to the plain version first
            err = (decoder_upsample(xs, w4, s4, b4, **kw).float()
                   - decoder_upsample_plain(xs, w4, s4, b4, **kw).float()
                   ).abs().max().item()
            worst_err[dt] = max(worst_err[dt], err)
            print(f"[check] {h}x{w} b{n} step {label:<24} bfloat16 "
                  f"{'split' if len(xs) == 2 else 'single'} max_abs_err "
                  f"{err:.3e} (tol {TOL[dt]:.0e}) "
                  f"{'ok' if err <= TOL[dt] else 'FAIL'}")
            if err > TOL[dt]:
                raise SystemExit(f"kernel disagrees at {h}x{w} b{n} {label}")
            ms = time_ms(lambda: decoder_upsample(xs, w4, s4, b4, **kw))
            plain = time_ms(
                lambda: decoder_upsample_plain(xs, w4, s4, b4, **kw))
            # the step's convolution alone, as one cuDNN call
            a = torch.nn.functional.pad(torch.cat(xs, 1), (1, 1, 1, 1),
                                        mode="replicate")
            k = w4.permute(3, 2, 0, 1).contiguous(
                memory_format=torch.channels_last)
            lib = time_ms(lambda: torch.nn.functional.conv2d(a, k))
            flops, nbytes = step_cost(n, sh, sw, parts, co, final, 2)
            t_ops, t_bytes = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BYTES * 1e3
            bound = max(t_ops, t_bytes)
            print(f"[time] {h}x{w} b{n} step {label:<24} kernel {ms:.4f} ms"
                  f" | plain {plain:.4f} | cudnn conv {lib:.4f} | bound "
                  f"{bound:.4f} ({'ops' if t_ops >= t_bytes else 'bytes'})"
                  f" | {flops / ms / 1e9:.1f} TFLOP/s")
            reps = 1 if final else 2        # G1 and G2 each run the step
            tot["ms"] += reps * ms
            tot["plain_ms"] += reps * plain
            tot["library_ms"] += reps * lib
            tot["bound_ms"] += reps * bound
            tot["ops_ms"] += reps * t_ops
            tot["bytes_ms"] += reps * t_bytes
        print(f"[time] {h}x{w} b{n} per stacked forward (10 launches): "
              f"kernel {tot['ms']:.4f} ms, plain {tot['plain_ms']:.4f}, "
              f"cudnn conv {tot['library_ms']:.4f}, bound "
              f"{tot['bound_ms']:.4f}")
        totals[(h, w)] = tot

    engine = InferenceEngine("mnet", ngf=NGF, dtype="bfloat16",
                             split_skip=True, max_batch=32, seed=0,
                             device=DEVICE)
    x = torch.randint(0, 256, (32, 256, 256, 3), dtype=torch.uint8,
                      device=DEVICE, generator=gen)
    ms = time_ms(lambda: engine._stacked(x), iters=10)
    with mock.patch.object(layers, "decoder_upsample",
                           decoder_upsample_plain):
        ms_plain = time_ms(lambda: engine._stacked(x), iters=10)
    print(f"[time] stacked G1+G2 256x256 b32 bf16: {32e3 / ms:.1f} img/s "
          f"({ms:.3f} ms/batch); plain decoder {32e3 / ms_plain:.1f} img/s "
          f"({ms_plain:.3f} ms/batch)")
    img = np.random.default_rng(1).integers(0, 256, (480, 640, 3),
                                            dtype=np.uint8)
    engine.infer_group([img] * 4)
    t0 = time.perf_counter()
    for _ in range(5):
        engine.infer_group([img] * 4)
    print(f"[time] infer_group 480x640 b4 bf16 (host included): "
          f"{(time.perf_counter() - t0) / 5 * 1e3:.2f} ms")
    profile_stacked(engine, x)

    t = totals[(256, 256)]
    return {"name": "decoder_upsample", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": launches,
            "max_abs_err": max(worst_err.values()),
            "max_abs_err_f32": worst_err[torch.float32],
            "ms": round(t["ms"], 5), "plain_ms": round(t["plain_ms"], 5),
            "bound_ms": round(t["bound_ms"], 5),
            "bound_by": ("operations" if t["ops_ms"] >= t["bytes_ms"]
                         else "bytes"),
            "library_ms": round(t["library_ms"], 5),
            "shape": "one stacked G1+G2 forward, 256x256, batch 32, bf16"}


def profile_stacked(engine, x) -> None:
    """Device time by kernel over one stacked forward (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    engine._stacked(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine._stacked(x)
        torch.cuda.synchronize()
    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    rows = [e for e in prof.key_averages() if dev_us(e) > 0]
    total = sum(dev_us(e) for e in rows)
    print(f"[profile] stacked 256x256 b32: device time {total / 1e3:.3f} ms "
          f"over {len(rows)} kernel names")
    for e in sorted(rows, key=lambda e: -dev_us(e))[:10]:
        print(f"[profile] {dev_us(e) / 1e3:9.3f} ms "
              f"{100 * dev_us(e) / max(total, 1):5.1f}% "
              f"x{e.count:<4} {e.key[:90]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    # f32 comparisons hold full f32: no TF32 in cuDNN or cuBLAS
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    phase_build()
    worst = phase_kernel_vs_plain()
    launches = phase_serving()
    kernel = phase_timings(worst, launches)
    print(f"[done] {time.perf_counter() - t0:.1f} s")
    print(nvidia_smi())
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
