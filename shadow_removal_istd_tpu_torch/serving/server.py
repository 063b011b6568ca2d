"""Online serving: micro-batching HTTP front-end over InferenceEngine.

Port of ``shadow_removal_istd_tpu/serving/server.py``: a dependency-free
(stdlib ``http.server``) daemon that

- accepts encoded images over HTTP and answers with the shadow-free
  image and/or the shadow matte as PNG,
- **micro-batches** concurrent requests: all requests arriving within
  ``--batch-window-ms`` of the first are grouped (per shape bucket, up
  to ``--max-batch``) into one device dispatch, amortizing the
  per-dispatch cost, and
- funnels ALL device work through one batcher thread, so HTTP
  concurrency never races the device.

Endpoints:
  POST /v1/unshadow[?output=shadowless|matte]  image bytes -> PNG
  POST /admin/reload                           {"g1","g2"} weight paths
                                               -> zero-downtime reload
  GET  /healthz                                liveness + device
  GET  /stats                                  counters + latency
                                               percentiles (JSON)

Run: ``python -m shadow_removal_istd_tpu_torch.serving
--load-weights-g1 G1_MNet_best.msgpack --load-weights-g2
G2_MNet_best.msgpack`` (flax msgpack weight files, as either package's
trainer writes them, or ``.npz``; ``--device cpu`` to run without a
card). ``--dtype int8 --int8-calib DIR`` serves the int8-quantized MNet
pair, its activation scales calibrated on DIR's images. ``--artifact
model.pt2`` serves a ``torch.export`` artifact (``tools/export.py``) on
``--device``; its weights are baked in, so ``/admin/reload`` answers
501.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import logging
import os
import queue
import signal
import threading
import time
from concurrent.futures import Future
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

import numpy as np
import torch

from shadow_removal_istd_tpu_torch.serving.engine import (
    ArtifactEngine,
    InferenceEngine,
)
from shadow_removal_istd_tpu_torch.utils.image_io import (
    imdecode_color,
    imencode_png,
    imread_color,
)
from shadow_removal_istd_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)


class OverloadedError(RuntimeError):
    """Raised by MicroBatcher.submit when the queue is at capacity —
    the server answers 503 + Retry-After instead of letting host
    memory and queue latency grow without bound."""


class ServerStats:
    """Thread-safe request/batch counters + latency reservoir."""

    def __init__(self, window: int = 2048):
        self._lock = threading.Lock()
        self.requests = 0
        self.errors = 0
        self.batches = 0
        self.images = 0
        self.max_batch = 0
        self.shed = 0      # 503s: queue full at admission
        self.expired = 0   # dropped: deadline passed while queued
        self._lat_ms = collections.deque(maxlen=window)

    def record_batch(self, n: int) -> None:
        with self._lock:
            self.batches += 1
            self.images += n
            self.max_batch = max(self.max_batch, n)

    def record_shed(self) -> None:
        with self._lock:
            self.shed += 1

    def record_expired(self) -> None:
        with self._lock:
            self.expired += 1

    def record_request(self, latency_ms: float, error: bool) -> None:
        with self._lock:
            self.requests += 1
            if error:
                self.errors += 1
            else:
                self._lat_ms.append(latency_ms)

    def snapshot(self) -> dict:
        with self._lock:
            lat = np.asarray(self._lat_ms, np.float64)
            out = {"requests": self.requests, "errors": self.errors,
                   "batches": self.batches, "images": self.images,
                   "max_batch": self.max_batch,
                   "shed": self.shed, "expired": self.expired}
        if lat.size:
            out["latency_ms"] = {
                "p50": round(float(np.percentile(lat, 50)), 2),
                "p90": round(float(np.percentile(lat, 90)), 2),
                "p99": round(float(np.percentile(lat, 99)), 2),
            }
        return out


class MicroBatcher:
    """Group concurrent requests into one dispatch per shape bucket.

    One daemon thread owns the engine: it blocks on the queue, then
    drains further requests for ``window_ms`` (bounded by
    ``max_batch``), groups them by bucket, and resolves each request's
    Future. A window of 0 degenerates to one-dispatch-per-request.
    While tracing is on (``utils/profiling.py``) the thread records
    ``batcher.take`` (the blocking get through the window),
    ``batcher.dispatch`` per bucket group (its ``dispatch`` id,
    ``images`` and the engine's ``padded`` batch; the engine's spans
    inside it) and ``batcher.resolve`` (the futures).
    """

    _CLOSE = object()

    class _Control:
        """A callable to run ON the batcher thread (which owns the
        engine) between batches — e.g. a weight hot-reload."""

        __slots__ = ("fn", "fut")

        def __init__(self, fn):
            self.fn = fn
            self.fut: Future = Future()

    def __init__(self, engine: InferenceEngine, *,
                 window_ms: float = 5.0, stats: ServerStats | None = None,
                 max_queue: int | None = None,
                 deadline_s: float = 600.0):
        self.engine = engine
        self.window_s = window_ms / 1e3
        self.stats = stats or ServerStats()
        # admission control: beyond this depth a burst can only add
        # latency the client will time out on anyway — shed instead.
        # Default: 8 full batches of headroom.
        self.max_queue = (int(max_queue) if max_queue is not None
                          else 8 * engine.max_batch)
        self.deadline_s = deadline_s
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._depth = 0
        self._depth_lock = threading.Lock()
        self._dispatches = itertools.count()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="srit-batcher")
        self._thread.start()

    @property
    def depth(self) -> int:
        with self._depth_lock:
            return self._depth

    def submit(self, img_bgr_u8: np.ndarray) -> Future:
        """Enqueue one HxWx3 uint8 image; resolves to (matte, shadowless).

        Raises :class:`OverloadedError` when the queue is at capacity
        (admission control — the 503 path)."""
        with self._depth_lock:
            if self._depth >= self.max_queue:
                self.stats.record_shed()
                raise OverloadedError(
                    f"queue at capacity ({self.max_queue})")
            self._depth += 1
        fut: Future = Future()
        self._q.put((img_bgr_u8, fut,
                     time.monotonic() + self.deadline_s))
        return fut

    def _take_data(self, item) -> tuple | None:
        """Account a dequeued data item; drop it (resolving its future
        with TimeoutError) when its deadline passed while queued — the
        client is gone, device time on it would be pure waste."""
        with self._depth_lock:
            self._depth -= 1
        img, fut, deadline = item
        if time.monotonic() >= deadline:
            self.stats.record_expired()
            fut.set_exception(TimeoutError("expired while queued"))
            return None
        return (img, fut)

    def run_on_batcher(self, fn) -> Future:
        """Execute ``fn()`` on the batcher thread between batches and
        return a Future of its result. The batcher thread owns the
        engine, so engine mutation (weight reload) must go through
        here — never from an HTTP handler thread mid-dispatch."""
        ctl = self._Control(fn)
        self._q.put(ctl)
        return ctl.fut

    def close(self) -> None:
        self._q.put(self._CLOSE)
        self._thread.join(timeout=10)

    def _drain(self, first) -> list | None:
        batch = [first]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.engine.max_batch:
            timeout = deadline - time.monotonic()
            if timeout <= 0:
                break
            try:
                item = self._q.get(timeout=timeout)
            except queue.Empty:
                break
            if item is self._CLOSE or isinstance(item, self._Control):
                self._q.put(item)  # re-post for the outer loop
                break
            entry = self._take_data(item)
            if entry is not None:
                batch.append(entry)
        return batch

    def _run_control(self, ctl) -> None:
        try:
            ctl.fut.set_result(ctl.fn())
        except Exception as exc:
            logger.exception("control call failed")
            ctl.fut.set_exception(exc)

    def _take(self):
        """The next batch (a list of (img, fut)) coalesced within the
        window, a control item, :attr:`_CLOSE`, or None (the item had
        expired)."""
        item = self._q.get()
        if item is self._CLOSE or isinstance(item, self._Control):
            return item
        entry = self._take_data(item)
        return None if entry is None else self._drain(entry)

    def _loop(self) -> None:
        while True:
            with span("batcher.take"):
                item = self._take()
            if item is self._CLOSE:
                return
            if isinstance(item, self._Control):
                self._run_control(item)
            elif item is not None:
                self._dispatch(item)

    def _dispatch(self, batch: list) -> None:
        """One ``infer_group`` call per bucket of ``batch``; resolve the
        futures."""
        groups: dict[tuple[int, int], list] = {}
        for img, fut in batch:
            key = self.engine.bucket_of(img.shape[0], img.shape[1])
            groups.setdefault(key, []).append((img, fut))
        for group in groups.values():
            imgs = [img for img, _ in group]
            with span("batcher.dispatch", dispatch=next(self._dispatches),
                      images=len(imgs)):
                try:
                    results = self.engine.infer_group(imgs)
                except Exception as exc:  # resolve, don't kill the loop
                    logger.exception("batch of %d failed", len(imgs))
                    for _, fut in group:
                        fut.set_exception(exc)
                    continue
                self.stats.record_batch(len(imgs))
                with span("batcher.resolve"):
                    for (_, fut), res in zip(group, results):
                        fut.set_result(res)


def _make_handler(batcher: MicroBatcher, stats: ServerStats,
                  max_body: int, request_timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        protocol_version = "HTTP/1.1"

        def log_message(self, fmt, *args):  # route through logging
            logger.debug("%s " + fmt, self.address_string(), *args)

        def _reply(self, code: int, body: bytes,
                   ctype: str = "application/json",
                   headers: dict | None = None) -> None:
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            for k, v in (headers or {}).items():
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def _err(self, code: int, msg: str) -> None:
            # error replies may precede reading the request body; the
            # unread bytes would desync HTTP/1.1 keep-alive parsing,
            # so close the connection after an error
            self.close_connection = True
            self._reply(code, json.dumps({"error": msg}).encode(),
                        headers={"Connection": "close"})

        def do_GET(self):
            path = urlparse(self.path).path
            if path == "/healthz":
                dev = torch.device(batcher.engine.device)
                self._reply(200, json.dumps({
                    "status": "ok",
                    "platform": dev.type,
                    "device": (torch.cuda.get_device_name(dev)
                               if dev.type == "cuda" else "cpu"),
                    "dtype": batcher.engine.dtype,
                    "devices": len(batcher.engine.devices),
                }).encode())
            elif path == "/stats":
                snap = stats.snapshot()
                snap["queue_depth"] = batcher.depth
                snap["max_queue"] = batcher.max_queue
                snap["dtype"] = batcher.engine.dtype
                self._reply(200, json.dumps(snap).encode())
            else:
                self._err(404, f"no such endpoint: {path}")

        def _reload(self):
            """Zero-downtime weight hot-reload: JSON {"g1": path,
            "g2": path} -> engine.load_weights on the batcher thread
            (in-flight batches finish on the old weights; later
            batches see the new ones atomically). Local-trust admin
            surface, same as the CLI's filesystem access. An
            artifact's weights are part of its graph: 501."""
            engine = batcher.engine
            if not hasattr(engine, "load_weights"):
                self._err(501, "engine serves a baked artifact; "
                               "restart with a new --artifact instead")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
                spec = json.loads(self.rfile.read(length))
                g1, g2 = spec["g1"], spec["g2"]
            except Exception:
                self._err(400, 'expected JSON {"g1": path, "g2": path}')
                return
            try:
                batcher.run_on_batcher(
                    lambda: engine.load_weights(g1, g2)).result(
                        timeout=request_timeout_s)
            except FileNotFoundError as exc:
                self._err(400, str(exc))
                return
            except Exception as exc:
                logger.exception("reload failed")
                self._err(500, str(exc))
                return
            self._reply(200, json.dumps({"status": "reloaded"}).encode())

        def do_POST(self):
            t0 = time.perf_counter()
            url = urlparse(self.path)
            if url.path == "/admin/reload":
                self._reload()
                return
            if url.path != "/v1/unshadow":
                self._err(404, f"no such endpoint: {url.path}")
                return
            output = parse_qs(url.query).get("output", ["shadowless"])[0]
            if output not in ("shadowless", "matte"):
                self._err(400, "output must be shadowless|matte")
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                length = 0
            if length <= 0:
                self._err(411, "Content-Length required")
                return
            if length > max_body:
                self._err(413, f"body over {max_body} bytes")
                return
            ok = False
            try:
                img = imdecode_color(self.rfile.read(length))
                matte, shadowless = batcher.submit(img).result(
                    timeout=request_timeout_s)
                png = imencode_png(matte if output == "matte"
                                   else shadowless)
                ms = (time.perf_counter() - t0) * 1e3
                self._reply(200, png, ctype="image/png", headers={
                    "X-Latency-Ms": f"{ms:.1f}",
                    "X-Output": output,
                })
                ok = True
            except OverloadedError as exc:
                # load shed: tell clients when to come back — one full
                # queue's worth of work, conservatively 1s minimum
                self.close_connection = True
                self._reply(503, json.dumps({"error": str(exc)}).encode(),
                            headers={"Retry-After": "1",
                                     "Connection": "close"})
            except ValueError as exc:
                self._err(400, str(exc))
            except TimeoutError:
                self._err(504, "inference timed out")
            except Exception as exc:  # pragma: no cover - defensive
                logger.exception("request failed")
                self._err(500, str(exc))
            finally:
                stats.record_request((time.perf_counter() - t0) * 1e3,
                                     error=not ok)

    return Handler


class ShadowRemovalServer:
    """Engine + batcher + threaded HTTP server, started together."""

    def __init__(self, engine: InferenceEngine, *, host: str = "127.0.0.1",
                 port: int = 8650, window_ms: float = 5.0,
                 max_body_mb: float = 32.0,
                 request_timeout_s: float = 600.0,
                 max_queue: int | None = None):
        self.stats = ServerStats()
        self.batcher = MicroBatcher(engine, window_ms=window_ms,
                                    stats=self.stats,
                                    max_queue=max_queue,
                                    deadline_s=request_timeout_s)
        handler = _make_handler(self.batcher, self.stats,
                                int(max_body_mb * 1024 * 1024),
                                request_timeout_s)

        class _Server(ThreadingHTTPServer):
            # bursts larger than the stdlib's 5-deep listen backlog get
            # kernel TCP resets before the handler can answer 503
            # (observed live: 24 concurrent clients -> 3 ECONNRESET);
            # a deeper backlog turns those into orderly shed responses
            request_queue_size = 128

        self.httpd = _Server((host, port), handler)
        self.httpd.daemon_threads = True

    @property
    def address(self) -> tuple[str, int]:
        return self.httpd.server_address[:2]

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def shutdown(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.batcher.close()


def _parse_sizes(spec: str) -> list[tuple[int, int]]:
    out = []
    for part in spec.split(","):
        if not part.strip():
            continue
        h, w = part.lower().split("x")
        out.append((int(h), int(w)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Shadow-removal serving daemon (stacked G1+G2)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8650)
    ap.add_argument("--net-G", default="mnet",
                    choices=["unet", "mnet", "denseunet", "stcgan"])
    ap.add_argument("--ngf", type=int, default=64)
    ap.add_argument("--droprate", type=float, default=0.0,
                    help="the generators' dropout rate (the identity in "
                         "eval; part of the network's definition)")
    ap.add_argument("--activation", default="tanh")
    ap.add_argument("--no-nn-upconv", action="store_true",
                    help="use ConvTranspose upsampling instead of "
                         "NN-upsample+conv")
    ap.add_argument("--use-selu", action="store_true",
                    help="SELU generators (no BatchNorm leaves in their "
                         "weight files)")
    ap.add_argument("--split-skip", action="store_true", default=True,
                    help="MNet split-skip decoder (eval-only exact "
                         "rewrite; the concat is never formed) — "
                         "default on")
    ap.add_argument("--no-split-skip", dest="split_skip",
                    action="store_false",
                    help="disable the split-skip decoder (exact "
                         "concat-materializing form)")
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "int8"],
                    help="int8 = post-training-quantized serving (MNet "
                         "nearest-upsample only; its convs on the int8 "
                         "kernels); pass --int8-calib for representative "
                         "scales")
    ap.add_argument("--int8-calib", default=None,
                    help="directory of representative images (PNG/JPG) "
                         "for int8 activation calibration; without it "
                         "synthetic noise is used (warned)")
    ap.add_argument("--load-weights-g1", default=None,
                    help="G1 weight file: flax .msgpack, or .npz with "
                         "the flax variable paths joined by '/'")
    ap.add_argument("--load-weights-g2", default=None)
    ap.add_argument("--artifact", default=None,
                    help="serve a torch.export artifact (tools/export.py) "
                         "instead of weight files: no model classes "
                         "involved; fixed HxW")
    ap.add_argument("--pad-multiple", type=int, default=None)
    ap.add_argument("--devices", type=int, default=None,
                    help="data-parallel serving over the first N "
                         "devices: a replica of the stacked pair on "
                         "each, every coalesced batch split equally "
                         "(with --device cpu: N CPU replicas)")
    ap.add_argument("--device", default=None,
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--batch-window-ms", type=float, default=5.0)
    ap.add_argument("--max-body-mb", type=float, default=32.0)
    ap.add_argument("--max-queue", type=int, default=None,
                    help="admission-control queue bound; beyond it "
                         "requests get 503 + Retry-After (default "
                         "8*max-batch)")
    ap.add_argument("--request-timeout-s", type=float, default=600.0,
                    help="per-request deadline: clients waiting longer "
                         "get 504, and requests whose deadline passed "
                         "while queued are dropped before dispatch")
    ap.add_argument("--warmup", default="480x640",
                    help="comma-separated HxW list to run once before "
                         "serving ('' to skip)")
    ap.add_argument("--platform", default=None,
                    help="the JAX daemon's platform flag: cpu or cuda "
                         "sets --device (the two must agree when both "
                         "are given); any other value (e.g. tpu) is "
                         "ignored with a warning")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(levelname)s %(message)s")
    if args.platform in ("cpu", "cuda"):
        if args.device is not None \
                and args.device.split(":")[0] != args.platform:
            ap.error(f"--platform {args.platform} and --device "
                     f"{args.device} disagree")
        args.device = args.device or args.platform
    elif args.platform is not None:
        logger.warning("--platform %s names no torch device; ignored",
                       args.platform)
    args.device = args.device or "cuda"
    if args.artifact:
        engine = ArtifactEngine(args.artifact, max_batch=args.max_batch,
                                device=args.device)
    else:
        if not (args.load_weights_g1 and args.load_weights_g2):
            ap.error("--load-weights-g1/-g2 required (or --artifact)")
        calib = None
        if args.int8_calib:
            calib = [imread_color(os.path.join(args.int8_calib, f))
                     for f in sorted(os.listdir(args.int8_calib))
                     if f.lower().endswith((".png", ".jpg", ".jpeg"))]
            if not calib:
                ap.error(f"--int8-calib {args.int8_calib}: no images")
        engine = InferenceEngine(
            args.net_G, ngf=args.ngf, droprate=args.droprate,
            nn_upconv=not args.no_nn_upconv, use_selu=args.use_selu,
            activation=args.activation, dtype=args.dtype,
            split_skip=args.split_skip, pad_multiple=args.pad_multiple,
            max_batch=args.max_batch, devices=args.devices,
            calib_images=calib, device=args.device)
        engine.load_weights(args.load_weights_g1, args.load_weights_g2)
    sizes = _parse_sizes(args.warmup)
    if sizes:
        logger.info("warming up %s ...", sizes)
        engine.warmup(sizes)

    server = ShadowRemovalServer(engine, host=args.host, port=args.port,
                                 window_ms=args.batch_window_ms,
                                 max_body_mb=args.max_body_mb,
                                 max_queue=args.max_queue,
                                 request_timeout_s=args.request_timeout_s)
    stop = threading.Event()

    def _on_signal(signum, frame):
        logger.info("signal %d: shutting down", signum)
        stop.set()
        threading.Thread(target=server.shutdown, daemon=True).start()

    signal.signal(signal.SIGTERM, _on_signal)
    signal.signal(signal.SIGINT, _on_signal)
    logger.info("serving on http://%s:%d (dtype=%s, max_batch=%d, "
                "window=%.1fms)", *server.address, args.dtype,
                args.max_batch, args.batch_window_ms)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
