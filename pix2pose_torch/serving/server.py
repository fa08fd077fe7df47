"""Socket transport + cross-client batching for :class:`PoseService`
(a copy of :mod:`pix2pose_tpu.serving.server`, whose package ``__init__``
imports jax; the wire protocol is byte-for-byte the same, so either
package's client talks to either package's server).

- :class:`BatchingFrontend` coalesces requests from concurrent clients
  into one ``PoseService.process_many`` batch. A lone request is
  dispatched at once; under concurrency the dispatcher drains whatever
  queued while the previous batch ran.
- :class:`PoseServer` is a threaded TCP server, one thread per
  connection (the device work is serialized through the frontend).
- :class:`PoseClient` is a blocking client.

Wire format, both directions: ``[u32 len][json][payload bytes...]``.
Request header: ``{"h", "w", "dtype", "want_images", "has_depth"}`` +
rgb bytes (+ float32 depth-in-meters bytes when ``has_depth``).
Response header: ``{"poses": [{obj_id, R, t, score, bbox}], "latency_s",
"server_batch"}`` (+ det/pose image bytes when ``want_images``):
``latency_s`` is this request's own time in the server, from its enqueue
to its result, and ``server_batch`` the frames of the batch it ran in.

With :mod:`pix2pose_torch.utils.tracing` on, the frontend records each
request's ``server.queue`` wait (enqueue to dispatch) and a
``server.dispatch`` span around each batch.
"""

from __future__ import annotations

import itertools
import json
import socket
import struct
import threading
import time
from typing import Sequence

import numpy as np

from pix2pose_torch.utils import tracing


# ---------------------------------------------------------------- framing
def _send_msg(sock: socket.socket, header: dict,
              payloads: Sequence[bytes] = ()):
    blob = json.dumps(header).encode()
    sock.sendall(struct.pack("!I", len(blob)) + blob)
    for p in payloads:
        sock.sendall(struct.pack("!I", len(p)) + p)


def _recv_exact(sock: socket.socket, n: int) -> bytes | None:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket, n_payloads: int = 0):
    raw = _recv_exact(sock, 4)
    if raw is None:
        return None, None
    blob = _recv_exact(sock, struct.unpack("!I", raw)[0])
    if blob is None:  # mid-message disconnect
        return None, None
    header = json.loads(blob)
    payloads = []
    for _ in range(n_payloads):
        raw = _recv_exact(sock, 4)
        if raw is None:
            return None, None
        p = _recv_exact(sock, struct.unpack("!I", raw)[0])
        if p is None:
            return None, None
        payloads.append(p)
    return header, payloads


# ---------------------------------------------------------- batching core
class _Pending:
    __slots__ = ("rgb", "depth", "want_images", "event", "result",
                 "batch_size", "ident", "t_enq", "t_enq_ns", "latency_s")

    def __init__(self, rgb, want_images, depth=None):
        self.rgb = rgb
        self.depth = depth
        self.want_images = want_images
        self.event = threading.Event()
        self.result = None
        self.batch_size = 0
        self.latency_s = 0.0


class BatchingFrontend:
    """Coalesces concurrent ``submit`` calls into ``process_many``
    batches. Dispatch policy: take everything queued (up to
    ``max_batch``) the moment the device is free — latency-optimal when
    idle, throughput-optimal under load."""

    def __init__(self, service, max_batch: int = 8):
        self.service = service
        self.max_batch = max_batch
        self._q: list[_Pending] = []
        self._cv = threading.Condition()
        self._stop = False
        self._tickets = itertools.count(1)
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, rgb: np.ndarray, want_images: bool = False,
               depth: np.ndarray | None = None):
        """Blocking: returns the completed ticket (``.result`` is the
        frame's FrameResult, ``.batch_size`` the dispatch batch size,
        ``.latency_s`` the seconds from enqueue to result)."""
        p = _Pending(rgb, want_images, depth)
        with self._cv:
            p.ident = next(self._tickets)
            p.t_enq_ns = time.time_ns() if tracing.enabled() else 0
            p.t_enq = time.monotonic()
            self._q.append(p)
            self._cv.notify()
        p.event.wait()
        if isinstance(p.result, Exception):
            raise p.result
        return p

    def close(self):
        with self._cv:
            self._stop = True
            self._cv.notify()
        self._thread.join(timeout=5)

    def _loop(self):
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if self._stop:
                    for p in self._q:
                        p.result = RuntimeError("frontend closed")
                        p.event.set()
                    return
                # one dispatch = one (shape, dtype) group: process_many
                # stacks frames into a single array, so mixed-resolution
                # clients must not land in the same batch. Head-of-queue
                # shape wins; other shapes stay queued for the next round
                k0 = (self._q[0].rgb.shape, self._q[0].rgb.dtype)
                batch = [p for p in self._q
                         if (p.rgb.shape, p.rgb.dtype) == k0
                         ][:self.max_batch]
                taken = set(map(id, batch))
                self._q = [p for p in self._q if id(p) not in taken]
                t_take_ns = time.time_ns() if tracing.enabled() else 0
            try:
                with tracing.span("server.dispatch", len(batch)) as sp:
                    for p in batch:
                        if p.t_enq_ns and t_take_ns:
                            tracing.wait("server.queue", p.t_enq_ns,
                                         t_take_ns, p.ident, sp.id)
                    want = any(p.want_images for p in batch)
                    depths = ([p.depth for p in batch]
                              if any(p.depth is not None for p in batch)
                              else None)
                    results = self.service.process_many(
                        [p.rgb for p in batch], depths=depths,
                        want_images=want)
                for p, r in zip(batch, results):
                    p.result = r
                    p.batch_size = len(batch)
                    p.latency_s = time.monotonic() - p.t_enq
                    p.event.set()
            except Exception as e:  # surface to every waiter
                for p in batch:
                    p.result = e
                    p.event.set()


# ----------------------------------------------------------------- server
class PoseServer:
    """Threaded TCP front end over a :class:`BatchingFrontend`."""

    def __init__(self, service, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 8):
        # every batch size the frontend can form, built before the socket
        # takes a request
        service.warm_up(max_batch)
        self.frontend = BatchingFrontend(service, max_batch=max_batch)
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(32)
        self.address = self._sock.getsockname()
        self._stop = False
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def close(self):
        self._stop = True
        try:
            self._sock.close()
        except OSError:
            pass
        self.frontend.close()

    def _accept_loop(self):
        while not self._stop:
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn: socket.socket):
        try:
            while True:
                # every read may hit a mid-message disconnect
                # (_recv_exact -> None): treat all of them as a clean
                # client hang-up, not a handler-thread crash
                header, payloads = _recv_msg(conn, 0)
                if header is None:
                    return
                n_payloads = 2 if header.get("has_depth") else 1
                disconnected = False
                for _ in range(n_payloads):
                    raw = _recv_exact(conn, 4)
                    if raw is None:
                        disconnected = True
                        break
                    p = _recv_exact(conn, struct.unpack("!I", raw)[0])
                    if p is None:
                        disconnected = True
                        break
                    payloads.append(p)
                if disconnected:
                    return
                rgb = np.frombuffer(
                    payloads[0], dtype=np.dtype(header["dtype"])
                ).reshape(header["h"], header["w"], 3)
                depth = None
                if header.get("has_depth"):
                    depth = np.frombuffer(
                        payloads[1], np.float32).reshape(
                        header["h"], header["w"])
                want = bool(header.get("want_images", False))
                try:
                    p = self.frontend.submit(rgb, want_images=want,
                                             depth=depth)
                except Exception as e:
                    _send_msg(conn, {"error": str(e)})
                    continue
                res = p.result
                out = {"poses": [
                    {"obj_id": int(po.obj_id),
                     "R": np.asarray(po.R).reshape(-1).tolist(),
                     "t": np.asarray(po.t).reshape(-1).tolist(),
                     "score": float(po.score),
                     "bbox": [int(x) for x in po.bbox]}
                    for po in res.poses],
                    "latency_s": p.latency_s,
                    "server_batch": p.batch_size}
                blobs = []
                if want:
                    out["image_shape"] = list(res.detection_image.shape)
                    blobs = [res.detection_image.tobytes(),
                             res.pose_image.tobytes()]
                _send_msg(conn, out, blobs)
        except (ConnectionResetError, BrokenPipeError, OSError):
            return
        finally:
            try:
                conn.close()
            except OSError:
                pass


class PoseClient:
    """Blocking client for :class:`PoseServer`."""

    def __init__(self, host: str, port: int, timeout: float = 120.0):
        self._sock = socket.create_connection((host, port),
                                              timeout=timeout)

    def estimate(self, rgb: np.ndarray, want_images: bool = False,
                 depth: np.ndarray | None = None):
        """``depth``: optional (H,W) float32 meters — triggers the
        server's batched ICP refinement when the service has meshes."""
        rgb = np.ascontiguousarray(rgb)
        payloads = [rgb.tobytes()]
        header = {"h": int(rgb.shape[0]), "w": int(rgb.shape[1]),
                  "dtype": str(rgb.dtype),
                  "want_images": bool(want_images)}
        if depth is not None:
            header["has_depth"] = True
            payloads.append(np.ascontiguousarray(
                depth.astype(np.float32)).tobytes())
        _send_msg(self._sock, header, payloads)
        header, payloads = _recv_msg(self._sock,
                                     2 if want_images else 0)
        if header is None:
            raise ConnectionError("server closed connection")
        if "error" in header:
            raise RuntimeError(header["error"])
        if want_images:
            shape = tuple(header["image_shape"])
            header["detection_image"] = np.frombuffer(
                payloads[0], np.uint8).reshape(shape)
            header["pose_image"] = np.frombuffer(
                payloads[1], np.uint8).reshape(shape)
        return header

    def close(self):
        try:
            self._sock.close()
        except OSError:
            pass

