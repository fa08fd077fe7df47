"""The cameras of a serving cell: one process, no torch, one thread per
camera, each in a closed loop (its next frame goes out when the reply to
the last has come).

It speaks the server's wire protocol through its own frozen copy of the
framing: ``[u32 len][json]`` then ``[u32 len][payload]`` per payload. It
reads its instructions and the frame pool on standard input, connects and
warms up, prints ``ready``, waits for ``go``, sends for the window's
seconds, and prints one JSON line of every request's times and answer.

Run by the harness as ``python3 -m benchmark.client``.
"""

from __future__ import annotations

import json
import socket
import struct
import sys
import threading
import time


def _send_msg(sock, header: dict, payloads=()):
    blob = json.dumps(header).encode()
    sock.sendall(struct.pack("!I", len(blob)) + blob)
    for p in payloads:
        sock.sendall(struct.pack("!I", len(p)) + p)


def _recv_exact(sock, n: int):
    buf = bytearray()
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            return None
        buf += chunk
    return bytes(buf)


def _recv_header(sock):
    raw = _recv_exact(sock, 4)
    if raw is None:
        return None
    blob = _recv_exact(sock, struct.unpack("!I", raw)[0])
    return None if blob is None else json.loads(blob)


class Camera:
    """Sends the pool frames of its own range in order from its start, so
    that no frame repeats in a window shorter than the range; warm-up
    requests take the range's last frames."""

    def __init__(self, idx: int, host: str, port: int, frames: list,
                 offset: int, span: int, ids):
        self.idx, self.frames, self.ids = idx, frames, ids
        self.pos, self.offset, self.span = offset, offset, span
        self.sock = socket.create_connection((host, port), timeout=300)
        self.records: list = []

    def request(self, record: bool, pool: int | None = None):
        if pool is None:
            pool = self.pos % len(self.frames)
            self.pos += 1
        meta, rgb = self.frames[pool]
        req = self.ids()
        buf = bytearray(rgb)
        buf[0:6] = struct.pack("<IH", req, pool)
        header = {"h": meta["h"], "w": meta["w"], "dtype": "uint8",
                  "want_images": False}
        payloads = [bytes(buf)]
        t0 = time.monotonic()
        err, reply = None, None
        try:
            _send_msg(self.sock, header, payloads)
            reply = _recv_header(self.sock)
            if reply is None:
                err = "server closed the connection"
            elif "error" in reply:
                err = reply["error"]
        except OSError as e:
            err = repr(e)
        t1 = time.monotonic()
        if record:
            self.records.append({
                "req": req, "pool": pool, "camera": self.idx, "t_send": t0,
                "t_recv": t1, "error": err,
                "server_batch": None if err else reply.get("server_batch"),
                "poses": None if err else reply.get("poses")})
        return err


def main():
    inp = sys.stdin.buffer
    spec = json.loads(inp.readline())
    frames = []
    for meta in spec["frames"]:
        rgb = inp.read(meta["h"] * meta["w"] * 3)
        frames.append((meta, rgb))
    lock = threading.Lock()
    counter = [spec["first_request_id"]]

    def next_id():
        with lock:
            counter[0] += 1
            return counter[0]

    n_cam = spec["cameras"]
    span = len(frames) // n_cam
    cams = [Camera(c, spec["host"], spec["port"], frames, c * span, span,
                   next_id) for c in range(n_cam)]

    def warm(cam):
        for k in range(spec["warmup_per_camera"]):
            cam.request(False, pool=cam.offset + cam.span - 1 - k)

    threads = [threading.Thread(target=warm, args=(c,)) for c in cams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    print("ready", flush=True)
    if sys.stdin.buffer.readline().strip() != b"go":
        return 1
    t_go = time.monotonic()
    t_end = t_go + spec["seconds"]

    def loop(cam):
        while time.monotonic() < t_end:
            cam.request(True)

    threads = [threading.Thread(target=loop, args=(c,)) for c in cams]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for c in cams:
        c.sock.close()
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    print(json.dumps({
        "t_go": t_go, "t_end": t_end,
        "requests": [r for c in cams for r in c.records],
        "modules": sorted(tops)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
