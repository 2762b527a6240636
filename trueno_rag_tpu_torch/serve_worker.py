"""HTTP front-end worker for multi-process serving.

The port's own copy of ``trueno_rag_tpu/serve_worker.py``. One Python
process cannot push the device's throughput through HTTP: JSON encode and
decode and request parsing share the interpreter lock with the batching
loop. This module scales the front end the way Python services do —
several processes on one port — and keeps ONE device-owning process.

Topology (``serve.run_server(..., workers=N)``):

- the DEVICE process owns the retriever + MicroBatcher and listens on a
  unix-domain socket for framed requests;
- N WORKER processes (this module, run as a standalone script, so neither
  the package nor torch is imported and no worker touches the card) each
  bind the same TCP port with SO_REUSEPORT (the kernel balances accepted
  connections), do all HTTP parsing and JSON encoding, and forward compact
  pickled frames over per-thread persistent unix connections.

The worker imports ONLY the standard library; ``serve.py`` imports the
framing helpers from here (safe in that direction).

Frames are length-prefixed pickles. Pickle over a mode-0700 unix socket
between same-user processes is a trusted local IPC, not a network
protocol; the TCP side speaks only JSON.
"""

from __future__ import annotations

import pickle
import socket
import struct
import threading

_LEN = struct.Struct("<I")

# Field order of the per-result tuples the device process emits
# (serve.result_to_tuple); the worker zips them back into the public
# JSON schema so the expensive json.dumps of chunk contents happens in
# the worker, off the device process's interpreter lock.
RESULT_FIELDS = (
    "score",
    "dense_score",
    "sparse_score",
    "fused_score",
    "rerank_score",
    "learned_score",
    "chunk_id",
    "document_id",
    "title",
    "content",
)


def send_msg(sock: socket.socket, obj) -> None:
    data = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(data)) + data)


def recv_msg(sock: socket.socket):
    """Read one length-prefixed frame; None on orderly EOF."""
    header = _recv_exact(sock, _LEN.size)
    if header is None:
        return None
    (length,) = _LEN.unpack(header)
    body = _recv_exact(sock, length)
    if body is None:
        raise ConnectionError("peer closed mid-frame")
    return pickle.loads(body)


def _recv_exact(sock: socket.socket, n: int):
    buf = bytearray()
    while len(buf) < n:
        part = sock.recv(n - len(buf))
        if not part:
            if buf:
                raise ConnectionError("peer closed mid-frame")
            return None  # orderly EOF between frames
        buf += part
    return bytes(buf)


def rows_to_dicts(rows):
    return [dict(zip(RESULT_FIELDS, r)) for r in rows]


# ---------------------------------------------------------------------------
# Worker-side HTTP server (stdlib only from here down)
# ---------------------------------------------------------------------------


def _worker_main(host: str, port: int, sock_path: str) -> None:
    import json
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

    tls = threading.local()

    def device_call(frame):
        """Send one frame on this thread's persistent connection,
        reconnecting once if the device process recycled it.

        Retries only IDEMPOTENT ops: a broken connection does not say
        whether the device already executed the frame, so re-sending a
        reload would run the (possibly minutes-long, state-changing)
        index load twice back-to-back. Queries/health re-execute
        harmlessly (results are pure; only the served counters move)."""
        retriable = frame[0] in ("query", "batch", "health")
        conn = getattr(tls, "conn", None)
        for attempt in (0, 1):
            try:
                if conn is None:
                    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
                    conn.connect(sock_path)
                    tls.conn = conn
                send_msg(conn, frame)
                reply = recv_msg(conn)
                if reply is None:
                    raise ConnectionError("device process closed connection")
                return reply
            except (ConnectionError, OSError):
                try:
                    conn.close()
                except Exception:  # noqa: BLE001 — already broken
                    pass
                tls.conn = conn = None
                if attempt or not retriable:
                    raise
        raise ConnectionError("unreachable")

    class Handler(BaseHTTPRequestHandler):
        # the hardening of serve.RagHTTPServer's handler: keep-alive avoids
        # accept-loop stampedes, and without TCP_NODELAY Nagle's algorithm
        # with delayed ACKs stalls every small keep-alive response
        protocol_version = "HTTP/1.1"
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _relay(self, frame) -> None:
            try:
                reply = device_call(frame)
            except (ConnectionError, OSError) as e:
                self._send(503, {"error": f"device process unavailable: {e}"})
                return
            if reply[0] == "ok":
                self._send(200, reply[1])
            else:  # ("err", code, message)
                self._send(reply[1], {"error": reply[2]})

        def do_GET(self):
            if self.path == "/health":
                self._relay(("health",))
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                self._relay(("reload",))
                return
            if self.path != "/query":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                k = int(payload.get("k", 5))
                if "queries" in payload:
                    frame = ("batch", list(payload["queries"]), k,
                             payload.get("filters"), payload.get("filter"))
                elif "query" in payload:
                    frame = ("query", str(payload["query"]), k,
                             payload.get("filter"))
                else:
                    self._send(400, {"error": "missing 'query' or 'queries'"})
                    return
            except Exception as e:  # noqa: BLE001 — JSON error responses
                self._send(400, {"error": f"{type(e).__name__}: {e}"})
                return
            try:
                reply = device_call(frame)
            except (ConnectionError, OSError) as e:
                self._send(503, {"error": f"device process unavailable: {e}"})
                return
            if reply[0] != "ok":
                self._send(reply[1], {"error": reply[2]})
            elif frame[0] == "query":
                self._send(200, {"results": rows_to_dicts(reply[1])})
            else:
                self._send(200, {"batches": [rows_to_dicts(b) for b in reply[1]]})

    class WorkerHTTPServer(ThreadingHTTPServer):
        daemon_threads = True
        request_queue_size = 1024
        allow_reuse_address = True

        def server_bind(self):
            # all workers bind the same port; the kernel load-balances
            # accepted connections across their listen queues
            self.socket.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEPORT, 1)
            super().server_bind()

    # Fail fast (before binding TCP) if the device process is gone.
    probe = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    probe.connect(sock_path)
    send_msg(probe, ("health",))
    if recv_msg(probe) is None:
        raise ConnectionError("device process rejected the probe")
    probe.close()

    # Lifeline: workers must not outlive the device process (a SIGKILLed
    # parent can't clean up its children — verified: plain kill of the
    # parent left workers listening on the port). This idle connection's
    # EOF is the kernel telling us the device process is gone, however
    # it died.
    lifeline = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    lifeline.connect(sock_path)

    def _watchdog() -> None:
        import os

        try:
            recv_msg(lifeline)  # blocks; the device sends nothing unsolicited
        except Exception:  # noqa: BLE001 — any break means the device died
            pass
        os._exit(0)

    threading.Thread(target=_watchdog, daemon=True).start()

    server = WorkerHTTPServer((host, port), Handler)
    print("worker ready", flush=True)  # parent waits for this line
    server.serve_forever()


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser(description="trueno-rag-tpu-torch HTTP worker")
    p.add_argument("--host", required=True)
    p.add_argument("--port", type=int, required=True)
    p.add_argument("--sock", required=True, help="device process unix socket")
    a = p.parse_args()
    _worker_main(a.host, a.port, a.sock)
