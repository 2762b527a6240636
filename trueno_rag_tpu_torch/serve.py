"""Serving: a micro-batching query server over a loaded index.

PyTorch counterpart of ``trueno_rag_tpu/serve.py``. The card earns its
throughput on batches, but serving traffic arrives as single queries.
:class:`MicroBatcher` bridges the two: requests queue up and a worker
drains them in batches (up to ``max_batch``, waiting at most
``max_wait_ms`` for stragglers), so concurrent callers share one batch of
device work.

:func:`run_server` exposes it over HTTP (stdlib only):

    POST /query   {"query": "...", "k": 5}           → {"results": [...]}
    POST /query   {"queries": ["...", "..."], "k":5} → {"batches": [[...]]}
    GET  /health                                      → {"status": "ok", ...}
    POST /reload  {}                                  → hot-swap the index

Requests may carry a tag filter — ``"filter": {"all": [...], "any":
[...], "none": [...]}`` (single or whole batch) or ``"filters": [...]``
(one per query); filtered and unfiltered requests coalesce into the same
micro-batches. A result carries ``learned_score`` beside the other
per-source scores (the JAX package's result dict has no such key).

Start via the CLI: ``python -m trueno_rag_tpu_torch.cli serve --index DIR``.
``--workers N`` scales the HTTP front end past one process's interpreter
lock: N stdlib-only worker processes share the port via SO_REUSEPORT and
forward framed requests over a unix socket to this device-owning process
(:mod:`trueno_rag_tpu_torch.serve_worker`).
"""

from __future__ import annotations

import json
import queue
import socket
import threading
from dataclasses import dataclass, field
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

from trueno_rag_tpu_torch.retrieve import RetrievalResult


def result_to_dict(r: RetrievalResult) -> Dict[str, Any]:
    return {
        "score": r.best_score(),
        "dense_score": r.dense_score,
        "sparse_score": r.sparse_score,
        "fused_score": r.fused_score,
        "rerank_score": r.rerank_score,
        "learned_score": r.learned_score,
        "chunk_id": r.chunk.id,
        "document_id": r.chunk.document_id,
        "title": r.chunk.metadata.title,
        "content": r.chunk.content,
    }


def result_to_tuple(r: RetrievalResult) -> tuple:
    """Compact row for the worker IPC: same values as
    :func:`result_to_dict` in ``serve_worker.RESULT_FIELDS`` order.
    The worker process zips the fields back into dicts and pays the
    json.dumps cost there, off this process's interpreter lock."""
    return (
        r.best_score(),
        r.dense_score,
        r.sparse_score,
        r.fused_score,
        r.rerank_score,
        r.learned_score,
        r.chunk.id,
        r.chunk.document_id,
        r.chunk.metadata.title,
        r.chunk.content,
    )


@dataclass
class _Pending:
    query: str
    k: int
    tag_filter: Optional[object] = None
    event: threading.Event = field(default_factory=threading.Event)
    results: Optional[List[RetrievalResult]] = None
    error: Optional[Exception] = None
    cancelled: bool = False  # set by a timed-out caller; never dispatched


class MicroBatcher:
    """Coalesces concurrent single-query requests into device batches.

    ``pipeline_depth`` > 1 enables two-phase pipelining: the batch loop dispatches batch N+1's device program
    (:meth:`HybridRetriever.retrieve_batch_submit`) while a collector
    thread runs batch N's host side — result fetch, the staged exact
    patch against ``VectorStore._host``, hydration. On the compact
    tier the exact contract's host f64 work thereby hides behind the
    next batch's device scan instead of serializing after it. Depth 1
    (default) is the previous synchronous behavior; mutations quiesce
    in-flight batches either way, so a patch never rescores rows a
    concurrent ingest replaced."""

    def __init__(self, retriever, max_batch: int = 32, max_wait_ms: float = 5.0,
                 pipeline_depth: int = 1) -> None:
        self.retriever = retriever
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._queue: "queue.Queue[_Pending]" = queue.Queue()
        self._stop = threading.Event()
        # guards the retriever's lazy snapshot/device state against
        # concurrent refresh from the worker and bulk-request threads;
        # the condition tracks pipelined batches in flight (collector
        # side) so mutations can quiesce them
        self._retriever_lock = threading.Lock()
        self._cond = threading.Condition(self._retriever_lock)
        self._inflight = 0
        self._draining = False
        self._collect_q: "queue.Queue" = queue.Queue(
            maxsize=max(1, self.pipeline_depth - 1)
        )
        self._collector = None
        if self.pipeline_depth > 1:
            self._collector = threading.Thread(
                target=self._collect_loop, daemon=True
            )
            self._collector.start()
        self._worker = threading.Thread(target=self._loop, daemon=True)
        self._worker.start()
        self.batches_served = 0
        self.queries_served = 0
        self._latencies_ms: List[float] = []  # ring buffer of batch latencies
        self._lat_lock = threading.Lock()
        self._stats_lock = threading.Lock()  # served counters (multi-thread)

    def query(self, query: str, k: int = 5, timeout: float = 30.0,
              tag_filter=None) -> List[RetrievalResult]:
        # Validate per-item BEFORE batching: one bad query must not
        # poison every request coalesced into the same micro-batch.
        if not query or not query.strip():
            from trueno_rag_tpu_torch.errors import QueryError

            raise QueryError("empty query")
        item = _Pending(query=query, k=k, tag_filter=tag_filter)
        self._queue.put(item)
        if not item.event.wait(timeout):
            # mark dead so the worker skips it: under sustained overload
            # an unbounded queue otherwise degrades into the device
            # answering only requests nobody is waiting for (congestion
            # collapse). Benign race: an item already mid-dispatch just
            # completes unobserved.
            item.cancelled = True
            raise TimeoutError("query timed out in the batching queue")
        if item.error is not None:
            raise item.error
        return item.results or []

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                first = self._queue.get(timeout=0.1)
            except queue.Empty:
                continue
            batch = [first]
            deadline = self.max_wait
            import time

            t0 = time.perf_counter()
            while len(batch) < self.max_batch:
                remaining = deadline - (time.perf_counter() - t0)
                if remaining <= 0:
                    break
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
            batch = [i for i in batch if not i.cancelled]
            if not batch:
                continue
            k = max(item.k for item in batch)
            # per-item filters ride the shared batch; all-None skips the
            # tagged code path entirely
            filters = None
            if any(i.tag_filter is not None for i in batch):
                filters = [i.tag_filter for i in batch]
            t_start = time.perf_counter()
            if self.pipeline_depth > 1:
                submitted = False
                try:
                    with self._cond:
                        # a waiting mutation (draining) wins over new
                        # pipelined submits; this batch takes the
                        # synchronous path and queues behind it
                        if not self._draining:
                            retr = self.retriever
                            handle = retr.retrieve_batch_submit(
                                [i.query for i in batch], k,
                                tag_filter=filters,
                            )
                            self._inflight += 1
                            submitted = True
                    if submitted:
                        # blocks once `pipeline_depth - 1` batches await
                        # collection — bounded device work in flight
                        self._collect_q.put((batch, retr, handle, t_start))
                        continue  # the collector finishes this batch
                except Exception:
                    pass  # submit failed: the synchronous path below retries
            try:
                with self._retriever_lock:
                    all_results = self.retriever.retrieve_batch(
                        [i.query for i in batch], k, tag_filter=filters
                    )
                for item, results in zip(batch, all_results):
                    item.results = results[: item.k]
            except Exception:
                # one bad item must not poison the whole coalesced
                # batch (e.g. a filter unsupported on this index): fall
                # back to per-item retrieval so only the offender errors
                for item in batch:
                    try:
                        with self._retriever_lock:
                            item.results = self.retriever.retrieve_batch(
                                [item.query], item.k,
                                tag_filter=[item.tag_filter]
                                if item.tag_filter is not None else None,
                            )[0]
                    except Exception as e:  # noqa: BLE001
                        item.error = e
            finally:
                self._record_latency((time.perf_counter() - t_start) * 1e3)
                with self._stats_lock:
                    self.batches_served += 1
                    self.queries_served += len(batch)
                for item in batch:
                    item.event.set()

    def _collect_loop(self) -> None:
        """Host side of the pipelined path: finish batch N (fetch +
        exact patch + hydrate) while the batch loop dispatches N+1."""
        import time

        while True:
            entry = self._collect_q.get()
            if entry is None:
                return
            batch, retr, handle, t_start = entry
            try:
                all_results = retr.retrieve_batch_collect(handle)
                for item, results in zip(batch, all_results):
                    item.results = results[: item.k]
            except Exception:
                # same per-item salvage as the synchronous path: only
                # the offending query errors
                for item in batch:
                    try:
                        with self._retriever_lock:
                            item.results = retr.retrieve_batch(
                                [item.query], item.k,
                                tag_filter=[item.tag_filter]
                                if item.tag_filter is not None else None,
                            )[0]
                    except Exception as e:  # noqa: BLE001
                        item.error = e
            finally:
                self._record_latency((time.perf_counter() - t_start) * 1e3)
                with self._stats_lock:
                    self.batches_served += 1
                    self.queries_served += len(batch)
                for item in batch:
                    item.event.set()
                with self._cond:
                    self._inflight -= 1
                    self._cond.notify_all()

    def _quiesce_locked(self) -> None:
        """Wait (holding the lock) until no pipelined batch is between
        submit and collect — callers then observe a stable index. The
        drain flag stops the batch loop from submitting new pipelined
        work past a waiting mutation (those batches fall back to the
        synchronous path and queue behind the lock)."""
        self._draining = True
        try:
            while self._inflight:
                self._cond.wait()
        finally:
            self._draining = False

    def retrieve_batch(self, queries: List[str], k: int,
                       tag_filter=None) -> List[List[RetrievalResult]]:
        """Bulk retrieval sharing the worker's retriever lock (the
        retriever's lazy snapshot refresh is not thread-safe).

        Sliced to ``max_batch`` per device call: an unbounded bulk request
        would otherwise build one giant batch (possible device OOM) and
        hold the lock for the whole call, starving every coalesced
        single-query request past its timeout. Slicing keeps device
        batches inside the tuned envelope and releases the lock between
        slices."""
        out: List[List[RetrievalResult]] = []
        is_list = isinstance(tag_filter, (list, tuple))
        for lo in range(0, len(queries), self.max_batch):
            sl = slice(lo, lo + self.max_batch)
            tf = list(tag_filter[sl]) if is_list else tag_filter
            if is_list and all(f is None for f in tf):
                tf = None
            with self._retriever_lock:
                out.extend(self.retriever.retrieve_batch(
                    queries[sl], k, tag_filter=tf
                ))
            with self._stats_lock:
                self.batches_served += 1
                self.queries_served += len(queries[sl])
        return out

    def _record_latency(self, ms: float) -> None:
        with self._lat_lock:
            self._latencies_ms.append(ms)
            if len(self._latencies_ms) > 1024:
                self._latencies_ms = self._latencies_ms[-512:]

    def latency_stats(self) -> Dict[str, float]:
        """p50/p95/p99 device-batch latency (ms) over the recent window."""
        with self._lat_lock:
            lat = sorted(self._latencies_ms)
        if not lat:
            return {}
        pick = lambda q: lat[min(len(lat) - 1, int(q * len(lat)))]  # noqa: E731
        return {"p50_ms": pick(0.50), "p95_ms": pick(0.95), "p99_ms": pick(0.99)}

    def swap_retriever(self, retriever) -> None:
        """Zero-downtime index swap: the in-flight batch finishes on
        the old retriever (the lock serializes), queued and future
        requests use the new one. Old index memory frees once its last
        batch completes."""
        with self._cond:
            self._quiesce_locked()
            self.retriever = retriever

    def mutate(self, fn):
        """Run a mutation (ingest/remove/tag edit) against the live
        retriever under the SAME lock the query path holds — the
        supported way to mutate an index that is actively serving.
        Queries dispatched before the mutation complete against the old
        state; queries after see the new state; nothing observes a
        half-applied host/device snapshot (the retriever's lazy device
        refresh is not thread-safe on its own). Returns ``fn``'s
        result. Keep ``fn`` small — it blocks the batch loop."""
        with self._cond:
            self._quiesce_locked()
            return fn(self.retriever)

    def shutdown(self) -> None:
        self._stop.set()
        self._worker.join(timeout=2.0)
        if self._collector is not None:
            self._collect_q.put(None)
            self._collector.join(timeout=2.0)


def _tier_stats(retriever) -> Dict[str, object]:
    """Scan-tier observability for /health: which tier serves, how many
    queries fell past its certificate (host-patched or fp32 re-run)."""
    store = getattr(retriever, "vector_store", None)
    if store is None:
        return {}
    return {
        "scan_tier": store._effective_tier(),
        "tier_fallbacks": int(store.tier_fallbacks),
        "uncertified_queries": int(store.compact_uncertified),
        # the containment patch: exact resolutions from candidate rows
        # alone vs. full-matrix GEMM last resorts
        "candidate_patched": int(store.compact_candidate_patched),
        "gemm_patched": int(store.compact_gemm_patched),
    }


def _status_for(exc: Exception) -> int:
    """HTTP status for a failed request: client errors are 4xx, queue
    saturation/timeouts are 503 (retryable elsewhere), anything else is
    a 500 — so load balancers fail over on overload instead of treating
    every server-side failure as the client's fault."""
    from trueno_rag_tpu_torch.errors import RagError

    if isinstance(exc, TimeoutError):
        return 503
    if isinstance(exc, (RagError, KeyError, TypeError, ValueError)):
        return 400
    return 500


def _parse_filter(spec):
    """{"all": [...], "any": [...], "none": [...]} → TagFilter.

    FAIL-CLOSED on unknown keys: a typo like {"anyof": [...]} must not
    silently become an unconstrained filter that leaks every tenant's
    documents — it is rejected as a client error instead."""
    if not spec:
        return None
    from trueno_rag_tpu_torch.errors import QueryError
    from trueno_rag_tpu_torch.retrieve import TagFilter

    unknown = set(spec) - {"all", "any", "none"}
    if unknown:
        raise QueryError(
            f"unknown filter key(s) {sorted(unknown)}; expected all/any/none"
        )
    return TagFilter(
        all=tuple(spec.get("all", ())),
        any=tuple(spec.get("any", ())),
        none=tuple(spec.get("none", ())),
    )


def make_handler(batcher: MicroBatcher, index_loader=None):
    """``index_loader``: optional zero-arg (or path-arg) callable
    returning a fresh retriever; enables ``POST /reload``."""
    reload_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        # HTTP/1.1 keep-alive: connection-per-request clients stampede the
        # serial accept loop (SYN retransmits); responses already carry
        # Content-Length, which persistence requires
        protocol_version = "HTTP/1.1"
        # a HANDLER attribute (StreamRequestHandler.setup), not a server
        # one: without it Nagle's algorithm with delayed ACKs stalls every
        # small keep-alive response
        disable_nagle_algorithm = True

        def log_message(self, fmt, *args):  # quiet
            pass

        def _send(self, code: int, payload: Dict[str, Any]) -> None:
            body = json.dumps(payload).encode("utf-8")
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/health":
                self._send(200, {
                    "status": "ok",
                    "chunks": len(batcher.retriever),
                    "batches_served": batcher.batches_served,
                    "queries_served": batcher.queries_served,
                    **batcher.latency_stats(),
                    **_tier_stats(batcher.retriever),
                })
            else:
                self._send(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path == "/reload":
                if index_loader is None:
                    self._send(501, {"error": "no index loader configured"})
                    return
                if not reload_lock.acquire(blocking=False):
                    self._send(409, {"error": "reload already in progress"})
                    return
                try:
                    # load OUTSIDE the batcher lock: requests keep
                    # serving on the old index during the (possibly
                    # long) artifact load, then the swap is atomic
                    new_retriever = index_loader()
                    # warm the incoming index BEFORE the swap — still on
                    # the old index's time: the device upload / scan-tier
                    # build (a full k-means for a cold clustered tier)
                    # must not land on the first post-swap request
                    warm_fn = getattr(new_retriever, "ensure_ready", None)
                    if warm_fn is not None:
                        warm_fn()
                    batcher.swap_retriever(new_retriever)
                    self._send(200, {"status": "reloaded",
                                     "chunks": len(new_retriever)})
                except Exception as e:  # noqa: BLE001 — surface to caller
                    self._send(500, {"error": f"{type(e).__name__}: {e}"})
                finally:
                    reload_lock.release()
                return
            if self.path != "/query":
                self._send(404, {"error": "unknown path"})
                return
            try:
                length = int(self.headers.get("Content-Length", 0))
                payload = json.loads(self.rfile.read(length) or b"{}")
                k = int(payload.get("k", 5))
                tag_filter = _parse_filter(payload.get("filter"))
                if "queries" in payload:
                    filters = payload.get("filters")
                    tf = [_parse_filter(f) for f in filters] if filters else tag_filter
                    batches = batcher.retrieve_batch(list(payload["queries"]), k,
                                                     tag_filter=tf)
                    self._send(200, {"batches": [[result_to_dict(r) for r in b] for b in batches]})
                elif "query" in payload:
                    results = batcher.query(str(payload["query"]), k,
                                            tag_filter=tag_filter)
                    self._send(200, {"results": [result_to_dict(r) for r in results]})
                else:
                    self._send(400, {"error": "missing 'query' or 'queries'"})
            except Exception as e:  # noqa: BLE001 — JSON error responses
                self._send(_status_for(e), {"error": f"{type(e).__name__}: {e}"})

    return Handler


class RagHTTPServer(ThreadingHTTPServer):
    """ThreadingHTTPServer hardened for concurrent clients: the stock
    ``request_queue_size=5`` overflows the listen backlog under a few
    dozen concurrent connections (clients see connection resets).
    Thread-per-connection remains; the interpreter lock, not the thread
    count, bounds one process (``workers`` scale past it)."""

    daemon_threads = True
    request_queue_size = 1024


class DeviceIPCServer:
    """Unix-socket side of multi-process serving (the device process).

    Accepts framed requests from :mod:`serve_worker` HTTP workers and
    answers from the shared :class:`MicroBatcher`. One thread per
    worker connection; workers hold one persistent connection per HTTP
    handler thread, so IPC concurrency mirrors HTTP concurrency and
    the batcher coalesces across all workers exactly as it does across
    threads in single-process mode."""

    def __init__(self, batcher: MicroBatcher, sock_path: str,
                 index_loader=None) -> None:
        self.batcher = batcher
        self.sock_path = sock_path
        self._index_loader = index_loader
        # set by WorkerPool so health responses can surface supervisor
        # state (respawn count, why self-healing gave up)
        self.pool = None
        self._reload_lock = threading.Lock()
        self._stop = threading.Event()
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(sock_path)
        self._listener.listen(256)
        self._accept_thread = threading.Thread(target=self._accept_loop,
                                               daemon=True)
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed
            with self._conns_lock:
                self._conns.add(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        from trueno_rag_tpu_torch.serve_worker import recv_msg, send_msg

        try:
            while True:
                frame = recv_msg(conn)
                if frame is None:
                    return
                send_msg(conn, self._handle(frame))
        except (ConnectionError, OSError):
            return  # worker went away; its requests die with it
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, frame) -> tuple:
        try:
            op = frame[0]
            if op == "query":
                _, q, k, fspec = frame
                results = self.batcher.query(q, int(k),
                                             tag_filter=_parse_filter(fspec))
                return ("ok", [result_to_tuple(r) for r in results])
            if op == "batch":
                _, queries, k, filters, one_filter = frame
                tf = ([_parse_filter(f) for f in filters] if filters
                      else _parse_filter(one_filter))
                batches = self.batcher.retrieve_batch(list(queries), int(k),
                                                      tag_filter=tf)
                return ("ok", [[result_to_tuple(r) for r in b] for b in batches])
            if op == "health":
                pool_stats = {}
                if self.pool is not None:
                    pool_stats = {
                        "respawns": int(self.pool.respawns),
                        "respawn_gave_up": self.pool.respawn_gave_up,
                    }
                return ("ok", {
                    "status": "ok",
                    "chunks": len(self.batcher.retriever),
                    "batches_served": self.batcher.batches_served,
                    "queries_served": self.batcher.queries_served,
                    **self.batcher.latency_stats(),
                    **_tier_stats(self.batcher.retriever),
                    **pool_stats,
                })
            if op == "reload":
                return self._reload()
            return ("err", 400, f"unknown op {op!r}")
        except Exception as e:  # noqa: BLE001 — JSON error responses
            return ("err", _status_for(e), f"{type(e).__name__}: {e}")

    def _reload(self) -> tuple:
        if self._index_loader is None:
            return ("err", 501, "no index loader configured")
        if not self._reload_lock.acquire(blocking=False):
            return ("err", 409, "reload already in progress")
        try:
            # load OUTSIDE the batcher lock (same zero-downtime contract
            # as the single-process handler)
            new_retriever = self._index_loader()
            self.batcher.swap_retriever(new_retriever)
            return ("ok", {"status": "reloaded", "chunks": len(new_retriever)})
        except Exception as e:  # noqa: BLE001 — surface to caller
            return ("err", 500, f"{type(e).__name__}: {e}")
        finally:
            self._reload_lock.release()

    def close(self) -> None:
        self._stop.set()
        try:
            self._listener.close()
        except OSError:
            pass
        # break every live connection — including the workers' lifeline
        # connections, whose EOF tells them to exit (serve_worker's
        # watchdog), so a close() tears the whole topology down even if
        # nobody terminates the worker processes explicitly
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            try:
                c.close()
            except OSError:
                pass


class MultiProcessServer:
    """``workers`` HTTP front-end processes + this device process.

    Workers run the port's ``serve_worker.py`` as standalone scripts
    (fresh interpreters that import neither the package nor torch, so
    only this process holds the card) and bind the same TCP port with
    SO_REUSEPORT; the kernel load-balances accepted connections. One
    process's interpreter lock caps the JSON work a single front end can
    do, which is what the workers spread."""

    def __init__(self, batcher: MicroBatcher, host: str, port: int,
                 workers: int, index_loader=None, respawn: bool = True,
                 respawn_interval: float = 0.5,
                 max_respawns: int = 20) -> None:
        import subprocess
        import sys
        import tempfile
        from pathlib import Path

        if port == 0:
            # workers must agree on one port; claim a free one up front
            with socket.socket() as probe:
                probe.bind((host, 0))
                port = probe.getsockname()[1]
        self.host, self.port = host, port
        self.batcher = batcher
        self._tmpdir = tempfile.TemporaryDirectory(prefix="trag-ipc-")
        import os

        os.chmod(self._tmpdir.name, 0o700)  # pickle IPC: owner-only
        self.sock_path = str(Path(self._tmpdir.name) / "device.sock")
        self.ipc = DeviceIPCServer(batcher, self.sock_path, index_loader)
        self._subprocess, self._sys = subprocess, sys
        self._script = Path(__file__).with_name("serve_worker.py")
        self.ipc.pool = self  # health responses surface supervisor state
        self.procs = [self._spawn() for _ in range(workers)]
        # self-healing: a crashed worker (OOM kill, segfault, operator
        # mistake) respawns automatically — crash-recovery is not an
        # operator action. Bounded by max_respawns so a worker that
        # dies instantly on startup cannot fork-bomb the box; no
        # respawn once the device side is closed (the new worker's
        # lifeline would be dead on arrival).
        self.respawns = 0
        # why the supervisor stopped respawning (None while healthy) —
        # surfaced through /stats so a disabled self-heal is visible to
        # the operator instead of a silently dead daemon thread
        self.respawn_gave_up = None
        self._max_respawns = max_respawns
        self._respawn_interval = respawn_interval
        self._supervisor = None
        if respawn:
            self._supervisor = threading.Thread(target=self._supervise,
                                                daemon=True)
            self._supervisor.start()

    def _spawn(self):
        p = self._subprocess.Popen(
            [self._sys.executable, "-u", str(self._script), "--host",
             self.host, "--port", str(self.port), "--sock", self.sock_path],
            stdout=self._subprocess.PIPE, text=True,
        )
        line = p.stdout.readline()  # blocks until "worker ready"
        if "ready" not in line:
            try:
                p.terminate()
            except OSError:
                pass
            raise RuntimeError(f"serve worker failed to start (exit {p.poll()})")
        return p

    def _supervise(self) -> None:
        import time as _time

        while not self.ipc._stop.is_set():
            _time.sleep(self._respawn_interval)
            if self.ipc._stop.is_set():
                return
            for i, p in enumerate(self.procs):
                if p.poll() is None:
                    continue
                if self.respawns >= self._max_respawns:
                    self.respawn_gave_up = (
                        f"max_respawns ({self._max_respawns}) reached"
                    )
                    return  # give up loudly-countably, not loopingly
                if p.stdout is not None:
                    p.stdout.close()
                try:
                    fresh = self._spawn()
                except (RuntimeError, OSError) as e:
                    # RuntimeError: device side gone or port lost.
                    # OSError: fork/exec failure, fd exhaustion — must
                    # not silently kill the supervisor thread. Either
                    # way, stop trying but leave a visible trace
                    # (surfaced via /stats respawn_gave_up).
                    self.respawn_gave_up = f"{type(e).__name__}: {e}"
                    return
                # Shutdown race: stop() may have set the flag and swept
                # self.procs while _spawn was blocked in readline
                # (worker startup takes seconds). Installing the fresh
                # worker now would orphan a process holding the
                # port — reap it instead of adopting it.
                if self.ipc._stop.is_set():
                    self._reap(fresh)
                    return
                self.procs[i] = fresh
                self.respawns += 1

    def poll_dead(self) -> list:
        return [p for p in self.procs if p.poll() is not None]

    @staticmethod
    def _reap(p) -> None:
        if p.poll() is None:
            try:
                p.terminate()
            except OSError:
                pass
        try:
            p.wait(timeout=5)
        except Exception:  # noqa: BLE001 — last resort
            p.kill()
        if p.stdout is not None:
            p.stdout.close()

    def stop(self) -> None:
        self.ipc._stop.set()  # stops the supervisor's respawn loop too
        if self._supervisor is not None:
            self._supervisor.join(timeout=2.0)
        for p in self.procs:
            self._reap(p)
        # Re-sweep if the supervisor outlived the join timeout (blocked
        # inside _spawn's readline): it either reaps the fresh worker
        # itself on the post-spawn stop check, or installed it into
        # self.procs before our first sweep — but if it installed
        # DURING the sweep we could miss it, so wait it out and sweep
        # once more. 30 s bounds a pathological worker start.
        if self._supervisor is not None and self._supervisor.is_alive():
            self._supervisor.join(timeout=30.0)
            for p in self.procs:
                self._reap(p)
        self.ipc.close()
        self._tmpdir.cleanup()


def prewarm(retriever, max_batch: int, k: int = 10,
            sample_queries: Optional[List[str]] = None) -> None:
    """Pay the first-use costs BEFORE accepting traffic: on the card the
    ``nvcc`` builds of the CUDA kernels (``ops.kernels.build``), the
    cuBLAS handles and workspaces, the caching allocator's first blocks
    and the index's device state. Every batch size up to ``max_batch``
    (powers of two) runs three times over ``sample_queries`` (drawn from
    real traffic or the corpus, as the autotuner draws its calibration
    queries), so wide and narrow BM25 slot lists both run once; without
    this, those costs land on the first live requests."""
    if str(getattr(retriever, "device", "cpu")).startswith("cuda"):
        from trueno_rag_tpu_torch.ops.kernels import build

        build.build_library()
    if not sample_queries:
        sample_queries = ["warmup query terms retrieval index search engine"]
    b = 1
    while True:
        # rotate through the sample pool so several slot-list widths run
        # per batch size, not just one
        for off in (0, b, 3 * b):
            qs = [sample_queries[(off + i) % len(sample_queries)] for i in range(b)]
            retriever.retrieve_batch(qs, k)
        if b >= max_batch:
            break
        b *= 2


def run_server(retriever, host: str = "127.0.0.1", port: int = 8080,
               max_batch=32, max_wait_ms: float = 5.0,
               autotune_k: int = 5,
               latency_budget_ms: Optional[float] = None,
               index_loader=None, warm: bool = True,
               workers: int = 0) -> None:
    """Serve ``retriever`` over HTTP. ``max_batch="auto"`` calibrates
    batch size and straggler wait by measurement before accepting
    traffic (see :func:`trueno_rag_tpu_torch.tune.autotune_serving`).
    ``workers=N`` spawns N HTTP front-end processes on the same port
    (SO_REUSEPORT) forwarding to this device-owning process, which keeps
    the card; one process's interpreter lock caps a single front end."""
    if max_batch == "auto":
        from trueno_rag_tpu_torch.tune import autotune_serving

        tuned = autotune_serving(
            retriever, k=autotune_k, latency_budget_ms=latency_budget_ms
        )
        max_batch, max_wait_ms = tuned.max_batch, tuned.max_wait_ms
        print(f"autotuned: max_batch={max_batch} max_wait_ms={max_wait_ms:.2f}")
        for p in tuned.table:
            print(f"  batch {p.batch_size:4d}: p50 {p.p50_ms:8.2f} ms  {p.qps:10,.0f} q/s")
    if warm:
        # corpus-sampled warm queries reach the wide slot lists a generic
        # string never does
        from trueno_rag_tpu_torch.tune import calibration_queries

        prewarm(retriever, int(max_batch), k=autotune_k,
                sample_queries=calibration_queries(retriever, 16))
    batcher = MicroBatcher(retriever, max_batch=int(max_batch), max_wait_ms=max_wait_ms)
    endpoints = "POST /query, GET /health" + (", POST /reload" if index_loader else "")
    if workers:
        import signal
        import time as time_mod

        # SIGTERM must unwind to the finally below so workers are
        # reaped promptly (their lifeline watchdog is the backstop for
        # kills this handler can't catch)
        def _sigterm(*_):
            raise SystemExit(0)

        try:
            signal.signal(signal.SIGTERM, _sigterm)
        except ValueError:
            # signal handlers only install on the main thread; embedded
            # callers running run_server on a worker thread keep the
            # lifeline watchdog as the reaping backstop
            pass
        mp_server = MultiProcessServer(batcher, host, port, workers,
                                       index_loader)
        print(f"serving {len(retriever)} chunks on "
              f"http://{host}:{mp_server.port} ({endpoints}) "
              f"[{workers} worker processes]", flush=True)
        try:
            while True:
                time_mod.sleep(1.0)
                dead = mp_server.poll_dead()
                if dead:
                    raise RuntimeError(
                        f"{len(dead)} serve worker(s) exited "
                        f"(codes {[p.poll() for p in dead]})")
        except KeyboardInterrupt:
            pass
        finally:
            mp_server.stop()
            batcher.shutdown()
        return
    server = RagHTTPServer((host, port), make_handler(batcher, index_loader))
    # the bound port: port 0 asks the OS for a free one
    print(f"serving {len(retriever)} chunks on http://{host}:{server.server_address[1]} ({endpoints})",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        batcher.shutdown()
        server.server_close()
