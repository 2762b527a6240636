"""Serving on the CPU: the port's ``MicroBatcher``, HTTP server, device IPC
server and worker pool, each answering every query as ``retrieve_batch``
does, and the JSON of ``/query`` against the JAX package's server on the
same index.

- coalesced single queries equal ``retrieve_batch`` (rows and scores
  exactly: the same code on the same rows), with per-item filters, and a
  failing coalesced call salvaged item by item;
- ``pipeline_depth=2`` over a compact bf16r store with an encoder embedder
  (the two-phase split) and over a clustered store, in both packages,
  against each package's synchronous answers; ``mutate`` quiesces
  pipelined batches;
- ``RagHTTPServer``: ``/query`` (single, bulk, filters), ``/health`` (its
  tier counters), ``/reload`` and the error codes; the JSON equal to the
  JAX server's (which has no ``learned_score`` key) within the parity
  tolerances;
- ``DeviceIPCServer`` frames; ``MultiProcessServer`` with one and two
  workers, a killed worker respawned;
- ``cli serve`` in a subprocess answering like ``cli query``.

Every server binds a port the OS picks, readiness is a printed line or a
returned socket, every join, read and request has its own timeout, and
every server, batcher and worker is stopped in a ``finally``."""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import trueno_rag_tpu as jrag
from trueno_rag_tpu import serve as jserve
from trueno_rag_tpu.models import encoder as je

import trueno_rag_tpu_torch as trag
from trueno_rag_tpu_torch import cli as tcli
from trueno_rag_tpu_torch import serve as tserve
from trueno_rag_tpu_torch import serve_worker
from trueno_rag_tpu_torch.convert import encoder_params_from_jax
from trueno_rag_tpu_torch.models import encoder as te

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DIM = 32
WORDS = [f"w{i:03d}" for i in range(160)]
TIMEOUT = 60


def _texts(n=48, seed=3):
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, size=5 + i)) for i in range(n)]  # distinct lengths: no BM25 ties


QUERIES = [" ".join(t.split()[:3]) for t in _texts()[::5]]


def _retriever(rag, device=True):
    emb = rag.MockEmbedder(dimension=DIM)
    kw = {"device": "cpu"} if device else {}
    retr = rag.HybridRetriever(emb, config=rag.HybridRetrieverConfig(candidates_per_source=8), **kw)
    chunks = []
    for i, t in enumerate(_texts()):
        c = rag.Chunk(document_id=f"d{i}", content=t, start_offset=0, end_offset=len(t), id=f"c{i:03d}",
                      metadata=rag.ChunkMetadata(title=f"t{i}"))
        chunks.append(c)
    emb.embed_chunks(chunks)
    retr.index_batch(chunks)
    for i, c in enumerate(chunks):
        retr.registry.set_tags(c.id, ["even" if i % 2 == 0 else "odd"])
    return retr


@pytest.fixture(scope="module")
def retriever():
    return _retriever(trag)


def _ids(results):
    return [[(r.chunk.id, r.best_score()) for r in res] for res in results]


def _concurrent(batcher, queries, k, filters=None, timeout=TIMEOUT):
    """Each query from its own thread → results (or the exception) per query."""
    out = [None] * len(queries)

    def go(i):
        try:
            out[i] = batcher.query(queries[i], k=k, timeout=timeout,
                                   tag_filter=None if filters is None else filters[i])
        except Exception as e:  # noqa: BLE001 — returned to the assertion
            out[i] = e

    threads = [threading.Thread(target=go, args=(i,)) for i in range(len(queries))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive()
    return out


def test_microbatcher_coalesces_like_retrieve_batch(retriever):
    filters = [trag.TagFilter(all=("even",)) if i % 3 == 0 else None for i in range(len(QUERIES))]
    batcher = tserve.MicroBatcher(retriever, max_batch=8, max_wait_ms=100.0)
    try:
        got = _concurrent(batcher, QUERIES, 4, filters)
        assert _ids(got) == _ids(retriever.retrieve_batch(QUERIES, 4, tag_filter=filters))
        assert batcher.queries_served == len(QUERIES) and batcher.batches_served < len(QUERIES)
        stats = batcher.latency_stats()
        assert set(stats) == {"p50_ms", "p95_ms", "p99_ms"} and stats["p99_ms"] >= stats["p50_ms"] > 0
        with pytest.raises(trag.QueryError):
            batcher.query("   ", k=2)  # refused before batching
        bulk = batcher.retrieve_batch(QUERIES * 3, 4)  # sliced to max_batch per call
        assert _ids(bulk) == _ids(retriever.retrieve_batch(QUERIES * 3, 4))
    finally:
        batcher.shutdown()


def test_one_bad_item_does_not_poison_the_microbatch():
    r = _retriever(trag)
    real = r.retrieve_batch

    def sabotaged(queries, k, fusion=None, tag_filter=None):
        if len(queries) > 1:  # only the coalesced call fails
            raise trag.QueryError("batch-level failure")
        return real(queries, k, fusion=fusion, tag_filter=tag_filter)

    r.retrieve_batch = sabotaged
    batcher = tserve.MicroBatcher(r, max_batch=4, max_wait_ms=60.0)
    try:
        got = _concurrent(batcher, QUERIES[:4], 3)
        assert _ids(got) == _ids([real([q], 3)[0] for q in QUERIES[:4]])
    finally:
        batcher.shutdown()


def _encoder_store_pair(tier):
    """A JAX and a port retriever over the same encoder weights and rows, on
    ``tier`` (compact bf16r or clustered), fused=None."""
    jemb = je.JaxEncoderEmbedder(config=je.EncoderConfig.tiny())
    temb = te.EncoderEmbedder(config=te.EncoderConfig.tiny(), params=encoder_params_from_jax(jemb.params, "cpu"),
                              device="cpu")
    rng = np.random.default_rng(5)
    texts = [" ".join(rng.choice(WORDS, size=6 + i % 11)) for i in range(2048)]
    vecs = rng.standard_normal((len(texts), jemb.dimension)).astype(np.float32)
    out = []
    for rag, emb, kw in ((jrag, jemb, {}), (trag, temb, {"device": "cpu"})):
        retr = rag.HybridRetriever(emb, config=rag.HybridRetrieverConfig(candidates_per_source=8),
                                   vector_config=rag.VectorStoreConfig(dimension=emb.dimension, scan_tier=tier,
                                                                       scan_tile_n=1024, cluster_probe_tiles=1),
                                   **kw)
        chunks = [rag.Chunk(document_id="d", content=t, start_offset=0, end_offset=len(t), id=f"c{i}")
                  for i, t in enumerate(texts)]
        for c, v in zip(chunks, vecs):
            c.set_embedding(v)
        retr.index_batch(chunks)
        out.append(retr)
    return out


@pytest.mark.parametrize("tier", ["compact", "clustered"])
def test_pipelined_batcher_matches_synchronous(tier):
    """The JAX package splits submit whenever the store holds no fp32 matrix
    (``is_compact``), the clustered tier included, and there runs its fused
    compact program over the clustered layout; the port splits only on the
    compact bf16r store and stages the clustered tier, so its pipelined
    answers equal its synchronous ones on both (ROADMAP Queue 3 records the
    reference's clustered route)."""
    jr, tr = _encoder_store_pair(tier)
    queries = [" ".join(np.random.default_rng(9 + i).choice(WORDS, size=4)) for i in range(12)]
    for retr, mod, split in ((tr, tserve, "fused_compact" if tier == "compact" else "done"),
                             (jr, jserve, "fused_compact")):
        want = retr.retrieve_batch(queries, 4)
        kinds = []
        submit = retr.retrieve_batch_submit

        def spy(*a, _submit=submit, **kw):  # the handle kind of every pipelined batch
            handle = _submit(*a, **kw)
            kinds.append(handle[0])
            return handle

        retr.retrieve_batch_submit = spy
        piped = mod.MicroBatcher(retr, max_batch=4, max_wait_ms=50.0, pipeline_depth=2)
        try:
            got = _concurrent(piped, queries, 4)
        finally:
            piped.shutdown()
            del retr.retrieve_batch_submit
        assert kinds and set(kinds) == {split}
        if mod is tserve or tier == "compact":
            assert [[r.chunk.id for r in res] for res in got] == [[r.chunk.id for r in res] for res in want]
        assert piped.queries_served == len(queries)


def test_pipelined_mutation_quiesces_inflight():
    _, retr = _encoder_store_pair("compact")
    piped = tserve.MicroBatcher(retr, max_batch=4, max_wait_ms=20.0, pipeline_depth=3)
    stop = threading.Event()
    errors = []

    def hammer(seed):
        i = 0
        while not stop.is_set():
            try:
                piped.query(f"w{(seed * 7 + i) % 100:03d} w001", k=3, timeout=TIMEOUT)
            except Exception as e:  # noqa: BLE001 — collected for the assertion
                errors.append(e)
            i += 1

    def add_chunk(r, i):
        c = trag.Chunk(document_id="d", content=f"fresh row {i}", start_offset=0, end_offset=5, id=f"new{i}")
        c.set_embedding(np.random.default_rng(i).standard_normal(r.embedder.dimension).astype(np.float32))
        r.index_batch([c])
        return len(r.registry)

    threads = [threading.Thread(target=hammer, args=(s,)) for s in range(3)]
    try:
        for t in threads:
            t.start()
        sizes = [piped.mutate(lambda r, i=i: add_chunk(r, i)) for i in range(3)]
        assert sizes == [2049, 2050, 2051]
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=TIMEOUT)
        piped.shutdown()
    assert not errors and piped._inflight == 0 and not any(t.is_alive() for t in threads)
    assert all(retr.registry.row_of(f"new{i}") is not None for i in range(3))


def _post(url, payload, timeout=TIMEOUT):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as e:  # 4xx/5xx carry a JSON body
        return e.code, json.loads(e.read())


def _get(url, timeout=TIMEOUT):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return resp.status, json.loads(resp.read())


@contextlib.contextmanager
def _http(mod, retr, loader=None, max_batch=8):
    batcher = mod.MicroBatcher(retr, max_batch=max_batch, max_wait_ms=5.0)
    srv = mod.RagHTTPServer(("127.0.0.1", 0), mod.make_handler(batcher, loader))
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        yield f"http://127.0.0.1:{srv.server_address[1]}", batcher
    finally:
        srv.shutdown()
        srv.server_close()
        batcher.shutdown()
        thread.join(timeout=TIMEOUT)


def _json_rows(rows):
    return [(r["chunk_id"], r["content"], r["title"]) for r in rows]


def _close(a, b):
    for x, y in zip(a, b):
        for f in ("score", "dense_score", "sparse_score", "fused_score", "rerank_score", "learned_score"):
            if f not in x or f not in y:  # the JAX server has no learned_score, the CLI no rerank_score
                continue
            assert (x[f] is None) == (y[f] is None), f
            if x[f] is not None:
                assert x[f] == pytest.approx(y[f], rel=1e-4, abs=1e-6), f


def test_http_server_answers_like_retrieve_batch_and_jax(retriever):
    jretr = _retriever(jrag, device=False)
    with _http(tserve, retriever, loader=lambda: _retriever(trag)) as (url, batcher), \
            _http(jserve, jretr) as (jurl, _):
        for q in QUERIES:
            status, data = _post(url + "/query", {"query": q, "k": 4})
            assert status == 200
            assert data["results"] == [tserve.result_to_dict(r) for r in retriever.retrieve(q, 4)]
            _, jdata = _post(jurl + "/query", {"query": q, "k": 4})
            assert _json_rows(data["results"]) == _json_rows(jdata["results"])
            _close(data["results"], jdata["results"])
            assert all(r["learned_score"] is None for r in data["results"])
        status, data = _post(url + "/query", {"queries": QUERIES, "k": 3, "filter": {"all": ["odd"]}})
        assert status == 200 and data["batches"] == [
            [tserve.result_to_dict(r) for r in res]
            for res in retriever.retrieve_batch(QUERIES, 3, tag_filter=trag.TagFilter(all=("odd",)))]
        filters = [{"all": ["even"]} if i % 2 else None for i in range(len(QUERIES))]
        _, data = _post(url + "/query", {"queries": QUERIES, "k": 3, "filters": filters})
        assert data["batches"][1] and all(int(r["chunk_id"][1:]) % 2 == 0 for r in data["batches"][1])
        status, health = _get(url + "/health")
        assert status == 200 and health["status"] == "ok" and health["chunks"] == len(retriever)
        assert health["scan_tier"] == "none" and health["tier_fallbacks"] == 0
        assert health["queries_served"] >= len(QUERIES) and "p50_ms" in health
        for payload, code in (({"k": 3}, 400), ({"query": "   "}, 400), ({"query": "w001", "filter": {"anyof": ["x"]}},
                                                                           400)):
            status, data = _post(url + "/query", payload)
            assert status == code and "error" in data
        assert _post(url + "/nope", {})[0] == 404
        with pytest.raises(urllib.error.HTTPError):
            _get(url + "/nope")
        status, data = _post(url + "/reload", {})
        assert status == 200 and data == {"status": "reloaded", "chunks": len(retriever)}
        assert batcher.retriever is not retriever
        assert _post(jurl + "/reload", {})[0] == 501  # no loader configured
    assert tserve.result_to_tuple(retriever.retrieve(QUERIES[0], 1)[0])[5] is None  # learned_score's slot
    assert serve_worker.RESULT_FIELDS[5] == "learned_score"
    assert tserve._status_for(TimeoutError()) == 503 and tserve._status_for(RuntimeError()) == 500


def test_device_ipc_server_frames(retriever, tmp_path):
    batcher = tserve.MicroBatcher(retriever, max_batch=8, max_wait_ms=5.0)
    path = str(tmp_path / "d.sock")
    ipc = tserve.DeviceIPCServer(batcher, path)
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(TIMEOUT)
    try:
        conn.connect(path)
        serve_worker.send_msg(conn, ("query", QUERIES[0], 3, None))
        status, rows = serve_worker.recv_msg(conn)
        assert status == "ok" and serve_worker.rows_to_dicts(rows) == [
            tserve.result_to_dict(r) for r in retriever.retrieve(QUERIES[0], 3)]
        serve_worker.send_msg(conn, ("batch", QUERIES[:3], 2, None, {"all": ["even"]}))
        status, batches = serve_worker.recv_msg(conn)
        assert status == "ok" and len(batches) == 3
        assert all(int(r[6][1:]) % 2 == 0 for b in batches for r in b)
        serve_worker.send_msg(conn, ("health",))
        status, health = serve_worker.recv_msg(conn)
        assert status == "ok" and health["chunks"] == len(retriever)
        for frame, code in ((("reload",), 501), (("bogus",), 400), (("query", " ", 2, None), 400)):
            serve_worker.send_msg(conn, frame)
            reply = serve_worker.recv_msg(conn)
            assert reply[0] == "err" and reply[1] == code
    finally:
        conn.close()
        ipc.close()
        batcher.shutdown()


@pytest.mark.parametrize("workers", [1, 2])
def test_multiprocess_server(retriever, workers):
    batcher = tserve.MicroBatcher(retriever, max_batch=8, max_wait_ms=5.0)
    mp = tserve.MultiProcessServer(batcher, "127.0.0.1", 0, workers, index_loader=lambda: _retriever(trag),
                                   respawn_interval=0.1)
    try:
        url = f"http://127.0.0.1:{mp.port}"
        want = [[tserve.result_to_dict(r) for r in res] for res in retriever.retrieve_batch(QUERIES, 3)]
        got = [None] * len(QUERIES)

        def go(i):
            got[i] = _post(url + "/query", {"query": QUERIES[i], "k": 3})

        threads = [threading.Thread(target=go, args=(i,)) for i in range(len(QUERIES))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=TIMEOUT)
            assert not t.is_alive()
        assert [g[0] for g in got] == [200] * len(QUERIES)
        assert [g[1]["results"] for g in got] == want
        status, data = _post(url + "/query", {"queries": QUERIES, "k": 3})
        assert status == 200 and data["batches"] == want
        assert _post(url + "/query", {"query": "  "})[0] == 400
        status, health = _get(url + "/health")
        assert health["respawns"] == 0 and health["respawn_gave_up"] is None
        if workers == 2:
            victim = mp.procs[0]
            victim.kill()
            victim.wait(timeout=TIMEOUT)
            deadline = time.monotonic() + TIMEOUT
            while mp.respawns < 1 and time.monotonic() < deadline:
                time.sleep(0.05)  # polls the supervisor's counter, bounded by the deadline
            assert mp.respawns == 1 and mp.procs[0] is not victim and mp.procs[0].poll() is None
            assert [_post(url + "/query", {"query": q, "k": 3})[1]["results"] for q in QUERIES] == want
            assert _post(url + "/reload", {})[1]["status"] == "reloaded"
    finally:
        mp.stop()
        batcher.shutdown()
    assert all(p.poll() is not None for p in mp.procs)


def test_cli_serve_answers_like_cli_query(tmp_path):
    docs = tmp_path / "docs"
    docs.mkdir()
    for i, t in enumerate(_texts(24)):
        (docs / f"f{i:02d}.md").write_text(t)
    idx = str(tmp_path / "idx")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["--device", "cpu", "index", "--path", str(docs), "--output", idx, "--dimension", "32"]) == 0
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-u", "-m", "trueno_rag_tpu_torch.cli", "--device", "cpu", "serve",
                             "--index", idx, "--port", "0", "--max-batch", "4"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=ROOT)
    try:
        line, seen = "", []
        deadline = time.monotonic() + 2 * TIMEOUT
        while "serving" not in line and time.monotonic() < deadline:
            line = proc.stdout.readline()  # readiness: the server's own line
            assert line or proc.poll() is None, "".join(seen)
            seen.append(line)
        assert "serving 24 chunks on http://127.0.0.1:" in line, "".join(seen)
        url = line.split(" on ")[1].split()[0]
        for q in QUERIES[:3]:
            status, data = _post(url + "/query", {"query": q, "k": 5})
            want = json.loads(_run_query(q, idx))
            assert status == 200 and [(r["content"], r["title"]) for r in data["results"]] == [
                (r["content"], r["title"]) for r in want]
            _close(data["results"], want)
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=TIMEOUT)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=TIMEOUT)
        proc.stdout.close()


def _run_query(q, idx):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert tcli.main(["--device", "cpu", "query", q, "--index", idx, "--format", "json"]) == 0
    return buf.getvalue()
