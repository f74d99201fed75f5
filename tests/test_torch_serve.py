"""The port's serving daemon, shard router and staged hot swap against the
JAX package's, on the CPU.

Mirrors ``tests/test_serve.py``, ``tests/test_serve_router.py`` and the
staged-swap cases of ``tests/test_hot_swap.py``.  The port's server and the
JAX server, each over its package's engine on the same index, must give the
same responses to the same requests; the port's router must answer as one
engine over the whole corpus (ties in doc-id order).  Every socket wait has
its own timeout of at most 30 s; no test sleeps for a fixed time (waits are
on events, or polls of a condition with a deadline).
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path
from queue import Empty, Queue

import numpy as np
import pytest

from improving_learned_index_tpu.index.inverted import InvertedIndexData as JaxIndex
from improving_learned_index_tpu.search.engine import InvertedIndex as JaxHost
from improving_learned_index_tpu.search.hybrid_engine import HybridSearchEngine as JaxHybrid
from improving_learned_index_tpu.serve import RetrievalServer as JaxServer
from improving_learned_index_tpu.serve.router import RemoteShardedEngine as JaxRouter
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.search.engine import InvertedIndex
from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
from improving_learned_index_tpu_torch.serve import RetrievalServer
from improving_learned_index_tpu_torch.serve.router import (
    RemoteShardedEngine,
    ShardClient,
    _parse_shard_spec,
)
from improving_learned_index_tpu_torch.serve.server import _PendingSwapEngine

REPO = Path(__file__).resolve().parent.parent
TIMEOUT = 30.0

DOCS = [
    {"apple": 200, "banana": 100},
    {"apple": 150, "cherry": 50},
    {"banana": 250, "cherry": 10, "apple": 5},
    {"date": 77},
]


class _FakeTokenizer:
    def process_query(self, q):
        return set(q.split())


def _index(docs=DOCS, cls=InvertedIndexData):
    return cls.build(enumerate(docs), num_docs=len(docs))


class _Client:
    def __init__(self, port):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=TIMEOUT)
        self.f = self.sock.makefile("rb")

    def call(self, req):
        self.sock.sendall((json.dumps(req) + "\n").encode())
        return self.recv()

    def send_raw(self, data: bytes):
        self.sock.sendall(data)

    def recv(self):
        return json.loads(self.f.readline())

    def close(self):
        self.sock.close()


def _wait_for(cond, what, deadline=TIMEOUT):
    """Poll ``cond()`` until it holds, at most ``deadline`` seconds."""
    end = time.monotonic() + deadline
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.005)


@pytest.fixture()
def servers():
    """The port's and the JAX server over the same index, each with its
    package's host engine."""
    kw = dict(tokenizer=_FakeTokenizer(), top_k=10, max_batch=4, max_wait_ms=10.0,
              allow_shutdown=True)
    port_engine = InvertedIndex(_index())
    srv = RetrievalServer(port_engine, **kw)
    jsrv = JaxServer(JaxHost(_index(cls=JaxIndex)), **kw)
    srv.start()
    jsrv.start()
    yield srv, jsrv, port_engine
    srv.stop()
    jsrv.stop()


def _both(servers, reqs, raw=()):
    """Send the same requests to both servers on one connection each; the
    responses must be equal.  Returns the port server's."""
    srv, jsrv, _ = servers
    out = []
    for s in (srv, jsrv):
        c = _Client(s.port)
        got = [c.recv() for data in raw for _ in [c.send_raw(data)]]
        got += [c.call(r) for r in reqs]
        c.close()
        out.append(got)
    assert out[0] == out[1]
    return out[0]


def test_terms_query_ping_stats(servers):
    srv, _, engine = servers
    r = _both(servers, [
        {"op": "ping"},
        {"id": 1, "terms": ["apple", "banana"]},
        {"id": "q2", "query": "cherry date"},
    ])
    assert r[0] == {"op": "pong"}
    assert r[1]["id"] == 1
    assert r[1]["results"] == [[int(d), float(s)] for d, s in engine.score_batch([{"apple", "banana"}], 10)[0]]
    assert r[2]["results"] == [[int(d), float(s)] for d, s in engine.score_batch([{"cherry", "date"}], 10)[0]]
    c = _Client(srv.port)
    st = c.call({"op": "stats"})
    assert st["queries"] == 2 and st["batches"] >= 1
    assert st["latency_ms"]["p50"] is not None
    assert set(st) == {"op", "queries", "batches", "errors", "degraded", "uptime_s", "latency_ms"}
    c.close()


def test_k_override_and_unknown_terms(servers):
    r = _both(servers, [{"id": 5, "terms": ["apple"], "k": 1}, {"id": 6, "terms": ["nosuchterm"]}])
    assert len(r[0]["results"]) == 1 and r[0]["results"][0][0] == 0
    assert r[1]["results"] == []


def test_errors(servers):
    r = _both(servers, [{"id": 9}], raw=[b"this is not json\n"])
    assert "bad json" in r[0]["error"]
    assert "need 'terms' or 'query'" in r[1]["error"]


def test_malformed_k_does_not_kill_batch_loop(servers):
    r = _both(servers, [{"id": 1, "terms": ["apple"], "k": "abc"}, {"id": 2, "terms": ["apple"]}])
    assert "error" in r[0] and r[0]["id"] == 1
    assert r[1]["id"] == 2 and "results" in r[1]


def test_non_object_json_and_string_terms_rejected(servers):
    r = _both(servers, [{"id": 3, "terms": "apple"}, {"op": "ping"}], raw=[b"[1, 2]\n", b"5\n"])
    assert "error" in r[0] and "error" in r[1]
    assert "error" in r[2] and r[2]["id"] == 3
    assert r[3] == {"op": "pong"}


def test_concurrent_clients_batch_and_agree(servers):
    srv, _, engine = servers
    n = 24
    results, errors = {}, {}
    lock = threading.Lock()

    def worker(i):
        try:
            c = _Client(srv.port)
            r = c.call({"id": i, "terms": ["apple", "cherry"]})
            with lock:
                results[i] = r
            c.close()
        except Exception as e:  # surface, don't silently drop the slot
            with lock:
                errors[i] = repr(e)

    threads = [threading.Thread(target=worker, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=TIMEOUT)
    stuck = [i for i, t in enumerate(threads) if t.is_alive()]
    assert not stuck and not errors, f"stuck={stuck} errors={errors}"
    expect = [[int(d), float(s)] for d, s in engine.score_batch([{"apple", "cherry"}], 10)[0]]
    for i in range(n):
        assert results[i]["id"] == i and results[i]["results"] == expect
    st = srv.stats.snapshot()
    assert st["queries"] >= n and st["batches"] <= st["queries"]


def test_pairwise_expansion():
    out = []
    for server, index, host in ((RetrievalServer, InvertedIndexData, InvertedIndex),
                                (JaxServer, JaxIndex, JaxHost)):
        idx = index.build(enumerate([{"a": 1, "a|b": 7, "b": 2}]), num_docs=1)
        srv = server(host(idx), top_k=5, pairwise=True, max_wait_ms=1.0)
        srv.start()
        try:
            c = _Client(srv.port)
            out.append(c.call({"id": 0, "terms": ["a", "b"]}))
            c.close()
        finally:
            srv.stop()
    assert out[0] == out[1] == {"id": 0, "results": [[0, 10.0]]}  # 1 + 2 + composite 7


def test_client_disconnect_mid_batch(servers):
    srv = servers[0]
    ghost = _Client(srv.port)
    ghost.send_raw(b'{"id": "ghost", "terms": ["apple"]}\n')
    ghost.close()
    c = _Client(srv.port)
    r = c.call({"id": "live", "terms": ["apple"]})
    assert r["id"] == "live" and r["results"]
    c.close()


def test_overload_shedding():
    """max_queue=2 with the engine held on a gate: the flood past the bound
    is shed with explicit "overloaded" errors, the rest served."""
    gate = threading.Event()

    class GatedEngine:
        def __init__(self, inner):
            self.inner = inner

        def score_batch(self, term_sets, k):
            gate.wait(TIMEOUT)
            return self.inner.score_batch(term_sets, k)

    srv = RetrievalServer(GatedEngine(InvertedIndex(_index())), top_k=5, max_batch=1,
                          max_wait_ms=0.0, max_queue=2)
    srv.start()
    try:
        clients = [_Client(srv.port) for _ in range(8)]
        for i, c in enumerate(clients):
            c.send_raw(json.dumps({"id": i, "terms": ["apple"]}).encode() + b"\n")
        _wait_for(lambda: srv.stats.errors >= 1, "a shed request")
        gate.set()
        replies = [c.recv() for c in clients]
        shed = [r for r in replies if r.get("error") == "overloaded"]
        served = [r for r in replies if "results" in r]
        assert shed and served and len(shed) + len(served) == 8
        for c in clients:
            c.close()
    finally:
        gate.set()
        srv.stop()


def test_shutdown_op_and_refused_by_default(servers):
    assert _both(servers, [{"op": "shutdown"}]) == [{"op": "bye"}]
    srv = RetrievalServer(InvertedIndex(_index()), max_wait_ms=1.0)
    srv.start()
    try:
        c = _Client(srv.port)
        assert "not allowed" in c.call({"op": "shutdown"})["error"]
        c.close()
    finally:
        srv.stop()


def test_hot_swap_engine(servers):
    """swap_engine over a merged index: the next request sees the new corpus."""
    srv = servers[0]
    c = _Client(srv.port)
    assert c.call({"id": 1, "terms": ["newterm"]})["results"] == []
    bigger = InvertedIndexData.merge([_index(), _index([{"newterm": 42}])])
    srv.swap_engine(InvertedIndex(bigger))
    assert c.call({"id": 2, "terms": ["newterm"]})["results"] == [[len(DOCS), 42.0]]
    c.close()


def test_stop_drains_queue_with_explicit_errors():
    sent = []

    class _FakeConn:
        def sendall(self, data):
            sent.append(json.loads(data))

    srv = RetrievalServer(InvertedIndex(_index()), top_k=10)
    srv._stop.set()
    srv._queue.append((_FakeConn(), threading.Lock(), {"id": 9, "terms": ["apple"]}, 0.0))
    srv._batch_loop()  # sees stop, drains the queue with explicit errors
    assert sent == [{"id": 9, "error": "shutting down"}]
    assert not srv._queue and srv.stats.errors == 1


def test_pipelined_batches_overlap_and_stay_correct():
    """An async engine: batch i+1 is dispatched before batch i is finalized
    (pipeline_depth=2), and every reply stays exact and correctly routed.
    The first dispatch holds until more requests are queued, so the overlap
    does not depend on timing."""
    inner = InvertedIndex(_index())
    events = []
    elock = threading.Lock()
    srv = None

    class AsyncEngine:
        def score_batch_async(self, term_sets, k):
            with elock:
                first = not events
                events.append("dispatch")
            if first:
                _wait_for(lambda: len(srv._queue) >= 2, "queued requests")
            out = inner.score_batch(term_sets, k)

            def finalize():
                with elock:
                    events.append("finalize")
                return out

            return finalize

    srv = RetrievalServer(AsyncEngine(), top_k=5, max_batch=2, max_wait_ms=0.0)
    assert srv.pipeline_depth == 2
    srv.start()
    try:
        c = _Client(srv.port)
        n = 12
        c.send_raw(b"".join(json.dumps({"id": i, "terms": ["apple", "cherry"]}).encode() + b"\n"
                            for i in range(n)))
        results = {r["id"]: r for r in (c.recv() for _ in range(n))}
        c.close()
        expect = [[int(d), float(s)] for d, s in inner.score_batch([{"apple", "cherry"}], 5)[0]]
        assert sorted(results) == list(range(n))
        assert all(r["results"] == expect for r in results.values())
        in_flight = mx = 0
        for op in events:
            in_flight += 1 if op == "dispatch" else -1
            mx = max(mx, in_flight)
        assert mx >= 2, f"no overlap observed: {events}"
    finally:
        srv.stop()


def test_hybrid_engine_served_as_jax(tmp_path):
    """The port's hybrid engine on the CPU behind the port's server (the
    pipelined ``score_batch_async`` route) answers as the JAX hybrid engine
    behind the JAX server, over one seeded index."""
    rng = np.random.default_rng(0)
    docs = [{f"t{t}": int(rng.integers(1, 256)) for t in rng.choice(40, rng.integers(1, 9), replace=False)}
            for _ in range(300)]
    reqs = [{"id": i, "terms": [f"t{t}" for t in rng.choice(40, 3, replace=False)], "k": 20}
            for i in range(24)]
    port_srv = RetrievalServer(HybridSearchEngine(_index(docs), heavy_min=16, device="cpu"),
                               top_k=20, max_batch=8, max_wait_ms=2.0)
    jax_srv = JaxServer(JaxHybrid(_index(docs, JaxIndex), heavy_min=16), top_k=20, max_batch=8,
                        max_wait_ms=2.0)
    assert port_srv.engine.t_heavy > 0
    answers = []
    for s in (port_srv, jax_srv):
        s.start()
        try:
            c = _Client(s.port)
            c.send_raw(b"".join(json.dumps(r).encode() + b"\n" for r in reqs))
            answers.append(sorted((c.recv() for _ in reqs), key=lambda r: r["id"]))
            c.close()
        finally:
            s.stop()
    assert answers[0] == answers[1]
    assert all(a["results"] for a in answers[0])


def test_hybrid_release_frees_and_guards():
    idx = InvertedIndexData.build([(0, {"a": 5}), (1, {"a": 3, "b": 1})])
    eng = HybridSearchEngine(idx, heavy_min=2, device="cpu")
    assert eng.score_batch([{"a"}], 2)[0]
    eng.release()
    assert eng.dense is None and eng.doc_ids is None and eng.impacts is None
    with pytest.raises(RuntimeError, match="released"):
        eng.score_batch([{"a"}], 2)
    eng.release()  # idempotent


# -- staged swap (tests/test_hot_swap.py) -------------------------------------


class _FakeEngine:
    def __init__(self, name, log=None):
        self.name = name
        self.log = log if log is not None else []
        self.released = False

    def release(self):
        self.log.append(f"release:{self.name}")
        self.released = True

    def score_batch(self, term_sets, top_k=None):
        if self.released:
            raise RuntimeError("released")
        return [[(0, float(len(self.name)))] for _ in term_sets]


def _server(engine):
    return RetrievalServer(engine, top_k=10, max_batch=4, max_wait_ms=1.0)


def test_staged_swap_releases_before_build():
    log = []
    srv = _server(_FakeEngine("old", log))

    def build_new():
        log.append("build")
        return _FakeEngine("fresh", log)

    out = srv.swap_engine_staged(build_new)
    assert log == ["release:old", "build"], log
    assert srv.engine is out and out.name == "fresh"


def test_staged_swap_fallback_serves_during_build():
    old, fallback = _FakeEngine("old"), _FakeEngine("fb")
    srv = _server(old)
    answered = []

    def build_new():
        answered.append(srv.engine.score_batch([{"q"}])[0][0][1])
        return _FakeEngine("fresh")

    srv.swap_engine_staged(build_new, fallback_engine=fallback)
    assert answered == [2.0]  # len("fb")
    assert srv.engine.name == "fresh" and old.released


def test_staged_swap_pending_blocks_then_delegates():
    srv = _server(_FakeEngine("old"))
    gate = threading.Event()
    results = []

    def build_new():
        gate.wait(TIMEOUT)
        return _FakeEngine("fresh")

    t = threading.Thread(target=lambda: srv.swap_engine_staged(build_new), daemon=True)
    t.start()
    _wait_for(lambda: isinstance(srv.engine, _PendingSwapEngine), "the pending engine")
    pend = srv.engine
    q = threading.Thread(target=lambda: results.append(pend.score_batch([{"q"}])[0][0][1]), daemon=True)
    q.start()
    assert results == []  # the build has not returned
    gate.set()
    t.join(TIMEOUT)
    q.join(TIMEOUT)
    assert results == [5.0]  # len("fresh"): delegated to the new engine


def test_staged_swap_build_failure_keeps_fallback():
    old, fallback = _FakeEngine("old"), _FakeEngine("fb")
    srv = _server(old)

    def build_new():
        raise RuntimeError("boom")

    with pytest.raises(RuntimeError, match="boom"):
        srv.swap_engine_staged(build_new, fallback_engine=fallback)
    assert srv.engine is fallback and old.released


def test_staged_swap_build_failure_fails_pending_batches():
    srv = _server(_FakeEngine("old"))
    with pytest.raises(RuntimeError, match="boom"):
        srv.swap_engine_staged(lambda: (_ for _ in ()).throw(RuntimeError("boom")))
    with pytest.raises(RuntimeError, match="build failed"):
        srv.engine.score_batch([{"q"}])


def test_staged_swap_waits_for_batches_in_flight():
    """A batch dispatched to the old engine finishes on it: the staged swap
    releases the old engine only after that batch's finalize, so its
    client gets an answer, not an error."""
    log = []
    dispatched, gate = threading.Event(), threading.Event()

    class AsyncOld(_FakeEngine):
        def score_batch_async(self, term_sets, k):
            dispatched.set()

            def finalize():
                gate.wait(TIMEOUT)
                return self.score_batch(term_sets, k)  # raises once released

            return finalize

    srv = RetrievalServer(AsyncOld("old", log), top_k=10, max_batch=4, max_wait_ms=0.0)
    srv.start()
    try:
        c = _Client(srv.port)
        c.send_raw(b'{"id": 1, "terms": ["q"]}\n')
        assert dispatched.wait(TIMEOUT)
        t = threading.Thread(target=lambda: srv.swap_engine_staged(lambda: _FakeEngine("fresh", log)),
                             daemon=True)
        t.start()
        _wait_for(lambda: isinstance(srv.engine, _PendingSwapEngine), "the pending engine")
        assert log == []  # not released under the batch in flight
        gate.set()
        assert c.recv() == {"id": 1, "results": [[0, 3.0]]}  # len("old")
        t.join(TIMEOUT)
        assert log == ["release:old"] and srv.engine.name == "fresh"
        assert c.call({"id": 2, "terms": ["q"]}) == {"id": 2, "results": [[0, 5.0]]}
        c.close()
    finally:
        gate.set()
        srv.stop()


def test_staged_swap_of_hybrid_engines_answers_every_query_once():
    """The in-process daemon over the port's hybrid engine (CPU) while a
    client streams queries: a staged swap to a filtered index midway; every
    query is answered exactly once, by the old or the new engine, and after
    the swap by the new one."""
    rng = np.random.default_rng(1)
    docs = [{f"t{t}": int(rng.integers(1, 256)) for t in rng.choice(30, rng.integers(1, 7), replace=False)}
            for _ in range(400)]
    full = _index(docs)
    filtered = full.delete_docs(range(0, 400, 3))
    queries = [{f"t{t}" for t in rng.choice(30, 3, replace=False)} for _ in range(64)]
    old_rows = HybridSearchEngine(full, heavy_min=16, device="cpu").score_batch(queries, 10)
    new_rows = HybridSearchEngine(filtered, heavy_min=16, device="cpu").score_batch(queries, 10)
    as_json = lambda rows: [[[int(d), float(s)] for d, s in r] for r in rows]  # noqa: E731
    old_rows, new_rows = as_json(old_rows), as_json(new_rows)
    srv = RetrievalServer(HybridSearchEngine(full, heavy_min=16, device="cpu"), top_k=10,
                          max_batch=8, max_wait_ms=1.0)
    srv.start()
    answers = Queue()

    def reader(c, n):
        for _ in range(n):
            answers.put(c.recv())

    try:
        c = _Client(srv.port)
        t = threading.Thread(target=reader, args=(c, len(queries)), daemon=True)
        t.start()
        for i, q in enumerate(queries):
            c.send_raw(json.dumps({"id": i, "terms": sorted(q)}).encode() + b"\n")
            if i == len(queries) // 2:
                srv.swap_engine_staged(lambda: HybridSearchEngine(filtered, heavy_min=16, device="cpu"))
        got = []
        for _ in queries:
            try:
                got.append(answers.get(timeout=TIMEOUT))
            except Empty:
                raise AssertionError("a query was never answered")
        assert sorted(r["id"] for r in got) == list(range(len(queries)))
        for r in got:
            assert "error" not in r, r
            assert r["results"] in (old_rows[r["id"]], new_rows[r["id"]])
        assert sum(r["results"] == new_rows[r["id"]] != old_rows[r["id"]] for r in got) > 0
        for i, q in enumerate(queries[:8]):
            assert c.call({"id": i, "terms": sorted(q)})["results"] == new_rows[i]
        c.close()
    finally:
        srv.stop()


# -- router (tests/test_serve_router.py) --------------------------------------

# equal scores across shards exercise the global (score desc, doc asc) tie
RDOCS = [
    {"apple": 200, "banana": 100},
    {"apple": 150, "cherry": 50},
    {"banana": 250, "cherry": 10, "apple": 5},
    {"date": 77, "apple": 150},       # ties doc 1 on {"apple"}
    {"banana": 100, "apple": 200},    # ties doc 0 on {"apple","banana"}
    {"elder": 13},
]
SPLIT = 3


def _shard_servers(server=RetrievalServer, index=InvertedIndexData, host=InvertedIndex):
    full = index.build(enumerate(RDOCS), num_docs=len(RDOCS))
    s0 = index.build(enumerate(RDOCS[:SPLIT]), num_docs=SPLIT)
    s1 = index.build(enumerate(RDOCS[SPLIT:]), num_docs=len(RDOCS) - SPLIT)
    srv0 = server(host(s0), top_k=10, max_wait_ms=1.0)
    srv1 = server(host(s1), top_k=10, max_wait_ms=1.0)
    srv0.start()
    srv1.start()
    return full, srv0, srv1


def _rows(rows):
    return [[(int(d), float(s)) for d, s in row] for row in rows]


def test_router_matches_single_engine_and_jax_router():
    full, srv0, srv1 = _shard_servers()
    _, jsrv0, jsrv1 = _shard_servers(JaxServer, JaxIndex, JaxHost)
    try:
        router = RemoteShardedEngine(f"127.0.0.1:{srv0.port}:0,127.0.0.1:{srv1.port}:{SPLIT}")
        jrouter = JaxRouter(f"127.0.0.1:{jsrv0.port}:0,127.0.0.1:{jsrv1.port}:{SPLIT}")
        queries = [{"apple"}, {"apple", "banana"}, {"cherry", "date"}, {"elder"}, {"nosuchterm"}, set()]
        got = router.score_batch(queries, 10)
        assert _rows(got) == _rows(InvertedIndex(full).score_batch(queries, 10))
        assert _rows(got) == _rows(jrouter.score_batch(queries, 10))
        got2 = router.score_batch([{"apple"}], 2)  # k cut AFTER the global merge
        assert got2[0] == InvertedIndex(full).score_batch([{"apple"}], 2)[0] and len(got2[0]) == 2
        router.close()
        jrouter.close()
    finally:
        for s in (srv0, srv1, jsrv0, jsrv1):
            s.stop()


def test_router_tier_composes_as_daemon():
    full, srv0, srv1 = _shard_servers()
    try:
        router = RemoteShardedEngine(f"127.0.0.1:{srv0.port}:0,127.0.0.1:{srv1.port}:{SPLIT}")
        top = RetrievalServer(router, top_k=10, max_wait_ms=1.0)
        top.start()
        try:
            c = _Client(top.port)
            r = c.call({"id": 1, "terms": ["apple", "banana"], "k": 4})
            want = InvertedIndex(full).score_batch([{"apple", "banana"}], 4)[0]
            assert r["results"] == [[int(d), float(s)] for d, s in want]
            c.close()
        finally:
            top.stop()
        router.close()
    finally:
        srv0.stop()
        srv1.stop()


def test_router_shard_failure_surfaces_as_error():
    _, srv0, srv1 = _shard_servers()
    router = RemoteShardedEngine(f"127.0.0.1:{srv0.port},127.0.0.1:{srv1.port}:{SPLIT}")
    router.score_batch([{"apple"}], 5)
    srv1.stop()
    try:
        with pytest.raises(RuntimeError, match="unreachable|shard"):
            router.score_batch([{"apple"}], 5)
    finally:
        router.close()
        srv0.stop()


def test_client_reconnects_after_backend_restart():
    _, srv0, srv1 = _shard_servers()
    srv1.stop()
    client = ShardClient("127.0.0.1", srv0.port, 0, timeout=TIMEOUT)
    first = client.score_batch([{"apple"}], 5)
    port = srv0.port
    srv0.stop()
    srv0b = RetrievalServer(InvertedIndex(_index(RDOCS[:SPLIT])), top_k=10, max_wait_ms=1.0, port=port)
    srv0b.start()
    try:
        assert client.score_batch([{"apple"}], 5) == first  # one transparent reconnect
    finally:
        client.close()
        srv0b.stop()


def test_shard_error_mid_batch_closes_connection_and_recovers():
    """An error for ONE query of a pipelined batch closes the connection
    before raising: the sibling responses still buffered must not be read
    as a later batch's answers."""

    def fake_shard(server_sock, expect, replies):
        conn, _ = server_sock.accept()
        f = conn.makefile("rb")
        n = 0
        while n < expect:
            if f.readline().strip():
                n += 1
        for resp in replies:
            conn.sendall((json.dumps(resp) + "\n").encode())
        conn.close()

    srv = socket.socket()
    srv.settimeout(TIMEOUT)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    port = srv.getsockname()[1]
    t = threading.Thread(target=fake_shard, daemon=True, args=(
        srv, 2, [{"id": 0, "error": "overloaded"}, {"id": 1, "results": [[3, 1.0]]}]))
    t.start()
    client = ShardClient("127.0.0.1", port, doc_offset=0, timeout=TIMEOUT)
    with pytest.raises(RuntimeError, match="overloaded"):
        client.score_batch([{"a"}, {"b"}], 5)
    assert client._sock is None  # closed, not poisoned
    t.join(TIMEOUT)
    t2 = threading.Thread(target=fake_shard, args=(srv, 1, [{"id": 0, "results": [[0, 9.0]]}]), daemon=True)
    t2.start()
    assert client.score_batch([{"c"}], 5) == [[(0, 9.0)]]  # its own result
    t2.join(TIMEOUT)
    srv.close()
    client.close()


def test_parse_shard_spec_validation():
    cs = _parse_shard_spec("h1:8000,h2:8001:300")
    assert [(c.host, c.port, c.doc_offset) for c in cs] == [("h1", 8000, 0), ("h2", 8001, 300)]
    c6 = _parse_shard_spec("[::1]:8000:5")[0]
    assert (c6.host, c6.port, c6.doc_offset) == ("::1", 8000, 5)
    for bad in ("::1:8000", "h1", "h1:-1x", ":8000", "h1:8000:5:9"):
        with pytest.raises(ValueError):
            _parse_shard_spec(bad)


def test_router_allow_partial_survives_dead_shard_mid_stream():
    _, srv0, srv1 = _shard_servers()
    router = RemoteShardedEngine(f"127.0.0.1:{srv0.port}:0,127.0.0.1:{srv1.port}:{SPLIT}",
                                 shard_timeout=5.0, allow_partial=True)
    top = RetrievalServer(router, top_k=10, max_wait_ms=1.0)
    top.start()
    try:
        c = _Client(top.port)
        healthy = c.call({"id": 1, "terms": ["apple"], "k": 5})
        assert "degraded" not in healthy and "error" not in healthy
        srv1.stop()
        r = c.call({"id": 2, "terms": ["apple"], "k": 5})
        assert "error" not in r
        assert r["degraded"]["failed_shards"] == [f"127.0.0.1:{srv1.port}"]
        s0_only = InvertedIndex(_index(RDOCS[:SPLIT])).score_batch([{"apple"}], 5)[0]
        assert r["results"] == [[int(d), float(s)] for d, s in s0_only]
        c2 = _Client(top.port)
        assert c2.call({"op": "stats"})["degraded"] >= 1
        c2.close()
        c.close()
    finally:
        top.stop()
        router.close()
        srv0.stop()


def test_router_all_shards_dead_still_errors():
    _, srv0, srv1 = _shard_servers()
    router = RemoteShardedEngine(f"127.0.0.1:{srv0.port}:0,127.0.0.1:{srv1.port}:{SPLIT}",
                                 shard_timeout=5.0, allow_partial=True)
    try:
        router.score_batch([{"apple"}], 5)
        srv0.stop()
        srv1.stop()
        with pytest.raises(RuntimeError, match="shard"):
            router.score_batch([{"apple"}], 5)
    finally:
        router.close()


def test_router_detailed_reports_failure_and_recovers():
    full, srv0, srv1 = _shard_servers()
    router = RemoteShardedEngine(f"127.0.0.1:{srv0.port}:0,127.0.0.1:{srv1.port}:{SPLIT}",
                                 shard_timeout=5.0, allow_partial=True)
    try:
        assert router.score_batch_detailed([{"apple"}], 5)[1] == {}
        port1 = srv1.port
        srv1.stop()
        assert list(router.score_batch_detailed([{"apple"}], 5)[1]) == [f"127.0.0.1:{port1}"]
        srv1b = RetrievalServer(InvertedIndex(_index(RDOCS[SPLIT:])), top_k=10, max_wait_ms=1.0, port=port1)
        srv1b.start()
        try:
            got, failed = router.score_batch_detailed([{"apple"}], 10)
            assert failed == {}
            assert _rows(got) == _rows(InvertedIndex(full).score_batch([{"apple"}], 10))
        finally:
            srv1b.stop()
    finally:
        router.close()
        srv0.stop()


# -- cli.serve ----------------------------------------------------------------


def _start_cli(args, cwd):
    """``cli.serve`` in a process of its own; returns (process, port) once it
    prints its ``serving ... on host:port`` line."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "improving_learned_index_tpu_torch.cli.serve", *args],
        cwd=cwd, env=dict(os.environ, PYTHONPATH=str(REPO)),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines = Queue()
    threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout], daemon=True).start()
    seen = []
    end = time.monotonic() + 120  # the process imports torch first
    while time.monotonic() < end:
        try:
            line = lines.get(timeout=max(0.0, min(TIMEOUT, end - time.monotonic())))
        except Empty:
            break
        seen.append(line)
        if line.startswith("serving ") and " on " in line:
            return proc, int(line.rsplit(":", 1)[1])
    proc.kill()
    raise AssertionError(f"cli.serve never came up: {''.join(seen)[-2000:]}")


@pytest.mark.parametrize("engine", [["--engine", "auto", "--device", "cpu"], ["--engine", "host"]])
def test_cli_serve_subprocess(tmp_path, engine):
    """cli.serve end to end in a process of its own (the hybrid or device
    engine on the CPU, or the host engine): index and vocab from disk,
    warmup, a query text over TCP, remote shutdown, exit code 0."""
    _index().save(tmp_path / "inv")
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\napple\nbanana\ncherry\ndate\n")
    proc, port = _start_cli(["--index_path", str(tmp_path / "inv"), "--vocab_path", str(tmp_path / "vocab.txt"),
                             "--port", "0", "--top_k", "5", "--max_wait_ms", "1",
                             "--allow_remote_shutdown", *engine], tmp_path)
    try:
        c = _Client(port)
        r = c.call({"id": 1, "query": "apple banana"})
        want = InvertedIndex(_index()).score_batch([{"apple", "banana"}], 5)[0]
        assert r["results"] == [[int(d), float(s)] for d, s in want]
        assert c.call({"op": "shutdown"}) == {"op": "bye"}
        c.close()
        assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        if proc.poll() is None:
            proc.kill()


def test_cli_serve_router_mode_over_cli_shards(tmp_path):
    """Two cli.serve shard daemons (hybrid on the CPU) from cli.split_index's
    manifest behind a cli.serve router: the router's answers equal one
    engine over the whole index."""
    from improving_learned_index_tpu_torch.cli.split_index import main as split_main

    _index(RDOCS).save(tmp_path / "inv")
    assert split_main(["-i", str(tmp_path / "inv"), "-o", str(tmp_path / "shards"), "--n_shards", "2",
                       "--num_docs", str(len(RDOCS))]) == 0
    manifest = json.loads((tmp_path / "shards" / "shards.json").read_text())
    procs = []
    try:
        specs = []
        for m in manifest:
            proc, port = _start_cli(["--index_path", str(tmp_path / "shards" / m["path"]),
                                     "--num_docs", str(m["num_docs"]), "--port", "0", "--device", "cpu",
                                     "--allow_remote_shutdown"], tmp_path)
            procs.append((proc, port))
            specs.append(f"127.0.0.1:{port}:{m['doc_offset']}")
        router, rport = _start_cli(["--shards", ",".join(specs), "--port", "0", "--allow_remote_shutdown"],
                                   tmp_path)
        procs.insert(0, (router, rport))
        c = _Client(rport)
        direct = InvertedIndex(_index(RDOCS))
        for i, q in enumerate([["apple"], ["apple", "banana"], ["cherry", "date"], ["elder"]]):
            want = direct.score_batch([set(q)], 10)[0]
            assert c.call({"id": i, "terms": q, "k": 10})["results"] == [[int(d), float(s)] for d, s in want]
        c.close()
        for proc, port in procs:
            c = _Client(port)
            assert c.call({"op": "shutdown"}) == {"op": "bye"}
            c.close()
            assert proc.wait(timeout=TIMEOUT) == 0
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()


def test_cli_serve_without_cuda_raises(tmp_path):
    """The card engines default to cuda: without a card cli.serve raises
    before it binds a port, unless given --device cpu; router mode takes no
    device."""
    import torch

    from improving_learned_index_tpu_torch.cli.serve import main as serve_main

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _index().save(tmp_path / "inv")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve_main(["--index_path", str(tmp_path / "inv"), "--port", "0"])
    with pytest.raises(SystemExit):
        serve_main(["--shards", "127.0.0.1:1", "--device", "cpu"])
    with pytest.raises(SystemExit):
        serve_main(["--port", "0"])
