"""Retrieval serving daemon: load the index once, serve queries over TCP
with dynamic micro-batching.

The port's copy of ``improving_learned_index_tpu/serve/server.py``.  The
reference has no serving process (its rank.py is a batch CLI over a query
file).  A long-lived process pays the engine build and the kernel loads
once and coalesces concurrently arriving single queries into card batches:
a batch of 64 costs the card little more than a batch of 1.

Protocol: newline-delimited JSON over TCP.

    -> {"id": 7, "query": "quick brown foxes"}        tokenizer-side terms
    -> {"id": 8, "terms": ["quick", "brown"], "k": 10}  pre-processed terms
    -> {"op": "ping"} | {"op": "stats"} | {"op": "shutdown"}
    <- {"id": 7, "results": [[doc_id, score], ...]}
    <- {"id": 8, "error": "..."}

Batching: requests queue up; a dispatch fires when ``max_batch`` queries
are waiting or the oldest has waited ``max_wait_ms``.  Engines are the
same objects the rank CLI uses (``score_batch(term_sets, k)``), so every
engine (hybrid/device on the card, host/native on the host, the remote
router) serves unchanged; ``score_batch_async`` engines are pipelined
``pipeline_depth`` batches deep.  ``swap_engine`` replaces the engine
atomically for live index updates (incremental merge/delete),
``swap_engine_staged`` releases the old engine before building the new one,
and ``max_queue`` bounds memory under flood by shedding with explicit
"overloaded" errors.
"""

from __future__ import annotations

import json
import socket
import threading
import time
from collections import deque
from typing import List, Optional, Tuple

from ..core.logging import get_logger
from ..utils.text_utils import expand_pairwise_terms

logger = get_logger("serve")


def answer(qid, scores, k: int, failed_shards=None) -> dict:
    """One query's response: its first ``k`` (doc, score) rows, with the
    failed shards named when the answer is exact over the live shards
    only (router ``allow_partial`` mode)."""
    resp = {"id": qid, "results": [[int(d), float(s)] for d, s in scores[:k]]}
    if failed_shards:
        # explicit per-query degradation notice: never silently-missing
        # documents
        resp["degraded"] = {"failed_shards": sorted(failed_shards)}
    return resp


def encode(obj) -> bytes:
    """One protocol line."""
    return (json.dumps(obj) + "\n").encode()


class _PendingSwapEngine:
    """Placeholder engine during a staged swap with no fallback: batches
    block (bounded) until the replacement engine is live, then delegate to
    it.  Exposes only the sync ``score_batch`` so the server's batch loop
    blocks at finalize time: queued requests wait out the swap."""

    def __init__(self, server: "RetrievalServer", timeout: float):
        self._server = server
        self._done = threading.Event()
        self._error: Optional[str] = None
        self._timeout = timeout

    def ready(self) -> None:
        self._done.set()

    def fail(self, message: str) -> None:
        self._error = message
        self._done.set()

    def score_batch(self, term_sets, top_k=None):
        if not self._done.wait(self._timeout):
            raise RuntimeError("engine swap still in progress")
        if self._error is not None:
            raise RuntimeError(self._error)
        return self._server.engine.score_batch(term_sets, top_k)


class _Stats:
    def __init__(self, maxlen: int = 4096):
        self.lock = threading.Lock()
        self.queries = 0
        self.batches = 0
        self.errors = 0
        self.degraded = 0  # queries answered from a partial shard set
        self.latencies_ms = deque(maxlen=maxlen)
        self.started = time.time()

    def reset(self) -> None:
        """Zero every counter (e.g. after a warmup phase whose compile
        stalls should not pollute monitored percentiles)."""
        with self.lock:
            self.queries = self.batches = self.errors = self.degraded = 0
            self.latencies_ms.clear()
            self.started = time.time()

    def record_batch(self, n: int, per_query_ms: List[float]) -> None:
        with self.lock:
            self.queries += n
            self.batches += 1
            self.latencies_ms.extend(per_query_ms)

    def snapshot(self) -> dict:
        with self.lock:
            lat = sorted(self.latencies_ms)
            q = lambda p: round(lat[min(int(p * len(lat)), len(lat) - 1)], 2) if lat else None
            return {
                "queries": self.queries,
                "batches": self.batches,
                "errors": self.errors,
                "degraded": self.degraded,
                "uptime_s": round(time.time() - self.started, 1),
                "latency_ms": {"p50": q(0.50), "p95": q(0.95), "p99": q(0.99)},
            }


class RetrievalServer:
    """TCP serving loop around any ``score_batch`` engine."""

    def __init__(
        self,
        engine,
        tokenizer=None,
        top_k: int = 1000,
        max_batch: int = 64,
        max_wait_ms: float = 5.0,
        pairwise: bool = False,
        host: str = "127.0.0.1",
        port: int = 0,
        allow_shutdown: bool = False,
        max_queue: int = 4096,
        pipeline_depth: int = 2,
    ):
        self.engine = engine
        self.tokenizer = tokenizer
        self.top_k = top_k
        self.max_batch = max_batch
        self.max_wait_ms = max_wait_ms
        self.pairwise = pairwise
        self.allow_shutdown = allow_shutdown
        self.max_queue = max_queue
        # batches concurrently in flight at the engine (1 = the sequential
        # loop; 2 hides one device round trip behind the next collection)
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._host, self._requested_port = host, port
        self.port: Optional[int] = None
        self.stats = _Stats()
        self._queue: deque = deque()  # (conn, lock, req, t_enqueue)
        self._queue_cv = threading.Condition()
        self._stop = threading.Event()
        self._sock: Optional[socket.socket] = None
        self._threads: List[threading.Thread] = []
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        # batches dispatched but not finalized, per engine (id -> count): a
        # staged swap releases the old engine only once its batches are done
        self._inflight: dict = {}
        self._inflight_cv = threading.Condition()

    def swap_engine(self, engine, tokenizer=None) -> None:
        """Atomically replace the serving engine (live index update: build
        the new engine — e.g. after an incremental ``merge`` or
        ``filter_docs`` — then swap; in-flight batches finish on the old
        engine, the next batch uses the new one).  No restart, no dropped
        requests.

        Building the replacement BEFORE calling this keeps both engines
        resident on the card; use ``swap_engine_staged`` when there is no
        room for two."""
        if tokenizer is not None:
            self.tokenizer = tokenizer
        self.engine = engine  # single attribute store: atomic under the GIL

    def swap_engine_staged(
        self,
        build_new,
        fallback_engine=None,
        tokenizer=None,
        swap_timeout: float = 600.0,
    ):
        """Memory-safe live swap: RELEASE the old engine's device buffers
        before constructing its replacement, so peak card memory is one
        engine plus build transients, never two full engines
        (``HybridSearchEngine.release``).

        During the build window queries are answered by ``fallback_engine``
        (e.g. the exact host postings engine ``search.engine.InvertedIndex``:
        slower, never wrong), or, with no fallback, wait in the pipeline
        until the new engine is live (bounded by ``swap_timeout``; the
        request queue keeps shedding with explicit "overloaded" errors past
        ``max_queue``).  Batches already dispatched to the old engine finish
        on it before it is released (a release under a batch in flight would
        fail that batch).  ``build_new`` is a zero-arg callable returning the
        replacement engine."""
        pend = (
            fallback_engine
            if fallback_engine is not None
            else _PendingSwapEngine(self, swap_timeout)
        )
        with self._inflight_cv:
            old, self.engine = self.engine, pend
            if not self._inflight_cv.wait_for(
                lambda: not self._inflight.get(id(old)), timeout=swap_timeout
            ):
                logger.warning("staged swap: batches on the old engine still in flight")
        release = getattr(old, "release", None)
        del old  # drop the last strong reference before building
        if release is not None:
            release()
            del release
        try:
            new_engine = build_new()
        except Exception:
            # the old engine is gone; leave the fallback serving rather
            # than flipping to a broken engine
            logger.error("staged swap build failed; fallback engine stays live")
            if isinstance(pend, _PendingSwapEngine):
                pend.fail("engine swap build failed")
            raise
        self.swap_engine(new_engine, tokenizer)
        if isinstance(pend, _PendingSwapEngine):
            pend.ready()
        return new_engine

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        # SO_REUSEADDR covers the restart case (TIME_WAIT/FIN_WAIT sockets
        # from the previous instance); deliberately NOT SO_REUSEPORT — that
        # would let a second daemon bind the same port and silently steal a
        # kernel-balanced share of connections (e.g. serving a stale index),
        # where EADDRINUSE is the error the operator needs to see
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((self._host, self._requested_port))
        self._sock.listen(128)
        # a blocked accept() is NOT interrupted by close() on Linux — poll
        # with a short timeout so stop() returns promptly
        self._sock.settimeout(0.2)
        self.port = self._sock.getsockname()[1]
        for target in (self._accept_loop, self._batch_loop):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)
        logger.info(f"serving on {self._host}:{self.port}")
        return self.port

    def stop(self) -> None:
        self._stop.set()
        with self._queue_cv:
            self._queue_cv.notify_all()
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
        # close live client connections so the port is immediately
        # rebindable (a restart on the same port must not EADDRINUSE on
        # lingering established sockets)
        with self._conns_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                # shutdown, not close: the reader thread's makefile holds a
                # reference that defers close(), so only shutdown actually
                # sends the FIN that unblocks clients NOW
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        for t in self._threads:
            t.join(timeout=5)

    def serve_forever(self) -> None:
        if self.port is None:
            self.start()
        try:
            while not self._stop.is_set():
                time.sleep(0.2)
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()

    # -- network -----------------------------------------------------------
    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                return  # socket closed by stop()
            conn.settimeout(None)  # inherited listener timeout: undo
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            t = threading.Thread(target=self._conn_loop, args=(conn,), daemon=True)
            t.start()

    def _conn_loop(self, conn: socket.socket) -> None:
        send_lock = threading.Lock()
        with self._conns_lock:
            self._conns.add(conn)
        f = conn.makefile("rb")
        try:
            for line in f:
                if not line.strip():
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    self._send(conn, send_lock, {"error": f"bad json: {e}"})
                    with self.stats.lock:
                        self.stats.errors += 1
                    continue
                if not isinstance(req, dict):
                    # valid JSON but not a request object ('5', '[1,2]'):
                    # reply instead of letting req.get kill the conn thread
                    self._send(conn, send_lock, {"error": "request must be a JSON object"})
                    with self.stats.lock:
                        self.stats.errors += 1
                    continue
                op = req.get("op")
                if op == "ping":
                    self._send(conn, send_lock, {"op": "pong"})
                elif op == "stats":
                    self._send(conn, send_lock, {"op": "stats", **self.stats.snapshot()})
                elif op == "shutdown":
                    if self.allow_shutdown:
                        self._send(conn, send_lock, {"op": "bye"})
                        self._stop.set()
                        with self._queue_cv:
                            self._queue_cv.notify_all()
                        return
                    self._send(conn, send_lock, {"error": "shutdown not allowed"})
                else:
                    with self._queue_cv:
                        if len(self._queue) >= self.max_queue:
                            overloaded = True
                        else:
                            overloaded = False
                            self._queue.append((conn, send_lock, req, time.time()))
                            self._queue_cv.notify()
                    if overloaded:
                        # bounded back-pressure: shed load with an explicit
                        # error instead of queueing unboundedly
                        self._send(
                            conn, send_lock,
                            {"id": req.get("id"), "error": "overloaded"},
                        )
                        with self.stats.lock:
                            self.stats.errors += 1
        except (OSError, ValueError):
            pass
        finally:
            with self._conns_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _send(conn, lock, obj) -> None:
        data = encode(obj)
        try:
            with lock:
                conn.sendall(data)
        except OSError:
            pass  # client went away

    # -- batching ----------------------------------------------------------
    def _take_batch(self, block: bool = True) -> List[Tuple]:
        """Block until work, then collect up to max_batch requests, waiting
        at most max_wait_ms past the first for stragglers.  On stop, returns
        EVERYTHING still queued so the batch loop can refuse it explicitly.
        ``block=False`` (batches in flight): return [] immediately when the
        queue is empty, so the caller can finalize instead of stalling."""
        with self._queue_cv:
            if not block and not self._queue:
                return []
            while not self._queue and not self._stop.is_set():
                self._queue_cv.wait(timeout=0.2)
            if self._stop.is_set():
                out = list(self._queue)
                self._queue.clear()
                return out
            deadline = self._queue[0][3] + self.max_wait_ms / 1e3
            while len(self._queue) < self.max_batch:
                remaining = deadline - time.time()
                if remaining <= 0:
                    break
                self._queue_cv.wait(timeout=remaining)
            out = []
            while self._queue and len(out) < self.max_batch:
                out.append(self._queue.popleft())
            return out

    def _terms_of(self, req: dict) -> set:
        if "terms" in req:
            if not isinstance(req["terms"], (list, tuple, set)):
                # a bare string would silently score character-by-character
                raise ValueError("'terms' must be a list of strings")
            terms = set(map(str, req["terms"]))
        elif "query" in req:
            if self.tokenizer is None:
                raise ValueError("server has no tokenizer; send 'terms'")
            terms = self.tokenizer.process_query(str(req["query"]))
        else:
            raise ValueError("need 'terms' or 'query'")
        if self.pairwise:
            expand_pairwise_terms(terms)
        return terms

    def _batch_loop(self) -> None:
        # Pipelined: dispatch batch i+1 to the engine BEFORE finalizing
        # batch i, so host-side collection and the card's work and result
        # copy of consecutive micro-batches overlap, ``pipeline_depth``
        # batches deep (engine.score_batch_async).
        pending: deque = deque()  # (finalize_fn, live, engine)
        while True:
            if self._stop.is_set():
                # finish what the engine already accepted, then refuse the
                # still-queued rest explicitly instead of silently dropping
                # it (a pipelined client would otherwise see a bare FIN for
                # requests the daemon accepted)
                while pending:
                    self._finalize(*pending.popleft())
                batch = []
                with self._queue_cv:
                    batch = list(self._queue)
                    self._queue.clear()
                for conn, lock, req, _ in batch:
                    self._send(conn, lock, {"id": req.get("id"), "error": "shutting down"})
                if batch:
                    with self.stats.lock:
                        self.stats.errors += len(batch)
                return
            with self._queue_cv:
                have_queued = bool(self._queue)
            if pending and (len(pending) >= self.pipeline_depth or not have_queued):
                self._finalize(*pending.popleft())
                continue
            batch = self._take_batch(block=not pending)
            if self._stop.is_set():
                # _take_batch drained the queue on stop: hand its batch back
                # so the shutdown branch above is the only refusal path
                with self._queue_cv:
                    self._queue.extendleft(reversed(batch))
                continue
            if not batch:
                continue
            try:
                item = self._dispatch_batch(batch)
                if item is not None:
                    pending.append(item)
            except Exception as e:  # the batch thread must never die: one
                # malformed request or engine bug would otherwise hang every
                # future query while ping/stats still answer (silent DoS)
                logger.error(f"batch dispatch failed: {e!r}")
                for conn, lock, req, _ in batch:
                    self._send(conn, lock, {"id": req.get("id"), "error": f"internal: {e}"})
                with self.stats.lock:
                    self.stats.errors += len(batch)

    def _dispatch_batch(self, batch: List[Tuple]):
        """Validate requests and hand the batch to the engine.  Returns
        ``(finalize_fn, live)`` where ``finalize_fn() -> (results,
        failed_shards)`` blocks on the engine, or None if nothing was
        admitted."""
        term_sets, live, k = [], [], 1
        for conn, lock, req, t0 in batch:
            try:
                terms = self._terms_of(req)
                want_k = int(req.get("k", self.top_k))  # validate BEFORE admitting
                term_sets.append(terms)
                live.append((conn, lock, req, t0, want_k))
                k = max(k, want_k)
            except Exception as e:
                self._send(conn, lock, {"id": req.get("id"), "error": str(e)})
                with self.stats.lock:
                    self.stats.errors += 1
        if not live:
            return None
        with self._inflight_cv:
            engine = self.engine  # pin: a concurrent swap must not split a batch
            self._inflight[id(engine)] = self._inflight.get(id(engine), 0) + 1
        detailed = getattr(engine, "score_batch_detailed", None)
        async_fn = getattr(engine, "score_batch_async", None)
        if detailed is not None:
            fin = lambda: detailed(term_sets, k)  # noqa: E731
        elif async_fn is not None:
            try:
                inner = async_fn(term_sets, k)  # dispatches NOW, fetch deferred
            except Exception as e:
                self._done_with(engine)
                logger.error(f"score_batch_async dispatch failed: {e}")
                for conn, lock, req, t0, _ in live:
                    self._send(conn, lock, {"id": req.get("id"), "error": f"engine: {e}"})
                with self.stats.lock:
                    self.stats.errors += len(live)
                return None
            fin = lambda: (inner(), {})  # noqa: E731
        else:
            fin = lambda: (engine.score_batch(term_sets, k), {})  # noqa: E731
        return fin, live, engine

    def _done_with(self, engine) -> None:
        with self._inflight_cv:
            n = self._inflight.pop(id(engine)) - 1
            if n:
                self._inflight[id(engine)] = n
            self._inflight_cv.notify_all()

    def _finalize(self, fin, live, engine) -> None:
        try:
            results, failed_shards = fin()
        except Exception as e:
            logger.error(f"score_batch failed: {e}")
            for conn, lock, req, t0, _ in live:
                self._send(conn, lock, {"id": req.get("id"), "error": f"engine: {e}"})
            with self.stats.lock:
                self.stats.errors += len(live)
            return
        finally:
            self._done_with(engine)
        now = time.time()
        # Record BEFORE sending: a client that has its answer must see
        # itself in a stats snapshot (tests and monitoring rely on
        # "response received => counted"; recording after the send loop
        # races the client's follow-up stats call).
        self.stats.record_batch(
            len(live), [(now - t0) * 1e3 for (_, _, _, t0, _) in live]
        )
        if failed_shards:
            with self.stats.lock:
                self.stats.degraded += len(live)
        for (conn, lock, req, t0, want_k), scores in zip(live, results):
            self._send(conn, lock, answer(req.get("id"), scores, want_k, failed_shards))
