"""Doc-sharded serving tier: fan queries out to shard daemons, merge top-k.

The port's copy of ``improving_learned_index_tpu/serve/router.py``.  Scaling
past one card means doc-sharding the corpus across daemons, each running
its own ``cli.serve`` over its shard (``cli.split_index`` writes the shards
and their offsets).  ``RemoteShardedEngine`` presents those daemons as one
engine: it implements the same ``score_batch(term_sets, k)`` interface
every local engine has, so a router is a ``cli.serve`` daemon whose engine
is remote (``--shards host:port:doc_offset,...``), and tiers compose.

Exactness: disjoint doc shards mean a document's score comes entirely from
its shard; the merged top-k over per-shard top-k lists is exact as long as
each shard returns its own k best (it does), ordered score desc / global
doc id asc: identical to a single engine over the whole corpus, whose
exact top-k takes boundary ties in doc-id order.

No reference equivalent (the reference is single-process).
"""

from __future__ import annotations

import json
import socket
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Sequence, Set, Tuple

from ..core.logging import get_logger

logger = get_logger("router")


def merge(results, top_k: int) -> List[List[Tuple[int, float]]]:
    """Each query's top ``top_k`` over the shards' rows (``results[shard]
    [query]``, global doc ids), score descending then doc ascending."""
    merged = []
    for per_shard in zip(*results):
        rows = [row for shard_rows in per_shard for row in shard_rows]
        rows.sort(key=lambda ds: (-ds[1], ds[0]))
        merged.append(rows[:top_k])
    return merged


class ShardClient:
    """Persistent newline-JSON connection to one shard daemon.  Pipelines a
    whole batch (send all, then read all) per call; thread-safe."""

    def __init__(self, host: str, port: int, doc_offset: int = 0, timeout: float = 120.0):
        self.host, self.port, self.doc_offset = host, port, doc_offset
        self._lock = threading.Lock()
        self._timeout = timeout
        self._sock = None
        self._file = None

    def _connect(self):
        self._sock = socket.create_connection((self.host, self.port), timeout=self._timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._file = self._sock.makefile("rb")

    def close(self):
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None
            self._file = None

    def score_batch(
        self, term_sets: Sequence[Set[str]], top_k: int
    ) -> List[List[Tuple[int, float]]]:
        """Score a batch on this shard; doc ids come back global
        (+doc_offset).  One reconnect attempt on a broken connection."""
        for attempt in (0, 1):
            try:
                with self._lock:
                    if self._sock is None:
                        self._connect()
                    payload = b"".join(
                        (json.dumps({"id": i, "terms": sorted(ts), "k": top_k}) + "\n").encode()
                        for i, ts in enumerate(term_sets)
                    )
                    self._sock.sendall(payload)
                    out: List[List[Tuple[int, float]]] = [None] * len(term_sets)  # type: ignore
                    for _ in term_sets:
                        resp = json.loads(self._file.readline())
                        if "error" in resp:
                            # close BEFORE raising: the remaining batch
                            # responses are still buffered in self._file, and
                            # a later call would read them as answers to ITS
                            # queries (same 0..N-1 ids) — silently wrong
                            # results from a healthy shard
                            self.close()
                            raise RuntimeError(
                                f"shard {self.host}:{self.port}: {resp['error']}"
                            )
                        out[resp["id"]] = [
                            (int(d) + self.doc_offset, float(s)) for d, s in resp["results"]
                        ]
                    return out
            except (OSError, ValueError) as e:
                self.close()
                if attempt:
                    raise RuntimeError(
                        f"shard {self.host}:{self.port} unreachable: {e}"
                    ) from e
                logger.warning(f"reconnecting to shard {self.host}:{self.port}: {e}")
        raise AssertionError("unreachable")


def _parse_shard_spec(spec: str, timeout: float = 15.0) -> List[ShardClient]:
    """"host:port:doc_offset,host:port:doc_offset,..." (offset optional).
    IPv6 hosts must be bracketed ("[::1]:8000:0") — an unbracketed IPv6
    literal is ambiguous with the port/offset separators and is rejected
    instead of silently connecting to the wrong endpoint."""
    clients = []
    for part in spec.split(","):
        part = part.strip()
        if part.startswith("["):
            host, _, rest = part[1:].partition("]")
            bits = rest.lstrip(":").split(":") if rest.lstrip(":") else []
        else:
            host, *bits = part.split(":")
        if (not host or not 1 <= len(bits) <= 2 or not bits[0].isdigit()
                or (len(bits) == 2 and not bits[1].lstrip("-").isdigit())):
            raise ValueError(
                f"bad shard spec {part!r}: want host:port[:doc_offset] "
                "(bracket IPv6 hosts: [::1]:8000)"
            )
        clients.append(ShardClient(host, int(bits[0]),
                                   int(bits[1]) if len(bits) == 2 else 0,
                                   timeout=timeout))
    return clients


class RemoteShardedEngine:
    """score_batch over doc-sharded remote daemons: concurrent fan-out,
    exact top-k merge (score desc, global doc id asc).

    Fault tolerance: every shard call is bounded by ``shard_timeout``
    (socket connect/read timeout — a hung daemon cannot stall the router
    forever).  A shard that errors or times out fails the batch by default
    (exact-or-error); with ``allow_partial=True`` the merge proceeds over
    the surviving shards and the failure is reported per call via
    ``score_batch_detailed`` — the serving daemon forwards it to clients as
    an explicit ``degraded`` field, never as silently-missing documents.
    """

    def __init__(self, shards, shard_timeout: float = 15.0,
                 allow_partial: bool = False):
        if isinstance(shards, str):
            shards = _parse_shard_spec(shards, timeout=shard_timeout)
        self.shards: List[ShardClient] = list(shards)
        if not self.shards:
            raise ValueError("need at least one shard")
        self.allow_partial = allow_partial
        # one long-lived pool: score_batch runs per micro-batch (~ms cadence
        # in the router hot path) — spawning fresh threads per call costs
        # latency jitter; the pool also propagates fetch exceptions
        self._pool = ThreadPoolExecutor(
            max_workers=len(self.shards), thread_name_prefix="shard-fetch"
        )

    def close(self):
        self._pool.shutdown(wait=False)
        for s in self.shards:
            s.close()

    def score_batch_detailed(
        self, query_term_sets: Sequence[Set[str]], top_k: int = 1000
    ) -> Tuple[List[List[Tuple[int, float]]], Dict[str, str]]:
        """(merged top-k, {failed "host:port": error}).  Raises only when
        EVERY shard failed (an all-dead tier has no degraded answer to
        give) or when a shard failed and ``allow_partial`` is off."""
        futures = [
            self._pool.submit(s.score_batch, query_term_sets, top_k)
            for s in self.shards
        ]
        results, failed = [], {}
        for shard, f in zip(self.shards, futures):
            try:
                results.append(f.result())
            except Exception as e:
                failed[f"{shard.host}:{shard.port}"] = str(e)
                logger.error(f"shard {shard.host}:{shard.port} failed: {e}")
        if failed and (not results or not self.allow_partial):
            raise RuntimeError(
                "; ".join(f"shard {hp}: {err}" for hp, err in failed.items())
            )
        return merge(results, top_k), failed

    def score_batch(
        self, query_term_sets: Sequence[Set[str]], top_k: int = 1000
    ) -> List[List[Tuple[int, float]]]:
        return self.score_batch_detailed(query_term_sets, top_k)[0]
