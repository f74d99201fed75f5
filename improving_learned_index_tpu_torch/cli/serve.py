"""CLI: retrieval serving daemon: load the index once, serve queries over TCP
with dynamic micro-batching (serve/server.py; no reference equivalent, the
reference only ships the batch rank CLI).

    python -m improving_learned_index_tpu_torch.cli.serve \\
        --index_path inverted/ --vocab_path vocab.txt --port 7700 \\
        --engine auto --max_batch 64 --max_wait_ms 5 [--device cpu]

    python -m improving_learned_index_tpu_torch.cli.serve \\
        --shards 10.0.0.1:7700:0,10.0.0.2:7700:4400000 --vocab_path vocab.txt

    echo '{"id": 1, "query": "quick brown foxes"}' | nc localhost 7700

Queries are tokenized by ``--vocab_path``'s WordPiece tokenizer or a local
HuggingFace tokenizer directory (``--hf_tokenizer``), as the JAX daemon
builds its tokenizer from either flag.  The card engines (auto, device,
hybrid) run on ``cuda`` unless ``--device cpu``, and raise without a card; host and native run on the host.  Router
mode (``--shards``: doc-sharded daemons, offsets from ``cli.split_index``'s
``shards.json``) scores nothing itself and takes no device.  A card engine
prints its ``card memory`` after the warmup; every daemon prints
``serving <src> on <host>:<port>`` (flushed) once it accepts connections.

Left out of the JAX CLI: its compilation cache (a JAX compile cache; there
is nothing to cache here), ``--use_pallas`` (the port's kernels follow the
device), ``--tail_partitioned`` (the hybrid engine's opt-in partitioned
tail is not ported) and ``--warmup_max_chunks`` (a JAX shape lattice; the
port's warmup is one batch of the longest heavy and tail terms).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..search.select import ENGINES, build_engine
from ..serve import RetrievalServer
from .common import add_tokenizer_args, build_tokenizer


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    add_tokenizer_args(parser)
    parser.add_argument("--index_path", type=Path, default=None)
    parser.add_argument("--shards", type=str, default=None,
                        help="router mode: comma-separated "
                        "host:port[:doc_offset] shard daemons; this daemon "
                        "fans queries out and merges exact top-k "
                        "(serve/router.py); tiers compose")
    parser.add_argument("--shard_timeout", type=float, default=15.0,
                        help="router mode: per-shard connect/read timeout "
                        "in seconds (a hung shard cannot stall the router)")
    parser.add_argument("--allow_partial", action="store_true",
                        help="router mode: answer from the surviving shards "
                        "when one fails, flagging each response with an "
                        "explicit degraded.failed_shards field (default: "
                        "exact-or-error)")
    parser.add_argument("--host", default="127.0.0.1")
    parser.add_argument("--port", type=int, default=7700)
    parser.add_argument("--engine", choices=list(ENGINES), default="auto")
    parser.add_argument("--num_docs", type=int, default=0,
                        help="documents in the index (pass a shard's count "
                        "from shards.json: a shard may end in documents "
                        "without postings)")
    parser.add_argument("--top_k", type=int, default=1000)
    parser.add_argument("--max_batch", type=int, default=64)
    parser.add_argument("--max_wait_ms", type=float, default=5.0)
    parser.add_argument("--pairwise", action="store_true")
    parser.add_argument("--dense_budget_gb", type=float, default=4.0,
                        help="hybrid engine: device memory for dense "
                        "heavy-term rows (bf16)")
    parser.add_argument("--device", default=None,
                        help="torch device of the card engines; default "
                        "cuda (cpu only when asked for)")
    parser.add_argument("--allow_remote_shutdown", action="store_true",
                        help="honor {\"op\": \"shutdown\"} requests")
    parser.add_argument("--no_warmup", action="store_true",
                        help="skip the startup warmup batch (the first "
                        "request then pays the kernel loads)")
    args = parser.parse_args(argv)

    if (args.index_path is None) == (args.shards is None):
        parser.error("need exactly one of --index_path or --shards")
    if args.shards:
        if args.device is not None:
            parser.error("router mode scores nothing itself: --device does not apply")
        from ..serve.router import RemoteShardedEngine

        engine = RemoteShardedEngine(
            args.shards,
            shard_timeout=args.shard_timeout,
            allow_partial=args.allow_partial,
        )
    else:
        engine = build_engine(
            args.index_path,
            engine=args.engine,
            dense_budget_bytes=int(args.dense_budget_gb * (1 << 30)),
            num_docs=args.num_docs,
            device=args.device,
        )
    tokenizer = build_tokenizer(args) if args.vocab_path or args.hf_tokenizer else None
    if not args.no_warmup:
        if hasattr(engine, "warmup"):
            # load the kernels and grow the allocator before taking traffic
            n = engine.warmup(max_batch=args.max_batch, top_k=args.top_k)
            print(f"warmup done: {n} batch of {args.max_batch} queries", flush=True)
        else:
            vocab = getattr(engine, "vocab", None)
            terms = {next(iter(vocab))} if vocab else {"warmup"}
            engine.score_batch([terms] * args.max_batch, min(args.top_k, 10))
            print("warmup batch done", flush=True)
    dev = getattr(engine, "device", None)
    if getattr(dev, "type", None) == "cuda":
        print(f"card memory: {torch.cuda.memory_allocated(dev) / 1e9:.3f} GB allocated, "
              f"{torch.cuda.memory_reserved(dev) / 1e9:.3f} GB reserved", flush=True)
    server = RetrievalServer(
        engine,
        tokenizer=tokenizer,
        top_k=args.top_k,
        max_batch=args.max_batch,
        max_wait_ms=args.max_wait_ms,
        pairwise=args.pairwise,
        host=args.host,
        port=args.port,
        allow_shutdown=args.allow_remote_shutdown,
    )
    server.start()
    src = args.index_path if args.index_path else f"router[{args.shards}]"
    print(f"serving {src} on {args.host}:{server.port}", flush=True)
    server.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
