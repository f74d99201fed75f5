"""Index lifecycle walkthrough on the PyTorch port: the store pipeline,
incremental adds, deletions, crash-resume, and the serving daemon -- the
operations a production deployment runs after the initial build.

The port's counterpart of ``examples/index_lifecycle.py``: the same steps,
corpus and sizes, through ``improving_learned_index_tpu_torch``.  The
encoder and the served engine run on the card by default and raise without
one; pass ``--device cpu`` to run them on the CPU.  The shard daemons serve
host engines, which take no device:

    python examples/index_lifecycle_torch.py [--workdir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path as _P

# self-locating: runnable without PYTHONPATH from any cwd
sys.path.insert(0, str(_P(__file__).resolve().parent.parent))

import json
import socket
import tempfile
from pathlib import Path

CORPUS_V1 = [
    ("0", "the quick brown fox jumps over the lazy dog"),
    ("1", "a fast auburn fox leaped across a sleepy canine"),
    ("2", "neural networks learn sparse representations of text"),
    ("3", "inverted indexes map terms to document postings"),
]
CORPUS_DELTA = [
    ("4", "impact scores quantize term importance into bytes"),
    ("5", "retrieval systems rank documents for user queries"),
]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", type=Path, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from improving_learned_index_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    work = args.workdir or Path(tempfile.mkdtemp(prefix="ili_lifecycle_"))
    work.mkdir(parents=True, exist_ok=True)
    print(f"workdir: {work}")

    from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig
    from improving_learned_index_tpu_torch.index import Indexer, InvertedIndexData
    from improving_learned_index_tpu_torch.index.impact_store import quantize_store
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.search.select import build_engine
    from improving_learned_index_tpu_torch.serve import RetrievalServer
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    # -- model (tiny random; swap for a real checkpoint via models.hf_import)
    texts = [t for _, t in CORPUS_V1 + CORPUS_DELTA]
    vocab = WordPieceVocab.build(texts, max_size=512)
    model = DeepImpact(
        EncoderConfig.tiny(vocab_size=len(vocab)),
        ImpactTokenizer(vocab, max_length=32),
        seed=0,
        device=device,
    )
    indexer = Indexer(model, IndexConfig(max_length=32, max_terms=32, model_batch_size=4))

    def build_shard(docs, name):
        """collection -> binary impact store -> quantize -> inverted index.
        The store keeps impacts as flat arrays between stages (byte-identical
        final index to the text route's)."""
        coll = work / f"{name}.tsv"
        coll.write_text("".join(f"{i}\t{t}\n" for i, t in docs))
        # --resume semantics: if this run dies mid-encode, calling again
        # with resume=True repairs the store and continues where it died
        indexer.index_to_file(coll, store_path=work / f"{name}.store", resume=True)
        quantize_store(work / f"{name}.store", work / f"{name}.qstore")
        index = InvertedIndexData.from_impact_store(work / f"{name}.qstore")
        index.save(work / f"inv_{name}")
        print(f"  {name}: {index.num_docs} docs, {index.num_postings} postings")
        return index

    print("build v1:")
    v1 = build_shard(CORPUS_V1, "v1")

    # -- incremental add: encode ONLY the new docs, merge the indexes
    print("add delta (no rebuild of v1):")
    delta = build_shard(CORPUS_DELTA, "delta")
    v2 = InvertedIndexData.merge([v1, delta])
    print(f"  merged: {v2.num_docs} docs, {v2.num_postings} postings")

    # -- deletion: drop doc 1, compact renumbering
    v3 = v2.delete_docs([1])
    v3.save(work / "inv_live")
    print(f"after delete: {v3.num_docs} docs, {len(v3)} terms")

    # -- cross-host serving: split into shards (one per host), daemons per
    # shard, a router daemon in front -- exact same results as one engine
    from improving_learned_index_tpu_torch.search.engine import InvertedIndex
    from improving_learned_index_tpu_torch.serve.router import RemoteShardedEngine

    shards = v3.split_docs(2)
    backends = []
    spec = []
    offset = 0
    for shard in shards:
        b = RetrievalServer(InvertedIndex(shard), max_wait_ms=1.0)
        b.start()
        backends.append(b)
        spec.append(f"127.0.0.1:{b.port}:{offset}")
        offset += shard.num_docs
    router = RemoteShardedEngine(",".join(spec))
    direct = InvertedIndex(v3)
    probe = [set(v3.vocab[:2])]
    assert router.score_batch(probe, 5) == direct.score_batch(probe, 5)
    print(f"router over {len(shards)} shard daemons == single engine")
    router.close()
    for b in backends:
        b.stop()

    # -- serve it
    engine = build_engine(work / "inv_live", engine="auto", num_docs=v3.num_docs, device=device)
    server = RetrievalServer(
        engine, tokenizer=model.tokenizer, top_k=5, max_batch=8, max_wait_ms=2.0
    )
    server.start()
    try:
        sock = socket.create_connection(("127.0.0.1", server.port))
        f = sock.makefile("rb")
        # free-text queries go through the tokenizer (a tiny RANDOM model
        # zeroes many terms, so these may legitimately return []) ...
        for q in ("quick brown fox", "document postings"):
            sock.sendall((json.dumps({"id": q, "query": q, "k": 3}) + "\n").encode())
            print(f"  {q!r} ->", json.loads(f.readline())["results"])
        # ... and pre-processed term requests skip it; terms drawn from the
        # live index vocabulary always hit
        terms = v3.vocab[:2]
        sock.sendall((json.dumps({"id": "t", "terms": terms, "k": 3}) + "\n").encode())
        print(f"  terms {terms} ->", json.loads(f.readline())["results"])
        sock.sendall(b'{"op": "stats"}\n')
        print("  stats:", json.loads(f.readline()))
        sock.close()
    finally:
        server.stop()
    print("done.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
