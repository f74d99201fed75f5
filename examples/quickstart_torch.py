"""End-to-end walkthrough on the PyTorch port: expansion -> merge -> impact
scores -> index -> search -> evaluation, on a self-contained toy corpus.

The port's counterpart of ``examples/quickstart.py``: the same steps,
corpus, queries and sizes, through ``improving_learned_index_tpu_torch``.
It runs on the card by default and raises without one; pass
``--device cpu`` to run it on the CPU (the kernels' plain versions run):

    python examples/quickstart_torch.py [--workdir DIR] [--device cuda|cpu]

Swap the tiny random models for real checkpoints via models.hf_import
(encoder) and cli.expand --llama_path / --t5 (doc2query) for production use.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path as _P

# self-locating: runnable without PYTHONPATH from any cwd
sys.path.insert(0, str(_P(__file__).resolve().parent.parent))

import tempfile
from pathlib import Path

CORPUS = [
    ("d0", "the quick brown fox jumps over the lazy dog"),
    ("d1", "a fast auburn fox leaped across a sleepy canine"),
    ("d2", "neural networks learn sparse representations of text"),
    ("d3", "inverted indexes map terms to document postings"),
    ("d4", "impact scores quantize term importance into bytes"),
    ("d5", "retrieval systems rank documents for user queries"),
]
QUERIES = [("q0", "quick brown fox"), ("q1", "inverted index postings")]
QRELS = [("q0", "d0"), ("q1", "d3")]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir", type=Path, default=None)
    parser.add_argument("--device", default="cuda", help="cuda (default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    from improving_learned_index_tpu_torch.core.device import resolve_device

    device = resolve_device(args.device)
    workdir = args.workdir or Path(tempfile.mkdtemp(prefix="ili_quickstart_"))
    workdir.mkdir(parents=True, exist_ok=True)
    print(f"workdir: {workdir}")

    from improving_learned_index_tpu_torch.core.config import (
        EncoderConfig,
        GenerationConfig,
        IndexConfig,
    )
    from improving_learned_index_tpu_torch.evaluation import Metrics, Ranker
    from improving_learned_index_tpu_torch.expand import (
        QueryGenerator,
        generate_expansions,
        merge_collection_and_expansions,
    )
    from improving_learned_index_tpu_torch.index import Indexer, InvertedIndexData
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    # -- files -----------------------------------------------------------
    collection = workdir / "collection.tsv"
    collection.write_text("".join(f"{i}\t{t}\n" for i, t in CORPUS))
    queries = workdir / "queries.tsv"
    queries.write_text("".join(f"{q}\t{t}\n" for q, t in QUERIES))
    qrels = workdir / "qrels.tsv"
    # integer pids: line number in the collection
    pid_of = {doc_id: str(i) for i, (doc_id, _) in enumerate(CORPUS)}
    qrels.write_text("".join(f"{q}\t0\t{pid_of[d]}\t1\n" for q, d in QRELS))

    # -- 1. doc2query expansion (tiny random Llama for the demo) ----------
    class ByteTokenizer:
        def encode(self, t):
            return [1] + [b + 3 for b in t.encode("utf-8")[:200]]

        def decode(self, ids):
            return bytes(i - 3 for i in ids if i >= 3).decode("utf-8", "ignore")

    llama_cfg = LlamaConfig.tiny(vocab_size=259)
    generator = QueryGenerator(
        init_llama_params(llama_cfg, seed=0, device=device),
        llama_cfg,
        ByteTokenizer(),
        GenerationConfig(num_return_sequences=3, max_new_tokens=8),
        device=device,
    )
    expansions = workdir / "expansions.jsonl"
    n = generate_expansions(generator, collection, expansions, batch_size=3)
    print(f"1. expanded {n} documents -> {expansions.name}")

    # -- 2. merge novel query terms into the collection -------------------
    vocab = WordPieceVocab.build([t for _, t in CORPUS], max_size=1024)
    tokenizer = ImpactTokenizer(vocab, max_length=64)
    expanded = workdir / "expanded-collection.tsv"
    merge_collection_and_expansions(collection, expansions, expanded, tokenizer)
    print(f"2. merged expansions -> {expanded.name}")

    # -- 3. per-term impact scores (tiny random encoder for the demo) -----
    model = DeepImpact(EncoderConfig.tiny(vocab_size=len(vocab)), tokenizer, seed=0, device=device)
    impacts = model.get_impact_scores(CORPUS[0][1])
    print(f"3. impact scores for d0: {[(t, round(s, 3)) for t, s in impacts[:4]]} ...")

    # -- 4. index: encode -> quantize -> inverted postings ----------------
    indexer = Indexer(model, IndexConfig(max_length=64, max_terms=64, model_batch_size=4))
    inv, max_val = indexer.build_inverted([t for _, t in CORPUS])
    index_dir = workdir / "inverted"
    inv.save(index_dir)
    print(
        f"4. inverted index: {len(inv)} terms, {inv.num_postings} postings "
        f"(8-bit, max impact {max_val:.3f}) -> {index_dir.name}/"
    )

    # -- 5. rank + evaluate ------------------------------------------------
    run_file = workdir / "run.tsv"
    Ranker(
        index_path=index_dir,
        queries_path=queries,
        output_path=run_file,
        tokenizer=tokenizer,
        device=device,
    ).run()
    metrics = Metrics(run_file, qrels, mrr_depths=[10], recall_depths=[10]).evaluate()
    print(f"5. metrics: {metrics}")

    # -- 6. corpus-scale engine: same index through the hybrid path -------
    from improving_learned_index_tpu_torch.search import HybridSearchEngine, InvertedIndex

    hybrid = HybridSearchEngine(InvertedIndexData.load(index_dir, num_docs=len(CORPUS)), device=device)
    host = InvertedIndex(InvertedIndexData.load(index_dir, num_docs=len(CORPUS)))
    # the demo query, and the index's whole vocabulary as one query: a tiny
    # RANDOM model zeroes most terms, so only the second surely hits a
    # posting and runs the exact top-k's search passes
    for q in (tokenizer.process_query(QUERIES[0][1]), set(inv.vocab)):
        assert [s for _, s in hybrid.score_batch([q], 3)[0]] == [
            s for _, s in host.score_batch([q], 3)[0]
        ]
    print("6. hybrid engine (dense heavy rows + exact integer top-k) agrees "
          "with the host engine")
    print(
        "note: random demo weights -> meaningless scores; import a trained "
        "checkpoint (models.hf_import / core.checkpoint) for real retrieval."
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
