"""The port's named regions (``core.profiling.annotate``) under
``torch.profiler`` on the CPU: the search, index and train loops emit each
region once a batch or step, on the thread that drives the device, and
the top-k's ``search/topk_sync`` regions count its host syncs.  Each loop
is profiled as the benchmark profiles it, every thread included, and with
torch's default (the calling thread only)."""

import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig, TrainConfig
from improving_learned_index_tpu_torch.index.forward_index import format_line
from improving_learned_index_tpu_torch.index.indexer import Indexer
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.models import DeepImpact
from improving_learned_index_tpu_torch.ops import exact_topk
from improving_learned_index_tpu_torch.parallel.dataloader import BatchLoader
from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
from improving_learned_index_tpu_torch.train import COLLATES, Trainer

CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "a fast auburn fox leaped across a sleepy canine",
    "neural networks learn sparse representations of text",
    "inverted indexes map terms to document postings",
    "impact scores quantize term importance into bytes, bytes and bytes!",
    "retrieval systems rank documents for user queries",
    "the dog sleeps while the fox runs through fields " * 3,
    "tpu systolic arrays multiply matrices in bfloat16",
]
TRIPLES = [
    ("quick fox", "the quick brown fox jumps", "sleepy dog naps inside"),
    ("lazy dog", "the lazy dog sleeps here", "fast fox runs far away"),
    ("sparse index", "inverted indexes map terms postings", "the fox is quick"),
    ("neural text", "neural networks learn text", "dogs and foxes play"),
]
SEARCH = ("search/stage_inputs", "search/topk", "search/result_wait", "search/answers")
INDEX = ("index/next_batch", "index/encode", "index/scores_to_host", "index/write")
TRAIN = ("train/next_batch", "train/put_batch", "train/forward", "train/backward", "train/optimizer",
         "train/step_end")


def profiled(fn, all_threads):
    """(fn's result, [(region name, thread)] of the regions it emitted)."""
    from torch.profiler import ProfilerActivity, profile

    extra = {}
    if all_threads:
        from torch._C._profiler import _ExperimentalConfig

        extra = {"experimental_config": _ExperimentalConfig(profile_all_threads=True)}
    with profile(activities=[ProfilerActivity.CPU], **extra) as prof:
        out = fn()
    prefixes = ("search/", "index/", "train/", "text/")
    return out, [(e.name, e.thread) for e in prof.events() if e.name.startswith(prefixes)]


@pytest.fixture(scope="module")
def tokenizer():
    return ImpactTokenizer(WordPieceVocab.build(CORPUS + [" ".join(t) for t in TRIPLES], max_size=512),
                           max_length=32)


@pytest.fixture(scope="module")
def engine():
    """A 600-doc integer index over 40 terms: the 8 longest lists as dense
    rows, the rest a tail."""
    rng = np.random.default_rng(7)
    lengths = np.linspace(400, 20, 40).astype(int)
    postings = {}
    for t, n in enumerate(lengths):
        for d in rng.choice(600, n, replace=False):
            postings.setdefault(int(d), {})[f"w{t}"] = int(rng.integers(1, 256))
    index = InvertedIndexData.build(sorted(postings.items()), num_docs=600)
    return HybridSearchEngine(index, heavy_min=200, device="cpu")


def query_texts(n, seed):
    rng = np.random.default_rng(seed)
    return [" ".join(f"w{t}" for t in rng.choice(40, rng.integers(1, 9), replace=False)) for _ in range(n)]


@pytest.mark.parametrize("all_threads", [False, True])
def test_search_regions_once_a_batch(engine, tokenizer, all_threads, monkeypatch):
    """``score_stream`` emits each ``search/*`` region once a batch and
    ``text/process_query`` once a query; ``search/topk_sync`` once each time
    the top-k's search tests its condition: once a pass (a count) and once
    more at the end of each call."""
    passes, calls = [0], [0]
    inner_count, inner_topk = exact_topk.count_ge_plain, exact_topk.exact_topk_integer

    def count_ge_plain(*args):
        passes[0] += 1
        return inner_count(*args)

    def exact_topk_integer(*args, **kwargs):
        calls[0] += 1
        return inner_topk(*args, **kwargs)

    monkeypatch.setattr(exact_topk, "count_ge_plain", count_ge_plain)
    from improving_learned_index_tpu_torch.search import hybrid_engine

    monkeypatch.setattr(hybrid_engine, "exact_topk_integer", exact_topk_integer)
    texts, nq = query_texts(40, 3), 8

    def run():
        batches = ([tokenizer.process_query(x) for x in texts[i:i + nq]] for i in range(0, len(texts), nq))
        return list(engine.score_stream(batches, top_k=25, depth=2))

    out, regions = profiled(run, all_threads)
    counts = Counter(name for name, _ in regions)
    assert len(out) == 5 and calls[0] == 5 and passes[0] >= 5
    assert {name: counts[name] for name in SEARCH} == dict.fromkeys(SEARCH, 5)
    assert counts["text/process_query"] == len(texts)
    assert counts["search/topk_sync"] == passes[0] + calls[0]
    assert len({thread for _, thread in regions}) == 1
    assert out == [engine.score_batch([tokenizer.process_query(x) for x in texts[i:i + nq]], 25)
                   for i in range(0, len(texts), nq)]


def test_topk_sync_counts_the_loop_tests(monkeypatch):
    """On rows whose k-th score sits at the top of a wide range the search
    takes its longest path: ``search/topk_sync`` equals the passes + 1."""
    passes = [0]
    inner = exact_topk.count_ge_plain

    def count_ge_plain(*args):
        passes[0] += 1
        return inner(*args)

    monkeypatch.setattr(exact_topk, "count_ge_plain", count_ge_plain)
    scores = torch.zeros(3, 4096)
    scores[:, :4096] = torch.arange(4096, dtype=torch.float32)  # row max 4095: widths 4095 -> 512 -> 64 -> 8 -> 1
    (vals, idx), regions = profiled(lambda: exact_topk.exact_topk_integer(scores, 10), False)
    assert vals[0, 0] == 4095 and idx[0, 9] == 4086
    assert passes[0] == 4
    assert Counter(name for name, _ in regions)["search/topk_sync"] == passes[0] + 1


def _encoder(tokenizer):
    cfg = dataclasses.replace(EncoderConfig.tiny(vocab_size=len(tokenizer.vocab)), dtype="float32")
    return DeepImpact(cfg, tokenizer, seed=0, device="cpu")


@pytest.mark.parametrize("pack", [False, True])
def test_index_regions_once_a_batch_and_the_same_file(tokenizer, tmp_path, pack):
    """``index_to_file`` emits the four ``index/*`` regions once a batch
    (``index/next_batch`` once more: the end of the stream), all on the
    consumer's thread, and writes the same bytes with and without a
    profiler, as a document-at-a-time writer of ``encode_document_rows``
    would."""
    model = _encoder(tokenizer)
    indexer = Indexer(model, IndexConfig(max_length=32, max_terms=32, model_batch_size=4, pack_sequences=pack))
    coll = tmp_path / "collection.tsv"
    coll.write_text("".join(f"{i}\t{t}\n" for i, t in enumerate(CORPUS * 3)), encoding="utf-8")
    dispatch = "encode_packed" if pack else "encode_term_scores"
    batches = [0]
    inner = getattr(model, dispatch)

    def counted(*args, **kwargs):
        batches[0] += 1
        return inner(*args, **kwargs)

    setattr(model, dispatch, counted)
    written, regions = profiled(lambda: indexer.index_to_file(coll, tmp_path / "traced.txt"), True)
    counts = Counter(name for name, _ in regions)
    assert written == len(CORPUS) * 3 and batches[0] >= 2
    assert counts["index/next_batch"] == batches[0] + 1
    assert {name: counts[name] for name in INDEX[1:]} == dict.fromkeys(INDEX[1:], batches[0])
    assert len({thread for _, thread in regions}) == 1

    assert indexer.index_to_file(coll, tmp_path / "plain.txt") == written
    per_doc = "".join(format_line([(t, float(row[j])) for j, t in enumerate(terms)], 3) + "\n"
                      for terms, row in indexer.encode_document_rows(CORPUS * 3))
    traced = (tmp_path / "traced.txt").read_bytes()
    assert traced == (tmp_path / "plain.txt").read_bytes() == per_doc.encode("utf-8")


@pytest.mark.parametrize("all_threads", [False, True])
def test_train_regions_once_a_step(tokenizer, tmp_path, all_threads):
    """``Trainer.train`` over a loader emits the six ``train/*`` regions
    once a step (``train/next_batch`` once more: the pull that ends the
    loop), on the training thread, none from the loader's collate."""
    model = _encoder(tokenizer)
    trainer = Trainer(model, TrainConfig(batch_size=2, lr=1e-3, save_every=10**6), tmp_path)
    loader = BatchLoader(TRIPLES * 2, 2, lambda b: COLLATES["pairwise_ce"](b, tokenizer, 32), shuffle=False)
    loss, regions = profiled(lambda: trainer.train(loader, skip=0), all_threads)
    counts = Counter(name for name, _ in regions)
    steps = len(TRIPLES) * 2 // 2
    assert loss > 0 and trainer.manager.step == steps
    assert counts["train/next_batch"] == steps + 1
    assert {name: counts[name] for name in TRAIN[1:]} == dict.fromkeys(TRAIN[1:], steps)
    assert "text/process_query" not in counts
    assert len({thread for _, thread in regions}) == 1
