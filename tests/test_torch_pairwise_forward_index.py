"""The port's ``PairwiseForwardIndex`` against the JAX package's.

``score(pid, query_terms)`` sums the single terms, then ``t1|t2`` for every
ordered pair of distinct query terms in ``permutations`` order.  Both
classes get the same set object, so both iterate it in one order and the
float sums are compared exactly.  Files: float lines (``format_line``),
quantized lines (``format_quantized_line``), and a file that the port's
pairwise ``Indexer`` writes with a tiny random model on the CPU.
"""

import dataclasses

import numpy as np
import pytest

from improving_learned_index_tpu.index.forward_index import ForwardIndex as JaxForwardIndex
from improving_learned_index_tpu.index.forward_index import PairwiseForwardIndex as JaxPairwiseIndex
from improving_learned_index_tpu.index.forward_index import format_line as jax_format_line
from improving_learned_index_tpu.index.forward_index import (
    format_quantized_line as jax_format_quantized_line,
)
from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig
from improving_learned_index_tpu_torch.index import (
    ForwardIndex,
    PairwiseForwardIndex,
    format_line,
    format_quantized_line,
    parse_line,
    quantize_file,
)
from improving_learned_index_tpu_torch.index.indexer import Indexer
from improving_learned_index_tpu_torch.models import DeepPairwiseImpact
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

WORDS = ["fox", "dog", "quick", "lazy", "brown", "jumps", "sleeps", "runs"]
# every query shape: empty, one term, two, three, unknown terms mixed in
QUERIES = [
    set(),
    {"fox"},
    {"unknown"},
    {"fox", "dog"},
    {"quick", "fox"},
    {"dog", "unknown"},
    {"fox", "dog", "quick"},
    {"lazy", "dog", "sleeps"},
    {"nope", "never", "fox"},
    {"brown", "jumps", "runs"},
]


def _docs(seed=0, n=12):
    """Docs of single and ``t1|t2`` entries; doc 0 has no composite entry,
    doc 1 none at all."""
    rng = np.random.default_rng(seed)
    docs = []
    for pid in range(n):
        terms = list(rng.choice(WORDS, size=int(rng.integers(2, 7)), replace=False))
        entries = [(t, float(rng.uniform(0.0, 3.0))) for t in terms]
        if pid >= 2:
            for _ in range(int(rng.integers(1, 6))):
                a, b = rng.choice(WORDS, size=2, replace=False)
                entries.append((f"{a}|{b}", float(rng.uniform(0.0, 1.0))))
        docs.append([] if pid == 1 else entries)
    return docs


def _write(path, lines):
    path.write_text("".join(line + "\n" for line in lines), encoding="utf-8")
    return path


def _assert_scores_equal(path, queries=QUERIES):
    port, jax_index, single = PairwiseForwardIndex(path), JaxPairwiseIndex(path), ForwardIndex(path)
    assert len(port) == len(jax_index)
    composite = 0
    for pid in range(len(port)):
        for q in queries:
            got, want = port.score(pid, q), jax_index.score(pid, q)
            assert type(got) is type(want) and got == want, (pid, sorted(q), got, want)
            composite += got != single.score(pid, q)
    return composite


def test_float_lines_match_jax(tmp_path):
    docs = _docs()
    lines = [format_line(d) for d in docs]
    assert lines == [jax_format_line(d) for d in docs]
    path = _write(tmp_path / "fwd.txt", lines)
    assert _assert_scores_equal(path) > 0


def test_quantized_lines_match_jax(tmp_path):
    docs = [[(t, int(v * 85)) for t, v in d] for d in _docs(seed=1)]
    lines = [format_quantized_line(d) for d in docs]
    assert lines == [jax_format_quantized_line(d) for d in docs]
    path = _write(tmp_path / "q.txt", lines)
    assert _assert_scores_equal(path) > 0


@pytest.mark.parametrize("query", [set(), {"fox"}, {"unknown", "never"}], ids=["empty", "one", "unknown"])
def test_no_composite_part_without_two_known_terms(tmp_path, query):
    """Fewer than two query terms, or only unknown ones: the single-term sum."""
    path = _write(tmp_path / "fwd.txt", [format_line(d) for d in _docs()])
    port = PairwiseForwardIndex(path)
    for pid in range(len(port)):
        assert port.score(pid, query) == ForwardIndex(path).score(pid, query)
        assert port.score(pid, query) == JaxForwardIndex(path).score(pid, query)


def test_doc_without_composites_scores_single_terms(tmp_path):
    path = _write(tmp_path / "fwd.txt", [format_line(d) for d in _docs()])
    port = PairwiseForwardIndex(path)
    assert not any("|" in t for t in parse_line(port.lines[0]))
    for q in QUERIES:
        assert port.score(0, q) == ForwardIndex(path).score(0, q)
    assert port.score(1, {"fox", "dog"}) == 0


def test_pair_order_is_directed(tmp_path):
    """``a|b`` and ``b|a`` are two entries, and both count."""
    path = _write(tmp_path / "fwd.txt", ["fox: 1.0, dog: 2.0, fox|dog: 0.25, dog|fox: 0.5"])
    q = {"fox", "dog"}
    assert PairwiseForwardIndex(path).score(0, q) == JaxPairwiseIndex(path).score(0, q) == 3.75


def test_pairwise_indexer_file_matches_jax(tmp_path):
    """A forward file (and its quantized form) written by the port's
    pairwise ``Indexer``: every query of 1-3 of the file's single terms."""
    corpus = [
        "the quick brown fox jumps over the lazy dog",
        "a fast auburn fox leaped across a sleepy canine",
        "neural networks learn sparse representations of text",
        "inverted indexes map terms to document postings",
        "the dog sleeps while the fox runs through fields",
        "retrieval systems rank documents for user queries",
    ]
    vocab = WordPieceVocab.build(corpus, max_size=512)
    fields = dataclasses.asdict(EncoderConfig.tiny(vocab_size=len(vocab)))
    fields["dtype"] = "float32"
    model = DeepPairwiseImpact(EncoderConfig(**fields), ImpactTokenizer(vocab, max_length=32),
                               seed=0, device="cpu")
    coll = tmp_path / "c.tsv"
    coll.write_text("".join(f"{i}\t{t}\n" for i, t in enumerate(corpus)), encoding="utf-8")
    fwd = tmp_path / "fwd.txt"
    Indexer(model, IndexConfig(max_length=32, max_terms=32, model_batch_size=4)).index_to_file(coll, fwd)
    docs = [parse_line(x) for x in fwd.read_text(encoding="utf-8").splitlines()]
    assert any("|" in t for d in docs for t in d)
    singles = sorted({t for d in docs for t in d if "|" not in t})
    rng = np.random.default_rng(0)
    queries = [set(map(str, rng.choice(singles, size=int(rng.integers(1, 4)), replace=False)))
               for _ in range(32)]
    queries += [{t1, t2} for d in docs for t in d if "|" in t for t1, t2 in [t.split("|")]][:16]
    assert _assert_scores_equal(fwd, queries) > 0
    quantize_file(fwd, tmp_path / "q.txt")
    _assert_scores_equal(tmp_path / "q.txt", queries)
