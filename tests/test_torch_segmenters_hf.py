"""The port's segmenters and HuggingFace tokenizer adapter against the JAX
package's, and ``cli.index --hf_tokenizer`` on a tiny model.

- Segmenters: equal term lists.  ``VnCoreNLPSegmenter`` runs over a fake
  ``py_vncorenlp`` (and ``underthesea``) put in ``sys.modules``; without
  the package the port raises ``ImportError`` and the JAX one returns
  ``[]``: the deviation, pinned.
- ``HFImpactTokenizer``: a ``BertTokenizerFast`` built from a local
  ``vocab.txt`` (no hub id); ids, masks, type ids and term maps equal.
  Without ``transformers`` the route raises ``ImportError`` (no fallback).
- ``cli.index --hf_tokenizer``: the same tiny model in both packages (its
  flax params written by the JAX package as a ``.msgpack`` and read by each
  ``--checkpoint``; the xlmr kind, whose softplus head scores every term),
  S=64, bf16: the same terms, impacts within 0.05, the
  bf16 tolerance of ``tests/test_torch_encoder.py``.
"""

import sys
import types

import numpy as np
import pytest

transformers = pytest.importorskip("transformers")

import improving_learned_index_tpu.text.segmenters as jseg  # noqa: E402
import improving_learned_index_tpu_torch.text.segmenters as pseg  # noqa: E402
from improving_learned_index_tpu.text import WordPieceVocab  # noqa: E402
from improving_learned_index_tpu.text.hf_adapter import HFImpactTokenizer as JaxHF  # noqa: E402
from improving_learned_index_tpu_torch.text import make_segmenter, whitespace_segmenter  # noqa: E402
from improving_learned_index_tpu_torch.text.hf_adapter import (  # noqa: E402
    HFImpactTokenizer,
    load_hf_tokenizer,
)

TEXTS = ["The quick, brown FOX!", "  spaced   out\ttabs\n", "Tiếng Việt có dấu", "", "a-b c.d (e)"]
CORPUS = [
    "the quick brown fox jumps over the lazy dog",
    "unbelievable running dogs, and foxes!",
    "sub-word pieces: tokenization fidelity matters",
    "repeated repeated terms terms stay unique",
]
DOCS = ["The quick brown fox! The fox.", "unbelievable running, dogs and foxes",
        "tokenization fidelity matters matters", "punctuation, everywhere! (really)",
        " ".join(CORPUS * 3)]


@pytest.fixture(autouse=True)
def _offline(monkeypatch):
    """Local directories only: any hub lookup fails instead of connecting."""
    import huggingface_hub.constants as hc

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(hc, "HF_HUB_OFFLINE", True)


def test_whitespace_and_make_segmenter():
    for text in TEXTS:
        assert whitespace_segmenter(text) == jseg.whitespace_segmenter(text)
        assert make_segmenter("whitespace")(text) == jseg.make_segmenter("whitespace")(text)
    assert isinstance(make_segmenter("vncorenlp", save_dir="/x"), pseg.VnCoreNLPSegmenter)
    for mk in (make_segmenter, jseg.make_segmenter):
        with pytest.raises(ValueError, match="unknown segmenter"):
            mk("nope")


def _fake_vncorenlp():
    mod = types.ModuleType("py_vncorenlp")

    class VnCoreNLP:
        def __init__(self, save_dir=None, annotators=()):
            assert annotators == ["wseg"]
            self.save_dir = save_dir

        def word_segment(self, text):
            if "boom" in text:
                raise RuntimeError("segmenter failure")
            words = text.split()
            return [" ".join("_".join(words[i:i + 2]) for i in range(0, len(words), 2))] if words else []

    mod.VnCoreNLP = VnCoreNLP
    norm = types.ModuleType("underthesea")
    norm.text_normalize = lambda t: " ".join(t.split())
    return mod, norm


def test_vncorenlp_with_fake_package(monkeypatch):
    mod, norm = _fake_vncorenlp()
    monkeypatch.setitem(sys.modules, "py_vncorenlp", mod)
    monkeypatch.setitem(sys.modules, "underthesea", norm)
    port, ref = pseg.VnCoreNLPSegmenter(save_dir="m"), jseg.VnCoreNLPSegmenter(save_dir="m")
    for text in TEXTS + ["Học sinh đi học ở trường", "boom goes the segmenter"]:
        assert port(text) == ref(text), text
    assert port("boom now") == [] and port._impl.save_dir == "m"


def test_vncorenlp_missing_package_raises(monkeypatch):
    """Deviation: the JAX segmenter gives every text [] without a word."""
    monkeypatch.delitem(sys.modules, "py_vncorenlp", raising=False)
    try:
        import py_vncorenlp  # noqa: F401
        pytest.skip("py_vncorenlp is installed")
    except ImportError:
        pass
    assert jseg.VnCoreNLPSegmenter()("Học sinh đi học") == []
    with pytest.raises(ImportError, match="py_vncorenlp"):
        pseg.VnCoreNLPSegmenter()("Học sinh đi học")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf")
    vocab = WordPieceVocab.build(CORPUS, max_size=512)
    vocab.save(d / "vocab.txt")
    tok = transformers.BertTokenizerFast(vocab_file=str(d / "vocab.txt"), do_lower_case=True)
    tok.save_pretrained(str(d / "tok"))
    return d


def test_hf_tokenizer_matches_jax(hf_dir):
    fast = transformers.BertTokenizerFast(vocab_file=str(hf_dir / "vocab.txt"), do_lower_case=True)
    port, ref = HFImpactTokenizer(fast, max_length=32), JaxHF(fast, max_length=32)
    loaded = load_hf_tokenizer(str(hf_dir / "tok"), max_length=32)
    for doc in DOCS:
        for ml in (None, 16):
            want = ref.process_document(doc, max_length=ml)
            for tok in (port, loaded):
                got = tok.process_document(doc, max_length=ml)
                assert (got.ids, got.attention_mask, got.type_ids, got.term_to_token_index) == (
                    want.ids, want.attention_mask, want.type_ids, want.term_to_token_index), doc
    for q, d in [("The Quick fox?", DOCS[0]), ("running dogs", DOCS[1])]:
        assert port.process_query(q) == ref.process_query(q)
        _, ma = port.process_query_and_document(q, d)
        _, mb = ref.process_query_and_document(q, d)
        np.testing.assert_array_equal(ma, mb)
    seg = HFImpactTokenizer(fast, 32, segmenter=whitespace_segmenter)
    assert seg.segment("The Fox!") == JaxHF(fast, 32, segmenter=jseg.whitespace_segmenter).segment("The Fox!")
    with pytest.raises(ValueError, match="fast tokenizer"):
        HFImpactTokenizer(object())


def test_cli_index_hf_tokenizer_matches_jax(tmp_path, hf_dir):
    from improving_learned_index_tpu.cli.index import main as jax_index_main
    from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
    from improving_learned_index_tpu.index.forward_index import parse_line
    from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
    from improving_learned_index_tpu_torch.cli.index import main as index_main

    tok_dir = str(hf_dir / "tok")
    # the CLIs' --tiny config with an HF tokenizer: vocab 512 (no .vocab
    # attribute); the xlmr kind's softplus head scores every term
    model = JaxDeepImpact(JaxConfig.tiny(vocab_size=512, impact_activation="softplus"),
                          load_hf_tokenizer(tok_dir), seed=3)
    model.save(tmp_path / "tiny.msgpack")
    (tmp_path / "c.tsv").write_text("".join(f"{i}\t{d}\n" for i, d in enumerate(DOCS)))
    common = ["--collection_path", str(tmp_path / "c.tsv"), "--hf_tokenizer", tok_dir, "--tiny",
              "--model_kind", "xlmr",
              "--checkpoint", str(tmp_path / "tiny.msgpack"), "--max_length", "64",
              "--model_batch_size", "2"]
    assert jax_index_main(common + ["--output_file_path", str(tmp_path / "jax.txt")]) == 0
    assert index_main(common + ["--output_file_path", str(tmp_path / "port.txt"), "--device", "cpu"]) == 0
    want = [parse_line(l) for l in (tmp_path / "jax.txt").read_text().splitlines()]
    got = [parse_line(l) for l in (tmp_path / "port.txt").read_text().splitlines()]
    assert len(got) == len(want) == len(DOCS)
    for g, w in zip(got, want):
        assert list(g) == list(w)
        assert max(abs(g[t] - w[t]) for t in w) <= 0.05
    assert all(v > 0 for d in got for v in d.values())


def test_missing_transformers_raises(tmp_path, monkeypatch):
    """Without ``transformers`` the HF route raises ``ImportError`` naming
    it, in the adapter and through ``cli.index``; it never falls back to the
    built-in WordPiece tokenizer."""
    from improving_learned_index_tpu_torch.cli.index import main as index_main

    monkeypatch.setitem(sys.modules, "transformers", None)
    with pytest.raises(ImportError, match="transformers"):
        load_hf_tokenizer(str(tmp_path))
    (tmp_path / "c.tsv").write_text("0\tquick fox\n")
    WordPieceVocab.build(CORPUS, max_size=64).save(tmp_path / "vocab.txt")
    with pytest.raises(ImportError, match="transformers"):
        index_main(["--collection_path", str(tmp_path / "c.tsv"), "--output_file_path", str(tmp_path / "f.txt"),
                    "--hf_tokenizer", str(tmp_path), "--vocab_path", str(tmp_path / "vocab.txt"), "--tiny",
                    "--device", "cpu"])
    assert not (tmp_path / "f.txt").exists()


def test_cli_serve_takes_hf_tokenizer(tmp_path, hf_dir, monkeypatch):
    """``cli.serve --hf_tokenizer`` builds its query tokenizer from the HF
    directory, as the JAX daemon does from either flag."""
    import numpy as np

    import improving_learned_index_tpu_torch.cli.serve as serve_cli
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData

    InvertedIndexData(["fox", "quick"], np.array([0, 1, 2]), np.array([0, 0], np.uint32),
                      np.array([5, 3], np.uint8), num_docs=1).save(tmp_path / "idx")
    seen = {}

    class FakeServer:
        def __init__(self, engine, tokenizer=None, **kw):
            seen["tokenizer"] = tokenizer
            self.port = 0

        def start(self):
            pass

        def serve_forever(self):
            pass

    monkeypatch.setattr(serve_cli, "RetrievalServer", FakeServer)
    assert serve_cli.main(["--index_path", str(tmp_path / "idx"), "--hf_tokenizer", str(hf_dir / "tok"),
                           "--engine", "host", "--no_warmup", "--port", "0"]) == 0
    assert isinstance(seen["tokenizer"], HFImpactTokenizer)
    assert seen["tokenizer"].process_query("The Quick fox!") == {"the", "quick", "fox"}
