"""The port stands alone: it imports neither JAX, flax nor the JAX package,
and its entry points refuse to run on the CPU unless asked to.  Covers the
query path, the encode path (text, encoder, indexer, CLIs), the other
query engines (host, native, device, dense, blocked) and query CLIs, and
training (losses, collates, packing, trainer, checkpoints, data parallelism,
``cli.train``), the in-memory eval (``SparseSearch``, NanoBEIR, TREC
metrics, BM25 and their CLIs), the rerankers (the pairwise and
cross-encoder models, ``ReRanker``, ``CrossEncoderReRanker``, their CLIs and
``cli.train --pairwise/--cross_encoder``), and the index lifecycle (the
binary impact store, merge/filter/split and their CLIs, the serving daemon,
its shard router and ``cli.serve``), the multi-device paths (the
doc-sharded engine, the data-parallel encode and the dry run), and the
host-side remainder (the data-prep scripts, the segmenters and the HF
tokenizer adapter, the Anserini export, term-pair attention, the flax
msgpack reader and the async checkpoint manager), and expansion (the
Llama decoder, quantization, LoRA, sampling, generation, fine-tuning,
merge, flash attention and their CLIs; the T5/mT5 model, its sampler and
query generator, ``cli.expand --t5``, the precomputed-expansion tools and
``cli.expand_precomputed``), the last of the surface
(``PairwiseForwardIndex``, ``port_deep_impact_to_hf`` and the subpackage
exports) and the two walkthroughs (``examples/quickstart_torch.py``,
``examples/index_lifecycle_torch.py``).  No port file imports
``msgpack``; ``transformers``, ``matplotlib``, ``py_vncorenlp`` and
``underthesea`` are imported only inside the functions that need them."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "improving_learned_index_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "improving_learned_index_tpu")
GATED = ("transformers", "matplotlib", "py_vncorenlp", "underthesea")
REMAINDER_MODULES = (
    "text/segmenters.py", "text/hf_adapter.py", "index/anserini.py", "cli/convert_to_anserini.py",
    "analysis/__init__.py", "analysis/attention.py", "analysis/visualize.py", "core/flax_msgpack.py",
    "core/async_checkpoint.py", "scripts/__init__.py", "scripts/construct_distil_hard_neg_dataset.py",
    "scripts/construct_hard_neg_dataset.py", "scripts/create_passages.py", "scripts/create_test_files.py",
    "scripts/create_training_files.py", "scripts/create_training_files_maxp.py",
    "scripts/create_unique_passage_mapping.py", "scripts/prepare_dataset.py",
    "scripts/preprocess_passages.py", "scripts/trim_scores.py",
)
EXPANSION_MODULES = (
    "ops/flash_attention.py", "models/llama.py", "models/quantization.py", "expand/__init__.py",
    "expand/lora.py", "expand/sampling.py", "expand/generate.py", "expand/merge.py", "expand/finetune.py",
    "cli/expand.py", "cli/finetune.py", "cli/merge.py", "utils/text_utils.py",
)
WALKTHROUGHS = (REPO / "examples" / "quickstart_torch.py", REPO / "examples" / "index_lifecycle_torch.py")
T5_MODULES = (
    "models/t5.py", "expand/t5_generate.py", "expand/precomputed.py", "cli/expand_precomputed.py", "cli/expand.py",
)


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(encoding="utf-8"), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py", *WALKTHROUGHS]
    names = {str(f.relative_to(PORT)) for f in files if PORT in f.parents}
    for module in ("ops/short_attention.py", "models/encoder.py", "models/hf_import.py",
                   "models/deep_impact.py", "index/indexer.py", "cli/index.py",
                   "ops/count_ge.py", "ops/pallas_scoring.py", "search/engine.py",
                   "search/device_engine.py", "search/dense_engine.py", "search/native.py",
                   "search/maxp.py", "cli/evaluate.py", "cli/aggregate_run.py",
                   "train/losses.py", "train/packed.py", "train/collate.py", "train/trainer.py",
                   "core/checkpoint.py", "core/metrics_log.py", "core/profiling.py",
                   "parallel/dataloader.py", "parallel/distributed.py", "data/datasets.py",
                   "cli/train.py", "evaluation/sparse_search.py", "evaluation/nano_beir.py",
                   "evaluation/trec_metrics.py", "evaluation/bm25.py", "cli/nano_beir.py",
                   "cli/bm25.py", "models/pairwise.py", "models/factory.py", "evaluation/reranker.py",
                   "evaluation/run_metrics.py", "cli/rerank.py", "cli/cross_encoder_rerank.py",
                   "cli/common.py", "index/impact_store.py", "index/inverted.py", "cli/quantize.py",
                   "cli/invert.py", "cli/merge_indexes.py", "cli/filter_index.py",
                   "cli/split_index.py", "serve/__init__.py", "serve/server.py", "serve/router.py",
                   "cli/serve.py", "search/sharded_engine.py", "parallel/multidevice.py",
                   *REMAINDER_MODULES, *EXPANSION_MODULES, *T5_MODULES):
        assert module in names
    assert len(files) > 30
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f) if _forbidden(m)]
    assert not bad


def _module_level_imports(path):
    """Imports outside every function body (module level, class bodies and
    top-level ``if``/``try`` blocks included)."""
    def walk(node):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                continue
            if isinstance(child, ast.Import):
                yield from (a.name for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0 and child.module:
                yield child.module
            yield from walk(child)

    yield from walk(ast.parse(path.read_text(encoding="utf-8"), str(path)))


def test_port_imports_no_msgpack_and_gates_optional_packages():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    msgpack = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
               if m == "msgpack" or m.startswith("msgpack.")]
    assert not msgpack
    top = [(str(f.relative_to(REPO)), m) for f in files for m in _module_level_imports(f)
           if m.split(".")[0] in GATED]
    assert not top
    inside = {m.split(".")[0] for f in files for m in _imports(f)} & set(GATED)
    assert inside == set(GATED)  # each is imported somewhere, inside a function


def test_cpu_query_leaves_jax_unimported(tmp_path):
    code = """
import sys
import numpy as np
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.search.select import build_engine
idx = InvertedIndexData(["a", "b"], np.array([0, 2, 3]), np.array([0, 1, 1], np.uint32),
                        np.array([5, 3, 7], np.uint8), num_docs=2)
idx.save(sys.argv[1])
res = build_engine(sys.argv[1], device="cpu").score_batch([{"a", "b"}], 5)
assert res == [[(1, 10.0), (0, 5.0)]], res
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "idx")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_entry_points_without_cuda_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
    from improving_learned_index_tpu_torch.search.select import build_engine

    idx = InvertedIndexData(["a"], np.array([0, 1]), np.array([0], np.uint32),
                            np.array([5], np.uint8), num_docs=1)
    idx.save(tmp_path / "idx")
    (tmp_path / "q.tsv").write_text("1\ta\n")
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\na\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        HybridSearchEngine(idx)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_engine(tmp_path / "idx")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_main(["--index_path", str(tmp_path / "idx"), "--queries_path", str(tmp_path / "q.tsv"),
                   "--output_path", str(tmp_path / "run"), "--vocab_path", str(tmp_path / "vocab.txt")])
    assert not (tmp_path / "run").exists()


def test_cpu_encode_leaves_jax_unimported(tmp_path):
    code = """
import sys
from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig
from improving_learned_index_tpu_torch.index.indexer import Indexer
from improving_learned_index_tpu_torch.models import DeepImpact
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
docs = ["the quick brown fox", "a lazy dog sleeps", "fox and dog"] * 3
vocab = WordPieceVocab.build(docs, max_size=64)
model = DeepImpact(EncoderConfig.tiny(vocab_size=len(vocab)), ImpactTokenizer(vocab, max_length=128),
                   device="cpu")
cfg = IndexConfig(max_length=128, max_terms=16, model_batch_size=4)
rows = list(Indexer(model, cfg).encode_documents(docs))
assert len(rows) == len(docs) and rows[0][0][0] == "the", rows[0]
index, _ = Indexer(model, IndexConfig(max_length=128, max_terms=16, model_batch_size=4,
                                      pack_sequences=True)).build_inverted(docs)
assert index.num_docs == len(docs)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_encode_entry_points_without_cuda_raise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.index.indexer import Indexer
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    vocab = WordPieceVocab.build(["a b c"], max_size=32)
    tok = ImpactTokenizer(vocab, max_length=128)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepImpact(EncoderConfig.tiny(vocab_size=len(vocab)), tok)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Indexer(DeepImpact(EncoderConfig.tiny(vocab_size=len(vocab)), tok))
    vocab.save(tmp_path / "vocab.txt")
    (tmp_path / "c.tsv").write_text("0\ta b c\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index_main(["--collection_path", str(tmp_path / "c.tsv"), "--output_file_path",
                    str(tmp_path / "fwd.txt"), "--vocab_path", str(tmp_path / "vocab.txt"), "--tiny"])
    assert not (tmp_path / "fwd.txt").exists()


def test_cpu_engines_leave_jax_unimported(tmp_path):
    code = """
import sys
import numpy as np
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.ops import PallasBlockedEngine
from improving_learned_index_tpu_torch.search import DenseSearchEngine, build_engine
idx = InvertedIndexData(["a", "b"], np.array([0, 2, 3]), np.array([0, 1, 1], np.uint32),
                        np.array([5, 3, 7], np.uint8), num_docs=2)
idx.save(sys.argv[1])
want = [[(1, 10.0), (0, 5.0)]]
for name in ("device", "hybrid", "host", "native"):
    res = build_engine(sys.argv[1], engine=name, device="cpu").score_batch([{"a", "b"}], 5)
    assert res == want, (name, res)
for cls in (PallasBlockedEngine, DenseSearchEngine):
    res = cls(idx, device="cpu").score_batch([{"a", "b"}], 5)
    assert res == want, (cls, res)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path / "idx")],
        capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]


def test_card_engines_without_cuda_raise(tmp_path):
    """The card engines default to cuda and raise without it; the host and
    native engines take no device and run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.ops import PallasBlockedEngine
    from improving_learned_index_tpu_torch.search import (
        DenseSearchEngine, DeviceSearchEngine, InvertedIndex, NativeSearchEngine, build_engine,
    )

    idx = InvertedIndexData(["a"], np.array([0, 1]), np.array([0], np.uint32),
                            np.array([5], np.uint8), num_docs=1)
    idx.save(tmp_path / "idx")
    for make in (lambda: DeviceSearchEngine(idx), lambda: DenseSearchEngine(idx),
                 lambda: PallasBlockedEngine(idx),
                 lambda: build_engine(tmp_path / "idx", engine="device"),
                 lambda: build_engine(tmp_path / "idx", engine="auto")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    for eng in (build_engine(tmp_path / "idx", engine="host"), InvertedIndex(idx),
                build_engine(tmp_path / "idx", engine="native"), NativeSearchEngine(tmp_path / "idx")):
        assert eng.score_batch([{"a"}], 3) == [[(0, 5.0)]]
    (tmp_path / "q.tsv").write_text("1\ta\n")
    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\na\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rank_main(["--index_path", str(tmp_path / "idx"), "--queries_path", str(tmp_path / "q.tsv"),
                   "--output_path", str(tmp_path / "run"), "--vocab_path", str(tmp_path / "vocab.txt"),
                   "--engine", "device"])
    assert not (tmp_path / "run").exists()


def test_cpu_training_leaves_jax_unimported(tmp_path):
    """cli.train on the CPU (packed, the short-attention route) and an index
    built from its checkpoint, in a fresh process: nothing of JAX loads."""
    code = """
import sys
from pathlib import Path
from improving_learned_index_tpu_torch.cli.index import main as index_main
from improving_learned_index_tpu_torch.cli.train import main as train_main
from improving_learned_index_tpu_torch.text import WordPieceVocab
d = Path(sys.argv[1])
docs = ["the quick brown fox", "a lazy dog sleeps", "fox and dog", "quick dog naps"]
(d / "c.tsv").write_text("".join(f"{i}\\t{t}\\n" for i, t in enumerate(docs)))
(d / "q.tsv").write_text("0\\tquick fox\\n1\\tlazy dog\\n")
(d / "t.tsv").write_text("0\\t0\\t1\\n1\\t1\\t2\\n")
WordPieceVocab.build(docs, max_size=64).save(d / "vocab.txt")
common = ["--vocab_path", str(d / "vocab.txt"), "--tiny", "--device", "cpu", "--max_length", "128"]
assert train_main(["--dataset_path", str(d / "t.tsv"), "--queries_path", str(d / "q.tsv"),
                   "--collection_path", str(d / "c.tsv"), "--checkpoint_dir", str(d / "ck"),
                   "--batch_size", "2", "--no_beir_eval", *common]) == 0
index_main(["--collection_path", str(d / "c.tsv"), "--output_file_path", str(d / "fwd.txt"),
            "--checkpoint", str(d / "ck" / "DeepImpact_final.pt"), *common])
assert len((d / "fwd.txt").read_text().splitlines()) == len(docs)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr[-2000:]


def test_train_entry_point_without_cuda_raises(tmp_path):
    """cli.train defaults to cuda (so does the Trainer, through its model)
    and raises without one, before it writes a checkpoint."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.cli.train import main as train_main

    (tmp_path / "vocab.txt").write_text("[PAD]\n[UNK]\n[CLS]\n[SEP]\n[MASK]\na\n")
    for name in ("t.tsv", "q.tsv", "c.tsv"):
        (tmp_path / name).write_text("0\ta\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_main(["--dataset_path", str(tmp_path / "t.tsv"), "--queries_path", str(tmp_path / "q.tsv"),
                    "--collection_path", str(tmp_path / "c.tsv"), "--checkpoint_dir", str(tmp_path / "ck"),
                    "--vocab_path", str(tmp_path / "vocab.txt"), "--tiny", "--no_beir_eval"])
    assert not (tmp_path / "ck").exists()


def test_cpu_eval_leaves_jax_unimported(tmp_path):
    """NanoBEIR through cli.nano_beir on the CPU, with both engines of
    ``SparseSearch`` (the switch lowered so the hybrid one runs too)."""
    code = """
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
d = root / "tiny"
d.mkdir()
docs = ["the quick brown fox", "a lazy dog sleeps", "fox and dog", "brown dogs run"]
(d / "corpus.jsonl").write_text("".join(json.dumps({"_id": str(i), "text": t}) + "\\n" for i, t in enumerate(docs)))
(d / "queries.jsonl").write_text(json.dumps({"_id": "q", "text": "brown fox"}) + "\\n")
(d / "qrels.tsv").write_text("q\\t0\\t1\\n")
from improving_learned_index_tpu_torch.cli.nano_beir import main
from improving_learned_index_tpu_torch.evaluation import sparse_search
from improving_learned_index_tpu_torch.text import WordPieceVocab
WordPieceVocab.build(docs, max_size=64).save(root / "vocab.txt")
for switch in (10, 2):
    sparse_search.HYBRID_MIN_DOCS = switch
    assert main(["--vocab_path", str(root / "vocab.txt"), "--tiny", "--device", "cpu", "--max_length", "128",
                 "--local_data_dir", str(root), "--output", str(root / "m.json")]) == 0
    assert set(json.loads((root / "m.json").read_text())) == {"tiny", "avg"}
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-2000:]


def test_cpu_rerankers_leave_jax_unimported(tmp_path):
    """cli.train --cross_encoder and --pairwise, cli.rerank,
    cli.cross_encoder_rerank and the pairwise index route on the CPU, in a
    fresh process: nothing of JAX loads."""
    code = """
import sys
from pathlib import Path
from improving_learned_index_tpu_torch.cli.cross_encoder_rerank import main as cross_main
from improving_learned_index_tpu_torch.cli.index import main as index_main
from improving_learned_index_tpu_torch.cli.rerank import main as rerank_main
from improving_learned_index_tpu_torch.cli.train import main as train_main
from improving_learned_index_tpu_torch.text import WordPieceVocab
d = Path(sys.argv[1])
docs = ["the quick brown fox", "a lazy dog sleeps", "fox and dog", "quick dog naps"]
(d / "c.tsv").write_text("".join(f"{i}\\t{t}\\n" for i, t in enumerate(docs)))
(d / "q.tsv").write_text("0\\tquick fox\\n1\\tlazy dog\\n")
(d / "t.tsv").write_text("0\\t0\\t1\\n1\\t1\\t2\\n")
(d / "run.tsv").write_text("".join(f"{q}\\t{p}\\t{p + 1}\\t1.0\\n" for q in (0, 1) for p in range(4)))
(d / "topk.tsv").write_text("".join(f"0\\t{p}\\tquick fox\\t{t}\\n" for p, t in enumerate(docs)))
WordPieceVocab.build(docs, max_size=64).save(d / "vocab.txt")
common = ["--vocab_path", str(d / "vocab.txt"), "--tiny", "--device", "cpu", "--max_length", "32"]
for flag in ("--cross_encoder", "--pairwise"):
    assert train_main(["--dataset_path", str(d / "t.tsv"), "--queries_path", str(d / "q.tsv"),
                       "--collection_path", str(d / "c.tsv"), "--checkpoint_dir", str(d / flag.strip("-")),
                       "--batch_size", "2", "--no_beir_eval", flag, *common]) == 0
assert rerank_main(["--top_k_run_file_path", str(d / "run.tsv"), "--queries_path", str(d / "q.tsv"),
                    "--collection_path", str(d / "c.tsv"), "--output_path", str(d / "r1"), *common]) == 0
assert cross_main(["--top_k_path", str(d / "topk.tsv"), "--collection_path", str(d / "c.tsv"),
                   "--output_path", str(d / "r2"), "--checkpoint",
                   str(d / "cross_encoder" / "DeepImpactCrossEncoder_final.pt"), *common]) == 0
index_main(["--collection_path", str(d / "c.tsv"), "--output_file_path", str(d / "fwd.txt"),
            "--model_kind", "pairwise", *common])
assert len((d / "r1").read_text().splitlines()) == 8 and len((d / "r2").read_text().splitlines()) == 4
assert len((d / "fwd.txt").read_text().splitlines()) == len(docs)
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-2000:]


def test_reranker_entry_points_without_cuda_raise(tmp_path):
    """The new models and CLIs default to cuda and raise without one,
    before they write an output."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.cli.cross_encoder_rerank import main as cross_main
    from improving_learned_index_tpu_torch.cli.rerank import main as rerank_main
    from improving_learned_index_tpu_torch.cli.train import main as train_main
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import DeepImpactCrossEncoder, DeepPairwiseImpact
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    vocab = WordPieceVocab.build(["a b c"], max_size=32)
    tok = ImpactTokenizer(vocab, max_length=32)
    for cls in (DeepImpactCrossEncoder, DeepPairwiseImpact):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cls(EncoderConfig.tiny(vocab_size=len(vocab)), tok)
    vocab.save(tmp_path / "vocab.txt")
    for name in ("c.tsv", "q.tsv", "t.tsv"):
        (tmp_path / name).write_text("0\ta\n")
    (tmp_path / "run.tsv").write_text("0\t0\t1\t1.0\n")
    (tmp_path / "topk.tsv").write_text("0\t0\ta\ta\n")
    common = ["--vocab_path", str(tmp_path / "vocab.txt"), "--tiny"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rerank_main(["--top_k_run_file_path", str(tmp_path / "run.tsv"), "--queries_path", str(tmp_path / "q.tsv"),
                     "--collection_path", str(tmp_path / "c.tsv"), "--output_path", str(tmp_path / "r1"), *common])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cross_main(["--top_k_path", str(tmp_path / "topk.tsv"), "--collection_path", str(tmp_path / "c.tsv"),
                    "--output_path", str(tmp_path / "r2"), *common])
    for flag in ("--pairwise", "--cross_encoder"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_main(["--dataset_path", str(tmp_path / "t.tsv"), "--queries_path", str(tmp_path / "q.tsv"),
                        "--collection_path", str(tmp_path / "c.tsv"), "--checkpoint_dir", str(tmp_path / "ck"),
                        "--no_beir_eval", flag, *common])
    assert not any((tmp_path / n).exists() for n in ("r1", "r2", "ck"))


def test_cpu_store_algebra_and_serving_leave_jax_unimported(tmp_path):
    """The store route (writer, quantize, invert), split and merge, and a
    router over two shard servers of the CPU hybrid engine, in a fresh
    process: nothing of JAX loads."""
    code = """
import json, socket, sys
from pathlib import Path
from improving_learned_index_tpu_torch.cli.invert import main as invert_main
from improving_learned_index_tpu_torch.cli.quantize import main as quantize_main
from improving_learned_index_tpu_torch.index.impact_store import ImpactStoreWriter
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
from improving_learned_index_tpu_torch.serve import RetrievalServer
from improving_learned_index_tpu_torch.serve.router import RemoteShardedEngine
d = Path(sys.argv[1])
with ImpactStoreWriter(d / "s") as w:
    for i in range(12):
        w.add_doc([("a", 0.5 + i), ("b", 2.0)] if i % 3 else [("c", 1.25)])
assert quantize_main(["-i", str(d / "s"), "-o", str(d / "q")]) == 0
assert invert_main(["-i", str(d / "q"), "-o", str(d / "idx")]) == 0
full = InvertedIndexData.load(d / "idx", num_docs=12)
shards = full.split_docs(2)
servers = [RetrievalServer(HybridSearchEngine(s, heavy_min=2, device="cpu"), max_wait_ms=1.0) for s in shards]
for s in servers:
    s.start()
router = RemoteShardedEngine(f"127.0.0.1:{servers[0].port}:0,127.0.0.1:{servers[1].port}:{shards[0].num_docs}")
want = HybridSearchEngine(InvertedIndexData.merge(shards), heavy_min=2, device="cpu").score_batch([{"a", "c"}], 5)
assert router.score_batch([{"a", "c"}], 5) == want, (router.score_batch([{"a", "c"}], 5), want)
router.close()
for s in servers:
    s.stop()
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-2000:]


def test_cpu_multidevice_leaves_jax_unimported(tmp_path):
    """A sharded query over ``["cpu"] * 4``, a data-parallel encode over
    ``["cpu"] * 2`` (unpacked and packed) and the dry run, in a fresh
    process: nothing of JAX loads."""
    code = """
import sys
import numpy as np
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.models import DeepImpact
from improving_learned_index_tpu_torch.parallel import dryrun_multidevice
from improving_learned_index_tpu_torch.search import ShardedSearchEngine
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
idx = InvertedIndexData(["a", "b"], np.array([0, 2, 3]), np.array([0, 1, 1], np.uint32),
                        np.array([5, 3, 7], np.uint8), num_docs=2)
res = ShardedSearchEngine(idx, ["cpu"] * 4, heavy_min=2).score_batch([{"a", "b"}], 5)
assert res == [[(1, 10.0), (0, 5.0)]], res
docs = ["the quick brown fox", "a lazy dog sleeps", "fox and dog"]
vocab = WordPieceVocab.build(docs, max_size=64)
model = DeepImpact(EncoderConfig.tiny(vocab_size=len(vocab)), ImpactTokenizer(vocab, max_length=128),
                   devices=["cpu", "cpu"])
assert len(model.get_impact_scores_batch(docs)) == len(model.get_impact_scores_batch_packed(docs)) == 3
dryrun_multidevice(["cpu", "cpu"])
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env, cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-2000:]


def test_multidevice_entry_points_without_cuda_raise():
    """``ShardedSearchEngine(index)`` (every visible card) and
    ``DeepImpact(devices=None)`` default to cuda and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.search import ShardedSearchEngine
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    idx = InvertedIndexData(["a"], np.array([0, 1]), np.array([0], np.uint32),
                            np.array([5], np.uint8), num_docs=1)
    vocab = WordPieceVocab.build(["a b c"], max_size=32)
    tok = ImpactTokenizer(vocab, max_length=128)
    for make in (lambda: ShardedSearchEngine(idx), lambda: ShardedSearchEngine(idx, ["cuda:0"] * 4),
                 lambda: DeepImpact(EncoderConfig.tiny(vocab_size=len(vocab)), tok, devices=None),
                 lambda: DeepImpact(EncoderConfig.tiny(vocab_size=len(vocab)), tok, devices=["cuda:0"] * 2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


def test_cpu_remainder_leaves_jax_unimported(tmp_path):
    """The scripts, the Anserini export, a JAX-format checkpoint written and
    read by ``core.flax_msgpack`` into ``DeepImpact.load`` and ``cli.index``,
    term-pair attention and the async manager, on the CPU, import no JAX,
    no msgpack and none of the gated packages."""
    code = """
import sys
from pathlib import Path
import torch
sys.path.insert(0, sys.argv[2])
from chip_smoke import port_params_to_flax
from improving_learned_index_tpu_torch.analysis import extract_term_pair_attention
from improving_learned_index_tpu_torch.cli.convert_to_anserini import main as anserini_main
from improving_learned_index_tpu_torch.cli.index import main as index_main
from improving_learned_index_tpu_torch.core import flax_msgpack
from improving_learned_index_tpu_torch.core.async_checkpoint import AsyncCheckpointManager
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models import DeepImpact
from improving_learned_index_tpu_torch.scripts.create_passages import main as passages_main
from improving_learned_index_tpu_torch.scripts.preprocess_passages import main as preprocess_main
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
d = Path(sys.argv[1])
docs = ["the quick brown fox", "a lazy dog sleeps", "fox and dog"] * 3
(d / "c.tsv").write_text("".join(f"{i}\\t{t}\\n" for i, t in enumerate(docs)))
assert passages_main(["--collection_path", str(d / "c.tsv"), "--output_collection", str(d / "p.tsv"),
                      "--output_mapping", str(d / "m.txt"), "--window", "2", "--stride", "1"]) == 0
assert preprocess_main(["--collection_path", str(d / "c.tsv"), "--output_path", str(d / "pre.tsv")]) == 0
vocab = WordPieceVocab.build(docs, max_size=64)
vocab.save(d / "vocab.txt")
cfg = EncoderConfig.tiny(vocab_size=len(vocab))
tok = ImpactTokenizer(vocab, max_length=64)
sd = DeepImpact(cfg, tok, device="cpu").module.state_dict()
flax_msgpack.write(d / "m.msgpack", {"params": port_params_to_flax(sd, cfg)})
model = DeepImpact.load(cfg, tok, d / "m.msgpack", device="cpu")
assert all(torch.equal(v, model.module.state_dict()[k]) for k, v in sd.items())
assert index_main(["--collection_path", str(d / "c.tsv"), "--output_file_path", str(d / "fwd.txt"),
                   "--vocab_path", str(d / "vocab.txt"), "--tiny", "--max_length", "64",
                   "--checkpoint", str(d / "m.msgpack"), "--device", "cpu"]) == 0
assert anserini_main(["-i", str(d / "fwd.txt"), "-o", str(d / "a.jsonl")]) == 0
assert extract_term_pair_attention(model, docs[:2])[0]
mgr = AsyncCheckpointManager(d / "ck", save_every=1)
mgr.on_step(sd)
mgr.wait()
assert mgr.exists()
gone = ("jax", "jaxlib", "flax", "improving_learned_index_tpu", "msgpack", "transformers", "matplotlib")
leaked = [m for m in sys.modules if m.split(".")[0] in gone]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path), str(REPO)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-2000:]


def test_remainder_entry_points_without_cuda_raise(tmp_path):
    """A JAX-format checkpoint through ``DeepImpact.load`` and ``cli.index
    --checkpoint`` defaults to cuda and raises without one, before any
    output is written."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from chip_smoke import port_params_to_flax
    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.core import flax_msgpack
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    vocab = WordPieceVocab.build(["a b c"], max_size=32)
    vocab.save(tmp_path / "vocab.txt")
    cfg = EncoderConfig.tiny(vocab_size=len(vocab))
    tok = ImpactTokenizer(vocab, max_length=128)
    sd = DeepImpact(cfg, tok, device="cpu").module.state_dict()
    flax_msgpack.write(tmp_path / "m.msgpack", {"params": port_params_to_flax(sd, cfg)})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DeepImpact.load(cfg, tok, tmp_path / "m.msgpack")
    (tmp_path / "c.tsv").write_text("0\ta b c\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        index_main(["--collection_path", str(tmp_path / "c.tsv"), "--output_file_path",
                    str(tmp_path / "fwd.txt"), "--vocab_path", str(tmp_path / "vocab.txt"), "--tiny",
                    "--checkpoint", str(tmp_path / "m.msgpack")])
    assert not (tmp_path / "fwd.txt").exists()


def test_cpu_expansion_leaves_jax_unimported(tmp_path):
    """Generation (int4 weights, int8 cache), a fine-tune step through the
    flash twin, a local generator round trip, T5 generation (int4 weights)
    and ``cli.expand_precomputed``, on the CPU, in a fresh process: nothing
    of JAX loads."""
    code = """
import dataclasses, sys
from pathlib import Path
from improving_learned_index_tpu_torch.core.config import GenerationConfig
from improving_learned_index_tpu_torch.expand import QueryGenerator, WordTokenizer, load_local_generator, save_local_generator
from improving_learned_index_tpu_torch.expand.finetune import Doc2QueryFineTuner
from improving_learned_index_tpu_torch.models.llama import LlamaConfig, init_llama_params
from improving_learned_index_tpu_torch.models.quantization import quantize_params_int4
d = Path(sys.argv[1])
tok = WordTokenizer.build(["a b c d e f", "g h i"])
cfg = dataclasses.replace(LlamaConfig.tiny(vocab_size=tok.vocab_size), kv_quant="int8", use_flash_attention=True)
params = init_llama_params(cfg, seed=0)
gen = QueryGenerator(quantize_params_int4(params), cfg, tok, GenerationConfig(num_return_sequences=2, max_new_tokens=3),
                     device="cpu")
assert len(gen.generate(["a b c", "g h"])[1]) == 2
ft = Doc2QueryFineTuner(params, cfg, tok, quantize_base="int8", layerwise=True, device="cpu")
assert ft.train([("a b c d", "e f"), ("g h", "i")], batch_size=2) > 0
save_local_generator(d / "gen", ft.merged_params(), cfg, tok)
assert load_local_generator(d / "gen")[1] == cfg
from improving_learned_index_tpu_torch.cli.expand_precomputed import main as precomputed_main
from improving_learned_index_tpu_torch.expand import T5QueryGenerator
from improving_learned_index_tpu_torch.models.t5 import T5Config, init_t5_params
from improving_learned_index_tpu_torch.text import WordPieceVocab
t5cfg = T5Config.tiny(vocab_size=tok.vocab_size)
t5 = T5QueryGenerator(quantize_params_int4(init_t5_params(t5cfg)), t5cfg, tok,
                      GenerationConfig(num_return_sequences=2, max_new_tokens=3), eos_token_id=tok.EOS, device="cpu")
assert len(t5.generate(["a b c", "g h"])[0]) == 2
(d / "c.tsv").write_text("0\\ta b c\\n1\\tg h\\n")
(d / "s.jsonl").write_text('{"doc_id": "0", "queries": [{"query": "d e", "score": 1.0}]}\\n')
WordPieceVocab.build(["a b c d e f g h i"], max_size=64).save(d / "vocab.txt")
assert precomputed_main(["--vocab_path", str(d / "vocab.txt"), "--collection_path", str(d / "c.tsv"),
                         "--queries_path", str(d / "s.jsonl"), "--output_path", str(d / "x.tsv")]) == 0
assert (d / "x.tsv").read_text().startswith("0\\ta b c [SEP] ")
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, env=env, cwd=tmp_path,
        timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-2000:]


def test_expansion_entry_points_without_cuda_raise(tmp_path):
    """``QueryGenerator``, ``T5QueryGenerator``, ``Doc2QueryFineTuner`` and
    ``cli.expand`` / ``cli.finetune`` default to cuda and raise without one."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from improving_learned_index_tpu_torch.cli.expand import main as expand_main
    from improving_learned_index_tpu_torch.cli.finetune import main as finetune_main
    from improving_learned_index_tpu_torch.expand import QueryGenerator, WordTokenizer
    from improving_learned_index_tpu_torch.expand.finetune import Doc2QueryFineTuner
    from improving_learned_index_tpu_torch.models.llama import LlamaConfig, init_llama_params

    tok = WordTokenizer(["a", "b"])
    cfg = LlamaConfig.tiny(vocab_size=tok.vocab_size)
    params = init_llama_params(cfg)
    (tmp_path / "c.tsv").write_text("0\ta b\n")
    (tmp_path / "p.tsv").write_text("a b\ta\n")
    from improving_learned_index_tpu_torch.expand import T5QueryGenerator
    from improving_learned_index_tpu_torch.models.t5 import T5Config, init_t5_params

    t5cfg = T5Config.tiny(vocab_size=tok.vocab_size)
    for make in (lambda: QueryGenerator(params, cfg, tok), lambda: Doc2QueryFineTuner(params, cfg, tok),
                 lambda: T5QueryGenerator(init_t5_params(t5cfg), t5cfg, tok),
                 lambda: expand_main(["--collection_path", str(tmp_path / "c.tsv"), "--output_path",
                                      str(tmp_path / "o.jsonl"), "--tiny"]),
                 lambda: finetune_main(["--dataset_path", str(tmp_path / "p.tsv"), "--output_adapter",
                                        str(tmp_path / "a.msgpack"), "--tiny"])):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()
    assert not (tmp_path / "o.jsonl").exists() and not (tmp_path / "a.msgpack").exists()


def test_cpu_walkthroughs_and_new_surface_leave_jax_unimported(tmp_path):
    """Both walkthroughs in-process with ``--device cpu``, then
    ``PairwiseForwardIndex``, ``port_deep_impact_to_hf`` and the subpackage
    exports, in a fresh process: nothing of JAX loads."""
    code = """
import runpy, sys
from pathlib import Path
d = Path(sys.argv[1])
for name in ("quickstart_torch.py", "index_lifecycle_torch.py"):
    main = runpy.run_path(str(Path(sys.argv[2]) / "examples" / name))["main"]
    assert main(["--device", "cpu", "--workdir", str(d / name)]) == 0
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.index import PairwiseForwardIndex, format_line, format_quantized_line, parse_line
from improving_learned_index_tpu_torch.models import (DeepImpactModel, dequantize_params, hf_deep_impact_to_port,
                                                      port_deep_impact_to_hf, quantize_params_int4,
                                                      quantize_params_int8)
from improving_learned_index_tpu_torch.ops import global_max, quantize_array, quantize_device, quantize_scale, quantize_value
from improving_learned_index_tpu_torch.train import collate_cross_encoder
from improving_learned_index_tpu_torch.utils import get_unique_query_terms, merge_document_and_queries
(d / "f.txt").write_text(format_line([("a", 1.0), ("b", 2.0), ("a|b", 0.5)]) + "\\n")
assert PairwiseForwardIndex(d / "f.txt").score(0, {"a", "b"}) == 3.5
cfg = EncoderConfig.tiny(vocab_size=64)
sd = DeepImpactModel(cfg).state_dict()
back = hf_deep_impact_to_port(port_deep_impact_to_hf(sd, cfg), cfg)
assert all((back[k] == v).all() for k, v in sd.items())
leaked = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "improving_learned_index_tpu")]
assert not leaked, leaked
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run(
        [sys.executable, "-c", code, str(tmp_path), str(REPO)], capture_output=True, text=True, env=env,
        cwd=tmp_path, timeout=120,
    )
    assert out.returncode == 0 and out.stdout.strip().splitlines()[-1] == "ok", out.stderr[-2000:]
