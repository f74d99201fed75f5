"""The eval CLIs and ``cli.train``'s in-training eval, on the CPU.

- ``cli.nano_beir --tiny --device cpu`` prints and writes what
  ``NanoBEIREvaluator`` gives for the same seeded model, and equals the JAX
  CLI's metrics where the model is the deterministic unit-impact stub.
- ``cli.bm25 --device cpu`` writes the JAX CLI's run file byte for byte.
- ``cli.train`` evaluates at the JAX package's iterations (0, eval_every,
  ...), on the weights of that step: the eval's impacts equal
  ``get_impact_scores_batch_packed`` of a fresh model loaded from the
  checkpoint of the same step, and its metrics equal the evaluator's on
  that model.  The eval leaves no autograd state behind: the losses equal
  those of a run without it.

Every dataset is written here in BEIR format; nothing is downloaded."""

import json

import numpy as np
import pytest

from improving_learned_index_tpu.cli import bm25 as jax_bm25_cli
from improving_learned_index_tpu_torch.cli import bm25 as bm25_cli
from improving_learned_index_tpu_torch.cli import nano_beir as nano_beir_cli
from improving_learned_index_tpu_torch.cli import train as train_cli
from improving_learned_index_tpu_torch.cli.build_vocab import main as build_vocab_main
from improving_learned_index_tpu_torch.core.checkpoint import load_params
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.evaluation import NanoBEIREvaluator
from improving_learned_index_tpu_torch.models import DeepImpact
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

PASSAGES = [
    "the quick brown fox jumps over the lazy dog",
    "a fast auburn fox leaped across a sleepy canine",
    "neural networks learn sparse representations of text",
    "inverted indexes map terms to document postings",
    "impact scores quantize term importance into bytes",
    "retrieval systems rank documents for user queries",
    "the dog sleeps while the fox runs through fields",
    "sparse retrieval needs exact top k answers",
]
QUERIES = ["quick fox", "sleepy canine", "sparse text", "document postings", "term bytes",
           "rank queries", "fox fields", "exact answers"]


def _write_beir(root, name, passages, queries):
    """Query i's one relevant passage is passage i."""
    d = root / name
    d.mkdir(parents=True)
    (d / "corpus.jsonl").write_text("".join(
        json.dumps({"_id": f"p{i}", "title": "", "text": p}) + "\n" for i, p in enumerate(passages)))
    (d / "queries.jsonl").write_text("".join(
        json.dumps({"_id": f"q{i}", "text": q}) + "\n" for i, q in enumerate(queries)))
    (d / "qrels.tsv").write_text("query-id\tcorpus-id\tscore\n"
                                 + "".join(f"q{i}\tp{i}\t1\n" for i in range(len(queries))))


@pytest.fixture
def data(tmp_path):
    """Training files (query i's positive is passage i, its negative i+3),
    a vocabulary by cli.build_vocab, and two BEIR datasets under beir/."""
    (tmp_path / "c.tsv").write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(PASSAGES)))
    (tmp_path / "q.tsv").write_text("".join(f"{i}\t{q}\n" for i, q in enumerate(QUERIES)))
    (tmp_path / "t.tsv").write_text("".join(f"{i}\t{i}\t{(i + 3) % 8}\n" for i in range(8)))
    build_vocab_main(["--collection_path", str(tmp_path / "c.tsv"), "--output_path",
                      str(tmp_path / "vocab.txt"), "--min_freq", "1"])
    _write_beir(tmp_path / "beir", "nano", PASSAGES, QUERIES)
    rng = np.random.default_rng(0)
    words = " ".join(PASSAGES).split()
    more = [" ".join(rng.choice(words, int(rng.integers(4, 12)))) for _ in range(40)]
    _write_beir(tmp_path / "beir", "other", more, [" ".join(p.split()[:2]) for p in more[:10]])
    return tmp_path


def _model(data, max_length, checkpoint=None):
    tok = ImpactTokenizer(WordPieceVocab.load(data / "vocab.txt"), max_length=max_length)
    state = load_params(checkpoint) if checkpoint else None
    return DeepImpact(EncoderConfig.tiny(vocab_size=len(tok.vocab)), tok, state_dict=state, device="cpu")


def test_cli_nano_beir_equals_the_evaluator(data, capsys):
    out = data / "metrics.json"
    assert nano_beir_cli.main(["--vocab_path", str(data / "vocab.txt"), "--tiny", "--device", "cpu",
                               "--max_length", "128", "--local_data_dir", str(data / "beir"),
                               "--batch_size", "4", "--output", str(out)]) == 0
    got = json.loads(out.read_text())
    assert json.loads(capsys.readouterr().out) == got
    assert set(got) == {"nano", "other", "avg"}
    want = NanoBEIREvaluator(batch_size=4, local_data_dir=data / "beir").evaluate_all(_model(data, 128))
    assert got == json.loads(json.dumps(want))
    assert all(0 <= v <= 1 for part in got["avg"] for v in part.values())


def test_cli_nano_beir_equals_jax_with_the_unit_model(data, monkeypatch, capsys):
    """The CLI's plumbing against the JAX CLI's, with the model replaced on
    both sides by the deterministic unit-impact stub (exact metrics)."""
    from improving_learned_index_tpu.cli import nano_beir as jax_nano_cli
    from test_nano_beir_full import UnitImpactModel

    class Stub(UnitImpactModel):
        device = "cpu"

    monkeypatch.setattr(nano_beir_cli, "build_model", lambda args: Stub())
    monkeypatch.setattr(jax_nano_cli, "build_model", lambda args: Stub())
    args = ["--vocab_path", str(data / "vocab.txt"), "--local_data_dir", str(data / "beir"),
            "--batch_size", "3"]
    assert nano_beir_cli.main(args + ["--output", str(data / "ours.json")]) == 0
    assert jax_nano_cli.main(args + ["--output", str(data / "theirs.json")]) == 0
    assert (data / "ours.json").read_text() == (data / "theirs.json").read_text()


def test_cli_bm25_equals_jax(data):
    args = ["--collection_path", str(data / "c.tsv"), "--queries_path", str(data / "q.tsv"),
            "--vocab_path", str(data / "vocab.txt"), "--top_k", "5"]
    assert bm25_cli.main(args + ["--output_path", str(data / "ours.run"), "--device", "cpu"]) == 0
    assert jax_bm25_cli.main(args + ["--output_path", str(data / "theirs.run")]) == 0
    ours = (data / "ours.run").read_text()
    assert ours == (data / "theirs.run").read_text()
    first = [line.split("\t") for line in ours.splitlines() if line.startswith("0\t")]
    assert first[0][1] == "0" and [r for _, _, r, _ in first] == [str(i) for i in range(1, len(first) + 1)]


def _train_args(data, ckpt, *extra):
    return ["--dataset_path", str(data / "t.tsv"), "--queries_path", str(data / "q.tsv"),
            "--collection_path", str(data / "c.tsv"), "--checkpoint_dir", str(data / ckpt),
            "--vocab_path", str(data / "vocab.txt"), "--tiny", "--device", "cpu",
            "--batch_size", "2", "--lr", "1e-3", "--max_length", "128", "--total_steps", "4",
            "--save_every", "1", *extra]


def test_cli_train_evaluates_the_weights_of_its_step(data, monkeypatch):
    calls = []
    real = DeepImpact.get_impact_scores_batch_packed

    def spy(self, documents, rows=None):
        out = real(self, documents, rows)
        calls.append((list(documents), out))
        return out

    monkeypatch.setattr(DeepImpact, "get_impact_scores_batch_packed", spy)
    assert train_cli.main(_train_args(data, "ck", "--nano_beir_dir", str(data / "beir"),
                                      "--eval_datasets", "nano", "--eval_every", "2")) == 0
    ck = data / "ck"
    records = [json.loads(line) for line in (ck / "metrics.txt").read_text().splitlines()]
    evals = [r for r in records if "eval_stall_seconds" in r]
    assert [r["iteration"] for r in evals] == [0, 2]
    assert all(r["eval_stall_seconds"] >= 0 and set(r["metrics"]) == {"nano", "avg"} for r in evals)
    # one packed encode of the 8 passages an eval (batch_size 64)
    assert len(calls) == 2 and all(docs == PASSAGES for docs, _ in calls)
    monkeypatch.setattr(DeepImpact, "get_impact_scores_batch_packed", real)
    evaluator = NanoBEIREvaluator(batch_size=64, local_data_dir=data / "beir", datasets=["nano"])
    for (_, impacts), record in zip(calls, evals):
        # the eval after batch i ran on the weights saved as step i + 1
        fresh = _model(data, 128, ck / f"DeepImpact_{record['iteration'] + 1}.pt")
        assert fresh.get_impact_scores_batch_packed(PASSAGES) == impacts
        assert json.loads(json.dumps(evaluator.evaluate_all(fresh))) == record["metrics"]
    assert calls[0][1] != calls[1][1]  # the weights moved between the evals

    # no autograd state or weight change left behind: the same losses without it
    assert train_cli.main(_train_args(data, "ck_plain", "--no_beir_eval")) == 0

    def losses(d):
        return [(r["train/loss"], r["train/grad_norm"])
                for r in map(json.loads, (d / "metrics.txt").read_text().splitlines()) if "train/loss" in r]

    assert losses(ck) == losses(data / "ck_plain") and len(losses(ck)) == 4


def test_cli_train_eval_refuses_an_empty_directory(data):
    (data / "empty").mkdir()
    with pytest.raises(ValueError, match="no BEIR-format datasets"):
        train_cli.main(_train_args(data, "c", "--nano_beir_dir", str(data / "empty")))
