"""The port's ``cli.train`` on the CPU: end to end into ``cli.index
--checkpoint``, its packing and refusal flags, multi-epoch resume, and
data parallelism over two gloo processes against one process.

Tolerances: the CLI runs are the same computation in the same process
layout, so params agree to 1e-6 (as the JAX package's resume test).  Two
ranks average two half-batch gradients where one process takes the mean of
the whole batch: the sums' order changes, fp32 rounding only, so gradients
agree to rtol 2e-4 / atol 1e-6 (the JAX package's packed-vs-unpacked
tolerance) and losses to rtol 1e-5.  Params after Adam are not compared
across layouts: Adam's first steps move a parameter by ~lr whatever the size
of its gradient, so a gradient within rounding of 0 can flip a param's step.
"""

import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from improving_learned_index_tpu_torch.cli import train as train_cli
from improving_learned_index_tpu_torch.cli.build_vocab import main as build_vocab_main
from improving_learned_index_tpu_torch.cli.index import main as index_main
from improving_learned_index_tpu_torch.core.checkpoint import load_params
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.index.forward_index import parse_line
from improving_learned_index_tpu_torch.models import DeepImpact
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

REPO = Path(__file__).resolve().parent.parent
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


@pytest.fixture
def data(tmp_path):
    """queries/collection/triples (query i's positive is passage i, its
    negative passage i+3) and a vocabulary built by cli.build_vocab."""
    (tmp_path / "c.tsv").write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(PASSAGES)))
    (tmp_path / "q.tsv").write_text("".join(f"{i}\t{q}\n" for i, q in enumerate(QUERIES)))
    (tmp_path / "t.tsv").write_text("".join(f"{i}\t{i}\t{(i + 3) % 8}\n" for i in range(8)))
    build_vocab_main(["--collection_path", str(tmp_path / "c.tsv"), "--output_path",
                      str(tmp_path / "vocab.txt"), "--min_freq", "1"])
    return tmp_path


def _train_args(d, ckpt, *extra):
    return ["--dataset_path", str(d / "t.tsv"), "--queries_path", str(d / "q.tsv"),
            "--collection_path", str(d / "c.tsv"), "--checkpoint_dir", str(d / ckpt),
            "--vocab_path", str(d / "vocab.txt"), "--tiny", "--device", "cpu",
            "--batch_size", "2", "--lr", "1e-3", "--no_beir_eval", *extra]


def test_cli_train_then_index_with_the_checkpoint(data):
    """Packed (the default) at max_length 128, the short-attention route:
    snapshots at steps 2 and 4 plus latest and final, finite logged losses,
    then cli.index --checkpoint writes what the trained model gives."""
    assert train_cli.main(_train_args(data, "ckpt", "--max_length", "128", "--total_steps", "4",
                                      "--save_every", "2")) == 0
    ck = data / "ckpt"
    for suffix, step in (("2", 2), ("4", 4), ("latest", 4), ("final", 4)):
        meta = json.loads((ck / f"DeepImpact_{suffix}.meta.json").read_text())
        assert (ck / f"DeepImpact_{suffix}.pt").exists() and meta["step"] == step, suffix
        assert meta["batch_size"] == 2 and meta["has_opt_state"]
    records = [json.loads(line) for line in (ck / "metrics.txt").read_text().splitlines()]
    train = [r for r in records if "train/loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3, 4]
    assert all(np.isfinite(r["train/loss"]) for r in train) and max(r["train/grad_norm"] for r in train) > 0

    index_main(["--collection_path", str(data / "c.tsv"), "--output_file_path", str(data / "fwd.txt"),
                "--vocab_path", str(data / "vocab.txt"), "--tiny", "--max_length", "128",
                "--device", "cpu", "--checkpoint", str(ck / "DeepImpact_final.pt")])
    tok = ImpactTokenizer(WordPieceVocab.load(data / "vocab.txt"), max_length=128)
    config = EncoderConfig.tiny(vocab_size=len(tok.vocab))
    trained = DeepImpact(config, tok, state_dict=load_params(ck / "DeepImpact_final.pt"), device="cpu")
    untrained = DeepImpact(config, tok, device="cpu")
    assert any(not torch.equal(a, b) for a, b in zip(trained.module.parameters(),
                                                     untrained.module.parameters()))
    got = [parse_line(line) for line in (data / "fwd.txt").read_text().splitlines()]
    want = [{t: round(v, 3) for t, v in doc} for doc in trained.get_impact_scores_batch(PASSAGES)]
    assert got == want


def test_cli_packs_by_default_and_no_pack_opts_out(data, monkeypatch):
    calls = []
    real = train_cli.packing_collate
    monkeypatch.setattr(train_cli, "packing_collate", lambda *a, **k: calls.append(1) or real(*a, **k))
    common = ["--max_length", "32", "--total_steps", "1", "--save_every", "1000000"]
    assert train_cli.main(_train_args(data, "c1", *common)) == 0
    assert calls, "pairwise_ce (packable) must pack by default"
    calls.clear()
    assert train_cli.main(_train_args(data, "c2", *common, "--no_pack")) == 0
    assert not calls, "--no_pack must disable packing"
    assert train_cli.main(_train_args(data, "c3", *common, "--in_batch_negatives")) == 0
    assert not calls, "an unpackable loss trains unpacked without a flag"


def test_cli_refusals(data):
    with pytest.raises(SystemExit):
        train_cli.main(_train_args(data, "c", "--in_batch_negatives", "--pack"))
    with pytest.raises(SystemExit):
        train_cli.main(_train_args(data, "c", "--pack", "--no_pack"))
    # the in-training eval is on without --no_beir_eval: a --nano_beir_dir
    # that holds no BEIR-format dataset is refused before training starts
    (data / "no_beir").mkdir()
    args = [a for a in _train_args(data, "c") if a != "--no_beir_eval"]
    with pytest.raises(ValueError, match="no BEIR-format datasets"):
        train_cli.main(args + ["--nano_beir_dir", str(data / "no_beir")])
    assert not (data / "c" / "metrics.txt").exists()
    # the pairwise and cross-encoder losses score a document under several
    # masks or as a pair: --pack is refused, and they train unpacked
    for flag, name in (("--pairwise", "DeepPairwiseImpact"), ("--cross_encoder", "DeepImpactCrossEncoder")):
        with pytest.raises(SystemExit):
            train_cli.main(_train_args(data, "c", flag, "--pack"))
        assert not (data / "c" / f"{name}_final.pt").exists()
        assert train_cli.main(_train_args(data, f"c_{name}", flag, "--max_length", "32",
                                          "--total_steps", "1")) == 0
        assert (data / f"c_{name}" / f"{name}_final.pt").exists()
    (data / "p.msgpack").write_bytes(b"")  # an empty (truncated) JAX checkpoint
    with pytest.raises(ValueError, match="truncated msgpack"):
        index_main(["--collection_path", str(data / "c.tsv"), "--output_file_path", str(data / "f.txt"),
                    "--vocab_path", str(data / "vocab.txt"), "--tiny", "--device", "cpu",
                    "--checkpoint", str(data / "p.msgpack")])


def test_cli_epochs_resume_equals_unbroken(data):
    """--epochs 2 at once, against --epochs 1 and then --epochs 2 in the same
    directory: the rerun resumes from latest, skips the seen epoch (the
    resume arithmetic of cli/train.py) and trains the second."""
    common = ["--max_length", "32", "--save_every", "1", "--no_pack"]
    assert train_cli.main(_train_args(data, "once", *common, "--epochs", "2")) == 0
    assert train_cli.main(_train_args(data, "split", *common, "--epochs", "1")) == 0
    assert json.loads((data / "split" / "DeepImpact_latest.meta.json").read_text())["step"] == 4
    assert train_cli.main(_train_args(data, "split", *common, "--epochs", "2")) == 0
    a = load_params(data / "once" / "DeepImpact_final.pt")
    b = load_params(data / "split" / "DeepImpact_final.pt")
    assert json.loads((data / "split" / "DeepImpact_final.meta.json").read_text())["step"] == 8
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), atol=1e-6, err_msg=k)


_WORKER = textwrap.dedent("""
    import dataclasses, json, sys
    from functools import partial
    import numpy as np, torch
    sys.path.insert(0, sys.argv[5])
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
    from improving_learned_index_tpu_torch.core.metrics_log import MetricsLogger
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.parallel import BatchLoader, initialize_distributed, rank_collate
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.train import COLLATES, Trainer
    from improving_learned_index_tpu_torch.train.packed import packing_collate

    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    passages, queries = json.loads(sys.argv[6]), json.loads(sys.argv[7])
    initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank, backend="gloo")
    tok = ImpactTokenizer(WordPieceVocab.build(passages, max_size=512), max_length=32)
    cfg = dataclasses.replace(EncoderConfig.tiny(len(tok.vocab), "softplus"), dtype="float32")
    items = [(queries[i], passages[i], passages[(i + 3) % 8]) for i in range(8)] * 2
    result = {}
    for pack in (False, True):
        collate = rank_collate(partial(COLLATES["pairwise_ce"], tokenizer=tok, max_length=32), rank, world)
        if pack:
            collate = packing_collate(collate)
        batches = list(BatchLoader(items, 4, collate, shuffle=True, seed=1))
        ckpt = f"{out}/ckpt_{pack}_{world}_{rank}"
        trainer = Trainer(DeepImpact(cfg, tok, seed=0, device="cpu"),
                          TrainConfig(batch_size=4, lr=1e-3, save_every=10**6, eval_every=10**9), ckpt,
                          metrics_logger=MetricsLogger(ckpt))
        loss, norm, grads = trainer._grad_step(trainer._put_batch(batches[0]))
        trainer.train(batches, total_steps=3)
        losses = [json.loads(line)["train/loss"] for line in open(f"{ckpt}/metrics.txt")] if rank == 0 else []
        result[str(pack)] = {"loss": float(loss), "grads": [g.tolist() for g in grads], "losses": losses,
                             "rows": int(batches[0]["input_ids"].shape[0])}
    if rank == 0:
        json.dump(result, open(f"{out}/result_{world}.json", "w"))
    torch.distributed.destroy_process_group() if world > 1 else None
""")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ddp_runs(tmp_path_factory):
    """One process, then two gloo ranks, over the same global batches."""
    out = tmp_path_factory.mktemp("ddp")
    script = out / "worker.py"
    script.write_text(_WORKER)
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for world in (1, 2):
        port = str(_free_port())
        procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), port, str(out), str(REPO),
                                   json.dumps(PASSAGES), json.dumps(QUERIES)],
                                  env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for r in range(world)]
        for p in procs:
            log, _ = p.communicate(timeout=300)
            assert p.returncode == 0, log[-3000:]
    return [json.loads((out / f"result_{w}.json").read_text()) for w in (1, 2)]


@pytest.mark.parametrize("pack", [False, True])
def test_two_gloo_ranks_equal_one_process(ddp_runs, pack):
    one, two = (r[str(pack)] for r in ddp_runs)
    # each rank took half of the 4 query groups: 4 document rows unpacked
    assert two["rows"] < one["rows"] or pack
    np.testing.assert_allclose(two["loss"], one["loss"], rtol=1e-5)
    for a, b in zip(two["grads"], one["grads"]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=2e-4, atol=1e-6)
    assert len(one["losses"]) == len(two["losses"]) == 3
    np.testing.assert_allclose(two["losses"], one["losses"], rtol=1e-5)
