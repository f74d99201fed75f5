"""CLI: train a DeepImpact model on the card
(reference: torchrun -m src.deep_impact.train, train.py:240-283).

    python -m improving_learned_index_tpu_torch.cli.train \\
        --dataset_path triples.tsv --queries_path queries.tsv \\
        --collection_path collection.tsv --checkpoint_dir ckpt \\
        --vocab_path vocab.txt --max_length 256 \\
        --nano_beir_dir beir --eval_datasets msmarco,nfcorpus [--device cpu]

The flags are the JAX package's.  ``--xlmr`` picks the model;
``--pairwise`` (``DeepPairwiseImpact``, the pairwise-impact loss) and
``--cross_encoder`` (``DeepImpactCrossEncoder``, pairwise cross-entropy of
its [CLS] scores) pick model and objective; otherwise
``--distil_kl/--distil_mse/--in_batch_negatives`` pick the objective
(default: pairwise cross-entropy on triples).  Sequence packing is the
default for the losses that allow it (``--no_pack`` restores the
row-per-document layout; the pairwise and cross-encoder losses refuse
``--pack``).  Checkpoints land in ``--checkpoint_dir`` as
``<Model>_{latest,<step>,best,final}.pt`` (``DeepImpact``,
``DeepPairwiseImpact``, ``DeepImpactCrossEncoder``); a rerun resumes from
``latest``, and ``cli.index --checkpoint <dir>/DeepImpact_final.pt`` indexes
with the trained weights (``cli.cross_encoder_rerank --checkpoint
<dir>/DeepImpactCrossEncoder_final.pt`` reranks with a trained
cross-encoder).

In-training eval: every ``--eval_every`` batches, counting from the first,
``evaluation.NanoBEIREvaluator`` scores the model on the BEIR-format
datasets under ``--nano_beir_dir`` (all of them, or ``--eval_datasets``)
and appends the metrics and the stall's seconds to
``<checkpoint_dir>/metrics.txt``; ``--no_beir_eval`` turns it off.

Data parallelism: under a launcher that sets ``WORLD_SIZE``/``RANK``/
``MASTER_ADDR``/``MASTER_PORT`` (``torchrun``) each process trains its share
of every global batch (``parallel.distributed``).  Rank 0 alone runs the
eval; the other ranks wait at their next collective for the whole stall.
"""

from __future__ import annotations

import argparse
from contextlib import closing
from functools import partial
from pathlib import Path

import torch.distributed as dist

from ..core.config import TrainConfig
from ..data.datasets import DistillationScores, MSMarcoTriples
from ..parallel.dataloader import BatchLoader
from ..parallel.distributed import initialize_distributed, rank_collate
from ..train.collate import COLLATES
from ..train.packed import PACKABLE_LOSSES, packing_collate
from ..train.trainer import Trainer
from .common import add_model_args, build_model


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_model_args(parser)
    parser.add_argument("--dataset_path", type=Path, required=True)
    parser.add_argument("--queries_path", type=Path, required=True)
    parser.add_argument("--collection_path", type=Path, required=True)
    parser.add_argument("--checkpoint_dir", type=Path, required=True)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--batch_size", type=int, default=16)
    parser.add_argument("--lr", type=float, default=3e-6)
    parser.add_argument("--save_every", type=int, default=20000)
    parser.add_argument("--save_best", action="store_true")
    parser.add_argument("--gradient_accumulation_steps", type=int, default=1)
    parser.add_argument("--xlmr", action="store_true")
    parser.add_argument("--pairwise", action="store_true")
    parser.add_argument("--cross_encoder", action="store_true")
    parser.add_argument("--distil_kl", action="store_true")
    parser.add_argument("--distil_mse", action="store_true")
    parser.add_argument("--in_batch_negatives", action="store_true")
    parser.add_argument("--qrels_path", type=Path, default=None)
    parser.add_argument("--eval_every", type=int, default=500)
    parser.add_argument("--no_beir_eval", action="store_true")
    parser.add_argument("--eval_datasets", type=str, default=None,
                        help="comma list of NanoBEIR dataset names to evaluate "
                        "in training (default: every BEIR-format directory "
                        "under --nano_beir_dir).  Each eval stalls training "
                        "for the whole set; its seconds go to metrics.txt as "
                        "eval_stall_seconds.  Under data parallelism rank 0 "
                        "evaluates while the other ranks wait at their next "
                        "all-reduce: a stall past the process group's timeout "
                        "(NCCL's default: 10 minutes) ends the run, so keep "
                        "the set small enough")
    parser.add_argument("--nano_beir_dir", type=Path, default=None,
                        help="BEIR-format datasets for the in-training eval "
                        "(<dir>/<dataset>/{corpus,queries}.jsonl, qrels.tsv)")
    parser.add_argument("--epochs", type=int, default=1)
    parser.add_argument("--total_steps", type=int, default=None)
    parser.add_argument("--use_wandb", action="store_true")
    parser.add_argument("--enable_profiler", action="store_true",
                        help="torch.profiler chrome trace under <checkpoint_dir>/profile")
    parser.add_argument("--pack", action="store_true",
                        help="force sequence-packed training batches "
                        "(train/packed.py): several short documents per "
                        "[max_length] row, same loss/gradients to fp "
                        "tolerance; pairwise_ce/distil only.  DEFAULT for "
                        "those losses: the flag only matters to assert")
    parser.add_argument("--no_pack", action="store_true",
                        help="disable sequence packing (row per document, "
                        "the reference layout)")
    args = parser.parse_args(argv)

    if args.distil_mse and args.distil_kl:
        parser.error("cannot use both distillation losses")
    if args.distil_mse and not args.qrels_path:
        parser.error("qrels_path is required for margin-MSE distillation")
    if sum([args.xlmr, args.pairwise, args.cross_encoder]) > 1:
        parser.error("only one of --xlmr/--pairwise/--cross_encoder")
    if args.xlmr:
        args.model_kind = "xlmr"
    elif args.pairwise:
        args.model_kind = "pairwise"
    elif args.cross_encoder:
        args.model_kind = "cross_encoder"

    if args.distil_kl:
        loss = "distil_kl"
    elif args.distil_mse:
        loss = "distil_mse"
    elif args.in_batch_negatives:
        loss = "in_batch_negatives"
    elif args.cross_encoder:
        loss = "cross_encoder"
    elif args.pairwise:
        loss = "pairwise_impact"
    else:
        loss = "pairwise_ce"

    if args.pack:
        if args.no_pack:
            parser.error("--pack and --no_pack conflict")
        if loss not in PACKABLE_LOSSES:
            parser.error(
                f"--pack supports {PACKABLE_LOSSES} (per-document masks); "
                f"{loss} scores documents under many query masks: train unpacked"
            )

    started = not dist.is_initialized()
    rank, world = initialize_distributed()
    try:
        return _train(args, loss, rank, world)
    finally:
        if started and dist.is_initialized():
            dist.destroy_process_group()


def _train(args, loss: str, rank: int, world: int) -> int:
    model = build_model(args)
    max_length = args.max_length or model.max_length

    if loss in ("distil_kl", "distil_mse"):
        dataset = DistillationScores(
            args.dataset_path,
            args.queries_path,
            args.collection_path,
            qrels_path=args.qrels_path if args.distil_mse else None,
        )
    else:
        dataset = MSMarcoTriples(args.dataset_path, args.queries_path, args.collection_path)

    # each rank collates the global batch and keeps its query groups; packing
    # (the default wherever it applies) then packs those groups only
    collate = rank_collate(
        partial(COLLATES[loss], tokenizer=model.tokenizer, max_length=max_length), rank, world
    )
    if (args.pack or loss in PACKABLE_LOSSES) and not args.no_pack:
        collate = packing_collate(collate)
    loader = BatchLoader(
        dataset, args.batch_size, collate, shuffle=True, seed=args.seed, drop_last=True
    )

    config = TrainConfig(
        batch_size=args.batch_size,
        lr=args.lr,
        seed=args.seed,
        max_length=max_length,
        grad_accumulation_steps=args.gradient_accumulation_steps,
        save_every=args.save_every,
        save_best=args.save_best,
        eval_every=args.eval_every,
        loss=loss,
    )
    from ..core.metrics_log import MetricsLogger
    from ..core.profiling import trace

    metrics_logger = evaluator = None
    if rank == 0:
        if not args.no_beir_eval:
            from ..evaluation.nano_beir import NanoBEIREvaluator

            evaluator = NanoBEIREvaluator(
                batch_size=64,
                local_data_dir=args.nano_beir_dir,
                datasets=args.eval_datasets.split(",") if args.eval_datasets else None,
            )
        metrics_logger = MetricsLogger(
            args.checkpoint_dir, use_wandb=args.use_wandb, config=vars(args)
        )
    trainer = Trainer(model, config, args.checkpoint_dir, evaluator=evaluator,
                      metrics_logger=metrics_logger)

    with trace(args.checkpoint_dir / "profile", enabled=args.enable_profiler and rank == 0):
        done = trainer.maybe_resume()
        steps_per_epoch = len(loader)
        for epoch in range(args.epochs):
            if done >= steps_per_epoch:
                done -= steps_per_epoch  # epoch fully seen before resume
                continue
            # closing() stops the loader's producer when --total_steps ends
            # the epoch early
            with closing(loader.epoch(epoch)) as batches:
                avg = trainer.train(batches, total_steps=args.total_steps, skip=done)
            done = 0
            if rank == 0:
                print(f"epoch {epoch}: avg loss {avg:.5f}")
    if metrics_logger is not None:
        metrics_logger.finish()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
