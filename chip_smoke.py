#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port: the query path at MS MARCO passage
scale, every query engine on the same index, the encode path, training,
the in-memory eval and the rerankers at BERT-base width, then the index
lifecycle: the binary impact store at BERT-base, the index algebra and the
serving daemons (shard router, staged hot swap) on the MS MARCO-scale index,
then the multi-device paths (doc-sharded engine, data-parallel encode)
with one card standing in for several, the host-side remainder: data-prep
scripts, async snapshots, a JAX-format checkpoint through the encode and
query paths, term-pair attention and the gated tokenizer routes,
expansion at Llama-2-7B width: the flash-attention kernels, generation,
the QLoRA fine-tune and the expansion CLIs, and last expansion's T5/mT5
route at mT5-base width and the precomputed-expansion tools.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without

Phases, in order; any failed check raises and the script exits non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.
2. Build: the six CUDA kernels (``gather_rows``, ``scatter_scores``,
   ``short_attention``, ``count_ge``, ``blocked_scoring``,
   ``flash_attention``) from ``csrc/``,
   one ``nvcc`` per source, started together, and the native C++ engine
   (``g++``).
3. Query set-up, then the query kernels against their plain versions: a
   synthetic index at MS MARCO passage geometry is generated on the card
   from a seed (8.8M docs, 30k-term Zipf vocabulary, ~388M postings,
   impacts 1..255, each list impact-descending as ``cli.invert`` writes
   it), saved with the port's ``save``, and loaded into an
   engine through ``build_engine``.  Each kernel runs on the inputs the
   first 64-query batch gives it and must equal its plain PyTorch version
   exactly: ``gather_rows`` and ``scatter_scores`` on the batch's stages
   (the gather's entry on the staged pair table, which the engines call,
   and its JAX-signature entry on the same pairs; the scatter's chunk-table
   entry, which the engines call, and its flat entry, whose time the row
   gives, with the tail stage's time by route),
   ``count_ge`` on the batch's score matrix with its first-pass thresholds,
   and the blocked kernel on the batch's tables in a ``PallasBlockedEngine``
   over the same index.  Kernel, plain and library-call times (CUDA events)
   are printed beside the least time the card could take.
4. Query main path: ``cli.rank.main`` ranks every query (k=1000) on the
   card, with the kernels' launch counts set to 0 just before and read just
   after (``gather_rows``, ``scatter_scores`` and ``count_ge`` must have
   launched).  Every query has one planted relevant doc holding all its
   terms at impact 255, so MRR@10 must be ~1; four sampled queries must
   match an independent numpy scorer rank by rank; ``score_stream``
   (depth 2) over 64-query batches must reproduce the run file and gives
   the pipelined q/s and a profile.
5. The other engines on the same index: ``cli.rank --engine host`` (four
   processes of 16 queries each), ``--engine native`` (one process), both
   alongside the card work, and ``--engine device`` over the first 64
   queries must write the hybrid run file's rows for them byte for byte; ``PallasBlockedEngine.score_batch``
   over two 64-query batches must return the hybrid rows rank by rank, with
   its counts set to 0 just before (the blocked kernel and ``count_ge`` must
   have launched), and gives its q/s.
6. Encode set-up, then ``short_attention`` against its plain version: a
   seeded synthetic corpus of 32,768 passages (Zipf words from a generated
   word list, ~60 words a passage, some past 256 tokens) and its
   ``vocab.txt`` from ``cli.build_vocab``.  The kernel runs at B=512, H=12,
   S=256, D=64 bf16 on seeded inputs, once with the padding mask of the
   first real batch and once with the packed segment ids of the corpus's
   first ``SequencePacker`` batch, and must agree within two bf16 ulps of
   the largest output.
7. Encode main path: ``cli.index`` (BERT-base, seeded random init,
   ``--max_length 256 --model_batch_size 512``) -> ``cli.quantize`` ->
   ``cli.invert`` -> ``cli.rank``, with the launch counts set to 0 just
   before ``cli.index`` and read just after: ``short_attention`` must have
   launched 12 times per batch.  Checks: on 512 passages the kernel route
   equals ``use_kernels=False`` (term lists identical, impacts within a
   stated tolerance) and the CLI's forward index; the inverted index equals
   a numpy inversion of the quantized file; four ranked queries equal the
   numpy scorer rank by rank, and ``DenseSearchEngine`` over the same index
   returns the same rows; ``cli.index --pack`` gives the same term lists
   with impacts within that tolerance.  Steady-state encode docs/s
   (unpacked and packed) and a profiler window over 4 encode batches.

8. Training: BERT-base at S=256 on phase 7's seeded checkpoint and phase
   6's corpus and vocabulary, with seeded triples (each query 3-4 words of
   its positive passage, the negative another passage; 16 steps' worth of
   128 query groups).  Check 1: on one packed batch the kernel route's loss
   is within 1% of ``use_kernels=False``'s, the global gradient norm within
   2%, the gradients' cosine >= 0.99; a profiler window of 2 steps gives the
   device time by kernel kind and by region (forward and loss, the
   attention backward's recompute, the clipped AdamW step).  Check 2:
   ``cli.train`` (packed, its default) for 12 steps with launch counts set
   to 0 just before and read just after: ``short_attention`` must have
   launched 12 x 12 times (the backward launches none); every logged loss
   finite; snapshots at steps 6 and 12, latest and final, with their step.
   Check 3: ``cli.train --no_pack`` for 4 steps.  Steady steps/s and docs/s
   (the first 2 steps and the steps that wrote checkpoints left out) and
   peak memory for both.  Check 4:
   ``cli.index --checkpoint <final>`` over 512 passages writes the forward
   index the trained model gives in process: identical term lists and
   impacts.
9. In-memory eval: two seeded BEIR-format datasets from phase 6's
   generator, ``nano`` (5,000 passages, NanoBEIR's scale) and ``large``
   (131,072, past ``SparseSearch``'s 100,000-doc switch to the hybrid
   engine's float mode), 50 queries each (3-4 words of one passage, that
   passage the one qrel).  Main path: ``cli.nano_beir`` on phase 8's final
   checkpoint at S=256, 512 documents an encode call, launch counts set to 0
   just before and read just after: ``short_attention`` (12 a packed batch)
   and ``scatter_scores`` on both datasets, ``gather_rows`` (its fp32
   instance) on ``large``.  Checks: each dataset's metrics equal
   ``trec_evaluate`` over an independent numpy fp64 scorer's runs of the
   impacts the CLI encoded (scores within 1e-5 relative; doc order exact
   but where two scores lie within 2e-5, a near-tie, counted; a relevant
   doc may move only by such a near-tie); on ``large`` the CLI's hybrid
   engine holds fp32 rows, its ``gather_rows`` and ``scatter_scores`` equal
   their plain versions on the first query batch within 4 x 2^-23 of each
   cell's sum of absolute values (times printed beside their bounds), 20
   heavy-stage calls under the profiler run nothing on the card but the
   table's upload and the gather kernel, and its rows equal
   ``DeviceSearchEngine``'s; ``short_attention`` at the
   eval's packed shape within two bf16 ulps.  Then ``cli.train`` at phase
   8's set-up for 8 steps with ``--eval_every 4 --eval_datasets nano``:
   records at iterations 0 and 4 with their stall, ``short_attention``
   launched 12 x 8 times for training plus 12 a packed eval batch.
10. Rerankers, at BERT-base width and S=256, in phase 6's work directory.
   Data: phase 9's ``nano`` dataset as TSV files and a first-stage run of
   its 50 queries x 100 candidates (each query's qrel passage and 99 seeded
   others, in seeded order), also written as a top-k file.  Launch counts
   are set to 0 just before each CLI and read just after.  (1)
   ``cli.rerank`` on phase 8's final checkpoint, 128 passages an encode
   batch: 50 queries written, ``short_attention`` launched 12 times an
   encode batch; every score within 1e-5 relative of the fp64 sum of the
   impacts the CLI encoded, in their stable descending order but for
   near-ties (counted); an in-process ``ReRanker`` with ``use_kernels=False``
   on the same checkpoint encodes the same terms with impacts within phase
   7's tolerance, and its run holds the CLI's scores within what those
   impacts add up to, the order exact but for near-ties (counted); MRR@10
   of the candidates and of the reranked run, and the candidates' recall
   as a top-k file.  (2) The cross-encoder, from phase 7's seeded trunk:
   on one batch of 32 query groups (64 rows of 256) the kernel route
   against the plain route with phase 8's rules, then ``cli.train
   --cross_encoder`` for 4 unpacked steps: ``short_attention`` launched 12
   x 4 times (the backward launches none), every logged loss finite,
   ``DeepImpactCrossEncoder_final.pt`` written.  (3)
   ``cli.cross_encoder_rerank`` on that snapshot over 20 queries x 100
   candidates, 32 a batch: ``short_attention`` launched 12 times a batch
   (4 batches a query), scores within phase 7's tolerance of the plain
   route's (relative to the largest score), the order exact but for
   near-ties (counted); the exact zeros counted.  (4) Pairwise, phase 7's
   trunk with a seeded pair head: ``cli.train --pairwise`` for 2 unpacked
   steps of 4 query groups (losses, peak memory), and the ``Indexer``'s
   pairwise route over 256 passages: neither launches ``short_attention``
   (the attention maps take the plain route, as in the JAX package), the
   forward index holds composite ``a|b`` terms, and the single-term impacts
   are within phase 7's tolerance of ``DeepImpact``'s kernel route on the
   same trunk.  Each part prints its wall seconds and a rate (pairs/s,
   docs/s) and each training CLI its peak memory.

11. The store route, in phase 6's work directory (its 32,768 passages,
   phase 7's seeded BERT-base checkpoint, S=256, B=512).  ``cli.index
   --output_file_path F --store_path S`` with the launch counts set to 0
   just before and read just after (``short_attention`` 12 a batch); F has
   phase 7's term lists, impacts within phase 7's tolerance (byte-equal
   lines counted).  ``cli.quantize -i S --text_out`` and ``cli.invert`` on
   the store against ``cli.quantize`` and ``cli.invert`` on F: the
   quantized texts and the three index files byte-equal, each route's
   seconds printed.  Crash and resume: copies of S (its three ``.bin``
   files cut mid-record at a seeded document past the middle, no
   ``meta.json``) and of F (cut mid-line at another) resume through
   ``cli.index --resume`` at the smaller survivor R, launching
   ``short_attention`` 12 x ceil((32,768 - R) / 512) times; both outputs
   then have the uninterrupted run's term lists, the first R documents
   byte-equal, the rest within the tolerance.
12. The index lifecycle on phase 3's index.  ``cli.split_index --n_shards
   4`` (``shards.json``: path, num_docs, doc_offset); ``cli.merge_indexes``
   over the shards, with the manifest's ``--num_docs``, gives phase 3's
   three index files byte for byte; ``cli.filter_index`` deletes the
   planted docs of the first 64 queries and a seeded 1% of the docs, and
   ``cli.rank`` over the result writes, for every query, phase 4's rows
   less the deleted docs first (5 queries equal to the numpy scorer, no
   planted doc of the 64 returns).  The shard tier as deployed: four
   ``cli.serve`` processes on the card, one per shard, and a ``cli.serve
   --shards`` router; 8 client connections send phase 4's 512 query texts
   as single k=1000 requests, and every answer equals phase 4's run file
   rank by rank; q/s, p50/p99 latency, each shard's batches and each
   daemon's card memory (nvidia-smi) printed; ``{"op": "shutdown"}``
   stops each process with exit code 0.  One card stands in for four hosts
   here.  ``gather_rows``, ``scatter_scores`` and ``count_ge`` are then
   held against their plain versions (exactly) on a served batch of 8 at
   a shard daemon's shape (shard 0's engine built in this process as
   ``cli.serve`` builds it).  Then one ``RetrievalServer`` in process over phase 3's index on
   the card, launch counts set to 0 after its warmup: the same 512 queries
   streamed, a ``swap_engine_staged`` to the filtered index after 256
   answers; every query answered once, without error, with phase 4's or the
   filtered rows (counted), then the first 64 again with the filtered rows;
   ``torch.cuda.max_memory_allocated`` across the swap within the larger of
   the first build's peak and the serving peak; ``gather_rows``,
   ``scatter_scores`` and ``count_ge`` must have launched, and equal their
   plain versions on a served batch of 8 on the server's engine after the
   swap.  The rate before the swap began and after it returned printed
   apart.  Every step's seconds printed.
13. Multi-device on one card, after phase 12 has released its engines.
   ``ShardedSearchEngine`` over ``["cuda:0"] * 4`` (the one-card stand-in
   for four cards) on phase 3's index through ``InvertedIndexData.load``:
   load, split and build seconds, ``shard_docs``, ``t_heavy`` and card
   memory (torch's counters).  Launch counts set to 0 just before
   ``score_stream`` (depth 2) scores phase 4's 512 queries (k=1000,
   64-query batches) and read just after: every answer equals phase 4's
   run file rank by rank, ``gather_rows`` and ``scatter_scores`` launch
   once a shard a batch, ``count_ge`` for each shard's search passes; its
   q/s beside phase 4's and its peak memory.  The three query kernels
   against their plain versions (exactly) on the first batch's inputs to
   shard 0, at a shard's shape [64, 2,228,224].  Then the data-parallel
   encode: phase 6's corpus again from its seed, BERT-base from phase 7's
   seeded trunk at S=256, ``Indexer`` over 4 batches of 512 passages
   (unpacked) and their packed rows, through ``DeepImpact(devices=
   ["cuda:0"] * 2)`` against the single-device route on the same weights:
   identical term lists, impacts within phase 7's rule, ``short_attention``
   12 launches a part; docs/s of both routes.  Last
   ``parallel.dryrun_multidevice(["cuda:0"] * 2)``.
14. The host-side remainder and JAX checkpoints, in phase 6's work
   directory (its 32,768 passages and vocabulary, phase 7's seeded trunk;
   BERT-base, S=256, B=512).  (1) The port's data-prep scripts through
   their ``main``s on seeded queries, qrels, mined negatives, duplicates
   and expansions: ``prepare_dataset``, ``create_unique_passage_mapping``,
   ``construct_hard_neg_dataset``, ``create_training_files``,
   ``create_passages``, ``preprocess_passages``; each output equal to a
   plain recount of its inputs (rows, dropped duplicates, the token budget,
   windows, kept terms) and a second run's bytes.  (2) A ``Trainer`` at
   phase 8's geometry on the prepared triples, 8 packed steps, with
   ``AsyncCheckpointManager`` (a snapshot every 2 steps) in place of its
   manager: ``short_attention`` 12 launches a step; every snapshot reloads
   equal to the state at its ``on_step``; then the synchronous manager in
   a second run, handed the first run's states and metrics at the same
   calls, writes the same stems and ``.meta.json``; each step's seconds
   under both.  (3) The final params written as a flax msgpack (the JAX
   ``CheckpointManager``'s payload, through ``port_params_to_flax``) and
   read back equal; ``cli.index --checkpoint`` on it (768 launches, text
   and store outputs) and on the ``.pt``: byte-equal forward indexes, then
   ``cli.quantize``, ``cli.invert`` and ``cli.rank`` (``gather_rows``,
   ``scatter_scores`` and ``count_ge`` must launch) with byte-equal
   indexes and runs; ``cli.convert_to_anserini`` on the text and the store
   gives 32,768 equal JSONL lines.  (4) ``extract_term_pair_attention``
   over 64 passages: every pair the max of both directions of the
   ``output_attentions`` maps, in [0, 1], no ``short_attention`` launch.
   (5) The optional tokenizer routes: ``cli.index --segmenter vncorenlp``
   (and ``--hf_tokenizer`` where ``transformers`` is missing), in a
   process of its own, exits non-zero with an ``ImportError`` naming the
   package; where ``transformers`` is installed, ``cli.index
   --hf_tokenizer`` (a BERT tokenizer directory of phase 6's vocabulary)
   over 2,048 passages encodes each as the WordPiece route does and writes
   the ``--vocab_path`` route's forward index byte for byte.
15. Expansion, in phase 6's work directory.  (1) ``flash_attention``'s
   forward and its backward (the di pre-pass and the dk/dv/dq kernel)
   against the twin (each output within 1% of its largest entry, the
   log-sum-exp within 1e-4) at the 7B fine-tune's [1, 32, 2048, 128]
   causal with a padded tail and the encoder's [64, 12, 512, 64] with
   packed segments; kernel, twin and SDPA (timed only) milliseconds beside
   the bound; the tile pairs the kernels computed, by their own count, equal
   to the tile rule's, and their share.  (2)
   BERT-base with ``use_flash_attention`` at S=512 (phase 7's trunk) through
   ``DeepImpact.get_impact_scores_batch`` over 64 passages: 12 forward
   launches, impacts within phase 7's rule of ``use_kernels=False``.  (3)
   Llama-2-7B (``LlamaConfig.llama2_7b``, seeded bf16 weights made on the
   card) with a word tokenizer of phase 6's 31,996 most frequent words:
   ``QueryGenerator`` at the JAX CLI's defaults (80 sequences, 50 new
   tokens, top-k 50, top-p 0.95, prompts within 350 tokens) for 2 passages
   with bf16, int8 and int4 weights and an int8 cache: tokens in range,
   sequences/s, tokens/s, peak memory; greedy decoding in fp32 at full
   depth, each token of the cache route the argmax of one cache-less
   forward over the prompts and the chosen tokens (a near-tie within 1e-3);
   a decode step's parts (a layer, a layer's int8/int4 dequantization, the
   head).  (4) The 7B QLoRA fine-tune
   (``FINETUNE_7B.json``'s int8 recipe: int8 base, r=16, S=2048, B=1,
   layerwise, flash attention, batches padded to 2048 as the JAX bench
   pads): the kernel route's loss within 0.5% and adapter gradients'
   cosine >= 0.99 of the twin route's; 3 steps with the counts set to 0
   before each and read after it (>= 32 forward, 32 backward pre-pass and
   32 backward launches a step; checkpointing recomputes each forward
   once); step s, tokens/s, peak memory, the step split (forward, backward, the rest), a
   profiled step; one ``trl_4bit`` step.  (5) The
   CLIs at 7B width, depth 2: a seeded local HF Llama directory (word-level
   tokenizer) -> ``cli.finetune --llama_path --quantize_base int8`` (4
   steps; the plain attention, as the JAX CLI's HF route) ->
   ``--output_adapter`` and ``--output_merged`` -> ``cli.expand
   --local_path`` (the same weights as a local generator) ``--peft_path``
   over 256 passages (10 sequences each) -> ``cli.merge`` (each passage
   keeps its text) -> ``cli.index`` (phase 7's trunk) -> ``cli.quantize``
   -> ``cli.invert`` -> ``cli.rank`` (64 queries of 4 words of a passage).
16. The T5/mT5 route, in phase 6's work directory, at mT5-base width
   (``T5Config.mt5_base``: 12 + 12 layers, d_model 768, 12 heads of 64,
   gated-GELU d_ff 2048, vocabulary 250,112, an untied fp32 head; seeded
   fp32 weights made on the card) with a T5-style word tokenizer of phase
   15's 31,996 words.  The T5 route reaches no kernel: the counts of the
   six are set to 0 when the phase starts and must read 0 at its end.  (1)
   ``T5QueryGenerator`` at the JAX CLI's defaults (80 sequences, 50 new
   tokens, top-k 50, top-p 0.95, documents within 350 tokens) for 2
   batches of 4 passages (320 decoder rows) with the fp32 tree and its int8
   and int4 quantizations: tokens in range, nothing but EOS after a row's
   first EOS; sequences/s, tokens/s, a loop step's ms, peak memory (torch's
   counters); the encoder's ms and a decode step's parts (the forward, the
   fp32 head, the top-k/top-p filter and one of its full sorts of [320,
   250112], the draw).  (2) Greedy in fp32 at full depth: 8 cached steps
   over 4 passages, each token the argmax of one teacher-forced forward
   over the same tokens (a near-tie within 1e-3).  (3) A 2-layer cut at
   the same width, card against CPU: the model's position-bias tables
   equal (built on the host; the card's own ``log`` buckets over [-4096,
   4096] are printed), teacher-forced logits within 1e-3 in fp32 and 5% of
   the largest in bf16.  (4) ``cli.expand --t5`` on a seeded local HF
   ``T5ForConditionalGeneration`` directory of mT5-base's shape (a
   word-level fast tokenizer) over 32 passages: ``--greedy`` (10
   sequences a passage) writes what the in-process ``T5QueryGenerator``
   writes from the same directory, byte for byte; ``--int8`` (sampled at
   the defaults) a row of 80 queries a passage.  (5)
   ``cli.expand_precomputed`` over a seeded store of 4,096 passages x 80
   scored queries, ``--threshold 0.7`` (a fraction) and ``--style tilde``:
   every line equal to a reference written here (the numpy percentile, the
   novel terms compared as sets, TILDE's in order).

The second-to-last line is the ``kernels`` JSON object (six rows; each
row's launches sum its ``launches_by_path``: ``short_attention`` over
``cli.index``, ``cli.train``, ``cli.nano_beir``, ``cli.train`` with eval,
``cli.rerank``, ``cli.train --cross_encoder``, ``cli.cross_encoder_rerank``,
the pairwise routes (0), ``cli.index --store_path`` and its resume;
``gather_rows`` over ``cli.rank``, ``cli.nano_beir``'s fp32 rows and the
in-process ``RetrievalServer``; ``scatter_scores`` and ``count_ge`` over
their paths and that server too; the shard daemons' launches happen in
processes of their own and are not counted; phase 13's sharded engine and
data-parallel encode add a path each, phase 14 its trainer, its
``cli.index`` routes, its term pairs (0) and its ``cli.rank``; row 6,
``flash_attention``, counts forward and backward launches over phase 15's
7B fine-tune steps and the S=512 encode, and the 7B
generation, which runs the cache route and launches none), the last line ``{"ok": true,
"device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import queue
import shutil
import socket
import subprocess
import sys
import threading
import time
from itertools import islice
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# The configuration: MS MARCO passage geometry (benchmarks/INDEX_BUILD_8M8.json),
# 8 batches of 64 queries of 8 Zipf terms, the CLI's default 4 GB dense budget.
SMOKE = SimpleNamespace(
    docs=8_800_000, terms=30_000, postings=387_717_182, batches=8, nq=64,
    query_terms=8, dense_budget_gb=4.0, seed=0, device="cuda",
    workdir=REPO / "build" / "chip_smoke",
)
# The encode configuration: BERT-base (EncoderConfig.bert_base) at the JAX
# package's encode geometry (bench.py: B=512, S=256) over a synthetic corpus
# of MS MARCO passage shape (~60 words a passage).
ENCODE = SimpleNamespace(
    passages=32_768, words=50_000, mean_words=60, max_length=256, batch=512,
    check_docs=512, profile_batches=4, rank_queries=4, query_terms=4, seed=0,
    device="cuda", workdir=REPO / "build" / "chip_smoke_encode",
)
# The training configuration: BERT-base at S=256 over phase 6's corpus,
# vocabulary and seeded checkpoint, 128 query groups (256 documents) a step,
# the JAX package's realistic training geometry (benchmarks/train_bench.py
# --realistic --batch 128); triples for 16 such steps.
TRAIN = SimpleNamespace(
    groups=128, triples=16 * 128, steps=12, save_every=6, unpacked_steps=4,
    index_docs=512, profile_steps=2, seed=0, device="cuda",
)
# The eval configuration: NanoBEIR's scale (NanoMSMARCO: ~5k docs, 50
# queries) and a corpus past SparseSearch's 100,000-doc engine switch, from
# the phase 6 generator; BERT-base at S=256 on phase 8's final checkpoint,
# cli.nano_beir's packed encode at 512 docs a call; the in-training eval at
# phase 8's set-up.
EVAL = SimpleNamespace(
    nano_docs=5_000, large_docs=131_072, queries=50, batch=512, train_steps=8, eval_every=4,
    seed=1, device="cuda",
)
# The rerank configuration: phase 9's nano dataset (5,000 passages, 50
# queries) as a first-stage run of 100 candidates a query (the qrel passage
# and 99 seeded others) reranked by cli.rerank on phase 8's checkpoint, 128
# passages an encode batch (the CLI's default); a cross-encoder trained by
# cli.train from phase 7's seeded trunk at S=256, 32 query groups (64 rows) a
# step, reranking 20 of those queries at 32 candidates a batch (the CLI's
# default); the pairwise model on the same trunk with a seeded pair head.
RERANK = SimpleNamespace(
    candidates=100, batch=128, ce_groups=32, ce_steps=4, ce_queries=20, ce_batch=32,
    pw_groups=4, pw_steps=2, pw_index_docs=256, pw_batch=64, seed=2, device="cuda",
)
# The store route (phase 11): phase 6's corpus through phase 7's encode
# geometry, one seeded crash point per output.
STORE = SimpleNamespace(seed=4, device="cuda")
# The index lifecycle (phase 12) on phase 3's index: 4 doc-range shards (one
# daemon each, as cli.split_index deploys them), 1% of the docs plus the
# first 64 queries' planted docs deleted, 8 client connections of single
# k=1000 requests (phase 4's 512 query texts).
LIFECYCLE = SimpleNamespace(shards=4, delete_share=0.01, planted_deletes=64, clients=8, k=1000, seed=5,
                            device="cuda")
# Multi-device (phase 13) on one card: phase 3's index in 4 doc shards
# (ShardedSearchEngine over ["cuda:0"] * 4, the one-card stand-in for 4
# cards), phase 4's queries at k=1000; the data-parallel encode over 2
# replicas for 4 of phase 6's batches.
MULTI = SimpleNamespace(shards=4, replicas=2, encode_batches=4, k=1000, device="cuda:0")
# The host-side remainder (phase 14) in phase 6's work directory: 256 seeded
# queries of one relevant passage each and a first-stage run of 24 others,
# 512 duplicated pids, expansions for 4,096 passages (a 128-token budget, 16
# terms), MaxP windows of 64 words every 32, the 30 most frequent words as
# stopwords; 8 packed steps at phase 8's geometry with snapshots every 2
# steps (BERT-base: 1.3 GB each with AdamW's state); term pairs of 64
# passages; the HF tokenizer route over 2,048 passages.
REMAINDER = SimpleNamespace(queries=256, candidates=24, duplicates=512, expanded_docs=4096, token_budget=128,
                            expansion_terms=16, window=64, stride=32, stopwords=30, steps=8, save_every=2,
                            pair_docs=64, hf_docs=2048, seed=6, device="cuda")
# Expansion (phase 15): Llama-2-7B (LlamaConfig.llama2_7b, the published
# meta-llama/Llama-2-7b-hf config; seeded weights) with a word tokenizer of
# phase 6's 31,996 most frequent words (vocabulary 32,000); generation at the
# JAX CLI's defaults (80 return sequences, 50 new tokens, top-k 50, top-p
# 0.95, prompts within 350 tokens) for 2 passages a mode; the QLoRA
# fine-tune at FINETUNE_7B.json's int8 recipe (S=2048, B=1, r=16) for 3
# steps and one trl_4bit step; the CLI chain at 7B width and depth 2 over
# 256 passages, 10 queries a passage; BERT-base's flash route at S=512 over
# 64 passages (one batch).
EXPAND = SimpleNamespace(seq=2048, gen_passages=2, returns=80, new_tokens=50, top_k=50, top_p=0.95,
                         max_tokens=350, ft_steps=3, cli_depth=2, cli_passages=256, cli_pairs=64, cli_steps=4,
                         cli_returns=10, cli_batch=16, enc_docs=64, seed=7, device="cuda")
# The T5/mT5 route (phase 16): mT5-base (T5Config.mt5_base, the published
# google/mt5-base config, the base of doc2query/msmarco-vietnamese-mt5-base-v1;
# seeded fp32 weights) with a word tokenizer of phase 15's 31,996 words (the
# model keeps its 250,112-row vocabulary); generation at the JAX CLI's
# defaults (80 return sequences, 50 new tokens, top-k 50, top-p 0.95,
# documents within 350 tokens, batches of 4 passages: 320 decoder rows) for
# 2 batches a weight mode; 8 greedy steps over 4 passages; a 2-layer cut for
# card against CPU on 3 trees (bf16 within half of bf16's own gap from fp32);
# cli.expand --t5 over 32 passages (greedy with 10 sequences a passage, then
# --int8 at the defaults), its directory's logits against HF's own forward;
# cli.expand_precomputed over 4,096 passages x 80 scored queries.
T5 = SimpleNamespace(batches=2, batch_docs=4, returns=80, new_tokens=50, top_k=50, top_p=0.95, max_tokens=350,
                     greedy_docs=4, greedy_steps=8, cut_layers=2, cut_trees=3, cli_passages=32, cli_greedy_returns=10,
                     store_passages=4096, store_queries=80, seed=8, device="cuda")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM, fp32 outside the tensor cores
BF16_OPS_PER_S = 989e12    # H100 SXM, dense bf16 on the tensor cores
# scatter_scores's flat entry at phase 3's shape as this script measured it
# before the chunk entry existed (NVIDIA H100 80GB HBM3, 700 W).  Printed
# beside the row, not in it: the kernels line holds only this run's
# measurements.
SCATTER_EARLIER_MS = 0.4530


def log(msg: str) -> None:
    print(msg, flush=True)


# -- synthetic corpus ------------------------------------------------------------


def zipf_counts(n_terms: int, n_postings: int, max_len: int) -> np.ndarray:
    """Per-term posting counts under Zipf(1), each capped at ``max_len`` docs,
    scaled so they sum to about ``n_postings``."""
    w = 1.0 / np.arange(1, n_terms + 1)
    lo, hi = 0.0, float(n_postings) * 10
    for _ in range(100):
        s = (lo + hi) / 2
        if np.minimum(s * w, max_len).sum() < n_postings:
            lo = s
        else:
            hi = s
    return np.maximum(np.floor(np.minimum(s * w, max_len)), 1).astype(np.int64)


def make_corpus(num_docs, n_terms, n_postings, n_queries, query_terms, seed, device):
    """Synthetic quantized index + queries, generated on ``device``.

    Term t samples ``c_t`` distinct docs from the first ``num_docs -
    n_queries`` docs, one uniform doc in each of c_t equal strata (so lists
    come out doc-ascending).  Queries draw ``query_terms`` distinct Zipf
    terms; query i's planted doc ``num_docs - n_queries + i`` holds each of
    its terms at impact 255.  Each list is then sorted stably by impact
    descending: the order ``cli.invert`` and the index algebra write (doc
    ascending among equal impacts), so phase 12's split and merge can be
    held to these bytes.  Returns host arrays (offsets, doc_ids uint32,
    impacts uint8), the queries as term-id lists, and each query's planted
    doc."""
    n_sampled = num_docs - n_queries
    c = zipf_counts(n_terms, n_postings, n_sampled)
    p = 1.0 / np.arange(1, n_terms + 1)
    qrng = np.random.default_rng(seed + 1)
    queries = [
        qrng.choice(n_terms, size=query_terms, replace=False, p=p / p.sum()).tolist()
        for _ in range(n_queries)
    ]
    planted = n_sampled + np.arange(n_queries)
    pl_t = np.array([t for q in queries for t in q], np.int64)
    pl_d = np.repeat(planted, query_terms)
    order = np.lexsort((pl_d, pl_t))
    pl_t, pl_d = pl_t[order], pl_d[order]
    pl_count = np.bincount(pl_t, minlength=n_terms)
    pl_off = np.zeros(n_terms + 1, np.int64)
    np.cumsum(pl_count, out=pl_off[1:])
    n_t = c + pl_count
    offsets = np.zeros(n_terms + 1, np.int64)
    np.cumsum(n_t, out=offsets[1:])
    total = int(offsets[-1])

    g = torch.Generator(device=device)
    g.manual_seed(seed)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    term_of = torch.repeat_interleave(
        torch.arange(n_terms, device=device), to(n_t), output_size=total
    )
    i = torch.arange(total, device=device) - to(offsets[:-1])[term_of]
    ct = to(c)[term_of]
    sampled = i < ct
    b0 = (i * n_sampled) // ct
    gap = ((i + 1) * n_sampled) // ct - b0
    u = torch.rand(total, generator=g, device=device, dtype=torch.float64)
    doc = b0 + torch.minimum((u * gap).long(), gap - 1)
    del u, b0, gap
    pl_idx = (to(pl_off[:-1])[term_of] + i - ct).clamp(0, max(len(pl_d) - 1, 0))
    doc = torch.where(sampled, doc, to(pl_d)[pl_idx])
    vals = torch.randint(1, 256, (total,), generator=g, device=device, dtype=torch.uint8)
    vals = torch.where(sampled, vals, torch.full_like(vals, 255))
    del i, ct, pl_idx, sampled
    order = torch.sort(term_of * 256 + (255 - vals.long()), stable=True).indices
    del term_of
    doc, vals = doc[order], vals[order]
    del order
    docs = doc.to(torch.int32).cpu().numpy().view(np.uint32)
    return offsets, docs, vals.cpu().numpy(), queries, planted


def write_inputs(workdir: Path, offsets, docs, vals, num_docs, queries, planted):
    """Save the index with the port's ``save`` and write vocab, queries and
    qrels files; returns (index dir, vocab, queries, qrels) paths."""
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.text.wordpiece import SPECIAL_TOKENS

    terms = [f"t{i:05d}" for i in range(len(offsets) - 1)]
    index_dir = workdir / "index"
    InvertedIndexData(terms, offsets, docs, vals, num_docs=num_docs).save(index_dir)
    vocab = workdir / "vocab.txt"
    vocab.write_text("\n".join(SPECIAL_TOKENS + terms) + "\n", encoding="utf-8")
    qpath, qrels = workdir / "queries.tsv", workdir / "qrels.tsv"
    qpath.write_text(
        "".join(f"{qi}\t{' '.join(terms[t] for t in q)}\n" for qi, q in enumerate(queries)),
        encoding="utf-8",
    )
    qrels.write_text(
        "".join(f"{qi}\t0\t{int(d)}\t1\n" for qi, d in enumerate(planted)), encoding="utf-8"
    )
    return index_dir, vocab, qpath, qrels


def numpy_topk(offsets, docs, vals, num_docs, tids, k):
    """Independent scorer: np.add.at over the query's posting lists, stable
    order by score descending then doc id."""
    scores = np.zeros(num_docs, np.int64)
    for t in tids:
        s, e = offsets[t], offsets[t + 1]
        np.add.at(scores, docs[s:e].astype(np.int64), vals[s:e].astype(np.int64))
    order = np.lexsort((np.arange(num_docs), -scores))[:k]
    return [(str(int(d)), float(scores[d])) for d in order if scores[d] > 0]


# -- timing ------------------------------------------------------------------------


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(bytes_moved: float, ops: float, ops_per_s: float = FP32_OPS_PER_S) -> tuple:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / ops_per_s
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def ulps_apart(got, want, sum_abs) -> bool:
    """Two fp32 sums of the same few terms in different orders: every cell
    within 4 x 2^-23 of its sum of absolute values (at least 4 ulps)."""
    return bool(((got - want).abs() <= 4 * 2.0 ** -23 * sum_abs).all())


def gather_row(engine, heavy, nq):
    """Gather kernel against its plain version on one batch's staged pair
    table (the engines' route, ``accumulate_grouped``): equal on integer
    rows, within ``ulps_apart`` on float rows (the float mode's fp32
    instance).  The JAX-signature entry ``accumulate_rows`` on the same
    pairs (its table built on the card) must give the same scores; its time
    is the row's ``jax_signature_ms``."""
    from improving_learned_index_tpu_torch.ops import gather_rows as gr

    table, dense, exact = heavy, engine.dense, engine.integer_scores
    out_k = gr.accumulate_grouped(dense, table, nq)
    out_p = gr.accumulate_grouped_plain(dense, table, nq)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not (torch.equal(out_k, out_p) if exact else
            ulps_apart(out_k, out_p, gr.accumulate_grouped_plain(dense.abs(), table, nq))):
        raise AssertionError(f"gather_rows kernel != plain (max abs err {err})")
    # the same pairs in the JAX layout (ids, pairs, counts)
    host = table.cpu().numpy()
    n_hit = int(host[0])
    qptr, hits = host[1 : nq + 2], host[nq + 2 : nq + 2 + n_hit]
    slots = host[nq + 2 + n_hit : nq + 2 + n_hit + qptr[-1]]
    n_pairs = len(slots)
    q_of = np.repeat(np.arange(nq), np.diff(qptr))
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).to(dense.device)  # noqa: E731
    ids, pairs, counts = to(hits), to(np.stack([q_of, slots], 1)), to([n_hit, n_pairs])
    if not torch.equal(gr.accumulate_rows(dense, ids, pairs, counts, nq), out_k):
        raise AssertionError("gather_rows: accumulate_rows != accumulate_grouped on the same pairs")
    del out_k
    t_heavy, n_pad = dense.shape
    # the same function as one library call: one-hot [nq, t_heavy] times the
    # whole dense matrix, bf16 operands and an fp32 result (torch.mm's
    # out_dtype, CUDA only, where this torch version has it)
    w = torch.zeros(nq, t_heavy, dtype=torch.float32, device=dense.device)
    w.index_put_((to(q_of).long(), to(hits[slots]).long()),
                 torch.ones(n_pairs, dtype=torch.float32, device=dense.device), accumulate=True)
    w = w.to(dense.dtype)
    if dense.dtype == torch.float32:
        library = lambda: torch.mm(w, dense)  # noqa: E731
        library_equal = torch.equal(library(), out_p)
    else:
        try:
            library_equal = torch.equal(torch.mm(w, dense, out_dtype=torch.float32), out_p)
            library = lambda: torch.mm(w, dense, out_dtype=torch.float32)  # noqa: E731
        except (TypeError, RuntimeError, NotImplementedError) as exc:
            log(f"no single-call library yardstick for gather_rows: {exc!r:.200}")
            library, library_equal = None, None
    b, by = bound_ms(n_hit * n_pad * dense.element_size() + nq * n_pad * 4 + table.numel() * 4,
                     n_pairs * n_pad)
    row = {
        "name": "gather_rows",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/gather_rows.cu",
        "replaces": "improving_learned_index_tpu/ops/gather_rows.py:39",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: gr.accumulate_grouped(dense, table, nq)),
        "jax_signature_ms": cuda_ms(lambda: gr.accumulate_rows(dense, ids, pairs, counts, nq)),
        "upload_and_gather_ms": cuda_ms(lambda: gr.accumulate_grouped(dense, to(host), nq)),
        "plain_ms": cuda_ms(lambda: gr.accumulate_grouped_plain(dense, table, nq)),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": cuda_ms(library) if library else None,
        "shape": {"dense": [t_heavy, n_pad], "dtype": str(dense.dtype), "nq": nq,
                  "hit_rows": n_hit, "pairs": n_pairs, "library_equal": library_equal},
        "tolerance": "equal" if exact else "4 x 2^-23 x each cell's sum of |terms|",
    }
    return row, out_p


def scatter_row(engine, base, tail):
    """The scatter kernel's two entries against their plain versions on one
    batch's tail: the chunk table read in place (``apply_tail_chunks``, the
    engine's route) and the flat updates ``gather_updates`` makes of it
    (``apply_tail_updates``, the row's timed function), each applied to that
    batch's heavy-stage scores; returns the row and the batch's score
    matrix.  Equal on integer impacts; on float impacts (whose atomics add
    in another order than the plain version) within ``ulps_apart`` of each
    cell's sum of absolute values."""
    from improving_learned_index_tpu_torch.ops import scatter_scores as ss
    from improving_learned_index_tpu_torch.search.hybrid_engine import TAIL_CHUNK

    table = (engine.doc_ids, engine.impacts, *tail, TAIL_CHUNK)
    d, v, r = ss.gather_updates(*table)
    if engine.integer_scores:
        same = torch.equal
    else:
        sum_abs = ss.apply_tail_updates_plain(base.abs(), d, v.abs(), r)
        same = lambda a, b: ulps_apart(a, b, sum_abs)  # noqa: E731
    s_k = ss.apply_tail_updates(base.clone(), d, v, r)
    s_p = ss.apply_tail_updates_plain(base.clone(), d, v, r)
    torch.cuda.synchronize()
    err = float((s_k - s_p).abs().max())
    if not same(s_k, s_p):
        raise AssertionError(f"scatter_scores kernel != plain (max abs err {err})")
    del s_k
    c_k = ss.apply_tail_chunks(base.clone(), *table)
    c_p = ss.apply_tail_chunks_plain(base.clone(), *table)
    torch.cuda.synchronize()
    err_chunks = float((c_k - c_p).abs().max())
    if not (same(c_k, c_p) and same(c_p, s_p)):
        raise AssertionError(f"apply_tail_chunks kernel != plain (max abs err {err_chunks})")
    del c_k, c_p
    nq, n_pad = base.shape
    live = v != 0
    flat = (r.long() * n_pad + d.long())[live]
    cells = int(torch.unique(flat).numel())
    # The [nq, n_pad] fp32 matrix is ~45 times the 50 MB L2, so each touched
    # 32-byte sector (8 cells) is read from device memory and written back
    # once at least; the update arrays (d, v, r) are read once.
    sectors = int(torch.unique(flat // 8).numel())
    n_live = int(live.sum())
    del flat
    scratch = base.clone()
    r64, d64 = r.long(), d.long()
    b, by = bound_ms(d.numel() * 12 + sectors * 64, n_live)
    row = {
        "name": "scatter_scores",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/scatter_scores.cu",
        "replaces": "improving_learned_index_tpu/ops/scatter_scores.py:45",
        "max_abs_err": max(err, err_chunks),
        "ms": cuda_ms(lambda: ss.apply_tail_updates(scratch, d, v, r)),
        "plain_ms": cuda_ms(lambda: ss.apply_tail_updates_plain(scratch, d, v, r)),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": cuda_ms(lambda: scratch.index_put_((r64, d64), v, accumulate=True)),
        # the whole tail stage of the batch: the flat arrays materialized and
        # applied, against the chunk table read in place
        "tail_stage_ms": {
            "gather_then_flat": cuda_ms(lambda: ss.apply_tail_updates(scratch, *ss.gather_updates(*table))),
            "chunks": cuda_ms(lambda: ss.apply_tail_chunks(scratch, *table)),
        },
        "shape": {"scores": [nq, n_pad], "updates": d.numel(), "live_updates": n_live,
                  "chunks": int(tail[0].numel()), "touched_cells": cells, "touched_sectors": sectors},
        "tolerance": "equal" if engine.integer_scores else "4 x 2^-23 x each cell's sum of |terms|",
    }
    return row, s_p


def count_row(scores):
    """``count_ge`` against its plain version on one batch's score matrix
    with the thresholds of the top-k's first search pass."""
    from improving_learned_index_tpu_torch.ops.count_ge import count_ge, count_ge_plain
    from improving_learned_index_tpu_torch.ops.exact_topk import _ARITY

    q, n = scores.shape
    lo = torch.ones(q, 1, device=scores.device)
    hi = scores.amax(dim=1, keepdim=True).clamp_min(1.0)
    frac = torch.arange(1, _ARITY, device=scores.device, dtype=torch.float32) / _ARITY
    t = torch.minimum(lo + torch.ceil(frac[None, :] * (hi - lo + 1.0)), hi)
    got, want = count_ge(scores, t), count_ge_plain(scores, t)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"count_ge kernel != plain (max abs err {err})")
    b, by = bound_ms(q * n * 4 + t.numel() * 8, q * n * t.shape[1])
    return {
        "name": "count_ge",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/count_ge.cu",
        "replaces": "improving_learned_index_tpu/ops/count_ge.py:39",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: count_ge(scores, t)),
        "plain_ms": cuda_ms(lambda: count_ge_plain(scores, t)),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": None,
        "library_note": "no single PyTorch call counts several thresholds a row in one read; "
                        "the nearest, the plain version, is one compare-and-sum call per threshold",
        "shape": {"scores": [q, n], "thresholds": list(t.shape)},
    }


def flat_postings(args):
    """The postings the blocked kernel adds, as (linear score index int32,
    impact fp32) pairs: the library call's input."""
    from improving_learned_index_tpu_torch.ops.pallas_scoring import window_postings

    cell_offsets, starts, meta, docs, vals, _, nb = args
    m = meta[: int(cell_offsets[-1])]
    total = int(((m & 0x3FFF) - ((m >> 14) & 0x3FFF)).sum())
    lin = torch.empty(total, dtype=torch.int32, device=docs.device)
    val = torch.empty(total, dtype=torch.float32, device=docs.device)
    at = 0
    for lin_s, val_s in window_postings(cell_offsets, starts, meta, docs, vals, nb):
        lin[at : at + len(lin_s)], val[at : at + len(val_s)] = lin_s, val_s
        at += len(lin_s)
    if at != total:
        raise AssertionError(f"{at} window postings, {total} in the tables' ranges")
    return lin, val


def blocked_row(blocked, batch):
    """The blocked scoring kernel against its plain version on one batch's
    tables; the library yardstick is ``index_add_`` of the same postings
    (linear int32 indices: ``index_put_(accumulate=True)`` would sort ~1.2G
    int64 keys, tens of GB of scratch)."""
    from improving_learned_index_tpu_torch.ops import pallas_scoring as ps

    padded = list(batch) + [set()] * (-len(batch) % ps.QG)
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(blocked.device)  # noqa: E731
    args = (*(put(a) for a in blocked._tables(padded)[:3]), blocked.docs, blocked.vals,
            len(padded), blocked.num_blocks)
    got = ps.blocked_scores(*args)
    want = ps.blocked_scores_plain(*args)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    if not torch.equal(got, want):
        raise AssertionError(f"blocked_scoring kernel != plain (max abs err {err})")
    del want
    lin, val = flat_postings(args)
    lib_out = torch.zeros_like(got).view(-1)
    lib_out.index_add_(0, lin, val)
    library_equal = torch.equal(lib_out.view_as(got), got)
    del got
    cell_offsets, starts, meta, _, _, nq, nb = args
    b, by = bound_ms(val.numel() * 8 + (cell_offsets.numel() + 2 * starts.numel()) * 4
                     + nq * nb * ps.BLK * 4, val.numel())
    row = {
        "name": "blocked_scoring",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/blocked_scoring.cu",
        "replaces": "improving_learned_index_tpu/ops/pallas_scoring.py:55",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ps.blocked_scores(*args)),
        "plain_ms": cuda_ms(lambda: ps.blocked_scores_plain(*args), iters=2, warmup=1),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": cuda_ms(lambda: lib_out.index_add_(0, lin, val)),
        "library_call": "index_add_ (int32 linear index)",
        "shape": {"scores": [nq, nb * ps.BLK], "cells": cell_offsets.numel() - 1,
                  "chunks": int(cell_offsets[-1]), "postings": val.numel(),
                  "library_equal": library_equal},
    }
    return row


def profile_window(fn, top: int = 12, annotations=()) -> dict:
    """Where a window's time goes: torch.profiler over ``fn()``; device time
    by kernel (device-side events only, so an operator and its kernel never
    count twice) and the device's busy share of the window's wall time (one
    stream: its kernels do not overlap).  ``annotations``: names of
    ``record_function`` regions inside ``fn``; each gets the device time of
    the kernels launched within it from the region's own thread (autograd
    runs a CUDA backward on a thread of its own, so a region around
    ``backward()`` would see none of its kernels).  The profiler's own
    overhead stretches the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # a record_function region (this script's or PyTorch's own, such as the
    # optimizer's step) also shows as a device-side span: not a kernel
    ops = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in averages
        if e.device_type == DeviceType.CUDA and e.key not in annotations
        and not getattr(e, "is_user_annotation", False)
    ]
    ops = sorted((o for o in ops if o[2] > 0), key=lambda o: -o[2])
    device_ms = sum(o[2] for o in ops)
    regions = {e.key: {"calls": e.count, "device_ms": e.device_time_total / 1e3}
               for e in averages if e.key in annotations and e.device_type == DeviceType.CPU}
    out = {
        "wall_ms": wall_ms,
        "device_ms": device_ms if ops else "not measured",
        "device_busy_share": device_ms / wall_ms if ops else "not measured",
        "top_kernels": [{"kernel": k[:100], "calls": c, "ms": ms,
                         "share": ms / device_ms} for k, c, ms in ops[:top]],
    }
    if annotations:
        out["regions"] = {name: regions.get(name, "not measured") for name in annotations}
        out["by_kind"] = kernel_kinds(ops)
    return out


def kernel_kinds(ops) -> dict:
    """Device ms by kind of kernel, from the kernel names."""
    kinds = {}
    for name, _, ms in ops:
        low = name.lower()
        if "short_attention" in low:
            kind = "short_attention"
        elif any(t in low for t in ("gemm", "nvjet", "xmma", "cutlass", "cublas")):
            kind = "gemm"
        elif "multi_tensor_apply" in low or "adam" in low:
            kind = "multi_tensor (AdamW, clip, norms)"
        elif "softmax" in low:
            kind = "softmax"
        elif "layer_norm" in low or "layernorm" in low:
            kind = "layer_norm"
        elif "reduce" in low:
            kind = "reductions"
        elif "elementwise" in low or "vectorized" in low:
            kind = "elementwise"
        elif "memcpy" in low or "memset" in low or "copy" in low:
            kind = "copies"
        else:
            kind = "other"
        kinds[kind] = kinds.get(kind, 0.0) + ms
    return dict(sorted(kinds.items(), key=lambda kv: -kv[1]))


# -- phases ------------------------------------------------------------------------


def all_kernels():
    from improving_learned_index_tpu_torch.ops import (
        gather_rows, pallas_scoring, scatter_scores, short_attention,
    )
    from improving_learned_index_tpu_torch.ops.count_ge import KERNEL as COUNT_GE

    return [gather_rows.KERNEL, scatter_scores.KERNEL, short_attention.KERNEL, COUNT_GE,
            pallas_scoring.KERNEL]


def six_kernels():
    from improving_learned_index_tpu_torch.ops import flash_attention

    return all_kernels() + [flash_attention.KERNEL]


def build_kernels() -> None:
    from improving_learned_index_tpu_torch.ops import _kernels
    from improving_learned_index_tpu_torch.search import native

    log("== phase 2: build kernels and the native engine")
    kernels = six_kernels()
    t0 = time.perf_counter()
    _kernels.build(kernels)
    for k in kernels:
        k.lib()
    t1 = time.perf_counter()
    native.build_library()
    log(f"built {[k.name for k in kernels]} in {t1 - t0:.1f} s, "
        f"the native engine in {time.perf_counter() - t1:.1f} s")


def run_query(cfg, workdir: Path) -> dict:
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.evaluation.run_metrics import Metrics
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.ops.pallas_scoring import PallasBlockedEngine
    from improving_learned_index_tpu_torch.search.select import build_engine
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    kernels = all_kernels()
    dev = torch.device(cfg.device)

    log("== phase 3: synthetic index on the card")
    n_queries = cfg.batches * cfg.nq
    t0 = time.perf_counter()
    offsets, docs, vals, queries, planted = make_corpus(
        cfg.docs, cfg.terms, cfg.postings, n_queries, cfg.query_terms, cfg.seed, dev
    )
    torch.cuda.empty_cache()
    log(f"generated {len(docs)} postings over {cfg.terms} terms, {cfg.docs} docs "
        f"in {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    index_dir, vocab, qpath, qrels = write_inputs(
        workdir, offsets, docs, vals, cfg.docs, queries, planted
    )
    log(f"saved index + queries in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    engine = build_engine(index_dir, dense_budget_bytes=int(cfg.dense_budget_gb * (1 << 30)),
                          device=dev)
    torch.cuda.synchronize()
    log(f"engine: n_pad {engine.n_pad}, {engine.t_heavy} heavy rows "
        f"({engine.dense.dtype}), {engine.doc_ids.numel()} tail slots, "
        f"built in {time.perf_counter() - t0:.1f} s")
    tok = ImpactTokenizer(WordPieceVocab.load(vocab))
    qtext = [line.split("\t", 1)[1] for line in qpath.read_text().splitlines()]
    batches = [
        [tok.process_query(q) for q in qtext[i : i + cfg.nq]]
        for i in range(0, n_queries, cfg.nq)
    ]

    log("== phase 3: query kernels against their plain versions (first batch)")
    heavy, tail = engine.stage_inputs(batches[0])
    if heavy is None or tail is None:
        raise AssertionError("the first batch must reach both stages")
    g_row, base = gather_row(engine, heavy, cfg.nq)
    s_row, scores = scatter_row(engine, base, tail)
    del base, heavy, tail
    c_row = count_row(scores)
    del scores
    t0 = time.perf_counter()
    blocked = PallasBlockedEngine(InvertedIndexData.load(index_dir), device=dev)
    torch.cuda.synchronize()
    log(f"blocked engine: {blocked.num_blocks} blocks, postings sorted on the card, "
        f"built in {time.perf_counter() - t0:.1f} s")
    b_row = blocked_row(blocked, batches[0])
    torch.cuda.empty_cache()
    for row in (g_row, s_row, c_row, b_row):
        log(f"{row['name']}: equal to plain; {json.dumps(row)}")
    log(f"scatter_scores: {s_row['ms']:.4f} ms; {SCATTER_EARLIER_MS} ms before the chunk "
        "entry, at this shape (NVIDIA H100 80GB HBM3, 700 W)")

    log("== phase 4: query main path (cli.rank on the card)")
    run_file = workdir / "run.tsv"
    for k in kernels:
        k.calls.clear()
    t0 = time.perf_counter()
    rank_main([
        "--index_path", str(index_dir), "--queries_path", str(qpath),
        "--output_path", str(run_file), "--vocab_path", str(vocab),
        "--qrels_path", str(qrels), "--top_k", "1000",
        "--dense_budget_gb", str(cfg.dense_budget_gb), "--device", cfg.device,
    ])
    torch.cuda.synchronize()
    launches = {k.name: k.launches for k in kernels}
    log(f"cli.rank: {n_queries} queries in {time.perf_counter() - t0:.1f} s "
        f"(index load and engine build included); launches {launches}")
    for row in (g_row, s_row, c_row):
        if launches[row["name"]] == 0:
            raise AssertionError(f"query main path never launched {row['name']}")
        row["launches"] = launches[row["name"]]

    metrics = Metrics(run_file, qrels).evaluate()
    log(f"metrics: {json.dumps(metrics)}")
    if metrics["MRR@10"] < 0.99:
        raise AssertionError(f"planted docs not ranked first: MRR@10 {metrics['MRR@10']}")

    ranked = {}
    for line in run_file.read_text().splitlines():
        qid, pid, _, score = line.split("\t")
        ranked.setdefault(qid, []).append((pid, float(score)))
    rng = np.random.default_rng(cfg.seed + 2)
    for qi in rng.choice(n_queries, size=4, replace=False).tolist():
        want = numpy_topk(offsets, docs, vals, cfg.docs, queries[qi], 1000)
        if ranked.get(str(qi), []) != want:
            raise AssertionError(f"query {qi}: run file differs from the numpy scorer")
    log("4 sampled queries match the numpy scorer rank by rank")

    log("== pipelined throughput (score_stream, depth 2)")
    list(engine.score_stream(batches[:2], top_k=1000, depth=2))  # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = list(engine.score_stream(batches, top_k=1000, depth=2))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    for bi, out in enumerate(outs):
        for j, res in enumerate(out):
            got = [(str(d), float(s)) for d, s in res]
            if got != ranked.get(str(bi * cfg.nq + j), []):
                raise AssertionError(f"score_stream differs from the run file at query {bi * cfg.nq + j}")
    qps = n_queries / dt
    log(f"pipelined: {n_queries} queries in {dt:.3f} s = {qps:.1f} q/s "
        f"(k=1000, {cfg.nq}-query batches) on {torch.cuda.get_device_name(0)}")
    prof = profile_window(lambda: list(engine.score_stream(batches[:2], top_k=1000, depth=2)))
    log(json.dumps({"profile": dict(prof, batches=2)}))
    engine.release()
    del engine
    torch.cuda.empty_cache()

    others = run_other_engines(cfg, workdir, index_dir, vocab, qtext, batches, ranked, blocked, b_row)
    return {
        "kernels": [g_row, s_row, c_row, b_row],
        "mrr10": metrics["MRR@10"],
        "qps": qps,
        "other_engines": others,
        # phase 12's inputs
        "inputs": SimpleNamespace(index_dir=index_dir, vocab=vocab, qpath=qpath, run_file=run_file,
                                  qtext=qtext, queries=queries, planted=planted, ranked=ranked),
    }


def run_other_engines(cfg, workdir, index_dir, vocab, qtext, batches, ranked, blocked, b_row) -> dict:
    """Phase 5: the host, native and device engines through ``cli.rank``
    over the first ``cfg.nq`` queries, and the blocked engine over two
    batches, against the hybrid engine's rows."""
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main

    log("== phase 5: the other engines on the same index")
    kernels = all_kernels()
    want = "".join(line + "\n" for line in (workdir / "run.tsv").read_text().splitlines()
                   if int(line.split("\t", 1)[0]) < cfg.nq)

    def args(name, engine, q0, q1):
        qpath = workdir / f"queries_{name}.tsv"
        qpath.write_text("".join(f"{qi}\t{qtext[qi]}\n" for qi in range(q0, q1)), encoding="utf-8")
        return ["--index_path", str(index_dir), "--queries_path", str(qpath), "--vocab_path", str(vocab),
                "--top_k", "1000", "--engine", engine, "--output_path", str(workdir / f"run_{name}.tsv")]

    # The host engines run in processes of their own, alongside the card
    # work; the numpy engine (~2 s a query at this scale) over 4 processes
    # of a quarter of the queries each.
    quarter = -(-cfg.nq // 4)
    runs = {f"host{i}": ("host", i * quarter, min(cfg.nq, (i + 1) * quarter)) for i in range(4)}
    runs["native"] = ("native", 0, cfg.nq)
    procs, out = {}, {}
    try:
        for name, (engine, q0, q1) in runs.items():
            log_file = open(workdir / f"rank_{name}.log", "w")
            procs[name] = (subprocess.Popen(
                [sys.executable, "-m", "improving_learned_index_tpu_torch.cli.rank", *args(name, engine, q0, q1)],
                cwd=REPO, stdout=log_file, stderr=subprocess.STDOUT,
            ), log_file, time.perf_counter())
        t0 = time.perf_counter()
        rank_main(args("device", "device", 0, cfg.nq) + ["--device", cfg.device])
        torch.cuda.synchronize()
        out["device_rank_s"] = time.perf_counter() - t0

        for k in kernels:
            k.calls.clear()
        t0 = time.perf_counter()
        rows = [r for bt in batches[:2] for r in blocked.score_batch(bt, 1000)]
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = {k.name: k.launches for k in kernels}
        for qi, res in enumerate(rows):
            if [(str(d), float(sc)) for d, sc in res] != ranked.get(str(qi), []):
                raise AssertionError(f"PallasBlockedEngine differs from the hybrid run at query {qi}")
        for name in ("blocked_scoring", "count_ge"):
            if launches[name] == 0:
                raise AssertionError(f"PallasBlockedEngine never launched {name}")
        b_row["launches"] = launches["blocked_scoring"]
        out["blocked"] = {"queries": len(rows), "s": dt, "qps": len(rows) / dt, "launches": launches}
        log(f"PallasBlockedEngine: {len(rows)} queries equal the hybrid rows rank by rank, "
            f"{len(rows) / dt:.1f} q/s ({cfg.nq}-query batches, tables on the host included); "
            f"launches {launches}")
        blocked.release()

        deadline = time.perf_counter() + 900
        while any(f"{name}_rank_s" not in out for name in procs):  # each process's own end
            if time.perf_counter() > deadline:
                raise AssertionError("cli.rank --engine host / native did not finish in 900 s")
            for name, (proc, _, t_start) in procs.items():
                if f"{name}_rank_s" not in out and proc.poll() is not None:
                    out[f"{name}_rank_s"] = time.perf_counter() - t_start
                    if proc.returncode != 0:
                        tail = (workdir / f"rank_{name}.log").read_text()[-2000:]
                        raise AssertionError(f"cli.rank {name} exited {proc.returncode}:\n{tail}")
            time.sleep(0.05)
        got = {"device": (workdir / "run_device.tsv").read_text(),
               "native": (workdir / "run_native.tsv").read_text(),
               "host": "".join((workdir / f"run_host{i}.tsv").read_text() for i in range(4))}
        for engine, text in got.items():
            if text != want:
                raise AssertionError(f"cli.rank --engine {engine} differs from the hybrid run file")
        log(f"cli.rank --engine device / host / native: run files byte-equal to the hybrid "
            f"rows of the first {cfg.nq} queries; {json.dumps(out)}")
        return out
    finally:
        for proc, log_file, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            log_file.close()


# -- encode path -------------------------------------------------------------------


def make_passages(cfg) -> list:
    """Seeded synthetic passages: words drawn Zipf(1) over a generated list of
    ``cfg.words`` pronounceable words (rare ones fall outside a 30,522-token
    vocabulary and split into WordPiece characters), lengths lognormal
    around ``cfg.mean_words`` (the longest pass 256 tokens and truncate),
    sentences ended by punctuation."""
    rng = np.random.default_rng(cfg.seed)
    cons, vows, tails = "bcdfghjklmnprstvwz", "aeiouy", ("", "s", "n", "r")
    words, seen = [], set()
    while len(words) < cfg.words:  # 2-5 syllables: ~5M possible words
        m = 2 * cfg.words
        syl = rng.integers(2, 6, m)
        c, v, t = rng.integers(0, 18, (m, 5)), rng.integers(0, 6, (m, 5)), rng.integers(0, 4, m)
        for i in range(m):
            w = "".join(cons[c[i, j]] + vows[v[i, j]] for j in range(syl[i])) + tails[t[i]]
            if w not in seen and len(words) < cfg.words:
                seen.add(w)
                words.append(w)
    words = np.array(words)
    p = 1.0 / np.arange(1, cfg.words + 1)
    n_words = np.clip(rng.lognormal(np.log(cfg.mean_words) - 0.18, 0.6, cfg.passages), 5, 400).astype(int)
    ids = rng.choice(cfg.words, size=int(n_words.sum()), p=p / p.sum())
    ends = rng.random(len(ids)) < 1 / 15
    toks = np.where(ends, np.char.add(words[ids], "."), words[ids])
    out, at = [], 0
    for n in n_words:
        out.append(" ".join(toks[at : at + n].tolist()))
        at += n
    return out


def write_bert_checkpoint(directory: Path, config, seed: int) -> None:
    """A seeded BERT trunk in HuggingFace layout (``bert.``-prefixed keys, no
    impact head) as ``directory/pytorch_model.bin``: weights and embeddings
    N(0, 0.02) (BERT's ``initializer_range``), biases 0, LayerNorms 1 and 0.
    At the flax initializer scales a random 12-layer trunk collapses every
    token to nearly one vector, and the ReLU head then zeroes every impact;
    at BERT's scale the tokens stay apart and about half the terms score."""
    g = torch.Generator()
    g.manual_seed(seed)
    h, inter = config.hidden_size, config.intermediate_size
    sd = {}

    def lin(name, n_out, n_in):
        sd[f"{name}.weight"] = torch.randn(n_out, n_in, generator=g) * 0.02
        sd[f"{name}.bias"] = torch.zeros(n_out)

    def norm(name):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = torch.ones(h), torch.zeros(h)

    for name, rows in (("word", config.vocab_size), ("position", config.max_position_embeddings),
                       ("token_type", config.type_vocab_size)):
        sd[f"bert.embeddings.{name}_embeddings.weight"] = torch.randn(rows, h, generator=g) * 0.02
    norm("bert.embeddings.LayerNorm")
    for i in range(config.num_layers):
        p = f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            lin(f"{p}.attention.self.{name}", h, h)
        lin(f"{p}.attention.output.dense", h, h)
        norm(f"{p}.attention.output.LayerNorm")
        lin(f"{p}.intermediate.dense", inter, h)
        lin(f"{p}.output.dense", h, inter)
        norm(f"{p}.output.LayerNorm")
    directory.mkdir(parents=True, exist_ok=True)
    torch.save(sd, directory / "pytorch_model.bin")


def parse_forward(path: Path) -> list:
    from improving_learned_index_tpu_torch.index.forward_index import parse_line

    with open(path, encoding="utf-8") as f:
        return [parse_line(line) for line in f]


def impacts_close(got: list, want: list, tol_max: float, tol_mean: float, what: str) -> dict:
    """Identical term lists; the largest impact difference within
    ``tol_max`` and the mean difference over all terms within ``tol_mean``
    (a wrong mask or position would move every impact, not a few)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} documents against {len(want)}")
    diffs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if list(g) != list(w):
            raise AssertionError(f"{what}: document {i} has other terms")
        diffs.extend(abs(g[t] - w[t]) for t in g)
    d = np.asarray(diffs or [0.0])
    out = {"max": float(d.max()), "mean": float(d.mean()), "p99": float(np.quantile(d, 0.99)),
           "terms": len(diffs)}
    if out["max"] > tol_max or out["mean"] > tol_mean:
        raise AssertionError(f"{what}: impact differences {out} beyond {tol_max} / {tol_mean}")
    return out


def attention_row(q, k, v, pad_mask, seg_ids) -> dict:
    """``short_attention`` against its plain version at the encoder's
    shapes, both masks; times of the kernel, the plain version and SDPA
    (timed only, never called by the port) on the padding mask."""
    import torch.nn.functional as F

    from improving_learned_index_tpu_torch.ops import short_attention as sa

    b, h, s, d = q.shape
    scale = d ** -0.5
    errs, tols = {}, {}
    for name, mask, packed in (("padding", pad_mask, False), ("packed", seg_ids, True)):
        got = sa.short_attention(q, k, v, mask, scale, packed)
        want = sa.short_attention_plain(q, k, v, mask, scale, packed)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        # both round the same fp32 context to bf16 once; the fp32 summation
        # order may move a value (or a bf16 probability) by one ulp
        peak = float(want.float().abs().max())
        tols[name] = 2 * 2.0 ** (np.floor(np.log2(peak)) - 7)
        errs[name] = err
        if not err <= tols[name]:
            raise AssertionError(f"short_attention kernel != plain ({name}): {err} > {tols[name]}")
        del got, want
    keep = pad_mask.bool()[:, None, None, :]
    same = (seg_ids[:, None, :, None] == seg_ids[:, None, None, :])
    b_bound, by = bound_ms(4 * b * h * s * d * q.element_size() + pad_mask.numel() * 4,
                           4 * b * h * s * s * d, BF16_OPS_PER_S)
    row = {
        "name": "short_attention",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/short_attention.cu",
        "replaces": "improving_learned_index_tpu/ops/short_attention.py:40",
        "max_abs_err": max(errs.values()),
        "ms": cuda_ms(lambda: sa.short_attention(q, k, v, pad_mask, scale)),
        "plain_ms": cuda_ms(lambda: sa.short_attention_plain(q, k, v, pad_mask, scale), iters=3),
        "bound_ms": b_bound,
        "bound_by": by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep, scale=scale)),
        "shape": {"q": [b, h, s, d], "dtype": str(q.dtype), "layout": "[B, S, H, D] memory",
                  "max_abs_err": errs, "tolerance": tols,
                  "packed_ms": cuda_ms(lambda: sa.short_attention(q, k, v, seg_ids, scale, True)),
                  "packed_library_ms": cuda_ms(
                      lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=same, scale=scale))},
    }
    return row


def steady_docs_per_s(indexer, docs, first_batch_docs: int) -> dict:
    """Encode ``docs`` through ``Indexer.encode_document_rows``.  Steady
    docs/s counts the documents after the first batch over the time from the
    first batch's first yielded document to the last one, so the model's
    first batch (tokenized before any device work) is left out."""
    t_first, n = None, 0
    t0 = time.perf_counter()
    for _ in indexer.encode_document_rows(docs):
        n += 1
        if t_first is None:
            t_first = time.perf_counter()
    t_end = time.perf_counter()
    return {"docs": n, "wall_s": t_end - t0,
            "steady_docs_per_s": (n - first_batch_docs) / (t_end - t_first)}


def run_encode(cfg, workdir: Path) -> dict:
    from improving_learned_index_tpu_torch.cli.build_vocab import main as build_vocab_main
    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.cli.invert import main as invert_main
    from improving_learned_index_tpu_torch.cli.quantize import main as quantize_main
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig
    from improving_learned_index_tpu_torch.index.indexer import Indexer
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.models import DeepImpact, load_hf_checkpoint
    from improving_learned_index_tpu_torch.ops import short_attention as sa
    from improving_learned_index_tpu_torch.search.dense_engine import DenseSearchEngine
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, SequencePacker, WordPieceVocab

    kernels = all_kernels()
    dev = torch.device(cfg.device)
    config = EncoderConfig.bert_base()
    heads, hd = config.num_heads, config.hidden_size // config.num_heads
    timings = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        timings[name] = time.perf_counter() - t0
        return out

    log("== phase 6: synthetic corpus, vocab, short_attention against its plain version")
    passages = timed("corpus_s", lambda: make_passages(cfg))
    coll = workdir / "collection.tsv"
    coll.write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(passages)), encoding="utf-8")
    vocab_path = workdir / "vocab.txt"
    timed("cli_build_vocab_s", lambda: build_vocab_main(
        ["--collection_path", str(coll), "--output_path", str(vocab_path)]))
    tok = ImpactTokenizer(WordPieceVocab.load(vocab_path), max_length=cfg.max_length)
    encs = timed("tokenize_s", lambda: [tok.process_document(p) for p in passages])
    lengths = np.array([sum(e.attention_mask) for e in encs])
    packer = SequencePacker(cfg.max_length, cfg.batch, cfg.max_length)
    packed_batches = [bt for e in encs for bt in packer.add(e)] + list(packer.flush())
    corpus = {"passages": len(passages), "vocab": len(tok.vocab),
              "mean_tokens": float(lengths.mean()), "truncated": int((lengths == cfg.max_length).sum()),
              "batches": -(-len(passages) // cfg.batch), "packed_batches": len(packed_batches)}
    log(f"corpus: {json.dumps(corpus)}")

    rng = np.random.default_rng(cfg.seed + 1)
    b, s = cfg.batch, cfg.max_length
    q, k, v = (
        torch.from_numpy(rng.standard_normal((b, s, heads, hd), dtype=np.float32) * 1.5)
        .to(dev, torch.bfloat16).permute(0, 2, 1, 3)
        for _ in range(3)
    )
    pad_mask = torch.from_numpy(np.asarray([e.attention_mask for e in encs[:b]], np.int32)).to(dev)
    seg_ids = torch.from_numpy(packed_batches[0].segment_ids).to(dev)
    a_row = attention_row(q, k, v, pad_mask, seg_ids)
    del q, k, v
    log(f"short_attention: within tolerance of plain; {json.dumps(a_row)}")

    log("== phase 7: encode main path (cli.index -> quantize -> invert -> rank on the card)")
    fwd, qfwd, idx = workdir / "forward.txt", workdir / "forward.q.txt", workdir / "index"
    bert = workdir / "bert"
    timed("checkpoint_s", lambda: write_bert_checkpoint(bert, config, cfg.seed))
    common = ["--collection_path", str(coll), "--vocab_path", str(vocab_path),
              "--max_length", str(cfg.max_length), "--model_batch_size", str(cfg.batch),
              "--hf_name", str(bert), "--device", cfg.device]
    for kern in kernels:
        kern.calls.clear()
    timed("cli_index_s", lambda: index_main(common + ["--output_file_path", str(fwd)]))
    launches = {kern.name: kern.launches for kern in kernels}
    log(f"cli.index: {len(passages)} passages in {timings['cli_index_s']:.1f} s; launches {launches}")
    want = config.num_layers * corpus["batches"]
    if launches["short_attention"] != want:
        raise AssertionError(f"short_attention launched {launches['short_attention']} times, want {want}")
    a_row["launches"] = launches["short_attention"]

    timed("cli_quantize_s", lambda: quantize_main(["-i", str(fwd), "-o", str(qfwd)]))
    timed("cli_invert_s", lambda: invert_main(["-i", str(qfwd), "-o", str(idx)]))

    # the kernel route against the plain one on the first passages, and
    # both against the CLI's forward index (same seed, same batches)
    weights = load_hf_checkpoint(bert, config)
    model = DeepImpact(config, tok, state_dict=weights, device=cfg.device)
    plain = DeepImpact(config, tok, state_dict=weights, device=cfg.device, use_kernels=False)
    head = passages[: cfg.check_docs]
    got = [dict(x) for x in model.get_impact_scores_batch(head)]
    ref = [dict(x) for x in plain.get_impact_scores_batch(head)]
    peak = max(max(d.values(), default=0.0) for d in ref)
    scored = sum(v > 0 for d in ref for v in d.values()) / max(sum(map(len, ref)), 1)
    if not 0.05 < scored < 0.95:
        raise AssertionError(f"degenerate model: {scored:.3f} of the terms score above 0")
    # The two routes differ only in attention's fp32 summation order, but
    # every activation is bf16: where one attention output lands one bf16
    # ulp (2^-8 relative) apart, the difference rides through 12 layers
    # of bf16 roundings, and the head sums 768 such hidden values (one
    # ulp of each, with random signs, moves an impact by ~0.01 at this
    # head's scale).  Tolerance: every impact within 5% of the largest,
    # the mean difference within 0.2% of it.
    tol = (0.05 * peak, 0.002 * peak)
    err_plain = impacts_close(got, ref, *tol, "kernel route vs plain")
    fwd_docs = parse_forward(fwd)
    # the same batch through the same kernels: equal up to round(v, 3)
    err_cli = impacts_close(fwd_docs[: cfg.check_docs], [{t: round(x, 3) for t, x in d.items()} for d in got],
                            1.5e-3, 1.5e-3, "cli.index vs the kernel route")
    log(f"kernel route vs plain on {len(head)} passages: max |diff| {err_plain} "
        f"(tolerance {tol}, largest impact {peak}, {scored:.3f} of terms above 0); "
        f"vs cli.index {err_cli}")
    del plain

    index = InvertedIndexData.load(idx)
    postings = {}
    for doc, d in enumerate(parse_forward(qfwd)):
        for t, val in d.items():
            postings.setdefault(t, []).append((-int(val), doc))
    if index.vocab != sorted(postings):
        raise AssertionError("inverted vocabulary != the quantized forward index's terms")
    for t, term in enumerate(index.vocab):
        ref_docs = sorted(postings[term])
        s0, e0 = index.offsets[t], index.offsets[t + 1]
        if (index.doc_ids[s0:e0].tolist() != [dd for _, dd in ref_docs]
                or index.impacts[s0:e0].tolist() != [-vv for vv, _ in ref_docs]):
            raise AssertionError(f"postings of {term!r} differ from the numpy inversion")
    if index.num_postings < len(passages):
        raise AssertionError(f"only {index.num_postings} postings for {len(passages)} passages")
    log(f"inverted index: {len(index.vocab)} terms, {index.num_postings} postings, "
        "equal to the numpy inversion")

    qrng = np.random.default_rng(cfg.seed + 2)
    lens = np.diff(index.offsets)
    pick = np.argsort(-lens, kind="stable")[:2000]
    queries = [qrng.choice(pick, cfg.query_terms, replace=False).tolist() for _ in range(cfg.rank_queries)]
    qpath, run_file = workdir / "queries.tsv", workdir / "run.tsv"
    qpath.write_text("".join(f"{i}\t{' '.join(index.vocab[t] for t in qt)}\n"
                             for i, qt in enumerate(queries)), encoding="utf-8")
    timed("cli_rank_s", lambda: rank_main([
        "--index_path", str(idx), "--queries_path", str(qpath), "--output_path", str(run_file),
        "--vocab_path", str(vocab_path), "--top_k", "1000", "--device", cfg.device]))
    ranked = {}
    for line in run_file.read_text().splitlines():
        qid, pid, _, score = line.split("\t")
        ranked.setdefault(qid, []).append((pid, float(score)))
    for qi, qt in enumerate(queries):
        want_q = numpy_topk(index.offsets, index.doc_ids, index.impacts, index.num_docs, qt, 1000)
        if not want_q or ranked.get(str(qi), []) != want_q:
            raise AssertionError(f"encode-path query {qi}: run file differs from the numpy scorer")
    log(f"{cfg.rank_queries} queries over the port-built index match the numpy scorer rank by rank")
    t0 = time.perf_counter()
    dense = DenseSearchEngine(index, device=cfg.device)
    dense_rows = dense.score_batch([{index.vocab[t] for t in qt} for qt in queries], 1000)
    timings["dense_engine_s"] = time.perf_counter() - t0
    for qi, res in enumerate(dense_rows):
        if [(str(d), float(sc)) for d, sc in res] != ranked.get(str(qi), []):
            raise AssertionError(f"DenseSearchEngine differs from the run file at encode query {qi}")
    log(f"DenseSearchEngine ({list(dense.impact_matrix.shape)} {dense.impact_matrix.dtype}) returns "
        f"the same rows for the {cfg.rank_queries} queries")
    del dense

    fwd_p = workdir / "forward.packed.txt"
    for kern in kernels:
        kern.calls.clear()
    timed("cli_index_packed_s", lambda: index_main(common + ["--output_file_path", str(fwd_p), "--pack"]))
    packed_launches = sa.KERNEL.launches
    if packed_launches != config.num_layers * corpus["packed_batches"]:
        raise AssertionError(f"packed: short_attention launched {packed_launches} times, "
                             f"want {config.num_layers * corpus['packed_batches']}")
    # other rows, other batch composition: the same bf16 argument, plus
    # the two files' round(v, 3)
    err_packed = impacts_close(parse_forward(fwd_p), fwd_docs, tol[0] + 1e-3, tol[1] + 5e-4,
                               "packed vs unpacked")
    log(f"cli.index --pack: same term lists, max |diff| {err_packed} against unpacked; "
        f"{packed_launches} launches")

    log("== encode throughput and profile")
    unpacked_cfg = IndexConfig(max_length=cfg.max_length, max_terms=cfg.max_length,
                               model_batch_size=cfg.batch)
    packed_cfg = IndexConfig(max_length=cfg.max_length, max_terms=cfg.max_length,
                             model_batch_size=cfg.batch, pack_sequences=True)
    rate = steady_docs_per_s(Indexer(model, unpacked_cfg), passages, cfg.batch)
    rate_p = steady_docs_per_s(Indexer(model, packed_cfg), passages, packed_batches[0].n_docs)
    log(f"encode: {json.dumps({'unpacked': rate, 'packed': rate_p})} on {torch.cuda.get_device_name(0)}")
    profiles = {}
    for name, icfg, per_batch in (("unpacked", unpacked_cfg, cfg.batch),
                                  ("packed", packed_cfg, packed_batches[0].n_docs)):
        # skip two batches, profile the next profile_batches (a steady
        # window, the producer already ahead of the device), drain the rest
        n_win = cfg.profile_batches * per_batch
        stream = Indexer(model, icfg).encode_document_rows(passages[: n_win + 3 * per_batch])
        list(islice(stream, 2 * per_batch))
        before = sa.KERNEL.launches
        profiles[name] = dict(profile_window(lambda: list(islice(stream, n_win)), top=15), docs=n_win)
        # batches whose forward ran inside the window
        profiles[name]["batches"] = (sa.KERNEL.launches - before) / config.num_layers
        list(stream)
    log(json.dumps({"encode_profile": profiles}))
    return {
        "row": a_row,
        "passages": passages,
        "corpus": corpus,
        "timings_s": timings,
        "unpacked": rate,
        "packed": rate_p,
        "profiles": {k: {"device_busy_share": v["device_busy_share"], "wall_ms": v["wall_ms"]}
                     for k, v in profiles.items()},
        "errors": {"kernel_vs_plain": err_plain, "tolerance": tol, "cli_vs_api": err_cli,
                   "packed_vs_unpacked": err_packed},
    }


# -- training ----------------------------------------------------------------------


def write_triples(workdir: Path, passages: list, n: int, seed: int) -> tuple:
    """Seeded training data over the collection ``passages`` (pid = index):
    query i is 3-4 distinct words of its positive passage, its negative a
    random other passage.  Returns the queries and triples paths."""
    rng = np.random.default_rng(seed + 3)
    pos = rng.choice(len(passages), n, replace=False)
    neg = (pos + rng.integers(1, len(passages), n)) % len(passages)
    queries = []
    for p in pos:
        words = [w.rstrip(".") for w in passages[p].split()]
        pick = rng.choice(len(words), size=min(len(words), int(rng.integers(3, 5))), replace=False)
        queries.append(" ".join(words[j] for j in sorted(pick)))
    qpath, tpath = workdir / "train_queries.tsv", workdir / "triples.tsv"
    qpath.write_text("".join(f"{i}\t{q}\n" for i, q in enumerate(queries)), encoding="utf-8")
    tpath.write_text("".join(f"{i}\t{a}\t{b}\n" for i, (a, b) in enumerate(zip(pos, neg))), encoding="utf-8")
    return qpath, tpath


def kernel_vs_plain_step(module, loss_name: str, batch: dict) -> dict:
    """One training batch's loss and gradients on the kernel route and on
    the plain route (``use_kernels=False``): the loss within 1%, the global
    gradient norm within 2%, the gradients' cosine >= 0.99, else
    AssertionError.  The same bf16 argument as phase 7's impact tolerance:
    the forwards differ by at most two bf16 ulps of an attention output, and
    the backwards are one recompute."""
    from improving_learned_index_tpu_torch.train import make_loss_fn

    routes = {}
    for use_kernels in (True, False):
        loss = make_loss_fn(module, loss_name, use_kernels=use_kernels)(batch)
        loss.backward()
        grads = torch.cat([p.grad.flatten() for p in module.parameters()])
        routes[use_kernels] = (loss.item(), grads)
        for p in module.parameters():
            p.grad = None
    (lk, gk), (lp, gp) = routes[True], routes[False]
    nk, npl = float(gk.norm()), float(gp.norm())
    cos = float(torch.dot(gk, gp)) / (nk * npl) if nk * npl > 0 else float("nan")
    check = {"loss": [lk, lp], "grad_norm": [nk, npl], "cosine": cos}
    if not (np.isfinite(lk) and abs(lk - lp) <= 0.01 * abs(lp) and npl > 0
            and abs(nk - npl) <= 0.02 * npl and check["cosine"] >= 0.99):
        raise AssertionError(f"{loss_name} step: kernel route vs plain route out of tolerance: {check}")
    return check


def train_metrics(ckpt: Path, steps: int, save_every: int) -> dict:
    """The CLI's logged steps: every loss finite, each step's seconds
    (``train/elapsed_s`` is read after the step's loss reached the host and
    its checkpoints were written), and the steady rate over the steps after
    the first two that wrote no checkpoint."""
    records = [json.loads(line) for line in (ckpt / "metrics.txt").read_text().splitlines()]
    train = [r for r in records if "train/loss" in r]
    if [r["step"] for r in train] != list(range(1, steps + 1)):
        raise AssertionError(f"{ckpt.name}: logged steps {[r['step'] for r in train]}, want 1..{steps}")
    losses = [r["train/loss"] for r in train]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{ckpt.name}: a logged loss is not finite: {losses}")
    t = [r["train/elapsed_s"] for r in train]
    step_s = [b - a for a, b in zip(t, t[1:])]  # steps 2..N
    steady = [d for i, d in enumerate(step_s[1:], start=3) if i % save_every]
    saving = [d for i, d in enumerate(step_s[1:], start=3) if not i % save_every]
    return {"losses": losses, "grad_norms": [r["train/grad_norm"] for r in train],
            "first_two_steps_s": t[1], "step_s": step_s,
            "steady_steps_per_s": len(steady) / sum(steady) if steady else None,
            "checkpoint_step_s": saving}


def run_train(cfg, workdir: Path, passages: list) -> dict:
    """Phase 8: training on the card at BERT-base width, S=256."""
    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.cli.train import main as train_main
    from improving_learned_index_tpu_torch.core.checkpoint import load_params
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
    from improving_learned_index_tpu_torch.data.datasets import MSMarcoTriples
    from improving_learned_index_tpu_torch.models import DeepImpact, load_hf_checkpoint
    from improving_learned_index_tpu_torch.ops import short_attention as sa
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.train import COLLATES, Trainer
    from improving_learned_index_tpu_torch.train.packed import pack_collated

    log("== phase 8: training on the card (BERT-base, S=256, 128 query groups a step)")
    kernels = all_kernels()
    config = EncoderConfig.bert_base()
    max_length = ENCODE.max_length
    coll, vocab, bert = workdir / "collection.tsv", workdir / "vocab.txt", workdir / "bert"
    qpath, tpath = write_triples(workdir, passages, cfg.triples, cfg.seed)
    tok = ImpactTokenizer(WordPieceVocab.load(vocab), max_length=max_length)
    dataset = MSMarcoTriples(tpath, qpath, coll)
    out = {}

    # check 1: the kernel route against the plain route on one packed batch
    model = DeepImpact(config, tok, state_dict=load_hf_checkpoint(bert, config), device=cfg.device)
    batches = [pack_collated(COLLATES["pairwise_ce"]([dataset[i] for i in range(j, j + cfg.groups)],
                                                     tok, max_length))
               for j in range(0, (2 + cfg.profile_steps) * cfg.groups, cfg.groups)]
    trainer = Trainer(model, TrainConfig(batch_size=cfg.groups, save_every=10**9, eval_every=10**9),
                      workdir / "ckpt_profile")
    put = trainer._put_batch(batches[0])
    check1 = {"rows": int(batches[0]["input_ids"].shape[0]), "docs": 2 * cfg.groups,
              **kernel_vs_plain_step(model.module, "pairwise_ce", put)}
    log(f"check 1, kernel route vs plain route on a packed batch: {json.dumps(check1)}")
    out["kernel_vs_plain"] = check1

    # the step's profile: 2 steps after 2 warm ones, forward + backward + the
    # clipped AdamW step as Trainer.train takes them (without its checkpoint)
    def step(batch):
        loss, norm, grads = trainer._grad_step(trainer._put_batch(batch))
        trainer._apply_grads(grads, norm)
        return loss.item()

    for b in batches[:2]:
        step(b)
    prof = profile_window(lambda: [step(b) for b in batches[2:]], top=15,
                          annotations=("train/forward", "short_attention.backward",
                                       "train/optimizer"))
    prof["steps"] = cfg.profile_steps
    out["profile"] = prof
    log(json.dumps({"train_profile": prof}))
    del trainer, model, put, batches
    torch.cuda.empty_cache()

    # check 2: cli.train, packed (its default), counts zeroed just before
    common = ["--dataset_path", str(tpath), "--queries_path", str(qpath), "--collection_path", str(coll),
              "--vocab_path", str(vocab), "--hf_name", str(bert), "--max_length", str(max_length),
              "--batch_size", str(cfg.groups), "--no_beir_eval", "--device", cfg.device]
    ck = workdir / "ckpt"
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.calls.clear()
    t0 = time.perf_counter()
    train_main(common + ["--checkpoint_dir", str(ck), "--total_steps", str(cfg.steps),
                         "--save_every", str(cfg.save_every)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    want = config.num_layers * cfg.steps
    if launches["short_attention"] != want:
        raise AssertionError(f"cli.train: short_attention launched {launches['short_attention']} times, "
                             f"want {want} ({config.num_layers} layers x {cfg.steps} forwards)")
    packed = dict(train_metrics(ck, cfg.steps, cfg.save_every), wall_s=wall, launches=launches,
                  peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    packed["steady_docs_per_s"] = packed["steady_steps_per_s"] * 2 * cfg.groups
    snapshots = {str(cfg.save_every): cfg.save_every, str(cfg.steps): cfg.steps,
                 "latest": cfg.steps, "final": cfg.steps}
    for suffix, step_no in snapshots.items():
        meta_path = ck / f"DeepImpact_{suffix}.meta.json"
        if not (ck / f"DeepImpact_{suffix}.pt").exists() or not meta_path.exists():
            raise AssertionError(f"cli.train wrote no {suffix} checkpoint")
        meta = json.loads(meta_path.read_text())
        if meta["step"] != step_no or meta["batch_size"] != cfg.groups:
            raise AssertionError(f"checkpoint {suffix}: meta {meta}, want step {step_no}")
    log(f"check 2, cli.train packed: {json.dumps(packed)}; checkpoints {sorted(snapshots)} "
        "with their steps")
    out["packed"] = packed
    torch.cuda.empty_cache()

    # check 3: the unpacked layout, for its rate
    ck_u = workdir / "ckpt_unpacked"
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    train_main(common + ["--checkpoint_dir", str(ck_u), "--total_steps", str(cfg.unpacked_steps),
                         "--save_every", "1000000", "--no_pack"])
    torch.cuda.synchronize()
    unpacked = dict(train_metrics(ck_u, cfg.unpacked_steps, 10**6), wall_s=time.perf_counter() - t0,
                    peak_gb=torch.cuda.max_memory_allocated() / 2**30)
    unpacked["steady_docs_per_s"] = unpacked["steady_steps_per_s"] * 2 * cfg.groups
    log(f"check 3, cli.train --no_pack: {json.dumps(unpacked)}")
    out["unpacked"] = unpacked
    shutil.rmtree(ck_u, ignore_errors=True)
    torch.cuda.empty_cache()

    # check 4: the trained checkpoint through the encode path
    final = ck / "DeepImpact_final.pt"
    head = workdir / "index_head.tsv"
    head.write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(passages[: cfg.index_docs])), encoding="utf-8")
    fwd = workdir / "forward.trained.txt"
    index_main(["--collection_path", str(head), "--output_file_path", str(fwd), "--vocab_path", str(vocab),
                "--max_length", str(max_length), "--model_batch_size", str(cfg.index_docs),
                "--checkpoint", str(final), "--device", cfg.device])
    trained = DeepImpact(config, tok, state_dict=load_params(final), device=cfg.device)
    want_docs = [{t: round(v, 3) for t, v in doc}
                 for doc in trained.get_impact_scores_batch(passages[: cfg.index_docs])]
    got_docs = parse_forward(fwd)
    if len(got_docs) != len(want_docs):
        raise AssertionError(f"cli.index --checkpoint: {len(got_docs)} documents, want {len(want_docs)}")
    for i, (g, w) in enumerate(zip(got_docs, want_docs)):
        if list(g) != list(w):
            raise AssertionError(f"cli.index --checkpoint: document {i} has other terms")
        if g != w:
            raise AssertionError(f"cli.index --checkpoint: document {i}'s impacts differ from the model's")
    scored = sum(v > 0 for d in want_docs for v in d.values())
    out["index_check"] = {"docs": len(got_docs), "terms": sum(map(len, got_docs)), "scored": scored}
    log(f"check 4, cli.index --checkpoint {final.name}: {json.dumps(out['index_check'])}, "
        "term lists and impacts equal to the trained model's")
    out["launches"] = launches["short_attention"]
    out["train_args"] = common
    return out


# -- in-memory eval -----------------------------------------------------------------


def write_beir(root: Path, name: str, passages: list, n_queries: int, seed: int) -> tuple:
    """A BEIR-format dataset: the passages as corpus.jsonl (ids 0..n-1),
    ``n_queries`` queries of 3-4 distinct words of one passage each, that
    passage the query's one qrel.  Returns (queries, qrels)."""
    rng = np.random.default_rng(seed)
    d = root / name
    d.mkdir(parents=True)
    with open(d / "corpus.jsonl", "w", encoding="utf-8") as f:
        for i, text in enumerate(passages):
            f.write(json.dumps({"_id": str(i), "title": "", "text": text}) + "\n")
    queries, qrels = {}, {}
    for qi, pid in enumerate(rng.choice(len(passages), n_queries, replace=False).tolist()):
        words = list(dict.fromkeys(w.rstrip(".") for w in passages[pid].split()))
        pick = rng.choice(len(words), size=min(len(words), int(rng.integers(3, 5))), replace=False)
        queries[str(qi)] = " ".join(words[j] for j in sorted(pick))
        qrels[str(qi)] = {str(pid): 1}
    with open(d / "queries.jsonl", "w", encoding="utf-8") as f:
        for qid, text in queries.items():
            f.write(json.dumps({"_id": qid, "text": text}) + "\n")
    (d / "qrels.tsv").write_text("query-id\tcorpus-id\tscore\n" + "".join(
        f"{qid}\t{pid}\t1\n" for qid, rel in qrels.items() for pid in rel), encoding="utf-8")
    return queries, qrels


def numpy_float_runs(impacts: list, query_terms: dict, k: int) -> dict:
    """The independent scorer: fp64 sums of each query's positive impacts
    per doc, ranked by (score desc, doc id asc), the top ``k`` with a score
    above 0, as {qid: [(doc, score), ...]}."""
    postings = {}
    for doc, row in enumerate(impacts):
        for term, value in row:
            if value > 0:
                postings.setdefault(term, ([], []))
                postings[term][0].append(doc)
                postings[term][1].append(value)
    postings = {t: (np.asarray(d, np.int64), np.asarray(v, np.float64)) for t, (d, v) in postings.items()}
    runs = {}
    for qid, terms in query_terms.items():
        scores = np.zeros(len(impacts), np.float64)
        for term in terms:
            if term in postings:
                np.add.at(scores, *postings[term])
        order = np.lexsort((np.arange(len(impacts)), -scores))[:k]
        runs[qid] = [(int(d), float(scores[d])) for d in order if scores[d] > 0]
    return runs


def float_rows_close(got: list, want: list, rel: float = 1e-5) -> int:
    """One query's ranked (doc, score) rows against a reference's: the same
    length, scores within ``rel`` rank by rank, and the doc ids equal except
    where the two docs' scores lie within 2 x ``rel`` of each other (a
    near-tie, which summation order may swap).  Returns the near-tie swaps."""
    if len(got) != len(want):
        raise AssertionError(f"{len(got)} rows against {len(want)}")
    gs, ws = np.asarray([s for _, s in got]), np.asarray([s for _, s in want])
    if not np.allclose(gs, ws, rtol=rel, atol=0):
        raise AssertionError(f"scores beyond {rel} relative: max {float(np.abs(gs / ws - 1).max())}")
    score = dict(want)
    swaps = 0
    for (gd, gv), (wd, _) in zip(got, want):
        if gd != wd:
            # a doc missing from ``want`` was cut there by a near-tie at its end
            if abs(score.get(gd, ws[-1]) - gv) > 2 * rel * gv:
                raise AssertionError(f"doc {gd} in place of {wd} without a near-tie")
            swaps += 1
    return swaps


def relevant_ranks(qrels: dict, results: dict) -> dict:
    """Each query's rank of its relevant doc in trec_eval's order (score
    desc, doc id desc), None when it is not in the run."""
    from improving_learned_index_tpu_torch.evaluation.trec_metrics import _sorted_docs

    out = {}
    for qid, rel in qrels.items():
        ranked = _sorted_docs(results.get(qid, {}))
        (pid,) = rel
        out[qid] = ranked.index(pid) + 1 if pid in ranked else None
    return out


class Spies:
    """Wraps methods of the eval path for one run: call counts, seconds and
    what they returned, without changing what they compute.  ``restore``
    puts the originals back."""

    def __init__(self):
        self.calls, self.seconds, self.records, self._undo = {}, {}, {}, []

    def wrap(self, owner, name: str, keep=None):
        real = getattr(owner, name)
        self.calls[name], self.seconds[name], self.records[name] = 0, 0.0, []

        def spy(*args, **kwargs):
            t0 = time.perf_counter()
            out = real(*args, **kwargs)
            self.seconds[name] += time.perf_counter() - t0
            self.calls[name] += 1
            if keep is not None:
                self.records[name].append(keep(args, out))
            return out

        setattr(owner, name, spy)
        self._undo.append((owner, name, real))

    def restore(self):
        for owner, name, real in reversed(self._undo):
            setattr(owner, name, real)
        self._undo.clear()


def run_eval(cfg, workdir: Path, ckpt: Path, train_args: list) -> dict:
    """Phase 9: the in-memory eval on the card at BERT-base width, S=256."""
    from improving_learned_index_tpu_torch.cli.nano_beir import main as nano_beir_main
    from improving_learned_index_tpu_torch.cli.train import main as train_main
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.evaluation import nano_beir, sparse_search
    from improving_learned_index_tpu_torch.evaluation.trec_metrics import evaluate as trec_evaluate
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.ops import short_attention as sa
    from improving_learned_index_tpu_torch.search.device_engine import DeviceSearchEngine
    from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine
    from improving_learned_index_tpu_torch.search.select import HYBRID_MIN_DOCS
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.text.packing import pack_documents

    log("== phase 9: in-memory eval (cli.nano_beir, in-training eval; BERT-base, S=256)")
    t_phase = time.perf_counter()
    kernels = all_kernels()
    dev = torch.device(cfg.device)
    config = EncoderConfig.bert_base()
    out = {"checkpoint": ckpt.name}

    # data: two BEIR-format datasets from the phase 6 generator
    t0 = time.perf_counter()
    gen = SimpleNamespace(**{**vars(ENCODE), "passages": cfg.nano_docs + cfg.large_docs, "seed": cfg.seed})
    passages = make_passages(gen)
    beir = workdir / "beir"
    data = {"nano": write_beir(beir, "nano", passages[: cfg.nano_docs], cfg.queries, cfg.seed),
            "large": write_beir(beir, "large", passages[cfg.nano_docs :], cfg.queries, cfg.seed + 1)}
    del passages
    if cfg.large_docs < HYBRID_MIN_DOCS:
        raise AssertionError("the large dataset must lie past SparseSearch's engine switch")
    log(f"BEIR datasets nano ({cfg.nano_docs} docs) and large ({cfg.large_docs} docs), "
        f"{cfg.queries} queries each, in {time.perf_counter() - t0:.1f} s")

    # the main path: cli.nano_beir, counts zeroed just before and read after
    spies = Spies()
    spies.wrap(DeepImpact, "get_impact_scores_batch_packed", keep=lambda a, o: (a[0], o))
    spies.wrap(DeepImpact, "encode_packed")
    spies.wrap(sparse_search.SparseSearch, "_build_index", keep=lambda a, o: a[0].engine)
    spies.wrap(sparse_search.SparseSearch, "search")
    spies.wrap(nano_beir, "trec_evaluate", keep=lambda a, o: (a[0], a[1], o))
    per_dataset = {}

    def launches_now():
        return {k.name: k.launches for k in kernels}

    real_eval = nano_beir.NanoBEIREvaluator.evaluate_dataset

    def evaluate_dataset(self, model, name):
        before, seconds = launches_now(), dict(spies.seconds)
        encodes = spies.calls["get_impact_scores_batch_packed"]
        t = time.perf_counter()
        result = real_eval(self, model, name)
        torch.cuda.synchronize()
        after = launches_now()
        per_dataset[name] = {
            "eval_s": time.perf_counter() - t,
            "launches": {k: after[k] - before[k] for k in after},
            "split_s": {k: spies.seconds[k] - seconds[k] for k in seconds},
            "encode_calls": spies.calls["get_impact_scores_batch_packed"] - encodes,
        }
        return result

    nano_beir.NanoBEIREvaluator.evaluate_dataset = evaluate_dataset
    metrics_path = workdir / "nano_beir.json"
    try:
        for k in kernels:
            k.calls.clear()
        t0 = time.perf_counter()
        with open(workdir / "nano_beir.stdout", "w") as sink:
            stdout, sys.stdout = sys.stdout, sink
            try:
                nano_beir_main(["--local_data_dir", str(beir), "--max_length", str(ENCODE.max_length),
                                "--batch_size", str(cfg.batch), "--checkpoint", str(ckpt),
                                "--vocab_path", str(workdir / "vocab.txt"), "--device", cfg.device,
                                "--output", str(metrics_path)])
            finally:
                sys.stdout = stdout
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
    finally:
        nano_beir.NanoBEIREvaluator.evaluate_dataset = real_eval
        spies.restore()
    metrics = json.loads(metrics_path.read_text())
    if json.loads((workdir / "nano_beir.stdout").read_text()) != metrics:
        raise AssertionError("cli.nano_beir printed other metrics than it wrote")
    names = sorted(data)
    if list(per_dataset) != names or set(metrics) != {*names, "avg"}:
        raise AssertionError(f"cli.nano_beir evaluated {list(per_dataset)}, metrics {sorted(metrics)}")
    engines = dict(zip(names, spies.records["_build_index"]))
    if not (isinstance(engines["large"], HybridSearchEngine) and isinstance(engines["nano"], DeviceSearchEngine)
            and not engines["large"].integer_scores and not engines["nano"].integer_scores):
        raise AssertionError(f"engines {[type(e).__name__ for e in engines.values()]}")
    for name in names:
        got = per_dataset[name]["launches"]
        want = ("short_attention", "scatter_scores") + (("gather_rows",) if name == "large" else ())
        missing = [k for k in want if got[k] == 0]
        if missing:
            raise AssertionError(f"cli.nano_beir on {name} never launched {missing}")
    want_attn = config.num_layers * spies.calls["encode_packed"]
    if launches["short_attention"] != want_attn:
        raise AssertionError(f"short_attention launched {launches['short_attention']} times, want "
                             f"{want_attn} ({config.num_layers} layers x {spies.calls['encode_packed']} packed batches)")
    out["main_path"] = {"wall_s": wall, "launches": launches,
                        "gather_rows_fp32_launches": per_dataset["large"]["launches"]["gather_rows"],
                        "packed_batches": spies.calls["encode_packed"]}

    # the impacts the CLI encoded, in corpus order (datasets in sorted order)
    model = spies.records["get_impact_scores_batch_packed"][0][0]
    impacts = [row for _, rows in spies.records["get_impact_scores_batch_packed"] for row in rows]
    n_docs = {"large": cfg.large_docs, "nano": cfg.nano_docs}
    if len(impacts) != sum(n_docs.values()):
        raise AssertionError(f"{len(impacts)} encoded docs, want {sum(n_docs.values())}")
    by_name = {"large": impacts[: cfg.large_docs], "nano": impacts[cfg.large_docs :]}
    del impacts
    tok = ImpactTokenizer(WordPieceVocab.load(workdir / "vocab.txt"), max_length=ENCODE.max_length)
    checks = {}
    for name, (qrels, results, returned) in zip(names, spies.records["trec_evaluate"]):
        got_metrics = json.loads(json.dumps(returned))
        queries, want_qrels = data[name]
        if qrels != want_qrels or got_metrics != metrics[name]:
            raise AssertionError(f"{name}: the CLI's qrels or metrics are not what it evaluated")
        terms = {qid: tok.process_query(q) for qid, q in queries.items()}
        want = numpy_float_runs(by_name[name], terms, 1000)
        swaps = 0
        for qid in queries:
            rows = sorted(((int(d), s) for d, s in results[qid].items()), key=lambda x: (-x[1], x[0]))
            swaps += float_rows_close(rows, want[qid])
        want_results = {qid: {str(d): s for d, s in rows} for qid, rows in want.items()}
        ranks, want_ranks = relevant_ranks(qrels, results), relevant_ranks(qrels, want_results)
        moved = [qid for qid in qrels if ranks[qid] != want_ranks[qid]]
        for qid in moved:  # a relevant doc moved by a near-tie only
            s_rel = dict(want[qid]).get(int(next(iter(qrels[qid]))))
            lo, hi = sorted((ranks[qid] or 1001, want_ranks[qid] or 1001))
            between = [s for _, s in want[qid][lo - 1 : hi]]
            if s_rel is None or any(abs(s - s_rel) > 2e-5 * s_rel for s in between):
                raise AssertionError(f"{name} query {qid}: relevant rank {ranks[qid]} against {want_ranks[qid]}")
        numpy_metrics = json.loads(json.dumps(trec_evaluate(qrels, want_results, (10, 100, 1000))))
        if not moved and numpy_metrics != metrics[name]:
            raise AssertionError(f"{name}: metrics {metrics[name]} against the numpy scorer's {numpy_metrics}")
        checks[name] = {"near_tie_swaps": swaps, "relevant_ranks_moved_by_near_ties": len(moved),
                        "metrics_equal_numpy": numpy_metrics == metrics[name]}
    log(f"cli.nano_beir: metrics equal trec_evaluate over the numpy fp64 scorer's runs "
        f"(scores within 1e-5 relative, doc order exact but for near-ties); {json.dumps(checks)}")

    # the float engines' kernels against their plain versions, on the CLI's
    # large engine and its first query batch
    engine = engines["large"]
    if engine.dense.dtype != torch.float32 or engine.t_heavy == 0:
        raise AssertionError(f"large engine: {engine.t_heavy} heavy rows of {engine.dense.dtype}")
    qids = list(data["large"][0])
    batch = [tok.process_query(data["large"][0][q]) for q in qids]
    heavy, tail = engine.stage_inputs(batch)
    if heavy is None or tail is None:
        raise AssertionError("the large batch must reach both stages")
    g_row, base = gather_row(engine, heavy, len(batch))
    s_row, _ = scatter_row(engine, base, tail)
    del base
    for row in (g_row, s_row):
        log(f"{row['name']} (float mode): within tolerance of plain; {json.dumps(row)}")
    out["kernels"] = {"gather_rows": g_row, "scatter_scores": s_row}
    # where the engine's heavy stage goes at this small shape: 20 calls of
    # its route (the table's one upload, then the kernel) under the
    # profiler; nothing else may run on the card
    from improving_learned_index_tpu_torch.ops import gather_rows as gr

    host_table = heavy.cpu()
    prof = profile_window(lambda: [gr.accumulate_grouped(engine.dense, host_table.to(dev), len(batch))
                                   for _ in range(20)])
    out["gather_profile"] = dict(prof, calls=20)
    log(json.dumps({"gather_rows_fp32_profile": out["gather_profile"]}))
    others = [k for k in prof["top_kernels"]
              if "gather_grouped" not in k["kernel"] and "HtoD" not in k["kernel"]]
    if others:
        raise AssertionError(f"the heavy stage ran other device work: {others}")

    # the hybrid rows against the device engine's on the same impacts
    device = DeviceSearchEngine.from_term_impacts(by_name["large"], device=dev)
    hybrid_rows, device_rows = engine.score_batch(batch, 1000), device.score_batch(batch, 1000)
    swaps = sum(float_rows_close(h, d) for h, d in zip(hybrid_rows, device_rows))
    log(f"large: the hybrid float rows equal DeviceSearchEngine's ({swaps} near-tie swaps)")
    out["hybrid_vs_device_near_tie_swaps"] = swaps
    engine.release()
    del engine, engines, device, spies, by_name
    torch.cuda.empty_cache()

    # short_attention at the eval's packed shape: the first packed batch of
    # a cfg.batch-document encode of the nano corpus
    with open(beir / "nano" / "corpus.jsonl", encoding="utf-8") as f:
        corpus = [json.loads(line)["text"] for line in islice(f, cfg.batch)]
    encs = [tok.process_document(p) for p in corpus]
    total = sum(sum(e.attention_mask) for e in encs)
    rows = min(-(-int(total * 1.18) // ENCODE.max_length), len(encs))
    seg = next(iter(pack_documents(encs, ENCODE.max_length, rows))).segment_ids
    rng = np.random.default_rng(cfg.seed)
    hd = config.hidden_size // config.num_heads
    q, k, v = (torch.from_numpy(rng.standard_normal((seg.shape[0], seg.shape[1], config.num_heads, hd),
                                                   dtype=np.float32) * 1.5).to(dev, torch.bfloat16)
               .permute(0, 2, 1, 3) for _ in range(3))
    seg_t = torch.from_numpy(seg).to(dev)
    got = sa.short_attention(q, k, v, seg_t, hd ** -0.5, True)
    want = sa.short_attention_plain(q, k, v, seg_t, hd ** -0.5, True)
    err, peak = float((got.float() - want.float()).abs().max()), float(want.float().abs().max())
    tol = 2 * 2.0 ** (np.floor(np.log2(peak)) - 7)
    if not err <= tol:
        raise AssertionError(f"short_attention at the eval's packed shape: {err} > {tol}")
    log(f"short_attention at the eval's packed shape {list(q.shape)}: max abs err {err} <= {tol}")
    out["attention_check"] = {"q": list(q.shape), "max_abs_err": err, "tolerance": tol}
    del q, k, v, got, want
    # where an eval encode call's time goes: 2 calls of cfg.batch documents
    # as SparseSearch makes them, under the profiler
    prof = profile_window(lambda: [model.get_impact_scores_batch_packed(corpus) for _ in range(2)])
    out["encode_profile"] = dict(prof, calls=2, docs_a_call=len(corpus))
    log(json.dumps({"eval_encode_profile": out["encode_profile"]}))
    del model

    for name in names:
        d = per_dataset[name]
        sp = d["split_s"]
        encode_s = sp["get_impact_scores_batch_packed"]
        d.update(docs=n_docs[name], encode_docs_per_s=n_docs[name] / encode_s,
                 ndcg10=metrics[name][0]["NDCG@10"],
                 breakdown_s={"load": d["eval_s"] - sp["search"] - sp["trec_evaluate"],
                              "encode": encode_s, "engine_build": sp["_build_index"] - encode_s,
                              "query": sp["search"] - sp["_build_index"],
                              "metrics": sp["trec_evaluate"]})
        del d["split_s"]
        log(f"{name}: {json.dumps(d)}")
    out["datasets"] = per_dataset

    # in-training eval: cli.train packed at phase 8's set-up
    ck = workdir / "ckpt_eval"
    spies = Spies()
    spies.wrap(DeepImpact, "encode_packed")
    try:
        for kern in kernels:
            kern.calls.clear()
        t0 = time.perf_counter()
        train_main([a for a in train_args if a != "--no_beir_eval"] + [
            "--checkpoint_dir", str(ck), "--total_steps", str(cfg.train_steps),
            "--save_every", "1000000", "--nano_beir_dir", str(beir), "--eval_datasets", "nano",
            "--eval_every", str(cfg.eval_every)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        spies.restore()
    launches = {kern.name: kern.launches for kern in kernels}
    steps = train_metrics(ck, cfg.train_steps, 10**6)
    records = [json.loads(line) for line in (ck / "metrics.txt").read_text().splitlines()]
    evals = [r for r in records if "eval_stall_seconds" in r]
    want_iters = list(range(0, cfg.train_steps, cfg.eval_every))
    if [r["iteration"] for r in evals] != want_iters or set(evals[0]["metrics"]) != {"nano", "avg"}:
        raise AssertionError(f"in-training eval records {[(r['iteration'], sorted(r['metrics'])) for r in evals]}")
    train_attn, eval_attn = config.num_layers * cfg.train_steps, config.num_layers * spies.calls["encode_packed"]
    if launches["short_attention"] != train_attn + eval_attn or eval_attn == 0:
        raise AssertionError(f"cli.train with eval: short_attention launched {launches['short_attention']}, "
                             f"want {train_attn} (training) + {eval_attn} (eval encodes)")
    out["train_eval"] = {"wall_s": wall, "launches": launches, "short_attention_training": train_attn,
                         "short_attention_eval": eval_attn, "losses": steps["losses"],
                         "step_s": steps["step_s"], "first_two_steps_s": steps["first_two_steps_s"],
                         "eval_stall_s": [r["eval_stall_seconds"] for r in evals],
                         "ndcg10": [r["metrics"]["nano"][0]["NDCG@10"] for r in evals]}
    log(f"cli.train with in-training eval: {json.dumps(out['train_eval'])}")
    shutil.rmtree(ck, ignore_errors=True)
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 9 in {out['phase_s']:.1f} s")
    return out


# -- rerankers ------------------------------------------------------------------------


def read_run(path: Path) -> dict:
    """A run file as {qid: [(pid, score), ...]} in file order."""
    out = {}
    with open(path, encoding="utf-8") as f:
        for line in f:
            qid, pid, _, score = line.rstrip("\n").split("\t")
            out.setdefault(qid, []).append((pid, float(score)))
    return out


def runs_close(got: dict, want: dict, tol_max: float, tol_mean: float, what: str) -> dict:
    """Two routes' run files over the same candidates: each query's scores
    within ``tol_max`` (their mean difference within ``tol_mean``), and its
    order the same except where a position holds two candidates whose
    ``want`` scores lie within twice the query's largest difference (a
    near-tie, which the routes' rounding may swap; counted)."""
    if got.keys() != want.keys():
        raise AssertionError(f"{what}: queries {sorted(got)[:5]}... against {sorted(want)[:5]}...")
    diffs, swaps = [], 0
    for qid, rows in want.items():
        score = dict(rows)
        if sorted(p for p, _ in got[qid]) != sorted(score):
            raise AssertionError(f"{what}: query {qid} has other candidates")
        d = [abs(s - score[p]) for p, s in got[qid]]
        diffs.extend(d)
        for (gp, _), (wp, _) in zip(got[qid], rows):
            if gp != wp:
                if abs(score[gp] - score[wp]) > 2 * max(d):
                    raise AssertionError(f"{what}: query {qid}: {gp} in place of {wp} without a near-tie")
                swaps += 1
    d = np.asarray(diffs)
    out = {"max": float(d.max()), "mean": float(d.mean()), "pairs": len(diffs), "near_tie_swaps": swaps}
    if out["max"] > tol_max or out["mean"] > tol_mean:
        raise AssertionError(f"{what}: score differences {out} beyond {tol_max} / {tol_mean}")
    return out


def run_rerank(cfg, workdir: Path, ckpt: Path) -> dict:
    """Phase 10: the rerankers on the card at BERT-base width, S=256."""
    from improving_learned_index_tpu_torch.cli import cross_encoder_rerank as cross_cli
    from improving_learned_index_tpu_torch.cli import rerank as rerank_cli
    from improving_learned_index_tpu_torch.cli.train import main as train_main
    from improving_learned_index_tpu_torch.core.checkpoint import load_params
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig, TrainConfig
    from improving_learned_index_tpu_torch.data.datasets import (
        MSMarcoTriples, QueryRelevanceDataset, TopKDataset,
    )
    from improving_learned_index_tpu_torch.evaluation import CrossEncoderReRanker, Metrics, ReRanker
    from improving_learned_index_tpu_torch.index.indexer import Indexer
    from improving_learned_index_tpu_torch.models import (
        DeepImpact, DeepImpactCrossEncoder, DeepPairwiseImpact, load_hf_checkpoint,
    )
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.text.processor import batch_arrays
    from improving_learned_index_tpu_torch.train import COLLATES, Trainer

    log("== phase 10: rerankers (cli.rerank, cli.train --cross_encoder, cli.cross_encoder_rerank, "
        "pairwise; BERT-base, S=256)")
    t_phase = time.perf_counter()
    kernels = all_kernels()
    dev = torch.device(cfg.device)
    config = EncoderConfig.bert_base()
    max_length = ENCODE.max_length
    vocab, bert = workdir / "vocab.txt", workdir / "bert"
    tok = ImpactTokenizer(WordPieceVocab.load(vocab), max_length=max_length)
    d = workdir / "rerank"
    d.mkdir()
    out, launches_by_path = {}, {}

    def launches_now():
        return {k.name: k.launches for k in kernels}

    def zero_counts():
        for k in kernels:
            k.calls.clear()

    # data: phase 9's nano dataset as TSV files, and a first-stage run of
    # each query's qrel passage and 99 seeded others, in seeded order
    beir = workdir / "beir" / "nano"
    with open(beir / "corpus.jsonl", encoding="utf-8") as f:
        corpus = [(r["_id"], r["text"]) for r in map(json.loads, f)]
    with open(beir / "queries.jsonl", encoding="utf-8") as f:
        queries = {r["_id"]: r["text"] for r in map(json.loads, f)}
    qrels = dict(line.split("\t")[:2] for line in (beir / "qrels.tsv").read_text().splitlines()[1:])
    passages = dict(corpus)
    pids = [pid for pid, _ in corpus]
    coll, qpath, qrels_path = d / "collection.tsv", d / "queries.tsv", d / "qrels.tsv"
    coll.write_text("".join(f"{pid}\t{text}\n" for pid, text in corpus), encoding="utf-8")
    qpath.write_text("".join(f"{q}\t{t}\n" for q, t in queries.items()), encoding="utf-8")
    qrels_path.write_text("".join(f"{q}\t0\t{p}\t1\n" for q, p in qrels.items()), encoding="utf-8")
    rng = np.random.default_rng(cfg.seed)
    cands = {}
    for qid in queries:
        rel = pids.index(qrels[qid])
        others = rng.choice(len(pids) - 1, cfg.candidates - 1, replace=False)
        order = rng.permutation(np.append(others + (others >= rel), rel))
        cands[qid] = [pids[i] for i in order]
    run_path, topk_path = d / "candidates.run", d / "candidates.topk.tsv"
    run_path.write_text("".join(f"{q}\t{p}\t{r}\t{cfg.candidates + 1 - r}\n"
                                for q, ps in cands.items() for r, p in enumerate(ps, 1)), encoding="utf-8")
    topk_path.write_text("".join(f"{q}\t{p}\t{queries[q]}\t{passages[p]}\n"
                                 for q, ps in cands.items() for p in ps), encoding="utf-8")
    n_pairs = len(queries) * cfg.candidates

    # 1. cli.rerank on phase 8's checkpoint, counts zeroed just before
    reranked = d / "reranked.run"
    spies = Spies()
    spies.wrap(rerank_cli, "build_model")
    spies.wrap(DeepImpact, "get_impact_scores_batch")
    spies.wrap(DeepImpact, "encode_term_scores")
    spies.wrap(ReRanker, "run", keep=lambda a, o: (a[0], o))
    try:
        zero_counts()
        t0 = time.perf_counter()
        rerank_cli.main(["--top_k_run_file_path", str(run_path), "--queries_path", str(qpath),
                         "--collection_path", str(coll), "--output_path", str(reranked),
                         "--vocab_path", str(vocab), "--max_length", str(max_length), "--checkpoint", str(ckpt),
                         "--batch_size", str(cfg.batch), "--device", cfg.device])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
    finally:
        spies.restore()
    (rr, n_queries), = spies.records["run"]
    batches = spies.calls["encode_term_scores"]
    sec = spies.seconds
    breakdown = {"build_model": sec["build_model"],
                 "tokenize_and_term_lists": sec["get_impact_scores_batch"] - sec["encode_term_scores"],
                 "encode": sec["encode_term_scores"],
                 "host_rest": wall - sec["build_model"] - sec["get_impact_scores_batch"]}
    got = read_run(reranked)
    if n_queries != len(queries) or list(got) != list(queries) or any(
            len(rows) != cfg.candidates for rows in got.values()):
        raise AssertionError(f"cli.rerank wrote {len(got)} queries ({n_queries} counted), want {len(queries)}")
    if launches["short_attention"] != config.num_layers * batches or batches == 0:
        raise AssertionError(f"cli.rerank: short_attention launched {launches['short_attention']} times, "
                             f"want {config.num_layers} x {batches} encode batches")
    launches_by_path["cli.rerank"] = launches["short_attention"]
    # its scores: fp64 sums of the impacts it encoded, its order their
    # stable descending sort (near-ties within 2e-5 relative may swap)
    swaps = 0
    for qid, ps in cands.items():
        terms = tok.process_query(queries[qid])
        sums = [(p, float(np.sum([rr.cache[p].get(t, 0.0) for t in terms], dtype=np.float64))) for p in ps]
        swaps += float_rows_close(got[qid], sorted(sums, key=lambda x: x[1], reverse=True))
    # the plain route on the same checkpoint: impacts within phase 7's
    # tolerance, the run within what those impacts add up to
    plain = DeepImpact(config, tok, state_dict=load_params(ckpt), device=cfg.device, use_kernels=False)
    rr_plain = ReRanker(plain, run_path, qpath, coll, d / "reranked.plain.run", batch_size=cfg.batch)
    rr_plain.run()
    encoded = sorted(rr.cache)
    ref = [rr_plain.cache[p] for p in encoded]
    peak = max(max(c.values(), default=0.0) for c in ref)
    tol = (0.05 * peak, 0.002 * peak)
    err = impacts_close([rr.cache[p] for p in encoded], ref, *tol, "cli.rerank's impacts vs the plain route")
    most_terms = max(len(tok.process_query(q)) for q in queries.values())
    vs_plain = runs_close(got, read_run(d / "reranked.plain.run"), most_terms * tol[0], most_terms * tol[1],
                          "cli.rerank vs the plain route")
    mrr = {"candidates": Metrics(run_path, qrels_path).evaluate()["MRR@10"],
           "reranked": Metrics(reranked, qrels_path).evaluate()["MRR@10"]}
    recall = Metrics.evaluate_recall_for_top_k(QueryRelevanceDataset(qrels_path), TopKDataset(topk_path))
    # where an encode batch's time goes: a query's 100 candidates, twice
    q0 = next(iter(queries))
    docs0 = [passages[p] for p in cands[q0]]
    profile = dict(profile_window(lambda: [rr.model.get_impact_scores_batch(docs0) for _ in range(2)]),
                   calls=2, docs_a_call=len(docs0))
    out["rerank"] = {"wall_s": wall, "pairs": n_pairs, "pairs_per_s": n_pairs / wall,
                     "pairs_per_s_after_model_build": n_pairs / (wall - sec["build_model"]),
                     "breakdown_s": breakdown, "profile": profile,
                     "encoded_docs": len(encoded), "encode_batches": batches, "launches": launches,
                     "fp64_near_tie_swaps": swaps, "impacts_vs_plain": err, "impact_tolerance": tol,
                     "vs_plain": vs_plain, "mrr10": mrr, "candidates_recall": recall}
    log(f"1. cli.rerank: {json.dumps(out['rerank'])}; scores equal fp64 sums of its impacts within 1e-5 "
        "relative")
    del rr, rr_plain, plain, spies
    torch.cuda.empty_cache()

    # 2. cli.train --cross_encoder from phase 7's seeded trunk (unpacked).
    # A random trunk's [CLS] states are nearly alike.  Through the seeded
    # head every [CLS] score lies below 0 (on an H100: -1.82 +- 0.11 on the
    # first training batch, -2.10 +- 0.050 on the first query's
    # candidates), so the ReLU would zero every score and gradient, and the
    # routes' bf16 differences are as large as that spread.  So the head is
    # rebuilt from the trunk: its weight the direction in which the first
    # query's 100 candidates' [CLS] states vary most, scaled to unit spread
    # of their scores; its bias puts the lowest score of those candidates
    # and of the first training batch at 1, so no score sits at the ReLU's
    # knee.  Training starts from that checkpoint.
    tq, tt, tc = workdir / "train_queries.tsv", workdir / "triples.tsv", workdir / "collection.tsv"
    dataset = MSMarcoTriples(tt, tq, tc)
    model = DeepImpactCrossEncoder(config, tok, state_dict=load_hf_checkpoint(bert, config), device=cfg.device)
    trainer = Trainer(model, TrainConfig(batch_size=cfg.ce_groups, loss="cross_encoder", save_every=10**9,
                                         eval_every=10**9), d / "ckpt_check")
    batch = COLLATES["cross_encoder"]([dataset[i] for i in range(cfg.ce_groups)], tok, max_length)
    put = trainer._put_batch(batch)
    q0 = next(iter(queries))
    sample = batch_arrays(model.process_cross_encoder_documents_and_query(
        [passages[p] for p in cands[q0]], queries[q0]))
    head = model.module.impact_head.dense
    with torch.no_grad():
        states = {}
        for name, arrays in (("training batch", put), ("first query's candidates", sample)):
            ids = [torch.as_tensor(arrays[k]).to(dev) for k in ("input_ids", "attention_mask", "type_ids")]
            states[name] = model.module.encoder(*ids)[:, 0, :]
        seeded = {k: head(v)[:, 0] for k, v in states.items()}
        cand = states["first query's candidates"]
        w = torch.linalg.svd(cand - cand.mean(0), full_matrices=False).Vh[0]
        w = w / (cand @ w).std()
        low = min(float((v @ w).min()) for v in states.values())
        head.weight.copy_(w[None])
        head.bias.fill_(1.0 - low)
        rebuilt = {k: head(v)[:, 0] for k, v in states.items()}
    ce_init = d / "cross_encoder_init.pt"
    model.save(ce_init)
    check1 = {"rows": int(batch["input_ids"].shape[0]),
              "seeded_head_mean_std": {k: [float(v.mean()), float(v.std())] for k, v in seeded.items()},
              "rebuilt_head_mean_std_min": {k: [float(v.mean()), float(v.std()), float(v.min())]
                                            for k, v in rebuilt.items()},
              **kernel_vs_plain_step(model.module, "cross_encoder", put)}
    log(f"2. cross-encoder kernel route vs plain route on one batch: {json.dumps(check1)}")
    del model, trainer, batch, put, states, cand
    torch.cuda.empty_cache()
    train_common = ["--dataset_path", str(tt), "--queries_path", str(tq), "--collection_path", str(tc),
                    "--vocab_path", str(vocab), "--max_length", str(max_length),
                    "--no_beir_eval", "--device", cfg.device, "--save_every", "1000000"]
    ck = d / "ckpt_ce"
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    train_main(train_common + ["--cross_encoder", "--checkpoint", str(ce_init), "--checkpoint_dir", str(ck),
                               "--batch_size", str(cfg.ce_groups), "--total_steps", str(cfg.ce_steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launches_now()
    if launches["short_attention"] != config.num_layers * cfg.ce_steps:
        raise AssertionError(f"cli.train --cross_encoder: short_attention launched {launches['short_attention']} "
                             f"times, want {config.num_layers} x {cfg.ce_steps} forwards")
    launches_by_path["cli.train --cross_encoder"] = launches["short_attention"]
    final = ck / "DeepImpactCrossEncoder_final.pt"
    if not final.exists():
        raise AssertionError("cli.train --cross_encoder wrote no DeepImpactCrossEncoder_final.pt")
    ce = dict(train_metrics(ck, cfg.ce_steps, 10**6), wall_s=wall, launches=launches,
              peak_gb=torch.cuda.max_memory_allocated() / 2**30, kernel_vs_plain=check1)
    ce["steady_docs_per_s"] = ce["steady_steps_per_s"] * 2 * cfg.ce_groups
    out["train_cross_encoder"] = ce
    log(f"2. cli.train --cross_encoder: {json.dumps(ce)}")
    torch.cuda.empty_cache()

    # 3. cli.cross_encoder_rerank on that snapshot, counts zeroed just before
    ce_queries = list(queries)[: cfg.ce_queries]
    ce_topk, ce_run = d / "ce.topk.tsv", d / "ce_reranked.run"
    ce_topk.write_text("".join(f"{q}\t{p}\t{queries[q]}\t{passages[p]}\n" for q in ce_queries for p in cands[q]),
                       encoding="utf-8")
    spies = Spies()
    spies.wrap(cross_cli, "build_model")
    spies.wrap(DeepImpactCrossEncoder, "process_cross_encoder_documents_and_query")
    spies.wrap(DeepImpactCrossEncoder, "score_batch")
    spies.wrap(CrossEncoderReRanker, "run", keep=lambda a, o: a[0])
    try:
        zero_counts()
        t0 = time.perf_counter()
        cross_cli.main(["--top_k_path", str(ce_topk), "--collection_path", str(coll),
                        "--output_path", str(ce_run), "--vocab_path", str(vocab),
                        "--max_length", str(max_length), "--checkpoint", str(final),
                        "--batch_size", str(cfg.ce_batch), "--device", cfg.device])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = launches_now()
    finally:
        spies.restore()
    calls = spies.calls["score_batch"]
    sec = spies.seconds
    breakdown = {"build_model": sec["build_model"],
                 "tokenize": sec["process_cross_encoder_documents_and_query"],
                 "score_batch": sec["score_batch"],
                 "host_rest": wall - sec["build_model"] - sec["score_batch"]
                 - sec["process_cross_encoder_documents_and_query"]}
    ce_rr, = spies.records["run"]
    profile = dict(profile_window(lambda: [ce_rr.rerank(q) for q in ce_queries[:2]]), queries=2)
    del ce_rr
    want_calls = len(ce_queries) * -(-cfg.candidates // cfg.ce_batch)
    if calls != want_calls or launches["short_attention"] != config.num_layers * calls:
        raise AssertionError(f"cli.cross_encoder_rerank: short_attention launched {launches['short_attention']} "
                             f"times in {calls} batches, want {config.num_layers} x {want_calls}")
    launches_by_path["cli.cross_encoder_rerank"] = launches["short_attention"]
    got = read_run(ce_run)
    plain = DeepImpactCrossEncoder(config, tok, state_dict=load_params(final), device=cfg.device, use_kernels=False)
    CrossEncoderReRanker(plain, ce_topk, coll, d / "ce_reranked.plain.run", batch_size=cfg.ce_batch).run()
    want = read_run(d / "ce_reranked.plain.run")
    spread = float(np.std([s for rows in want.values() for _, s in rows]))
    if spread == 0:
        raise AssertionError("cli.cross_encoder_rerank: every candidate scores alike on the plain route")
    # The routes' [CLS] states differ by bf16 roundings, which the rebuilt
    # head reads along the direction of the candidates' largest spread.
    # Tolerance, relative to the spread of the plain route's scores (1 on
    # the first query by the head's construction): every score within half
    # of it, the mean difference within a tenth.  A wrong mask or scale
    # moves the [CLS] states by far more than their spread.  (Phase 7's
    # rule, relative to the largest score, does not fit here: the scores
    # sit ~5 above 0, and the bf16 differences scale with the head's weight
    # rather than with the scores: on an H100 the mean difference was 0.0214
    # against that rule's 0.0137.)
    tol = (0.5 * spread, 0.1 * spread)
    vs_plain = runs_close(got, want, *tol, "cli.cross_encoder_rerank vs the plain route")
    n_ce = len(ce_queries) * cfg.candidates
    out["cross_encoder_rerank"] = {
        "wall_s": wall, "pairs": n_ce, "pairs_per_s": n_ce / wall,
        "pairs_per_s_after_model_build": n_ce / (wall - sec["build_model"]), "breakdown_s": breakdown,
        "profile": profile, "batches": calls, "launches": launches,
        "vs_plain": vs_plain, "tolerance": tol, "plain_score_spread": spread,
        "exact_zero_scores": sum(s == 0.0 for rows in got.values() for _, s in rows)}
    log(f"3. cli.cross_encoder_rerank: {json.dumps(out['cross_encoder_rerank'])}")
    del plain, spies
    torch.cuda.empty_cache()

    # 4. pairwise: phase 7's trunk with a seeded pair head; cli.train
    # --pairwise (unpacked) and the Indexer's pairwise route
    ck_pw = d / "ckpt_pw"
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    t0 = time.perf_counter()
    train_main(train_common + ["--pairwise", "--hf_name", str(bert), "--checkpoint_dir", str(ck_pw),
                               "--batch_size", str(cfg.pw_groups), "--total_steps", str(cfg.pw_steps)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    train_pw = launches_now()
    if not (ck_pw / "DeepPairwiseImpact_final.pt").exists():
        raise AssertionError("cli.train --pairwise wrote no DeepPairwiseImpact_final.pt")
    pw = train_metrics(ck_pw, cfg.pw_steps, 10**6)
    pw = {"wall_s": wall, "losses": pw["losses"], "step_s": pw["step_s"],
          "docs_per_s_last_step": 2 * cfg.pw_groups / pw["step_s"][-1], "launches": train_pw,
          "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    torch.cuda.empty_cache()
    with open(tc, encoding="utf-8") as f:
        head = [line.rstrip("\n").split("\t", 1)[1] for line in islice(f, cfg.pw_index_docs)]
    head_path, fwd = d / "pairwise_head.tsv", d / "forward.pairwise.txt"
    head_path.write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(head)), encoding="utf-8")
    trunk = load_hf_checkpoint(bert, config)
    model = DeepPairwiseImpact(config, tok, state_dict=trunk, device=cfg.device)
    zero_counts()
    t0 = time.perf_counter()
    Indexer(model, IndexConfig(max_length=max_length, max_terms=max_length,
                               model_batch_size=cfg.pw_batch)).index_to_file(head_path, fwd)
    torch.cuda.synchronize()
    index_wall = time.perf_counter() - t0
    index_pw = launches_now()
    for what, counts in (("cli.train --pairwise", train_pw), ("the pairwise Indexer", index_pw)):
        if counts["short_attention"] != 0:
            raise AssertionError(f"{what} launched short_attention {counts['short_attention']} times: "
                                 "the attention maps route takes the plain attention")
    launches_by_path["cli.train --pairwise"] = launches_by_path["Indexer (pairwise)"] = 0
    docs = parse_forward(fwd)
    composite = sum("|" in t for doc in docs for t in doc)
    if len(docs) != len(head) or composite == 0:
        raise AssertionError(f"pairwise forward index: {len(docs)} docs, {composite} composite terms")
    # the single-term impacts against DeepImpact on the same trunk: through
    # the same plain attention route and batches, equal (the pair head does
    # not touch them); against its kernel route, within phase 7's tolerance
    def batched(m):
        return [doc for i in range(0, len(head), cfg.pw_batch)
                for doc in m.get_impact_scores_batch(head[i : i + cfg.pw_batch])]

    single = [{t: v for t, v in doc if "|" not in t} for doc in batched(model)]
    del model
    plain_config = dataclasses.replace(config, use_short_attention=False)
    errs = {}
    for route, m in (("plain", DeepImpact(plain_config, tok, state_dict=trunk, device=cfg.device)),
                     ("kernel", DeepImpact(config, tok, state_dict=trunk, device=cfg.device))):
        ref = [dict(doc) for doc in batched(m)]
        if any(g.keys() != w.keys() for g, w in zip(single, ref)):
            raise AssertionError(f"pairwise single terms differ from DeepImpact's ({route} route)")
        peak = max(max(w.values(), default=0.0) for w in ref)
        tol = (1e-5 * peak, 1e-6 * peak) if route == "plain" else (0.05 * peak, 0.002 * peak)
        errs[route] = dict(impacts_close([{t: g[t] for t in w} for g, w in zip(single, ref)], ref, *tol,
                                         f"pairwise single terms vs DeepImpact's {route} route"), tolerance=tol)
        del m
    pw["index"] = {"docs": len(docs), "wall_s": index_wall, "docs_per_s": len(docs) / index_wall,
                   "terms": sum(map(len, docs)), "composite_terms": composite, "launches": index_pw,
                   "single_vs_deep_impact": errs}
    out["pairwise"] = pw
    log(f"4. pairwise: {json.dumps(pw)}")
    torch.cuda.empty_cache()
    out["launches"] = launches_by_path
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"phase 10 in {out['phase_s']:.1f} s")
    return out


# -- index lifecycle ---------------------------------------------------------------


def files_equal(a: Path, b: Path, chunk: int = 64 << 20) -> bool:
    """Byte equality of two files, read in chunks."""
    if a.stat().st_size != b.stat().st_size:
        return False
    with open(a, "rb") as fa, open(b, "rb") as fb:
        while True:
            x, y = fa.read(chunk), fb.read(chunk)
            if x != y:
                return False
            if not x:
                return True


def same_index_files(a: Path, b: Path, what: str) -> None:
    for name in ("vocab.txt", "inverted_index.dat", "inverted_index.idx"):
        if not files_equal(a / name, b / name):
            raise AssertionError(f"{what}: {name} differs")


def run_store(cfg, workdir: Path, tol: tuple) -> dict:
    """Phase 11: the store route at BERT-base (phase 6's corpus, phase 7's
    seeded checkpoint, S=256, B=512), in the encode work directory."""
    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.cli.invert import main as invert_main
    from improving_learned_index_tpu_torch.cli.quantize import main as quantize_main
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.ops import short_attention as sa

    log("== phase 11: the store route (cli.index --store_path -> quantize -> invert; resume)")
    t_phase = time.perf_counter()
    layers = EncoderConfig.bert_base().num_layers
    coll = workdir / "collection.tsv"
    n_docs = sum(1 for _ in open(coll, encoding="utf-8"))
    common = ["--collection_path", str(coll), "--vocab_path", str(workdir / "vocab.txt"),
              "--max_length", str(ENCODE.max_length), "--model_batch_size", str(ENCODE.batch),
              "--hf_name", str(workdir / "bert"), "--device", cfg.device]
    d = workdir / "store_route"
    d.mkdir()
    fwd, store = d / "forward.txt", d / "forward.store"
    seconds, launches = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    # 1. both outputs in one encode
    sa.KERNEL.calls.clear()
    timed("cli_index", lambda: index_main(common + ["--output_file_path", str(fwd), "--store_path", str(store)]))
    launches["cli.index --store_path"] = sa.KERNEL.launches
    want = layers * -(-n_docs // ENCODE.batch)
    if sa.KERNEL.launches != want:
        raise AssertionError(f"short_attention launched {sa.KERNEL.launches} times, want {want}")

    # 2. the same term lists as phase 7's forward index, impacts within its tolerance
    docs = parse_forward(fwd)
    err7 = impacts_close(docs, parse_forward(workdir / "forward.txt"), *tol, "store-route text vs phase 7")
    with open(fwd, "rb") as fa, open(workdir / "forward.txt", "rb") as fb:
        equal_lines = sum(x == y for x, y in zip(fa, fb))
    log(f"cli.index --store_path: {n_docs} passages in {seconds['cli_index']:.1f} s, {sa.KERNEL.launches} "
        f"launches; against phase 7's forward index {equal_lines} of {n_docs} lines byte-equal, {err7}")

    # 3. the store route and the text route to the final index
    qs, qt, inv_s = d / "forward.q.store", d / "forward.q.from_store.txt", d / "index_store"
    qf, inv_t = d / "forward.q.txt", d / "index_text"
    timed("store_quantize", lambda: quantize_main(["-i", str(store), "-o", str(qs), "--text_out", str(qt)]))
    timed("store_invert", lambda: invert_main(["-i", str(qs), "-o", str(inv_s)]))
    timed("text_quantize", lambda: quantize_main(["-i", str(fwd), "-o", str(qf)]))
    timed("text_invert", lambda: invert_main(["-i", str(qf), "-o", str(inv_t)]))
    if not files_equal(qt, qf):
        raise AssertionError("the store's quantized text differs from cli.quantize's")
    same_index_files(inv_s, inv_t, "store route vs text route")
    routes = {"store_s": seconds["store_quantize"] + seconds["store_invert"],
              "text_s": seconds["text_quantize"] + seconds["text_invert"]}
    log(f"quantize + invert: store route {routes['store_s']:.2f} s, text route {routes['text_s']:.2f} s "
        f"(x{routes['text_s'] / routes['store_s']:.1f}); quantized text and the three index files byte-equal")

    # 4. crash and resume: copies cut at seeded points past the middle, the
    # store's three .bin files mid-record, the text mid-line elsewhere
    rng = np.random.default_rng(cfg.seed)
    counts = np.fromfile(store / "counts.bin", np.int32)
    cum = np.concatenate(([0], np.cumsum(counts, dtype=np.int64)))
    cut_store = int(rng.choice(np.flatnonzero(counts[n_docs // 2 : n_docs - 1] >= 2))) + n_docs // 2
    cut_text = int(rng.integers(n_docs // 2, n_docs - 1))
    while cut_text == cut_store:
        cut_text = int(rng.integers(n_docs // 2, n_docs - 1))
    s2, f2 = d / "crash.store", d / "crash.txt"
    shutil.copytree(store, s2)
    shutil.copyfile(fwd, f2)
    (s2 / "meta.json").unlink()  # a writer that never closed left none
    # counts past the cut doc, its postings torn: cut_store docs survive
    os.truncate(s2 / "counts.bin", 4 * (cut_store + 1) + 2)
    os.truncate(s2 / "term_ids.bin", 4 * (cum[cut_store] + 1) + 3)
    os.truncate(s2 / "values.bin", 4 * cum[cut_store + 1] - 1)
    with open(fwd, "rb") as f:
        line_end = sum(len(next(f)) for _ in range(cut_text))
    os.truncate(f2, line_end + 7)
    resume_at = min(cut_store, cut_text)
    sa.KERNEL.calls.clear()
    timed("cli_index_resume", lambda: index_main(
        common + ["--output_file_path", str(f2), "--store_path", str(s2), "--resume"]))
    launches["cli.index --store_path --resume"] = sa.KERNEL.launches
    want = layers * -(-(n_docs - resume_at) // ENCODE.batch)
    if sa.KERNEL.launches != want:
        raise AssertionError(f"resume from {resume_at}: short_attention launched {sa.KERNEL.launches} "
                             f"times, want {want}")
    # text: the first resume_at lines byte-equal, the rest within tolerance
    with open(f2, "rb") as fa, open(fwd, "rb") as fb:
        head_equal = all(next(fa) == next(fb) for _ in range(resume_at))
    if not head_equal:
        raise AssertionError("resumed text: the surviving lines changed")
    err_text = impacts_close(parse_forward(f2)[resume_at:], docs[resume_at:], *tol, "resumed text")
    # store: term lists (counts, term ids, vocab) byte-equal; values equal
    # for the first resume_at documents, the rest within tolerance
    for name in ("counts.bin", "term_ids.bin", "vocab.txt", "meta.json", "format.json"):
        if not files_equal(s2 / name, store / name):
            raise AssertionError(f"resumed store: {name} differs from the uninterrupted run's")
    v_got, v_want = np.fromfile(s2 / "values.bin", np.int32), np.fromfile(store / "values.bin", np.int32)
    head = int(cum[resume_at])
    if not np.array_equal(v_got[:head], v_want[:head]):
        raise AssertionError("resumed store: the surviving documents' values changed")
    dv = np.abs(v_got[head:].astype(np.int64) - v_want[head:]) / 1000.0
    err_store = {"max": float(dv.max(initial=0.0)), "mean": float(dv.mean()) if dv.size else 0.0}
    if err_store["max"] > tol[0] + 1e-3 or err_store["mean"] > tol[1] + 1e-3:
        raise AssertionError(f"resumed store: impact differences {err_store} beyond {tol}")
    log(f"cli.index --resume: store cut at doc {cut_store} (mid-record), text at doc {cut_text} (mid-line); "
        f"resumed at {resume_at} in {seconds['cli_index_resume']:.1f} s, {sa.KERNEL.launches} launches; "
        f"both outputs have the uninterrupted run's term lists, the first {resume_at} documents byte-equal, "
        f"the rest within tolerance (text {err_text}, store {err_store})")
    shutil.rmtree(d)
    out = {"seconds": seconds, "routes": routes, "launches": launches, "equal_lines_vs_phase7": equal_lines,
           "vs_phase7": err7, "resume": {"store_cut": cut_store, "text_cut": cut_text, "at": resume_at,
                                         "text": err_text, "store": err_store},
           "phase_s": time.perf_counter() - t_phase}
    log(f"phase 11 in {out['phase_s']:.1f} s")
    return out


def spawn_daemon(args: list, log_path: Path):
    """Start ``cli.serve`` in a process of its own, its output copied to
    ``log_path``; returns (process, queue that gets its ``card memory``
    line and then the port from its ``serving ... on host:port`` line, or
    None at its end)."""
    proc = subprocess.Popen(
        [sys.executable, "-u", "-m", "improving_learned_index_tpu_torch.cli.serve", *args],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    found = queue.Queue()

    def pump():
        with open(log_path, "w") as log_file:
            for line in proc.stdout:
                log_file.write(line)
                log_file.flush()
                if line.startswith("card memory: "):
                    found.put(line[len("card memory: "):].strip())
                if line.startswith("serving ") and " on " in line:
                    found.put(int(line.rsplit(":", 1)[1]))
        found.put(None)

    threading.Thread(target=pump, daemon=True).start()
    return proc, found


def daemon_port(proc, found, log_path: Path, timeout: float = 600.0) -> tuple:
    """(port, its ``card memory`` line or None) once the daemon serves."""
    memory, port = None, None
    deadline = time.perf_counter() + timeout
    while True:
        try:
            item = found.get(timeout=max(deadline - time.perf_counter(), 0.001))
        except queue.Empty:
            item = None
        if isinstance(item, str):
            memory = item
            continue
        port = item
        break
    if port is None:
        proc.kill()
        proc.wait()
        raise AssertionError(f"cli.serve never came up:\n{log_path.read_text()[-3000:]}")
    return port, memory


def request(port: int, req: dict, timeout: float = 120.0) -> dict:
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as sock:
        sock.sendall((json.dumps(req) + "\n").encode())
        return json.loads(sock.makefile("rb").readline())


def stream_queries(port: int, qids: list, qtext: list, clients: int, k: int, on_answer=None) -> dict:
    """``clients`` connections, each sending single ``{"id", "query", "k"}``
    requests and waiting for each answer (closed loop) from a shared list of
    query ids.  Returns {qid: [answers]}, per-request latencies (ms), each
    answer's ``perf_counter`` time, the start time and the wall seconds."""
    todo = queue.Queue()
    for qi in qids:
        todo.put(qi)
    answers, lat, done_at, errors = {}, [], [], []
    lock = threading.Lock()

    def client():
        try:
            with socket.create_connection(("127.0.0.1", port), timeout=900) as sock:
                f = sock.makefile("rb")
                while True:
                    try:
                        qi = todo.get_nowait()
                    except queue.Empty:
                        return
                    t0 = time.perf_counter()
                    sock.sendall((json.dumps({"id": qi, "query": qtext[qi], "k": k}) + "\n").encode())
                    resp = json.loads(f.readline())
                    t1 = time.perf_counter()
                    with lock:
                        answers.setdefault(resp.get("id"), []).append(resp)
                        lat.append((t1 - t0) * 1e3)
                        done_at.append(t1)
                    if on_answer is not None:
                        on_answer()
        except Exception as e:  # noqa: BLE001 -- reported below
            with lock:
                errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, daemon=True) for _ in range(clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1800)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"query clients failed: {errors[:3]}")
    return {"answers": answers, "latency_ms": lat, "done_at": done_at, "t0": t0, "wall_s": wall}


def latency_summary(stream: dict, n: int) -> dict:
    lat = np.asarray(stream["latency_ms"])
    return {"queries": n, "qps": n / stream["wall_s"], "wall_s": stream["wall_s"],
            "p50_ms": float(np.percentile(lat, 50)), "p99_ms": float(np.percentile(lat, 99))}


# a served batch's breakdown: the first 64 queries in batches of 8, the
# size 8 closed-loop connections give the daemons
BREAKDOWN_QUERIES, BREAKDOWN_BATCH = 64, 8


def served_batch_rows(engine, sets: list, what: str) -> list:
    """The three query kernels against their plain versions on a served
    batch of 8 (the first ``BREAKDOWN_BATCH`` queries, un-padded, as the
    daemons' batch threads stage them) on ``engine``, exactly as phase 3
    holds them on its batch of 64."""
    heavy, tail = engine.stage_inputs(sets[:BREAKDOWN_BATCH])
    if heavy is None or tail is None:
        raise AssertionError(f"{what}: the served batch must reach both stages")
    nq = min(len(sets), BREAKDOWN_BATCH)
    g_row, base = gather_row(engine, heavy, nq)
    s_row, scores = scatter_row(engine, base, tail)
    del base, heavy, tail
    c_row = count_row(scores)
    del scores
    rows = [g_row, s_row, c_row]
    log(f"{what}: a served batch of {nq}, n_pad {engine.n_pad}: gather_rows, scatter_scores and count_ge "
        f"equal to plain; " + json.dumps({r["name"]: {"ms": r["ms"], "plain_ms": r["plain_ms"],
                                                    "max_abs_err": r["max_abs_err"], "shape": r["shape"]}
                                         for r in rows}))
    return rows


def daemon_breakdown(engine, tok, qtext: list, k: int) -> dict:
    """Where a served batch's time goes in one daemon, each layer timed
    alone over the first 64 queries in batches of 8: tokenize, the
    engine's ``score_batch`` (host prep, the kernels, the top-k and its
    syncs, the result copy) with its device busy share, and the JSON of
    the answers (the server's own ``answer`` and ``encode``).  The rest of
    a request's latency is the socket, the queue and the micro-batch
    wait."""
    from improving_learned_index_tpu_torch.serve.server import answer, encode

    texts = qtext[:BREAKDOWN_QUERIES]
    t0 = time.perf_counter()
    sets = [tok.process_query(q) for q in texts]
    tokenize = time.perf_counter() - t0
    batches = [sets[i : i + BREAKDOWN_BATCH] for i in range(0, len(sets), BREAKDOWN_BATCH)]
    engine.score_batch(batches[0], k)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = [r for b in batches for r in engine.score_batch(b, k)]
    score = time.perf_counter() - t0
    t0 = time.perf_counter()
    for qi, r in enumerate(rows):
        encode(answer(qi, r, k))
    dumps = time.perf_counter() - t0
    prof = profile_window(lambda: [engine.score_batch(b, k) for b in batches[:4]])
    per = 1e3 / len(batches)
    return {"batch": BREAKDOWN_BATCH, "tokenize_ms": tokenize * per, "score_batch_ms": score * per,
            "json_dumps_ms": dumps * per, "device_ms": prof["device_ms"] / 4,
            "device_busy_share": prof["device_busy_share"],
            "top_kernels": [(t["kernel"][:60], round(t["share"], 3)) for t in prof["top_kernels"][:5]]}


def router_breakdown(spec: str, sets: list, k: int) -> dict:
    """The router's layers for a batch of 8, from this process against the
    live shard daemons: one shard's round trip alone (its queue, engine and
    JSON, the socket, this side's parse), the four at once with the merge,
    and the merge alone (the router's own ``merge`` of 4 x k rows a
    query)."""
    from improving_learned_index_tpu_torch.serve.router import RemoteShardedEngine, merge
    from improving_learned_index_tpu_torch.serve.server import answer, encode

    router = RemoteShardedEngine(spec, shard_timeout=120.0)
    try:
        batches = [sets[i : i + BREAKDOWN_BATCH] for i in range(0, len(sets), BREAKDOWN_BATCH)]
        router.score_batch(batches[0], k)
        t0 = time.perf_counter()
        parts = [router.shards[0].score_batch(b, k) for b in batches]
        one = time.perf_counter() - t0
        t0 = time.perf_counter()
        for b in batches:
            router.score_batch(b, k)
        fanout = time.perf_counter() - t0
        per_shard = [[s.score_batch(b, k) for s in router.shards] for b in batches[:2]]
        t0 = time.perf_counter()
        for shard_rows in per_shard:
            merge(shard_rows, k)
        merge_s = (time.perf_counter() - t0) / len(per_shard)
        t0 = time.perf_counter()
        for p in parts:
            for qi, r in enumerate(p):
                json.loads(encode(answer(qi, r, k)))
        loads = time.perf_counter() - t0
    finally:
        router.close()
    per = 1e3 / len(batches)
    return {"batch": BREAKDOWN_BATCH, "one_shard_round_trip_ms": one * per, "four_shards_and_merge_ms": fanout * per,
            "merge_ms": merge_s * 1e3, "json_loads_one_shard_ms": loads * per}


def as_rows(resp: dict) -> list:
    if "error" in resp or "degraded" in resp:
        raise AssertionError(f"query {resp.get('id')}: {resp}")
    return [(str(int(d)), float(s)) for d, s in resp["results"]]


def run_lifecycle(cfg, workdir: Path, inputs) -> dict:
    """Phase 12: the index algebra and serving on phase 3's index."""
    from improving_learned_index_tpu_torch.cli.filter_index import main as filter_main
    from improving_learned_index_tpu_torch.cli.merge_indexes import main as merge_main
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.cli.split_index import main as split_main
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.search.select import build_engine
    from improving_learned_index_tpu_torch.serve import RetrievalServer
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    log("== phase 12: index algebra (split, merge, filter) and serving on phase 3's index")
    t_phase = time.perf_counter()
    kernels = all_kernels()
    dev = torch.device(cfg.device)
    n_docs, n_queries, k = SMOKE.docs, len(inputs.qtext), cfg.k
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        seconds[name] = time.perf_counter() - t0
        return out

    # 1-2. split into shards, merge them back
    shards = workdir / "shards"
    timed("split", lambda: split_main(["-i", str(inputs.index_dir), "-o", str(shards), "--n_shards",
                                       str(cfg.shards), "--num_docs", str(n_docs)]))
    manifest = json.loads((shards / "shards.json").read_text())
    if [set(m) for m in manifest] != [{"path", "num_docs", "doc_offset"}] * cfg.shards \
            or sum(m["num_docs"] for m in manifest) != n_docs:
        raise AssertionError(f"bad manifest {manifest}")
    merged = workdir / "merged"
    timed("merge", lambda: merge_main(["-i", *(str(shards / m["path"]) for m in manifest), "-o", str(merged),
                                       "--num_docs", *(str(m["num_docs"]) for m in manifest)]))
    same_index_files(merged, inputs.index_dir, "merged shards vs phase 3's index")
    shutil.rmtree(merged)
    log(f"split into {cfg.shards} ({[m['num_docs'] for m in manifest]} docs) in {seconds['split']:.1f} s; "
        f"merged back in {seconds['merge']:.1f} s, byte-equal to phase 3's index")

    # 3. delete the first 64 queries' planted docs plus 1% of the docs
    rng = np.random.default_rng(cfg.seed)
    planted = [int(inputs.planted[qi]) for qi in range(cfg.planted_deletes)]
    deleted = np.union1d(rng.choice(n_docs, int(cfg.delete_share * n_docs), replace=False), planted)
    (workdir / "deleted.txt").write_text("".join(f"{x}\n" for x in deleted.tolist()))
    filtered = workdir / "filtered"
    timed("filter", lambda: filter_main(["-i", str(inputs.index_dir), "-o", str(filtered), "--delete_ids_path",
                                         str(workdir / "deleted.txt"), "--num_docs", str(n_docs)]))
    run_f = workdir / "run_filtered.tsv"
    timed("rank_filtered", lambda: rank_main([
        "--index_path", str(filtered), "--queries_path", str(inputs.qpath), "--output_path", str(run_f),
        "--vocab_path", str(inputs.vocab), "--top_k", str(k), "--device", cfg.device]))
    keep = np.ones(n_docs, bool)
    keep[deleted] = False
    old_id = np.flatnonzero(keep)  # filtered id -> phase 3 id
    ranked_f = {}
    for line in run_f.read_text().splitlines():
        qid, pid, _, score = line.split("\t")
        ranked_f.setdefault(qid, []).append((pid, float(score)))
    for qi in range(n_queries):
        got = [(str(int(old_id[int(p)])), sc) for p, sc in ranked_f.get(str(qi), [])]
        want = [(p, sc) for p, sc in inputs.ranked[str(qi)] if keep[int(p)]]
        if got[: len(want)] != want:
            raise AssertionError(f"filtered query {qi}: rows do not begin with phase 4's rows less the deleted")
        if qi < cfg.planted_deletes and str(planted[qi]) in {p for p, _ in got}:
            raise AssertionError(f"filtered query {qi}: its deleted planted doc came back")
    fidx = InvertedIndexData.load(filtered, num_docs=n_docs - len(deleted))
    tid = {t: i for i, t in enumerate(fidx.vocab)}
    for qi in rng.choice(n_queries, 4, replace=False).tolist() + [0]:
        terms = inputs.qtext[qi].split()
        want = numpy_topk(fidx.offsets, fidx.doc_ids, fidx.impacts, fidx.num_docs,
                          [tid[t] for t in terms if t in tid], k)
        if ranked_f.get(str(qi), []) != want:
            raise AssertionError(f"filtered query {qi}: run file differs from the numpy scorer")
    del fidx
    log(f"filter: {len(deleted)} docs deleted in {seconds['filter']:.1f} s; cli.rank over the filtered index "
        f"in {seconds['rank_filtered']:.1f} s: every query's rows begin with phase 4's less the deleted docs, "
        f"no planted doc of the first {cfg.planted_deletes} queries returns, 5 queries equal the numpy scorer")

    tok = ImpactTokenizer(WordPieceVocab.load(inputs.vocab))
    term_sets = [tok.process_query(q) for q in inputs.qtext[:BREAKDOWN_QUERIES]]

    # 4. the shard tier: one cli.serve process per shard, and a router;
    # this process hands its cached blocks back to the card first
    torch.cuda.empty_cache()
    log(f"this process before the daemons: {torch.cuda.memory_allocated() / 1e9:.2f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.2f} GB reserved")
    procs, logs = [], workdir / "daemon_logs"
    logs.mkdir()
    tier = {}
    try:
        t0 = time.perf_counter()
        spawned = [spawn_daemon(["--index_path", str(shards / m["path"]), "--num_docs", str(m["num_docs"]),
                                 "--port", "0", "--top_k", str(k), "--device", cfg.device,
                                 "--dense_budget_gb", str(SMOKE.dense_budget_gb), "--allow_remote_shutdown"],
                                logs / f"shard{i}.log") for i, m in enumerate(manifest)]
        shard_memory = []
        for i, (proc, found) in enumerate(spawned):
            port, memory = daemon_port(proc, found, logs / f"shard{i}.log")
            procs.append((proc, port))
            shard_memory.append(memory)
        seconds["shards_up"] = time.perf_counter() - t0
        spec = ",".join(f"127.0.0.1:{port}:{m['doc_offset']}" for (_, port), m in zip(procs, manifest))
        t0 = time.perf_counter()
        proc, found = spawn_daemon(["--shards", spec, "--vocab_path", str(inputs.vocab), "--port", "0",
                                    "--top_k", str(k), "--allow_remote_shutdown"], logs / "router.log")
        router = (proc, daemon_port(proc, found, logs / "router.log")[0])
        procs.insert(0, router)
        seconds["router_up"] = time.perf_counter() - t0
        stream = timed("shard_tier_queries", lambda: stream_queries(
            router[1], list(range(n_queries)), inputs.qtext, cfg.clients, k))
        for qi in range(n_queries):
            got = stream["answers"].get(qi, [])
            if len(got) != 1 or as_rows(got[0]) != inputs.ranked[str(qi)]:
                raise AssertionError(f"router query {qi}: the answer differs from phase 4's run file")
        tier = latency_summary(stream, n_queries)
        # each daemon's own torch counters after its warmup (nvidia-smi
        # inside a container may not attribute memory to these processes),
        # and the card's whole use with every daemon up, CUDA contexts included
        smi = subprocess.run(["nvidia-smi", "--query-gpu=memory.used", "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip() if shutil.which("nvidia-smi") else ""
        apps = subprocess.run(["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
                              capture_output=True, text=True).stdout.strip() if shutil.which("nvidia-smi") else ""
        tier["card_memory_used"] = smi or "not measured"
        tier["compute_apps"] = apps.splitlines()
        tier["shards"] = []
        for (proc, port), m, memory in zip(procs[1:], manifest, shard_memory):
            st = request(port, {"op": "stats"})
            # the shard's queries include the router's warmup batch
            tier["shards"].append({"docs": m["num_docs"], "batches": st["batches"], "queries": st["queries"],
                                   "mean_batch": st["queries"] / max(st["batches"], 1),
                                   "card_memory": memory or "not printed"})
        tier["router_stats"] = request(router[1], {"op": "stats"})
        tier["breakdown"] = router_breakdown(spec, term_sets, k)
        for proc, port in procs:
            if request(port, {"op": "shutdown"}) != {"op": "bye"}:
                raise AssertionError(f"daemon on port {port} refused the shutdown")
            if proc.wait(timeout=120) != 0:
                raise AssertionError(f"daemon on port {port} exited {proc.returncode}")
        log(f"shard tier (4 cli.serve shard processes and a router on ONE card, standing in for four "
            f"hosts): {n_queries} queries over {cfg.clients} connections, k={k}, every answer equal to "
            f"phase 4's rows; {json.dumps(tier)}")
        log("the shard daemons' kernel launches happen in their own processes: this process cannot count them")
    finally:
        for proc, _ in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()

    # the kernels at a shard daemon's shape: shard 0's engine as cli.serve
    # builds it, on a served batch of 8
    budget = int(SMOKE.dense_budget_gb * (1 << 30))
    shard_engine = build_engine(shards / manifest[0]["path"], dense_budget_bytes=budget, device=dev,
                                num_docs=manifest[0]["num_docs"])
    checks = {f"shard 0 engine ({manifest[0]['num_docs']} docs)":
              served_batch_rows(shard_engine, term_sets, "shard 0's engine")}
    del shard_engine

    # 5. one daemon in process, a staged hot swap to the filtered index midway
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = timed("engine_build", lambda: build_engine(inputs.index_dir, dense_budget_bytes=budget, device=dev))
    torch.cuda.synchronize()
    build_peak = torch.cuda.max_memory_allocated() - base
    engine.warmup(max_batch=64, top_k=k)
    torch.cuda.synchronize()
    steady = torch.cuda.memory_allocated() - base
    srv = RetrievalServer(engine, tokenizer=tok, top_k=k, max_batch=64, max_wait_ms=5.0)
    del engine  # the server holds the only reference: the staged swap frees it
    srv.start()
    try:
        for kern in kernels:
            kern.calls.clear()
        torch.cuda.reset_peak_memory_stats()
        answered = threading.Semaphore(0)
        swap = {}

        def do_swap():
            for _ in range(n_queries // 2):
                answered.acquire()
            torch.cuda.synchronize()
            swap["serve_peak"] = torch.cuda.max_memory_allocated() - base
            torch.cuda.reset_peak_memory_stats()
            swap["t0"] = time.perf_counter()
            srv.swap_engine_staged(lambda: build_engine(filtered, dense_budget_bytes=budget, device=dev,
                                                        num_docs=n_docs - len(deleted)))
            torch.cuda.synchronize()
            swap["t1"] = time.perf_counter()
            swap["s"] = swap["t1"] - swap["t0"]
            swap["peak"] = torch.cuda.max_memory_allocated() - base

        swapper = threading.Thread(target=do_swap, daemon=True)
        swapper.start()
        stream = timed("swap_queries", lambda: stream_queries(
            srv.port, list(range(n_queries)), inputs.qtext, cfg.clients, k, on_answer=answered.release))
        swapper.join(timeout=900)
        if "peak" not in swap:
            raise AssertionError("the staged swap did not finish")
        launches = {kern.name: kern.launches for kern in kernels}
        counts = {"old": 0, "new": 0}
        for qi in range(n_queries):
            got = stream["answers"].get(qi, [])
            if len(got) != 1:
                raise AssertionError(f"hot swap: query {qi} answered {len(got)} times")
            rows = as_rows(got[0])
            if rows == inputs.ranked[str(qi)]:
                counts["old"] += 1
            elif rows == ranked_f.get(str(qi), []):
                counts["new"] += 1
            else:
                raise AssertionError(f"hot swap: query {qi} equals neither phase 4's nor the filtered rows")
        again = stream_queries(srv.port, list(range(cfg.planted_deletes)), inputs.qtext, cfg.clients, k)
        for qi in range(cfg.planted_deletes):
            if as_rows(again["answers"][qi][0]) != ranked_f.get(str(qi), []):
                raise AssertionError(f"after the swap query {qi} differs from the filtered rows")
        breakdown = daemon_breakdown(srv.engine, tok, inputs.qtext, k)
        checks["RetrievalServer engine after the swap"] = served_batch_rows(
            srv.engine, term_sets, "the in-process server's engine")
    finally:
        srv.stop()
    for name in ("gather_rows", "scatter_scores", "count_ge"):
        if launches[name] == 0:
            raise AssertionError(f"RetrievalServer never launched {name}")
    limit = max(build_peak, swap["serve_peak"])
    memory = {"steady_gb": steady / 1e9, "build_peak_gb": build_peak / 1e9,
              "build_transient_gb": (build_peak - steady) / 1e9, "serve_peak_gb": swap["serve_peak"] / 1e9,
              "swap_peak_gb": swap["peak"] / 1e9, "two_engines_gb": 2 * steady / 1e9}
    if swap["peak"] > limit:
        raise AssertionError(f"staged swap peak {memory} above one engine's build or serving peak")
    served = latency_summary(stream, n_queries)
    # the rate before the swap began (answers up to it over the time to
    # it) and after it returned (answers after it over the time from it to
    # the last answer); answers given while it ran count in neither
    done = np.asarray(stream["done_at"])
    before, after = done[done <= swap["t0"]], done[done > swap["t1"]]
    served["before_swap"] = {"answers": len(before), "qps": len(before) / (swap["t0"] - stream["t0"])}
    served["after_swap"] = {"answers": len(after),
                            "qps": len(after) / (done.max() - swap["t1"]) if len(after) else None}
    log(f"in-process RetrievalServer with a staged swap to the filtered index after {n_queries // 2} answers: "
        f"every query answered once, {counts['old']} by phase 4's rows, {counts['new']} by the filtered rows; "
        f"the first {cfg.planted_deletes} again equal the filtered rows; swap {swap['s']:.1f} s; memory "
        f"{json.dumps(memory)}; launches {launches}; {json.dumps(served)}")
    torch.cuda.empty_cache()
    log(f"a served batch of {BREAKDOWN_BATCH} queries, by layer: {json.dumps(breakdown)}")
    out = {"seconds": seconds, "shard_tier": tier, "hot_swap": dict(served, counts=counts, swap_s=swap["s"],
           memory=memory, breakdown=breakdown), "deleted": len(deleted), "launches": launches,
           "served_batch_kernels": checks,
           "phase_s": time.perf_counter() - t_phase}
    log(f"phase 12 in {out['phase_s']:.1f} s; seconds {json.dumps(seconds)}")
    return out


def run_multidevice(cfg, workdir: Path, inputs, query_qps: float) -> dict:
    """Phase 13: the doc-sharded engine on phase 3's index and the
    data-parallel encode at phase 6's geometry, then the multi-device dry
    run, all over one card named several times.  Each kernel of the two
    paths is held against its plain version at the path's own shapes (a
    shard's, a replica's part)."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, IndexConfig
    from improving_learned_index_tpu_torch.index.indexer import Indexer
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.models import DeepImpact, load_hf_checkpoint
    from improving_learned_index_tpu_torch.models.deep_impact import part_bounds
    from improving_learned_index_tpu_torch.ops import short_attention as sa
    from improving_learned_index_tpu_torch.parallel import dryrun_multidevice
    from improving_learned_index_tpu_torch.search import ShardedSearchEngine
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, SequencePacker, WordPieceVocab

    log(f"== phase 13: multi-device on one card ({cfg.shards} shards of phase 3's index, "
        f"{cfg.replicas} encode replicas)")
    t_phase = time.perf_counter()
    kernels = all_kernels()
    dev = torch.device(cfg.device)
    devices = [dev] * cfg.shards
    seconds = {}

    # 1. build through InvertedIndexData.load, shards one at a time
    t0 = time.perf_counter()
    index = InvertedIndexData.load(inputs.index_dir, num_docs=SMOKE.docs)
    seconds["load"] = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    engine = ShardedSearchEngine(index, devices, dense_budget_bytes=int(SMOKE.dense_budget_gb * (1 << 30)))
    torch.cuda.synchronize()
    seconds["build"], seconds["split"] = engine.build_seconds, engine.split_seconds
    del index
    memory = {"steady_gb": (torch.cuda.memory_allocated() - base) / 1e9,
              "build_peak_gb": (torch.cuda.max_memory_allocated() - base) / 1e9}
    geometry = {"shard_docs": engine.shard_docs, "t_heavy": engine.t_heavy,
                "dense_dtypes": sorted({str(sh.dense.dtype) for sh in engine.shards}),
                "tail_postings": [sh.doc_ids.numel() for sh in engine.shards]}
    log(f"ShardedSearchEngine over {cfg.shards} x {dev}: load {seconds['load']:.1f} s, build "
        f"{seconds['build']:.1f} s (split {seconds['split']:.1f} s); {json.dumps(geometry)}; "
        f"memory {json.dumps(memory)}")

    # 2-4. phase 4's queries through score_stream, counts zeroed just before
    tok = ImpactTokenizer(WordPieceVocab.load(inputs.vocab))
    nq = SMOKE.nq
    batches = [[tok.process_query(q) for q in inputs.qtext[i : i + nq]]
               for i in range(0, len(inputs.qtext), nq)]
    list(engine.score_stream(batches[:2], top_k=cfg.k, depth=2))  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for kern in kernels:
        kern.calls.clear()
    t0 = time.perf_counter()
    outs = list(engine.score_stream(batches, top_k=cfg.k, depth=2))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {kern.name: kern.launches for kern in kernels}
    memory["serve_peak_gb"] = (torch.cuda.max_memory_allocated() - base) / 1e9
    for bi, out in enumerate(outs):
        for j, res in enumerate(out):
            if [(str(d), float(sc)) for d, sc in res] != inputs.ranked.get(str(bi * nq + j), []):
                raise AssertionError(f"sharded engine: query {bi * nq + j} differs from phase 4's run file")
    per_batch = cfg.shards * len(batches)
    for name in ("gather_rows", "scatter_scores"):
        if launches[name] != per_batch:
            raise AssertionError(f"sharded engine: {name} launched {launches[name]} times, want {per_batch}")
    if launches["count_ge"] < per_batch:
        raise AssertionError(f"sharded engine: count_ge launched {launches['count_ge']} times, "
                             f"fewer than one search pass a shard a batch")
    qps = len(inputs.qtext) / dt
    log(f"sharded: all {len(inputs.qtext)} answers equal phase 4's run file rank by rank; pipelined "
        f"{qps:.1f} q/s (phase 4's hybrid engine in this run: {query_qps:.1f} q/s), k={cfg.k}, "
        f"{nq}-query batches, depth 2; launches {launches}; memory {json.dumps(memory)}")

    # 5. the kernels against their plain versions at one shard's shape, on
    # the first batch's inputs to shard 0 (the global heavy rows, its tail)
    shard0 = engine.shards[0]
    heavy, tail = shard0.stage_inputs(batches[0])
    if heavy is None or tail is None:
        raise AssertionError("the first batch must reach both stages of shard 0")
    g_row, base_scores = gather_row(shard0, heavy, nq)
    s_row, scores = scatter_row(shard0, base_scores, tail)
    del base_scores, heavy, tail
    c_row = count_row(scores)
    del scores
    shard_rows = [g_row, s_row, c_row]
    for row in shard_rows:
        log(f"{row['name']} at a shard's shape: equal to plain; ms {row['ms']:.4f}, plain "
            f"{row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} ({row['bound_by']}); {json.dumps(row['shape'])}")
    engine.release()
    del engine, shard0
    torch.cuda.empty_cache()

    # 6. data-parallel encode: phase 6's corpus again, BERT-base from a seeded init
    t0 = time.perf_counter()
    passages = make_passages(ENCODE)
    vocab = WordPieceVocab.build(passages, max_size=30522, min_freq=2)
    seconds["corpus_and_vocab"] = time.perf_counter() - t0
    etok = ImpactTokenizer(vocab, max_length=ENCODE.max_length)
    docs = passages[: cfg.encode_batches * ENCODE.batch]
    del passages
    config = EncoderConfig.bert_base()
    write_bert_checkpoint(workdir / "bert", config, ENCODE.seed)
    weights = load_hf_checkpoint(workdir / "bert", config)
    single = DeepImpact(config, etok, state_dict=weights, device=dev)
    parallel = DeepImpact(config, etok, state_dict=weights, devices=[dev] * cfg.replicas)
    del weights
    unpacked = IndexConfig(max_length=ENCODE.max_length, max_terms=ENCODE.max_length,
                           model_batch_size=ENCODE.batch)
    packed = dataclasses.replace(unpacked, pack_sequences=True)
    packer = SequencePacker(ENCODE.max_length, ENCODE.batch, ENCODE.max_length)
    encs = [etok.process_document(d) for d in docs]
    packed_batches = [b for e in encs for b in packer.add(e)] + list(packer.flush())
    packed_rows = [b.input_ids.shape[0] for b in packed_batches]
    first_docs = {"unpacked": ENCODE.batch, "packed": packed_batches[0].n_docs}

    # short_attention against its plain version at a part's shape: the
    # first unpacked part's padding mask, the first packed part's segments
    rows = part_bounds(ENCODE.batch, cfg.replicas)[1]
    if part_bounds(packed_rows[0], cfg.replicas)[1] != rows:
        raise AssertionError(f"the first packed part has other rows than the unpacked one ({rows})")
    heads = config.num_heads
    rng = np.random.default_rng(ENCODE.seed + 2)
    q, k, v = (
        torch.from_numpy(rng.standard_normal((rows, ENCODE.max_length, heads, config.hidden_size // heads),
                                             dtype=np.float32) * 1.5).to(dev, torch.bfloat16).permute(0, 2, 1, 3)
        for _ in range(3)
    )
    pad_mask = torch.from_numpy(np.asarray([e.attention_mask for e in encs[:rows]], np.int32)).to(dev)
    seg_ids = torch.from_numpy(packed_batches[0].segment_ids[:rows]).to(dev)
    part_row = attention_row(q, k, v, pad_mask, seg_ids)
    del q, k, v, pad_mask, seg_ids, packed_batches, encs
    log(f"short_attention at a part's shape: within tolerance of plain; ms {part_row['ms']:.4f}, plain "
        f"{part_row['plain_ms']:.4f}, bound {part_row['bound_ms']:.4f} ({part_row['bound_by']}), SDPA "
        f"{part_row['library_ms']:.4f}; {json.dumps(part_row['shape'])}")

    def encode(model, icfg):
        return [dict(zip(terms, row.tolist())) for terms, row in Indexer(model, icfg).encode_document_rows(docs)]

    enc = {}
    for route, icfg, parts in (("unpacked", unpacked, [cfg.replicas] * cfg.encode_batches),
                               ("packed", packed, [min(r, cfg.replicas) for r in packed_rows])):
        for kern in kernels:
            kern.calls.clear()
        got = encode(parallel, icfg)
        torch.cuda.synchronize()
        n_attn = sa.KERNEL.launches
        want_attn = config.num_layers * sum(parts)
        if n_attn != want_attn:
            raise AssertionError(f"data-parallel {route}: short_attention launched {n_attn} times, want {want_attn}")
        ref = encode(single, icfg)
        peak = max(max(d.values(), default=0.0) for d in ref)
        err = impacts_close(got, ref, 0.05 * peak, 0.002 * peak, f"data-parallel {route} vs single-device")
        rates = {name: steady_docs_per_s(Indexer(model, icfg), docs, first_docs[route])
                 for name, model in (("single", single), ("replicas", parallel))}
        enc[route] = {"launches": n_attn, "parts": sum(parts), "errors": err,
                      "tolerance": [0.05 * peak, 0.002 * peak], "docs_per_s": rates}
        log(f"data-parallel encode, {route}: {len(docs)} passages, term lists identical to the single-device "
            f"route, max |diff| {err}; short_attention {n_attn} launches ({config.num_layers} x {sum(parts)} "
            f"parts); docs/s {json.dumps(rates)}")
    del single, parallel
    torch.cuda.empty_cache()

    # 7. the dry run
    for kern in kernels:
        kern.calls.clear()
    t0 = time.perf_counter()
    dry = dryrun_multidevice([dev] * cfg.replicas)
    torch.cuda.synchronize()
    seconds["dryrun"] = time.perf_counter() - t0
    dry["launches"] = {kern.name: kern.launches for kern in kernels}
    log(f"dryrun_multidevice over {cfg.replicas} x {dev} in {seconds['dryrun']:.1f} s; "
        f"launches {dry['launches']}")
    out = {"seconds": seconds, "geometry": geometry, "memory": memory, "qps": qps, "phase4_qps": query_qps,
           "launches": launches, "shard_shape_kernels": shard_rows, "part_shape_attention": part_row,
           "encode": enc, "dryrun": dry,
           "phase_s": time.perf_counter() - t_phase}
    log(f"phase 13 in {out['phase_s']:.1f} s; seconds {json.dumps(seconds)}")
    return out


# -- the host-side remainder and JAX checkpoints ----------------------------------


def port_params_to_flax(state_dict: dict, config) -> dict:
    """The inverse of ``models.hf_import.flax_params_to_port``: a port
    ``DeepImpact`` state dict as the JAX package's flax parameter tree (fp32
    numpy, in the JAX init's key order), the tree its checkpoints hold."""
    h, heads = config.hidden_size, config.num_heads

    def g(key):
        return np.ascontiguousarray(state_dict[key].detach().float().cpu().numpy())

    def norm(key):
        return {"scale": g(f"{key}.weight"), "bias": g(f"{key}.bias")}

    def dense(key):
        return {"kernel": np.ascontiguousarray(g(f"{key}.weight").T), "bias": g(f"{key}.bias")}

    emb = "encoder.embeddings"
    enc = {"embeddings": {
        "word_embeddings": {"embedding": g(f"{emb}.word_embeddings.weight")},
        "position_embeddings": {"embedding": g(f"{emb}.position_embeddings.weight")},
        "token_type_embeddings": {"embedding": g(f"{emb}.token_type_embeddings.weight")},
        "layer_norm": norm(f"{emb}.layer_norm"),
    }}
    for i in range(config.num_layers):
        p = f"encoder.layers.{i}"
        attention = {}
        for name in ("query", "key", "value"):  # [H, heads, head_dim]
            d = dense(f"{p}.attention.{name}")
            attention[name] = {"kernel": d["kernel"].reshape(h, heads, h // heads),
                               "bias": d["bias"].reshape(heads, h // heads)}
        d = dense(f"{p}.attention.output_dense")  # [heads, head_dim, H]
        attention["output_dense"] = {"kernel": d["kernel"].reshape(heads, h // heads, h), "bias": d["bias"]}
        enc[f"layer_{i}"] = {"attention": attention, "attention_norm": norm(f"{p}.attention_norm"),
                             "intermediate": dense(f"{p}.intermediate"), "output": dense(f"{p}.output"),
                             "output_norm": norm(f"{p}.output_norm")}
    return {"encoder": enc, "impact_head": {"dense": dense("impact_head.dense")}}


def clone_state(params: dict, opt_state) -> tuple:
    """A copy of a training state on its own device (the live state_dict
    tensors change in place at the next optimizer step)."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.detach().clone()
        if isinstance(x, dict):
            return {k: copy(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(copy(v) for v in x)
        return x

    return copy(params), copy(opt_state)


def same_state(got, want, what: str) -> None:
    """Exact equality of two state trees (tensors compared on the host)."""
    if isinstance(want, torch.Tensor):
        if not (isinstance(got, torch.Tensor) and got.dtype == want.dtype
                and torch.equal(got.cpu(), want.cpu())):
            raise AssertionError(f"{what}: a tensor differs from the state at its on_step")
    elif isinstance(want, dict):
        if not isinstance(got, dict) or set(got) != set(want):
            raise AssertionError(f"{what}: keys differ")
        for k in want:
            same_state(got[k], want[k], f"{what}/{k}")
    elif isinstance(want, (list, tuple)):
        if len(got) != len(want):
            raise AssertionError(f"{what}: lengths differ")
        for i, (a, b) in enumerate(zip(got, want)):
            same_state(a, b, f"{what}/{i}")
    elif got != want:
        raise AssertionError(f"{what}: {got!r} != {want!r}")


def snapshot_files(d: Path) -> tuple:
    """(stems of the payloads, {meta file: contents}) of a checkpoint directory."""
    stems = sorted(p.name[: -len(".pt")] for p in d.glob("*.pt"))
    metas = {p.name: json.loads(p.read_text()) for p in sorted(d.glob("*.meta.json"))}
    return stems, metas


def step_seconds(times: list, save_every: int) -> dict:
    """Seconds of each step from the on_step return times (steps 2..N): the
    saving steps and the plain ones after the first two."""
    step_s = [b - a for a, b in zip(times, times[1:])]
    return {"step_s": step_s,
            "plain_step_s": [d for i, d in enumerate(step_s[1:], start=3) if i % save_every],
            "saving_step_s": [d for i, d in enumerate(step_s, start=2) if not i % save_every]}


def window_count(n_words: int, window: int, stride: int) -> int:
    """Passages of a document of ``n_words`` words (search.maxp.make_passages)."""
    return 1 if n_words <= window else 1 + -(-(n_words - window) // stride)


def write_prep_inputs(d: Path, texts: list, cfg) -> dict:
    """Seeded inputs of the data-prep scripts over the collection ``texts``
    (pid = index): queries of 3-4 words of their one relevant passage, a
    first-stage run of ``cfg.candidates`` others a query (mined negatives
    from two systems that overlap), the collection with ``cfg.duplicates``
    repeated pids appended, expansions for the first ``cfg.expanded_docs``
    passages, and stopwords (the most frequent words and two negations)."""
    from collections import Counter

    rng = np.random.default_rng(cfg.seed)
    n = len(texts)
    pos = rng.choice(n, cfg.queries, replace=False)
    queries, negs = [], []
    for p in pos:
        words = [w.rstrip(".") for w in texts[p].split()]
        pick = rng.choice(len(words), size=min(len(words), int(rng.integers(3, 5))), replace=False)
        queries.append(" ".join(words[j] for j in sorted(pick)))
        cands = (p + 1 + rng.choice(n - 1, cfg.candidates, replace=False)) % n
        negs.append([str(c) for c in cands])
    (d / "queries.tsv").write_text("".join(f"q{i}\t{q}\n" for i, q in enumerate(queries)), encoding="utf-8")
    (d / "qrels.tsv").write_text("".join(f"q{i}\t0\t{p}\t1\n" for i, p in enumerate(pos)), encoding="utf-8")
    half = 2 * cfg.candidates // 3
    with open(d / "negatives.jsonl", "w", encoding="utf-8") as f:
        for i, (p, c) in enumerate(zip(pos, negs)):
            f.write(json.dumps({"qid": f"q{i}", "pos": [str(p)],
                                "neg": {"run": c[:half], "other": c[half // 2:]}}) + "\n")
    dup = rng.choice(n, cfg.duplicates, replace=False)
    with open(d / "collection_dups.tsv", "w", encoding="utf-8") as f:
        f.write("".join(f"{i}\t{t}\n" for i, t in enumerate(texts)))
        f.write("".join(f"{p}\tduplicate {j} of {p}\n" for j, p in enumerate(dup)))
    vocab_words = np.array([w.rstrip(".") for t in texts[: 4 * cfg.expanded_docs] for w in t.split()])
    with open(d / "expansions.jsonl", "w", encoding="utf-8") as f:
        for i in range(cfg.expanded_docs):
            qs = [" ".join(rng.choice(vocab_words, int(rng.integers(3, 6)))) for _ in range(3)]
            f.write(json.dumps({"doc_id": str(i), "queries": qs}) + "\n")
    counts = Counter(w for t in texts for w in t.lower().replace(".", " ").split())
    stop = [w for w, _ in counts.most_common(cfg.stopwords)] + ["not", "no"]
    (d / "stopwords.txt").write_text("".join(f"{w}\n" for w in stop), encoding="utf-8")
    return {"pos": pos.tolist(), "queries": queries, "negs": negs, "stop": set(stop)}


def run_data_prep(cfg, workdir: Path, texts: list) -> dict:
    """Phase 14, part 1: the port's data-prep scripts on the card's machine,
    each output checked against a plain recount of its inputs and each
    script run twice into two directories with the same bytes out."""
    import re

    from improving_learned_index_tpu_torch.scripts import (
        construct_hard_neg_dataset,
        create_passages,
        create_training_files,
        create_unique_passage_mapping,
        prepare_dataset,
        preprocess_passages,
    )

    d = workdir / "prep"
    d.mkdir()
    t0 = time.perf_counter()
    inp = write_prep_inputs(d, texts, cfg)
    coll = workdir / "collection.tsv"
    runs = {
        "prepare_dataset": (prepare_dataset, lambda o: [
            "--qrels_path", d / "qrels.tsv", "--queries_path", d / "queries.tsv",
            "--collection_path", coll, "--output_path", o / "pairs.tsv"]),
        "create_unique_passage_mapping": (create_unique_passage_mapping, lambda o: [
            "--collection_path", d / "collection_dups.tsv", "--output_path", o / "unique.tsv"]),
        "construct_hard_neg_dataset": (construct_hard_neg_dataset, lambda o: [
            "--negatives_path", d / "negatives.jsonl", "--output_path", o / "triples.tsv",
            "--seed", str(cfg.seed)]),
        "create_training_files": (create_training_files, lambda o: [
            "--doc_mapping", coll, "--expansions_path", d / "expansions.jsonl",
            "--output_docs_tsv", o / "expanded.tsv", "--output_expansion_csv", o / "expansion_terms.csv",
            "--max_length", str(cfg.token_budget), "--max_expansion_terms", str(cfg.expansion_terms)]),
        "create_passages": (create_passages, lambda o: [
            "--collection_path", coll, "--output_collection", o / "passages.tsv",
            "--output_mapping", o / "pid_mapping.txt", "--expansions_path", d / "expansions.jsonl",
            "--window", str(cfg.window), "--stride", str(cfg.stride)]),
        "preprocess_passages": (preprocess_passages, lambda o: [
            "--collection_path", coll, "--output_path", o / "preprocessed.tsv",
            "--stopwords_path", d / "stopwords.txt"]),
    }
    seconds = {"inputs": time.perf_counter() - t0}
    for name, (mod, argv) in runs.items():
        t0 = time.perf_counter()
        for run in ("a", "b"):
            o = d / run
            o.mkdir(exist_ok=True)
            if mod.main([str(x) for x in argv(o)]) != 0:
                raise AssertionError(f"scripts.{name} returned non-zero")
        seconds[name] = (time.perf_counter() - t0) / 2
    a, b = d / "a", d / "b"
    names = sorted(p.name for p in a.iterdir())
    for name in names:
        if not files_equal(a / name, b / name):
            raise AssertionError(f"data prep: a second run wrote other bytes to {name}")

    # plain recounts of the same inputs
    n = len(texts)
    want = "".join(f"{texts[p]}\t{q}\n" for p, q in zip(inp["pos"], inp["queries"]))
    if (a / "pairs.tsv").read_text(encoding="utf-8") != want:
        raise AssertionError("prepare_dataset: pairs differ from the qrels' passage/query pairs")
    if not files_equal(a / "unique.tsv", coll):
        raise AssertionError(f"create_unique_passage_mapping: {cfg.duplicates} appended duplicates "
                             "not dropped back to the collection")
    triples = [tuple(line.split("\t")) for line in (a / "triples.tsv").read_text().splitlines()]
    want_triples = {(f"q{i}", str(p), c) for i, (p, negs) in enumerate(zip(inp["pos"], inp["negs"]))
                    for c in set(negs[: 2 * cfg.candidates // 3]) | set(negs[cfg.candidates // 3:])}
    if len(triples) != len(want_triples) or set(triples) != want_triples:
        raise AssertionError(f"construct_hard_neg_dataset: {len(triples)} triples, want {len(want_triples)}")
    raw = {str(i): t.split() for i, t in enumerate(texts)}
    csv_rows = (a / "expansion_terms.csv").read_text(encoding="utf-8").splitlines()[1:]
    expanded = (a / "expanded.tsv").read_text(encoding="utf-8").splitlines()
    if len(expanded) != cfg.expanded_docs or len(csv_rows) != cfg.expanded_docs:
        raise AssertionError(f"create_training_files: {len(expanded)} rows, want {cfg.expanded_docs}")
    for line, row in zip(expanded, csv_rows):
        doc_id, text = line.split("\t")
        exp = row.split(",", 1)[1].strip('"').split()
        words = raw[doc_id]
        budget = cfg.token_budget - len(exp)
        if (row.split(",", 1)[0] != doc_id or len(exp) > cfg.expansion_terms or len(set(exp)) != len(exp)
                or set(exp) & set(words) or text.split() != words[:budget] + exp):
            raise AssertionError(f"create_training_files: document {doc_id} breaks the token budget "
                                 "or the dedupe against its words")
    n_passages = sum(window_count(len(t.split()), cfg.window, cfg.stride) for t in texts)
    passages = (a / "passages.tsv").read_text(encoding="utf-8").splitlines()
    mapping = (a / "pid_mapping.txt").read_text(encoding="utf-8").splitlines()
    if len(passages) != n_passages or len(mapping) != n_passages or mapping[0] != "0#0":
        raise AssertionError(f"create_passages: {len(passages)} passages, want {n_passages}")
    pre = (a / "preprocessed.tsv").read_text(encoding="utf-8").splitlines()
    keep = preprocess_passages.DEFAULT_NEGATION_WHITELIST
    terms = [w for t in texts for w in re.findall(r"\w+|[^\w\s]", t.lower())]
    kept = sum(1 for w in terms if w not in inp["stop"] or w in keep)
    if len(pre) != n or sum(len(line.split("\t")[1].split()) for line in pre) != kept:
        raise AssertionError(f"preprocess_passages: {len(pre)} lines / kept terms differ from the "
                             f"recount ({kept} terms)")
    out = {"seconds": seconds, "outputs": names, "triples": len(triples), "pairs": cfg.queries,
           "dropped_duplicates": cfg.duplicates, "expanded_docs": cfg.expanded_docs,
           "passages": n_passages, "terms": len(terms), "terms_kept": kept, "relevant": inp["pos"]}
    log(f"data prep: 6 scripts, each output equal to its recount and a second run's bytes; "
        f"{json.dumps({k: v for k, v in out.items() if k != 'relevant'})}")
    return out


def gated_route_failures(workdir: Path, device: str) -> list:
    """Start ``cli.index`` on each optional tokenizer route whose package is
    not installed (``--hf_tokenizer`` needs ``transformers``, ``--segmenter
    vncorenlp`` needs ``py_vncorenlp``), in processes of their own: each
    must exit non-zero with an ImportError naming its package.  Returns
    (package, process) pairs."""
    small = workdir / "gated.tsv"
    small.write_text("0\tquick brown fox\n1\tlazy dog\n", encoding="utf-8")
    base = [sys.executable, "-m", "improving_learned_index_tpu_torch.cli.index", "--collection_path",
            str(small), "--tiny", "--max_length", "128", "--device", device]
    env = dict(os.environ, PYTHONPATH=str(REPO), HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1")
    routes = [("transformers", ["--hf_tokenizer", str(workdir), "--output_file_path", str(workdir / "g1.txt")]),
              ("py_vncorenlp", ["--vocab_path", str(workdir / "vocab.txt"), "--segmenter", "vncorenlp",
                                "--output_file_path", str(workdir / "g2.txt")])]
    return [(pkg, subprocess.Popen(base + extra, cwd=REPO, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True))
            for pkg, extra in routes if importlib.util.find_spec(pkg) is None]


def hf_tokenizer_route(cfg, workdir: Path, ckpt: Path) -> dict:
    """``cli.index --hf_tokenizer``, where ``transformers`` is installed: a
    BERT tokenizer directory of phase 6's vocabulary (``vocab.txt`` and a
    ``tokenizer_config.json``; a local directory, the hub switched off)
    against the built-in WordPiece route
    over the first ``cfg.hf_docs`` passages with the same checkpoint: both
    tokenizers must encode every passage alike (ids, mask, term map), and
    each passage gets the same forward-index line byte for byte."""
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"  # local directories only
    import huggingface_hub.constants
    import transformers

    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.ops import short_attention as sa
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.text.hf_adapter import load_hf_tokenizer

    huggingface_hub.constants.HF_HUB_OFFLINE = True
    vocab = workdir / "vocab.txt"
    # a BERT tokenizer directory as the hub keeps one: vocab.txt and its config
    hf_dir = workdir / "hf_tokenizer"
    hf_dir.mkdir()
    shutil.copy(vocab, hf_dir / "vocab.txt")
    (hf_dir / "tokenizer_config.json").write_text(
        json.dumps({"tokenizer_class": "BertTokenizer", "do_lower_case": True}), encoding="utf-8")
    head = workdir / "hf_head.tsv"
    with open(workdir / "collection.tsv", encoding="utf-8") as f:
        lines = list(islice(f, cfg.hf_docs))
    head.write_text("".join(lines), encoding="utf-8")
    common = ["--collection_path", str(head), "--max_length", str(ENCODE.max_length), "--model_batch_size",
              str(ENCODE.batch), "--checkpoint", str(ckpt), "--device", cfg.device]
    hf = load_hf_tokenizer(str(hf_dir), ENCODE.max_length)
    out = {"transformers": transformers.__version__, "tokenizer": type(hf.tokenizer).__name__,
           "tokenizer_vocab": len(hf.tokenizer)}
    for route, flags in (("hf_tokenizer", ["--hf_tokenizer", str(hf_dir)]), ("vocab_path", ["--vocab_path", str(vocab)])):
        sa.KERNEL.calls.clear()
        t0 = time.perf_counter()
        index_main(common + flags + ["--output_file_path", str(workdir / f"forward.{route}.txt")])
        torch.cuda.synchronize()
        out[route] = {"seconds": time.perf_counter() - t0, "launches": sa.KERNEL.launches}
    want = EncoderConfig.bert_base().num_layers * -(-cfg.hf_docs // ENCODE.batch)
    if out["hf_tokenizer"]["launches"] != want:
        raise AssertionError(f"cli.index --hf_tokenizer: {out['hf_tokenizer']['launches']} launches, want {want}")

    wp = ImpactTokenizer(WordPieceVocab.load(vocab), max_length=ENCODE.max_length)
    for i, line in enumerate(lines):  # tests/test_tokenizer_fidelity.py's contract, per passage
        text = line.split("\t", 1)[1].rstrip("\n")
        a, b = wp.process_document(text), hf.process_document(text)
        if (a.ids, a.attention_mask, a.term_to_token_index) != (b.ids, b.attention_mask, b.term_to_token_index):
            j = next((k for k, (x, y) in enumerate(zip(a.ids, b.ids)) if x != y), len(a.ids))
            raise AssertionError(f"the HF tokenizer encodes passage {i} otherwise than the WordPiece route: "
                                 f"ids {a.ids[:j + 4]} vs {b.ids[:j + 4]}; {json.dumps(out)}")
    if not files_equal(workdir / "forward.hf_tokenizer.txt", workdir / "forward.vocab_path.txt"):
        raise AssertionError("cli.index --hf_tokenizer wrote another forward index than --vocab_path")
    log(f"cli.index --hf_tokenizer (transformers {transformers.__version__}): {cfg.hf_docs} passages "
        f"encoded as by the WordPiece route, their lines byte-equal to --vocab_path's; {json.dumps(out)}")
    return out


def run_remainder(cfg, workdir: Path) -> dict:
    """Phase 14: the host-side remainder and JAX checkpoints on the card, in
    phase 6's work directory (its passages, vocabulary and phase 7's seeded
    BERT-base trunk), at S=256, B=512."""
    log("== phase 14: data prep, async snapshots, a JAX-format checkpoint through the encode and "
        "query paths, term-pair attention, gated routes")
    t_phase = time.perf_counter()
    texts = [line.split("\t", 1)[1].rstrip("\n") for line in open(workdir / "collection.tsv", encoding="utf-8")]
    if importlib.util.find_spec("py_vncorenlp") is not None:
        raise AssertionError("py_vncorenlp is installed: its route needs a VnCoreNLP model directory "
                             "that the repository does not hold")
    gated = gated_route_failures(workdir, cfg.device)
    try:
        return remainder_checks(cfg, workdir, texts, gated, t_phase)
    finally:
        for _, proc in gated:
            if proc.poll() is None:
                proc.kill()
            proc.communicate()


def remainder_checks(cfg, workdir: Path, texts: list, gated: list, t_phase: float) -> dict:
    """Phase 14's parts 1-5 (``run_remainder`` starts the gated routes'
    processes and stops them)."""
    from improving_learned_index_tpu_torch.analysis import extract_term_pair_attention
    from improving_learned_index_tpu_torch.cli.convert_to_anserini import main as anserini_main
    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.cli.invert import main as invert_main
    from improving_learned_index_tpu_torch.cli.quantize import main as quantize_main
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.core import flax_msgpack
    from improving_learned_index_tpu_torch.core.async_checkpoint import AsyncCheckpointManager
    from improving_learned_index_tpu_torch.core.checkpoint import load_params
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
    from improving_learned_index_tpu_torch.data.datasets import MSMarcoTriples
    from improving_learned_index_tpu_torch.models import DeepImpact, load_hf_checkpoint
    from improving_learned_index_tpu_torch.ops import short_attention as sa
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.train import COLLATES, Trainer
    from improving_learned_index_tpu_torch.train.packed import pack_collated

    kernels = all_kernels()
    config = EncoderConfig.bert_base()
    coll, vocab_path, bert = workdir / "collection.tsv", workdir / "vocab.txt", workdir / "bert"
    out = {"prep": run_data_prep(cfg, workdir, texts)}
    seconds, launches = {}, {}

    # 2. async snapshots: a Trainer at phase 8's geometry on the prepared
    # triples, AsyncCheckpointManager in place of its manager (run B), then
    # the synchronous manager (run A) handed run B's states and metrics at
    # the same on_step calls: the same files must come out
    max_length = ENCODE.max_length
    tok = ImpactTokenizer(WordPieceVocab.load(vocab_path), max_length=max_length)
    dataset = MSMarcoTriples(workdir / "prep" / "a" / "triples.tsv", workdir / "prep" / "queries.tsv", coll)
    groups = TRAIN.groups
    t0 = time.perf_counter()
    batches = [pack_collated(COLLATES["pairwise_ce"]([dataset[i] for i in range(j, j + groups)], tok, max_length))
               for j in range(0, cfg.steps * groups, groups)]
    seconds["collate"] = time.perf_counter() - t0
    # no best snapshot: every other step writes, the rest are plain steps
    tcfg = TrainConfig(batch_size=groups, save_every=cfg.save_every, save_best=False, eval_every=10**9)
    weights = load_hf_checkpoint(bert, config)
    calls, finals, times = [], {}, {"async": [], "sync": []}

    trainer = Trainer(DeepImpact(config, tok, state_dict=weights, device=cfg.device), tcfg,
                      workdir / "ckpt_async")
    sync_mgr = trainer.manager
    mgr = AsyncCheckpointManager(sync_mgr.checkpoint_dir, name=sync_mgr.name, save_every=sync_mgr.save_every,
                                 save_best=sync_mgr.save_best, batch_size=sync_mgr.batch_size)
    trainer.manager = mgr
    inner_step, inner_save = mgr.on_step, mgr.save

    def on_step_b(params, opt_state=None, metric=None):
        # the state at a call that saves, kept on the card (a clone takes ~1 ms)
        saves = [str(mgr.step + 1), "latest"] if (mgr.step + 1) % mgr.save_every == 0 else []
        if mgr.save_best and metric is not None and metric < mgr.best_metric:
            saves.append("best")
        state = clone_state(params, opt_state) if saves else None
        inner_step(params, opt_state, metric)
        times["async"].append(time.perf_counter())
        calls.append({"saves": saves, "metric": metric, "state": state})

    def save_b(suffix, params, opt_state=None, metric=None):
        finals[suffix] = clone_state(params, opt_state)
        inner_save(suffix, params, opt_state, metric)

    mgr.on_step, mgr.save = on_step_b, save_b
    for kern in kernels:
        kern.calls.clear()
    t0 = time.perf_counter()
    trainer.train(batches)
    seconds["train_async"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mgr.wait()
    seconds["final_wait"] = time.perf_counter() - t0
    launches["Trainer (async snapshots)"] = sa.KERNEL.launches
    if sa.KERNEL.launches != config.num_layers * cfg.steps:
        raise AssertionError(f"async run: short_attention launched {sa.KERNEL.launches} times, "
                             f"want {config.num_layers * cfg.steps}")
    del trainer, mgr
    torch.cuda.empty_cache()

    trainer = Trainer(DeepImpact(config, tok, state_dict=weights, device=cfg.device), tcfg,
                      workdir / "ckpt_sync")
    sync_mgr = trainer.manager
    inner_step_a, inner_save_a = sync_mgr.on_step, sync_mgr.save
    replay = iter(calls)

    def on_step_a(params, opt_state=None, metric=None):
        rec = next(replay)
        if rec["state"] is not None:
            params, opt_state = rec["state"]
        inner_step_a(params, opt_state, rec["metric"])
        times["sync"].append(time.perf_counter())

    def save_a(suffix, params, opt_state=None, metric=None):
        if suffix in finals:  # Trainer.train's final save
            params, opt_state = finals[suffix]
        inner_save_a(suffix, params, opt_state, metric)

    sync_mgr.on_step, sync_mgr.save = on_step_a, save_a
    sa.KERNEL.calls.clear()
    t0 = time.perf_counter()
    trainer.train(batches)
    seconds["train_sync"] = time.perf_counter() - t0
    launches["Trainer (sync snapshots)"] = sa.KERNEL.launches
    del trainer, weights, batches
    torch.cuda.empty_cache()

    got, want = snapshot_files(workdir / "ckpt_async"), snapshot_files(workdir / "ckpt_sync")
    if got != want:
        raise AssertionError(f"async snapshots {got} differ from the synchronous manager's {want}")
    by_suffix = {s: c["state"] for c in calls for s in c["saves"]}
    by_suffix.update(finals)
    if sorted(by_suffix) != sorted(s.split("_", 1)[1] for s in got[0]):
        raise AssertionError(f"snapshots {got[0]}, want those of {sorted(by_suffix)}")
    t0 = time.perf_counter()
    for suffix, (params, opt_state) in by_suffix.items():
        payload = torch.load(workdir / "ckpt_async" / f"DeepImpact_{suffix}.pt", map_location="cpu",
                             weights_only=True)
        same_state(payload["params"], params, f"snapshot {suffix} params")
        same_state(payload["opt_state"], opt_state, f"snapshot {suffix} optimizer state")
    seconds["reload_check"] = time.perf_counter() - t0
    snaps = {"stems": got[0], "metas": got[1],
             "async": step_seconds(times["async"], cfg.save_every),
             "sync": step_seconds(times["sync"], cfg.save_every)}
    log(f"async snapshots: {len(got[0])} files, stems and .meta.json equal to the synchronous manager's, "
        f"every snapshot equal to the state at its on_step; {json.dumps(snaps)}")
    out["snapshots"] = snaps
    final_params = finals["final"][0]
    del calls, finals, by_suffix
    torch.cuda.empty_cache()

    # 3. the final params as a JAX-format checkpoint (the manager's payload)
    pt = workdir / "ckpt_async" / "DeepImpact_final.pt"
    mp = workdir / "DeepImpact_final.msgpack"
    t0 = time.perf_counter()
    flax_msgpack.write(mp, {"params": port_params_to_flax(final_params, config)})
    seconds["msgpack_write"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_mp = load_params(mp, config)
    seconds["msgpack_load"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from_pt = load_params(pt, config)
    seconds["pt_load"] = time.perf_counter() - t0
    same_state(dict(from_mp), {k: v.cpu() for k, v in final_params.items()}, "msgpack params")
    same_state(dict(from_mp), dict(from_pt), "msgpack vs .pt params")
    del from_mp, from_pt, final_params
    log(f"{mp.name}: {mp.stat().st_size / 1e6:.1f} MB written in {seconds['msgpack_write']:.2f} s, loaded in "
        f"{seconds['msgpack_load']:.2f} s (.pt {seconds['pt_load']:.2f} s), equal to the trained params")

    common = ["--collection_path", str(coll), "--vocab_path", str(vocab_path), "--max_length", str(max_length),
              "--model_batch_size", str(ENCODE.batch), "--device", cfg.device]
    routes = {}
    for route, ckpt in (("msgpack", mp), ("pt", pt)):
        r = workdir / f"route_{route}"
        r.mkdir()
        extra = ["--store_path", str(r / "forward.store")] if route == "msgpack" else []
        for kern in kernels:
            kern.calls.clear()
        t0 = time.perf_counter()
        index_main(common + ["--checkpoint", str(ckpt), "--output_file_path", str(r / "forward.txt")] + extra)
        torch.cuda.synchronize()
        seconds[f"cli_index_{route}"] = time.perf_counter() - t0
        n_attn = sa.KERNEL.launches
        want_attn = config.num_layers * -(-len(texts) // ENCODE.batch)
        if n_attn != want_attn:
            raise AssertionError(f"cli.index --checkpoint {ckpt.name}: short_attention launched {n_attn} "
                                 f"times, want {want_attn}")
        quantize_main(["-i", str(r / "forward.txt"), "-o", str(r / "forward.q.txt")])
        invert_main(["-i", str(r / "forward.q.txt"), "-o", str(r / "index")])
        for kern in kernels:
            kern.calls.clear()
        t0 = time.perf_counter()
        rank_main(["--index_path", str(r / "index"), "--queries_path", str(workdir / "prep" / "queries.tsv"),
                   "--output_path", str(r / "run.tsv"), "--vocab_path", str(vocab_path), "--top_k", "1000",
                   "--device", cfg.device])
        torch.cuda.synchronize()
        seconds[f"cli_rank_{route}"] = time.perf_counter() - t0
        routes[route] = {"short_attention": n_attn, **{k.name: k.launches for k in kernels
                                                        if k.name != "short_attention"}}
    r_mp, r_pt = workdir / "route_msgpack", workdir / "route_pt"
    if not files_equal(r_mp / "forward.txt", r_pt / "forward.txt"):
        raise AssertionError("cli.index from the .msgpack wrote another forward index than from the .pt")
    same_index_files(r_mp / "index", r_pt / "index", "msgpack route vs .pt route")
    if not files_equal(r_mp / "run.tsv", r_pt / "run.tsv"):
        raise AssertionError("cli.rank over the msgpack-built index wrote another run than the .pt route's")
    for name in ("gather_rows", "scatter_scores", "count_ge"):
        if routes["msgpack"][name] == 0:
            raise AssertionError(f"cli.rank (msgpack route): {name} never launched")
    ranked = {}
    for line in (r_mp / "run.tsv").read_text().splitlines():
        qid, pid = line.split("\t")[:2]
        ranked.setdefault(qid, []).append(pid)
    top10 = [ranked.get(f"q{i}", [])[:10] for i in range(cfg.queries)]
    mrr = float(np.mean([1.0 / (t.index(str(p)) + 1) if str(p) in t else 0.0
                         for t, p in zip(top10, out["prep"]["relevant"])]))
    launches["cli.index (msgpack)"] = routes["msgpack"]["short_attention"]
    launches["cli.index (.pt, phase 14)"] = routes["pt"]["short_attention"]
    log(f"cli.index --checkpoint {mp.name} and {pt.name}: byte-equal forward indexes, indexes and runs "
        f"({len(texts)} passages, {cfg.queries} queries, MRR@10 {mrr:.4f}); launches {json.dumps(routes)}")

    for src, name in ((r_mp / "forward.txt", "text"), (r_mp / "forward.store", "store")):
        t0 = time.perf_counter()
        anserini_main(["-i", str(src), "-o", str(workdir / f"anserini.{name}.jsonl")])
        seconds[f"anserini_{name}"] = time.perf_counter() - t0
    a_text, a_store = workdir / "anserini.text.jsonl", workdir / "anserini.store.jsonl"
    n_lines = sum(1 for _ in open(a_text, encoding="utf-8"))
    if n_lines != len(texts) or not files_equal(a_text, a_store):
        raise AssertionError(f"cli.convert_to_anserini: {n_lines} lines, or the store's JSONL differs")
    first = json.loads(open(a_text, encoding="utf-8").readline())
    if first["id"] != 0 or first["contents"] != "" or not first["vector"]:
        raise AssertionError(f"cli.convert_to_anserini: first line {first}")
    log(f"cli.convert_to_anserini: {n_lines} equal JSONL lines from the forward index and the store")

    # 4. term-pair attention with the trained model (plain attention: maps)
    model = DeepImpact(config, tok, state_dict=load_params(pt, config), device=cfg.device)
    docs = texts[: cfg.pair_docs]
    for kern in kernels:
        kern.calls.clear()
    t0 = time.perf_counter()
    pairs = extract_term_pair_attention(model, docs)
    torch.cuda.synchronize()
    seconds["term_pairs"] = time.perf_counter() - t0
    launches["extract_term_pair_attention"] = sa.KERNEL.launches
    if sa.KERNEL.launches:
        raise AssertionError("extract_term_pair_attention launched short_attention (it needs the maps)")
    encs = [model.process_document(doc) for doc in docs]
    with torch.inference_mode():
        ids, mask, types = (torch.from_numpy(np.asarray([getattr(e, k) for e in encs], np.int32)).to(cfg.device)
                            for k in ("ids", "attention_mask", "type_ids"))
        _, maps = model.module.encoder(ids, mask, types, use_kernels=model.use_kernels, output_attentions=True)
        maps = torch.stack(maps).cpu().numpy()
    n_pairs = 0
    for b, (enc, doc_pairs) in enumerate(zip(encs, pairs)):
        slot = enc.term_to_token_index
        for (t1, t2), series in doc_pairs.items():
            i, j = slot[t1], slot[t2]
            if not (np.array_equal(series, np.maximum(maps[:, b, i, j], maps[:, b, j, i]))
                    and series.min() >= 0 and series.max() <= 1):
                raise AssertionError(f"term pair ({t1}, {t2}) of document {b}: {series}")
            n_pairs += 1
    out["term_pairs"] = {"docs": len(docs), "pairs": n_pairs, "seconds": seconds["term_pairs"],
                         "max": float(max(s.max() for p in pairs for s in p.values()))}
    log(f"term-pair attention: {json.dumps(out['term_pairs'])}, each the max of both directions of "
        "the output_attentions maps, in [0, 1]; 0 short_attention launches")
    del model, maps, pairs

    # 5. the optional tokenizer routes: a missing package fails loudly; an
    # installed transformers runs the HF tokenizer route
    if importlib.util.find_spec("transformers") is not None:
        out["hf_tokenizer"] = hf_tokenizer_route(cfg, workdir, pt)
        launches["cli.index --hf_tokenizer"] = out["hf_tokenizer"]["hf_tokenizer"]["launches"]
        launches["cli.index (its --vocab_path twin)"] = out["hf_tokenizer"]["vocab_path"]["launches"]
    failures = {}
    for pkg, proc in gated:
        _, err = proc.communicate(timeout=600)
        if proc.returncode == 0 or "Error" not in err or pkg not in err:
            raise AssertionError(f"the {pkg} route exited {proc.returncode} without an ImportError naming "
                                 f"it: {err[-800:]}")
        failures[pkg] = {"rc": proc.returncode, "error": err.strip().splitlines()[-1]}
    log(f"gated routes: {json.dumps(failures)}")
    out.update(seconds=seconds, launches=launches, routes=routes, mrr_at_10=mrr, gated=failures,
               phase_s=time.perf_counter() - t_phase)
    log(f"phase 14 in {out['phase_s']:.1f} s; seconds {json.dumps(seconds)}")
    return out



# -- phase 15: expansion (the Llama route) ---------------------------------------------


def flash_shape_check(b, h, s, d, causal, seg, seed) -> dict:
    """``flash_attention``'s forward and backward kernels against the twin
    at one shape, with times: kernel, twin, SDPA (forward and backward,
    timed only), and the bound of the function on this run's inputs.  Its
    operations: the (query, key) pairs this run's mask allows (equal segment
    ids and, causal, key <= query), 4 d of them a pair forward (q k^T, p v)
    and 10 d backward (q k^T again, dv, dp, dq, dk).  Its bytes: forward,
    q, k, v and the segment ids read, o and the fp32 log-sum-exp written;
    backward, q, k, v, o, do, the log-sum-exp and the segment ids read, dq,
    dk and dv written in the inputs' dtype."""
    import torch.nn.functional as F

    from improving_learned_index_tpu_torch.ops import flash_attention as fa

    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_forward(q, k, v, seg, seg, causal, scale)
    o2, lse2 = fa.flash_attention_plain(q, k, v, seg, seg, causal, scale)
    grads = fa.flash_attention_backward(q, k, v, seg, seg, o2, lse2, do, causal, scale)
    want = fa.flash_attention_plain_bwd(q, k, v, seg, seg, o2, lse2, do, causal, scale)
    torch.cuda.synchronize()
    errs, rel = {"o": float((o.float() - o2.float()).abs().max())}, {}
    rel["o"] = errs["o"] / float(o2.float().abs().max())
    for name, a, w in zip(("dq", "dk", "dv"), grads, want):
        errs[name] = float((a.float() - w.float()).abs().max())
        rel[name] = errs[name] / float(w.float().abs().max())
    errs["lse"] = float((lse - lse2).abs().max())
    # p is rounded to bf16 against a running max in the kernel, the final one
    # in the twin: each output within 1% of its largest entry
    bad = {n: r for n, r in rel.items() if not r <= 1e-2}
    if bad or not errs["lse"] <= 1e-4 or not all(torch.isfinite(t).all() for t in (o, *grads)):
        raise AssertionError(f"flash_attention kernels != twin at {[b, h, s, d]}: {errs}, {rel}")
    del o2, lse2, grads, want
    allowed = seg[:, :, None] == seg[:, None, :]
    pairs = h * int((allowed.tril() if causal else allowed).sum())
    del allowed
    # the (64-row, 128-key) tile pairs the kernels computed, by their own
    # count, against the tile rule's
    fwd_tiles, bwd_tiles = fa.computed_tile_pairs(q, k, v, seg, seg, causal, scale)
    rule_tiles = h * int(fa.tile_pairs(seg, seg, causal, s)[0].sum())
    if not fwd_tiles == bwd_tiles == rule_tiles:
        raise AssertionError(f"flash_attention at {[b, h, s, d]} computed {fwd_tiles} forward and {bwd_tiles} "
                             f"backward tile pairs, the tile rule {rule_tiles}")
    tiles = fwd_tiles / (b * h * (s // fa.TILE_Q) * (s // fa.TILE_K))
    io, lse_bytes, seg_bytes = q.element_size() * b * h * s * d, 4 * b * h * s, 2 * seg.element_size() * b * s
    fwd_bound = bound_ms(4 * io + lse_bytes + seg_bytes, 4 * d * pairs, BF16_OPS_PER_S)
    bwd_bound = bound_ms(8 * io + lse_bytes + seg_bytes, 10 * d * pairs, BF16_OPS_PER_S)
    t = {
        "fwd_ms": cuda_ms(lambda: fa.flash_attention_forward(q, k, v, seg, seg, causal, scale)),
        "bwd_ms": cuda_ms(lambda: fa.flash_attention_backward(q, k, v, seg, seg, o, lse, do, causal, scale)),
        "plain_fwd_ms": cuda_ms(lambda: fa.flash_attention_plain(q, k, v, seg, seg, causal, scale), iters=3),
    }
    o2, lse2 = fa.flash_attention_plain(q, k, v, seg, seg, causal, scale)
    t["plain_bwd_ms"] = cuda_ms(lambda: fa.flash_attention_plain_bwd(q, k, v, seg, seg, o2, lse2, do, causal,
                                                                      scale), iters=3)
    del o2, lse2
    # SDPA: causal for the decoder's shape, the segments' equality mask for
    # the packed encoder shape; its backward through autograd
    mask = None if causal else (seg[:, None, :, None] == seg[:, None, None, :])
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]

    def sdpa():
        return F.scaled_dot_product_attention(*leaves, attn_mask=mask, is_causal=causal, scale=scale)

    out = sdpa()
    t["library_fwd_ms"] = cuda_ms(sdpa)
    t["library_bwd_ms"] = cuda_ms(lambda: torch.autograd.grad(out, leaves, do, retain_graph=True))
    del out, leaves
    return {"shape": [b, h, s, d], "causal": causal, "mask": "padded tail" if causal else "packed segments",
            "allowed_pairs": pairs, "tile_pairs_computed": tiles, "max_abs_err": errs, "rel_err": rel, **t,
            "fwd_bound_ms": fwd_bound[0], "fwd_bound_by": fwd_bound[1],
            "bwd_bound_ms": bwd_bound[0], "bwd_bound_by": bwd_bound[1]}


def flash_shapes() -> dict:
    """Row 6's two shapes as (b, h, s, d, causal, segment ids, seed): the
    decoder's [1, 32, 2048, 128] causal with a padded tail (the 7B
    fine-tune's) and the encoder's [64, 12, 512, 64] with packed segments
    of 100 and 72 tokens and 40 of padding."""
    s = EXPAND.seq
    pad = torch.ones(1, s, dtype=torch.int32, device="cuda")
    pad[0, s - s // 8:] = 0
    packed = (torch.arange(512, device="cuda")[None].expand(64, 512) // 100 + 1).int().contiguous()
    packed[:, -40:] = 0
    return {"decoder": (1, 32, s, 128, True, pad, EXPAND.seed),
            "encoder": (64, 12, 512, 64, False, packed, EXPAND.seed + 1)}


def flash_row() -> dict:
    """Row 6 at ``flash_shapes``' two shapes."""
    shapes = flash_shapes()
    dec = flash_shape_check(*shapes["decoder"])
    enc = flash_shape_check(*shapes["encoder"])
    log(f"flash_attention at {dec['shape']} causal: forward {dec['fwd_ms']:.4f} ms (bound "
        f"{dec['fwd_bound_ms']:.4f}, twin {dec['plain_fwd_ms']:.3f}, SDPA {dec['library_fwd_ms']:.4f}), "
        f"backward {dec['bwd_ms']:.4f} ms (bound {dec['bwd_bound_ms']:.4f}, twin {dec['plain_bwd_ms']:.3f}, "
        f"SDPA {dec['library_bwd_ms']:.4f}); at {enc['shape']} packed: forward {enc['fwd_ms']:.4f}, "
        f"backward {enc['bwd_ms']:.4f} ms (bound {enc['fwd_bound_ms']:.4f} + {enc['bwd_bound_ms']:.4f}, SDPA "
        f"{enc['library_fwd_ms']:.4f} + {enc['library_bwd_ms']:.4f}); tile pairs computed (the kernels' count) "
        f"{dec['tile_pairs_computed']:.4f}, {enc['tile_pairs_computed']:.4f}; relative errors {dec['rel_err']}, "
        f"{enc['rel_err']}")
    return {
        "name": "flash_attention",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/flash_attention.cu",
        "replaces": "jax/experimental/pallas/ops/tpu/flash_attention.py:758 (forward), :1121 (dk/dv), "
                    ":1456 (dq)",
        "max_abs_err": max(max(dec["max_abs_err"].values()), max(enc["max_abs_err"].values())),
        "ms": dec["fwd_ms"] + dec["bwd_ms"],
        "plain_ms": dec["plain_fwd_ms"] + dec["plain_bwd_ms"],
        "bound_ms": dec["fwd_bound_ms"] + dec["bwd_bound_ms"],
        "bound_by": dec["fwd_bound_by"] if dec["fwd_bound_by"] == dec["bwd_bound_by"] else "operations",
        "library_ms": dec["library_fwd_ms"] + dec["library_bwd_ms"],
        "note": "ms, plain_ms, bound_ms and library_ms: forward + backward at the 7B fine-tune's shape",
        "shapes": {"decoder": dec, "encoder": enc},
    }


def word_tokenizer(workdir: Path, size: int):
    """The generator's tokenizer: phase 6's ``size - 4`` most frequent words."""
    from collections import Counter

    from improving_learned_index_tpu_torch.expand import WordTokenizer

    counts = Counter(w for line in open(workdir / "collection.tsv", encoding="utf-8")
                     for w in line.split("\t", 1)[1].split())
    return WordTokenizer(sorted(w for w, _ in counts.most_common(size - 4)))



def generation_runs(cfg, params, config, tok, passages) -> dict:
    """7B generation through ``QueryGenerator`` in the four weight/cache
    modes at the JAX CLI's defaults; sequences/s, tokens/s, peak memory."""
    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand import QueryGenerator
    from improving_learned_index_tpu_torch.models.quantization import quantize_params_int4, quantize_params_int8

    gen = GenerationConfig(num_return_sequences=cfg.returns, max_new_tokens=cfg.new_tokens, top_k=cfg.top_k,
                           top_p=cfg.top_p, max_tokens=cfg.max_tokens)
    out = {}
    for mode in ("bf16", "int8", "int4", "kv_int8"):
        t0 = time.perf_counter()
        mp = {"int8": quantize_params_int8, "int4": quantize_params_int4}.get(mode, lambda p: p)(params)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        mc = dataclasses.replace(config, kv_quant="int8" if mode == "kv_int8" else "none")
        generator = QueryGenerator(mp, mc, tok, gen, device=cfg.device)
        ids, mask = generator.prompt_and_tokenize(passages)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        raw = generator.sampler.generate(generator.params, ids, mask, num_return_sequences=cfg.returns,
                                         seed=cfg.seed)
        seconds = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        if raw.shape != (len(passages) * cfg.returns, cfg.new_tokens) or raw.min() < 0 \
                or raw.max() >= config.vocab_size:
            raise AssertionError(f"{mode}: tokens of shape {raw.shape} in [{raw.min()}, {raw.max()}]")
        # a sequence's tokens: up to and with its EOS
        ended = (raw == generator.eos_token_id)
        lengths = np.where(ended.any(1), ended.argmax(1) + 1, raw.shape[1])
        out[mode] = {"quantize_s": quant_s, "seconds": seconds, "sequences": int(raw.shape[0]),
                     "prompt_tokens": int(ids.shape[1]), "new_tokens": int(lengths.sum()),
                     "sequences_per_s": raw.shape[0] / seconds, "tokens_per_s": float(lengths.sum()) / seconds,
                     "peak_gb": peak, "distinct_tokens": int(len(np.unique(raw)))}
        log(f"7B generation {mode}: {raw.shape[0]} sequences x {cfg.new_tokens} tokens from "
            f"{len(passages)} prompts of {ids.shape[1]} in {seconds:.2f} s: "
            f"{out[mode]['sequences_per_s']:.1f} sequences/s, {out[mode]['tokens_per_s']:.1f} tokens/s, "
            f"peak {peak:.2f} GB")
        del mp, generator
        torch.cuda.empty_cache()
    return out


def greedy_check(cfg, config, tok, passages, steps: int = 8) -> dict:
    """Greedy decoding at Llama-2-7B width and depth in fp32: the sampler's
    cache route (the prefill into the caches, then a token a step) against
    one cache-less forward of the prompts and the tokens it chose (the plain
    attention, the causal and padding mask): each chosen token is the
    cache-less route's argmax, or within 1e-3 of its row's largest logit
    (a near-tie), up to and with the sequence's EOS."""
    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand import QueryGenerator
    from improving_learned_index_tpu_torch.models.llama import LlamaModel, init_llama_params

    fcfg = dataclasses.replace(config, dtype="float32")
    gen = GenerationConfig(num_return_sequences=1, max_new_tokens=steps, do_sample=False, max_tokens=cfg.max_tokens)
    generator = QueryGenerator(init_llama_params(fcfg, seed=cfg.seed, device=cfg.device), fcfg, tok, gen,
                               device=cfg.device)
    ids, mask = generator.prompt_and_tokenize(passages)
    got = generator.sampler.generate(generator.params, ids, mask)
    eos, prompt = generator.eos_token_id, ids.shape[1]
    ended = got == eos
    lengths = np.where(ended.any(1), ended.argmax(1) + 1, steps)
    x = torch.as_tensor(np.concatenate([ids, got], 1).astype(np.int64), device=cfg.device)
    m = torch.as_tensor(np.concatenate([mask, np.ones_like(got)], 1).astype(np.int64), device=cfg.device)
    with torch.no_grad():
        logits, _ = LlamaModel(fcfg, device="meta")(x, m, torch.clamp(torch.cumsum(m, 1) - 1, min=0),
                                                    params=generator.params, use_kernels=False)
    logits = logits[:, prompt - 1: prompt - 1 + steps].double().cpu().numpy()
    del generator, x
    torch.cuda.empty_cache()
    exact, worst = 0, 0.0
    for i, n in enumerate(lengths):
        row = logits[i, :n]
        chosen = np.take_along_axis(row, got[i, :n, None].astype(np.int64), 1)[:, 0]
        gap = row.max(1) - chosen
        exact += int((row.argmax(1) == got[i, :n]).sum())
        worst = max(worst, float((gap / (1.0 + np.abs(row).max(1))).max()))
    out = {"prompts": len(passages), "prompt_tokens": prompt, "tokens": int(lengths.sum()), "argmax_equal": exact,
           "worst_relative_gap": worst}
    if worst > 1e-3:
        raise AssertionError(f"7B greedy: the cache route's tokens are not the cache-less route's argmax: {out}")
    log(f"7B greedy (fp32): {exact} of {out['tokens']} cached-route tokens are the cache-less forward's argmax, "
        f"the largest relative gap {worst:.3g}")
    return out


def decode_breakdown(cfg, params, config, batch: int, prompt: int) -> dict:
    """One decode step at the generation's shape, by part (CUDA events): a
    layer's forward (bf16 weights, bf16 cache), the dequantization of one
    layer's int8 and int4 weights (plain torch, at each use), the head."""
    from improving_learned_index_tpu_torch.models import llama as tl
    from improving_learned_index_tpu_torch.models.quantization import (
        dequantize_params, quantize_params_int4, quantize_params_int8,
    )

    model = tl.LlamaModel(config, device="meta")
    dev = cfg.device
    caches = tl.make_kv_caches(config, batch, prompt + cfg.new_tokens, device=dev)
    mask = torch.ones(batch, prompt + cfg.new_tokens, dtype=torch.long, device=dev)
    tok = torch.randint(4, 1000, (batch, 1), device=dev)
    pos = torch.full((batch, 1), prompt, device=dev)
    step = lambda: model(tok, mask, pos, caches, prompt, params=params)  # noqa: E731
    x = torch.randn(batch, 1, config.hidden_size, device=dev).to(torch.bfloat16)
    bias = tl.attention_bias(mask, 1, caches, prompt)
    layer = model.layer_0
    layer_ms = cuda_ms(lambda: tl._call(layer, params["layer_0"], torch.bfloat16, x, pos, bias, caches[0], prompt))
    q8, q4 = quantize_params_int8(params["layer_0"]), quantize_params_int4(params["layer_0"])
    xh = torch.randn(batch, 1, config.hidden_size, device=dev)
    out = {
        "batch": batch, "cache_slots": prompt + cfg.new_tokens,
        "step_ms": cuda_ms(step, iters=5),
        "layer_ms": layer_ms,
        "dequant_int8_layer_ms": cuda_ms(lambda: dequantize_params(q8, torch.bfloat16)),
        "dequant_int4_layer_ms": cuda_ms(lambda: dequantize_params(q4, torch.bfloat16)),
        "head_ms": cuda_ms(lambda: tl._call(model.lm_head, params["lm_head"], torch.bfloat16, xh, torch.float32)),
    }
    log(f"decode step at {batch} sequences, {out['cache_slots']} cache slots: {out['step_ms']:.2f} ms; a layer "
        f"{layer_ms:.3f} ms, its int8 dequantization {out['dequant_int8_layer_ms']:.3f} ms, int4 "
        f"{out['dequant_int4_layer_ms']:.3f} ms; the head {out['head_ms']:.3f} ms")
    del caches
    return out


def finetune_runs(cfg, params, config, tok, passages) -> dict:
    """The 7B QLoRA fine-tune: int8 base, r=16 a=32, S=2048, B=1, layerwise,
    flash attention; the kernel route's loss and adapter gradients against
    the twin route's; steps timed with the flash launches counted; one
    ``trl_4bit`` step."""
    from improving_learned_index_tpu_torch.expand.finetune import Doc2QueryFineTuner
    from improving_learned_index_tpu_torch.expand.lora import lora_leaves
    from improving_learned_index_tpu_torch.ops import flash_attention as fa

    fcfg = dataclasses.replace(config, use_flash_attention=True, max_position_embeddings=cfg.seq)
    doc = " ".join(passages)
    pairs = [(" ".join(doc.split()[i * 50:][: cfg.seq - 40]), " ".join(passages[i].split()[:6]))
             for i in range(cfg.ft_steps + 2)]
    out = {}
    t0 = time.perf_counter()
    # layerwise, as the JAX bench asks (the auto choice at 32 layers anyway)
    ft = Doc2QueryFineTuner(params, fcfg, tok, max_length=cfg.seq, quantize_base="int8", layerwise=True,
                            device=cfg.device)
    torch.cuda.synchronize()
    out["setup_s"] = time.perf_counter() - t0

    def full_batch(pair, tuner=None):
        batch = (tuner or ft).make_batch([pair])
        pad = cfg.seq - batch["input_ids"].shape[1]  # every step the worst case, as the JAX bench pads
        fill = {"input_ids": 0, "labels": -100, "attention_mask": 0}
        return {k: np.pad(v, ((0, 0), (0, pad)), constant_values=fill[k]) for k, v in batch.items()}

    batch = full_batch(pairs[0])
    if batch["input_ids"].shape != (1, cfg.seq) or (batch["labels"] != -100).sum() < 4:
        raise AssertionError(f"fine-tune batch {batch['input_ids'].shape}, "
                             f"{(batch['labels'] != -100).sum()} labels")
    check = {}
    for use in (True, False):
        ft.use_kernels = use
        loss = ft.loss(ft._to_device(batch))
        grads = torch.autograd.grad(loss, lora_leaves(ft.lora))
        check[use] = (float(loss.detach()), torch.cat([g_.flatten() for g_ in grads]))
    ft.use_kernels = True
    cos = float(torch.nn.functional.cosine_similarity(check[True][1], check[False][1], dim=0))
    rel = abs(check[True][0] - check[False][0]) / abs(check[False][0])
    out["loss_kernel"], out["loss_twin"], out["loss_rel_diff"], out["grad_cosine"] = \
        check[True][0], check[False][0], rel, cos
    del check
    if not (rel <= 5e-3 and cos >= 0.99 and np.isfinite(out["loss_kernel"])):
        raise AssertionError(f"7B fine-tune, kernel vs twin: loss {out['loss_kernel']} vs {out['loss_twin']}, "
                             f"gradient cosine {cos}")
    times, launches = [], []
    torch.cuda.reset_peak_memory_stats()
    for i in range(cfg.ft_steps):
        b = full_batch(pairs[i + 1])
        fa.KERNEL.calls.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = float(ft.train_step(b))
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        launches.append(dict(fa.KERNEL.calls))
        if not np.isfinite(loss):
            raise AssertionError(f"fine-tune step {i}: loss {loss}")
    per_step = launches[-1]
    if not (per_step.get("ili_flash_fwd", 0) >= config.num_layers
            and per_step.get("ili_flash_bwd_prep", 0) >= config.num_layers
            and per_step.get("ili_flash_bwd", 0) >= config.num_layers):
        raise AssertionError(f"a fine-tune step launched the flash kernels {per_step}")
    # the step split: forward (the loss through the checkpointed layers),
    # backward (each layer's forward recomputed, then its backward), the rest
    # (AdamW on the adapters)
    b = ft._to_device(full_batch(pairs[1]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss_t = ft.loss(b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    torch.autograd.grad(loss_t, lora_leaves(ft.lora))
    torch.cuda.synchronize()
    split = {"forward_s": t1 - t0, "backward_s": time.perf_counter() - t1}
    del loss_t, b
    step_s = float(np.median(times[1:] if len(times) > 1 else times))
    split["optimizer_and_host_s"] = step_s - split["forward_s"] - split["backward_s"]
    out.update(step_s=times, steady_step_s=step_s, tokens_per_s=cfg.seq / step_s, split=split,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9, launches_per_step=per_step,
               launches=sum(sum(x.values()) for x in launches), last_loss=loss)
    log(f"7B QLoRA (int8 base, r=16, S={cfg.seq}, B=1, layerwise, flash): loss {out['loss_kernel']:.4f} vs "
        f"twin {out['loss_twin']:.4f}, gradient cosine {cos:.6f}; steps {[round(x, 3) for x in times]} s, "
        f"{out['tokens_per_s']:.1f} tokens/s, peak {out['peak_gb']:.2f} GB; launches a step {per_step}; "
        f"split {json.dumps(split)}")
    profile = profile_window(lambda: ft.train_step(full_batch(pairs[1])), top=40,
                             annotations=("flash_attention.backward",))
    out["profile"] = {k: profile[k] for k in ("wall_ms", "device_ms", "device_busy_share", "top_kernels")}
    kinds = {"flash_fwd": 0.0, "flash_bwd": 0.0}
    for kern in profile["top_kernels"]:
        if "flash_fwd_kernel" in kern["kernel"]:
            kinds["flash_fwd"] += kern["ms"]
        elif "flash_bwd" in kern["kernel"]:
            kinds["flash_bwd"] += kern["ms"]
    out["profile"]["flash_ms"] = kinds
    del ft
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    ft4 = Doc2QueryFineTuner.trl_4bit(params, fcfg, tok, max_length=cfg.seq, layerwise=True, device=cfg.device)
    setup4 = time.perf_counter() - t0
    fa.KERNEL.calls.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss4 = float(ft4.train_step(full_batch(pairs[0], ft4)))
    torch.cuda.synchronize()
    out["trl_4bit"] = {"setup_s": setup4, "step_s": time.perf_counter() - t0, "loss": loss4,
                       "launches": dict(fa.KERNEL.calls)}
    out["launches"] += sum(fa.KERNEL.calls.values())
    if not np.isfinite(loss4) or fa.KERNEL.calls.get("ili_flash_bwd", 0) < config.num_layers:
        raise AssertionError(f"trl_4bit step: loss {loss4}, launches {fa.KERNEL.calls}")
    log(f"trl_4bit (int4 base, r=64, clip 0.3): one step {out['trl_4bit']['step_s']:.3f} s, loss {loss4:.4f}")
    del ft4
    torch.cuda.empty_cache()
    return out


def write_hf_llama(path: Path, config, tok, seed: int, device: str) -> None:
    """A local HF Llama directory of ``config``'s shape: a seeded
    ``LlamaForCausalLM`` built on ``device``, and a word-level fast tokenizer
    with ``tok``'s ids (pad, bos, eos, unk, then its words)."""
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"  # local directories only
    import huggingface_hub.constants
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers

    huggingface_hub.constants.HF_HUB_OFFLINE = True
    vocab = {"<pad>": 0, "<s>": 1, "</s>": 2, "<unk>": 3, **{w: i + 4 for i, w in enumerate(tok.words)}}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    transformers.PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>", eos_token="</s>", unk_token="<unk>",
                                         pad_token="<pad>").save_pretrained(path)
    hf = transformers.LlamaConfig(
        vocab_size=config.vocab_size, hidden_size=config.hidden_size, intermediate_size=config.intermediate_size,
        num_hidden_layers=config.num_layers, num_attention_heads=config.num_heads,
        num_key_value_heads=config.num_kv_heads, max_position_embeddings=config.max_position_embeddings,
        rms_norm_eps=config.rms_norm_eps)  # RoPE theta 1e4 and untied embeddings: the defaults
    torch.manual_seed(seed)
    with torch.device(device):
        model = transformers.LlamaForCausalLM(hf)
    model.save_pretrained(path)
    del model
    torch.cuda.empty_cache()


def cli_chain(cfg, workdir: Path, tok, passages) -> dict:
    """The CLIs at full width, depth 2: a seeded local HF Llama directory
    -> ``cli.finetune --llama_path`` (int8 base; ``--output_adapter``,
    ``--output_merged``) -> ``cli.expand --local_path`` (the same weights
    as a local generator) ``--peft_path`` -> ``cli.merge`` -> ``cli.index``
    -> ``cli.quantize`` -> ``cli.invert`` -> ``cli.rank``."""
    from improving_learned_index_tpu_torch.cli.expand import main as expand_main
    from improving_learned_index_tpu_torch.cli.finetune import main as finetune_main
    from improving_learned_index_tpu_torch.cli.index import main as index_main
    from improving_learned_index_tpu_torch.cli.invert import main as invert_main
    from improving_learned_index_tpu_torch.cli.merge import main as merge_main
    from improving_learned_index_tpu_torch.cli.quantize import main as quantize_main
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.core.flax_msgpack import read
    from improving_learned_index_tpu_torch.expand import save_local_generator
    from improving_learned_index_tpu_torch.models.llama import LlamaConfig, llama_flax_params_to_port, load_hf_llama
    from improving_learned_index_tpu_torch.ops import short_attention as sa

    d = workdir / "expand"
    d.mkdir(exist_ok=True)
    seconds, launches = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        rc = fn()
        seconds[name] = time.perf_counter() - t0
        if rc not in (0, None):
            raise AssertionError(f"{name} exited {rc}")

    config = dataclasses.replace(LlamaConfig.llama2_7b(), num_layers=cfg.cli_depth, vocab_size=tok.vocab_size)
    timed("write_hf_model", lambda: write_hf_llama(d / "hf", config, tok, cfg.seed, cfg.device))
    t0 = time.perf_counter()
    params, hf_config, _, eos = load_hf_llama(str(d / "hf"))
    if hf_config != config or eos != tok.EOS:
        raise AssertionError(f"the HF directory reads back as {hf_config}, eos {eos}")
    save_local_generator(d / "gen0", params, hf_config, tok)
    seconds["write_generator"] = time.perf_counter() - t0
    del params
    coll = d / "collection.tsv"
    coll.write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(passages[: cfg.cli_passages])))
    rng = np.random.default_rng(cfg.seed)
    queries = []
    for p in passages[: cfg.cli_pairs]:
        w = p.split()
        at = int(rng.integers(0, max(1, len(w) - 4)))
        queries.append(" ".join(w[at: at + 4]))
    (d / "pairs.tsv").write_text("".join(f"{p}\t{q}\n" for p, q in zip(passages, queries)))
    timed("cli.finetune", lambda: finetune_main([
        "--dataset_path", str(d / "pairs.tsv"), "--output_adapter", str(d / "adapter.msgpack"),
        "--llama_path", str(d / "hf"), "--output_merged", str(d / "merged.msgpack"), "--quantize_base", "int8",
        "--batch_size", "4", "--max_length", "512", "--total_steps", str(cfg.cli_steps), "--device", cfg.device]))
    # the merged tree has the base's names and shapes (checked in the conversion)
    llama_flax_params_to_port(read(d / "merged.msgpack"), config)
    out = d / "expansions.jsonl"
    timed("cli.expand", lambda: expand_main([
        "--collection_path", str(coll), "--output_path", str(out), "--local_path", str(d / "gen0"),
        "--peft_path", str(d / "adapter.msgpack"), "--num_return_sequences", str(cfg.cli_returns),
        "--batch_size", str(cfg.cli_batch), "--seed", str(cfg.seed), "--device", cfg.device]))
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    if [r["doc_id"] for r in rows] != [str(i) for i in range(cfg.cli_passages)] \
            or any(len(r["queries"]) != cfg.cli_returns for r in rows):
        raise AssertionError("cli.expand wrote the wrong rows")
    merged = d / "merged.tsv"
    timed("cli.merge", lambda: merge_main([
        "--collection_path", str(coll), "--queries_path", str(out), "--output_path", str(merged),
        "--vocab_path", str(workdir / "vocab.txt")]))
    lines = merged.read_text().splitlines()
    grown = sum(len(line) > len(p) + len(str(i)) + 1 for i, (line, p) in enumerate(zip(lines, passages)))
    if len(lines) != cfg.cli_passages or not all(
            line.split("\t", 1)[1].startswith(p) for line, p in zip(lines, passages)):
        raise AssertionError("cli.merge: each merged passage must start with its original text")
    sa.KERNEL.calls.clear()
    fwd = d / "forward.txt"
    timed("cli.index", lambda: index_main([
        "--collection_path", str(merged), "--output_file_path", str(fwd), "--vocab_path",
        str(workdir / "vocab.txt"), "--hf_name", str(workdir / "bert"), "--max_length", "256",
        "--model_batch_size", "128", "--device", cfg.device]))
    launches["cli.index (expanded)"] = sa.KERNEL.launches
    timed("cli.quantize", lambda: quantize_main(["-i", str(fwd), "-o", str(d / "quantized.txt")]))
    timed("cli.invert", lambda: invert_main(["-i", str(d / "quantized.txt"), "-o", str(d / "index")]))
    (d / "queries.tsv").write_text("".join(f"{i}\t{q}\n" for i, q in enumerate(queries)))
    timed("cli.rank", lambda: rank_main([
        "--index_path", str(d / "index"), "--queries_path", str(d / "queries.tsv"), "--output_path",
        str(d / "run.tsv"), "--vocab_path", str(workdir / "vocab.txt"), "--top_k", "10",
        "--device", cfg.device]))
    ranked = {}
    for line in (d / "run.tsv").read_text().splitlines():
        qid, pid = line.split("\t")[:2]
        ranked.setdefault(qid, []).append(pid)
    hits = sum(str(i) in ranked.get(str(i), []) for i in range(len(queries)))
    if len(ranked) < len(queries) // 2 or any(pid not in {str(i) for i in range(cfg.cli_passages)}
                                              for pids in ranked.values() for pid in pids):
        raise AssertionError(f"cli.rank over the expanded index: {len(ranked)} of {len(queries)} queries ranked")
    result = {"seconds": seconds, "launches": launches, "expanded_passages": len(rows), "grown": grown,
              "rank_hits_at_10": hits, "queries": len(queries)}
    log(f"CLI chain (7B width, depth {cfg.cli_depth}): {json.dumps(seconds)}; {grown} of {len(lines)} passages "
        f"grew; {hits} of {len(queries)} queries find their passage in the top 10")
    shutil.rmtree(d)
    return result


def encoder_flash_route(cfg, workdir: Path, passages: list) -> dict:
    """The encoder's flash route: BERT-base (phase 7's seeded trunk) with
    ``use_flash_attention`` at S=512, where short attention does not apply,
    through ``DeepImpact.get_impact_scores_batch`` ([64, 12, 512, 64] a
    layer): 12 forward launches a batch, impacts within phase 7's rule of
    the ``use_kernels=False`` route."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import DeepImpact, load_hf_checkpoint
    from improving_learned_index_tpu_torch.ops import flash_attention as fa
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    config = EncoderConfig.bert_base(use_flash_attention=True)
    tok = ImpactTokenizer(WordPieceVocab.load(workdir / "vocab.txt"), 512)
    sd = load_hf_checkpoint(workdir / "bert", config)
    docs = passages[: cfg.enc_docs]
    fa.KERNEL.calls.clear()
    model = DeepImpact(config, tok, state_dict=sd, device=cfg.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = [dict(x) for x in model.get_impact_scores_batch(docs)]
    seconds = time.perf_counter() - t0
    launches = dict(fa.KERNEL.calls)
    if launches != {"ili_flash_fwd": config.num_layers}:
        raise AssertionError(f"the S=512 encode launched {launches}")
    plain = DeepImpact(config, tok, state_dict=sd, device=cfg.device, use_kernels=False)
    ref = [dict(x) for x in plain.get_impact_scores_batch(docs)]
    peak = max(max(d.values(), default=0.0) for d in ref)
    err = impacts_close(got, ref, 0.05 * peak, 0.002 * peak, "encoder flash route vs plain")
    log(f"BERT-base at S=512 through flash_attention: {len(docs)} passages in {seconds:.2f} s, "
        f"{launches['ili_flash_fwd']} launches, impacts against the plain route {err}")
    del model, plain
    torch.cuda.empty_cache()
    return {"docs": len(docs), "seconds": seconds, "launches": launches["ili_flash_fwd"], "errors": err}


def run_expansion(cfg, workdir: Path) -> dict:
    """Phase 15: the Llama route of expansion at Llama-2-7B width."""
    from improving_learned_index_tpu_torch.models.llama import LlamaConfig, init_llama_params
    from improving_learned_index_tpu_torch.ops import flash_attention as fa

    log("== phase 15: expansion: flash attention, 7B generation, the 7B QLoRA fine-tune, the CLI chain")
    t_phase = time.perf_counter()
    row = flash_row()
    tok = word_tokenizer(workdir, LlamaConfig.llama2_7b().vocab_size)
    with open(workdir / "collection.tsv", encoding="utf-8") as f:
        passages = [line.split("\t", 1)[1].rstrip("\n") for line in islice(f, 4096)]
    encoder = encoder_flash_route(cfg, workdir, passages)
    config = dataclasses.replace(LlamaConfig.llama2_7b(), vocab_size=tok.vocab_size)
    t0 = time.perf_counter()
    params = init_llama_params(config, seed=cfg.seed, device=cfg.device, dtype=torch.bfloat16)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    log(f"7B parameters (bf16, seeded) built on the card in {build_s:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    fa.KERNEL.calls.clear()
    generation = generation_runs(cfg, params, config, tok, passages[: cfg.gen_passages])
    generation["flash_launches"] = fa.KERNEL.launches  # generation runs the cache route: none
    generation["greedy"] = greedy_check(cfg, config, tok, passages[: cfg.gen_passages])
    breakdown = decode_breakdown(cfg, params, config, cfg.gen_passages * cfg.returns, 128)
    finetune = finetune_runs(cfg, params, config, tok, passages[: 512])
    del params
    torch.cuda.empty_cache()
    chain = cli_chain(cfg, workdir, tok, passages)
    row["launches_by_path"] = {"7B QLoRA fine-tune (int8 + trl_4bit steps)": finetune.pop("launches"),
                               "DeepImpact S=512 encode (use_flash_attention)": encoder["launches"],
                               "7B generation (cache route)": generation["flash_launches"]}
    row["launches"] = sum(row["launches_by_path"].values())
    seconds = time.perf_counter() - t_phase
    log(f"phase 15 in {seconds:.1f} s")
    return {"row": row, "encoder_s512": encoder, "build_s": build_s, "generation": generation, "decode_breakdown": breakdown,
            "finetune": finetune, "cli_chain": chain, "seconds": seconds}


# -- phase 16: expansion's T5/mT5 route ----------------------------------------------------


class T5WordTokenizer:
    """A word tokenizer with T5's conventions: pad 0, EOS 1 appended to every
    text, unk 2, then one id per word; ids past the words (the model's
    250,112-row vocabulary is wider) decode to nothing."""

    PAD, EOS, UNK = 0, 1, 2

    def __init__(self, words):
        self.words = list(words)
        self._w2i = {w: i + 3 for i, w in enumerate(self.words)}

    def encode(self, text):
        return [self._w2i.get(w, self.UNK) for w in text.split()] + [self.EOS]

    def decode(self, ids):
        n = len(self.words)
        return " ".join(self.words[i - 3] for i in map(int, ids) if 3 <= i < n + 3)


def eos_rule_violations(raw: np.ndarray, eos: int) -> int:
    """Cells after a row's first EOS that hold another token (trap: a finished
    row is forced to EOS, and the buffer starts as EOS)."""
    after = np.maximum.accumulate(raw == eos, axis=1)
    return int((after & (raw != eos)).sum())


def t5_generation_runs(cfg, params, config, tok, passages) -> dict:
    """mT5-base generation through ``T5QueryGenerator`` at the JAX CLI's
    defaults, ``cfg.batches`` batches of ``cfg.batch_docs`` passages, with the
    fp32 tree and its int8 and int4 quantizations; sequences/s, tokens/s,
    peak memory; every token in range, the EOS rule held."""
    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand import T5QueryGenerator
    from improving_learned_index_tpu_torch.models.quantization import quantize_params_int4, quantize_params_int8

    gen = GenerationConfig(num_return_sequences=cfg.returns, max_new_tokens=cfg.new_tokens, top_k=cfg.top_k,
                           top_p=cfg.top_p, max_tokens=cfg.max_tokens)
    out = {}
    for mode in ("fp32", "int8", "int4"):
        t0 = time.perf_counter()
        mp = {"int8": quantize_params_int8, "int4": quantize_params_int4}.get(mode, lambda p: p)(params)
        torch.cuda.synchronize()
        quant_s = time.perf_counter() - t0
        generator = T5QueryGenerator(mp, config, tok, gen, pad_token_id=tok.PAD, eos_token_id=tok.EOS,
                                     device=cfg.device)
        torch.cuda.reset_peak_memory_stats()
        seconds, tokens, sequences, enc_lens, steps = 0.0, 0, 0, [], []
        for b in range(cfg.batches):
            ids, mask = generator.tokenize(passages[b * cfg.batch_docs:(b + 1) * cfg.batch_docs])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw = generator.sampler.generate(generator.params, ids, mask, num_return_sequences=cfg.returns,
                                             seed=cfg.seed + b)
            seconds += time.perf_counter() - t0
            if raw.shape != (cfg.batch_docs * cfg.returns, cfg.new_tokens) or raw.min() < 0 \
                    or raw.max() >= config.vocab_size:
                raise AssertionError(f"T5 {mode}: tokens of shape {raw.shape} in [{raw.min()}, {raw.max()}]")
            bad = eos_rule_violations(raw, tok.EOS)
            if bad:
                raise AssertionError(f"T5 {mode}: {bad} tokens after a row's EOS are not EOS")
            ended = raw == tok.EOS
            lengths = np.where(ended.any(1), ended.argmax(1) + 1, raw.shape[1])
            tokens += int(lengths.sum())
            sequences += raw.shape[0]
            enc_lens.append(int(ids.shape[1]))
            steps.append(int(lengths.max()))
        peak = torch.cuda.max_memory_allocated() / 1e9
        out[mode] = {"quantize_s": quant_s, "seconds": seconds, "sequences": sequences, "new_tokens": tokens,
                     "encoder_lengths": enc_lens, "decode_steps": steps, "sequences_per_s": sequences / seconds,
                     "tokens_per_s": tokens / seconds, "loop_step_ms": 1e3 * seconds / sum(steps), "peak_gb": peak}
        log(f"mT5-base generation {mode}: {sequences} sequences x {cfg.new_tokens} tokens from {cfg.batches} "
            f"batches of {cfg.batch_docs} passages (encoder lengths {enc_lens}) in {seconds:.2f} s: "
            f"{out[mode]['sequences_per_s']:.1f} sequences/s, {out[mode]['tokens_per_s']:.1f} tokens/s, "
            f"{out[mode]['loop_step_ms']:.2f} ms a step, peak {peak:.2f} GB")
        del mp, generator
        torch.cuda.empty_cache()
    return out


def t5_step_breakdown(cfg, params, config, batch: int, enc_len: int) -> dict:
    """The encoder at [batch, enc_len] and one decode step at ``batch`` rows
    (cache index ``new_tokens // 2``), by part (CUDA events): the decoder's
    forward (12 layers and the fp32 head, on the sampler's once-built
    position bias), the head alone, the
    top-k/top-p filter (its two full sorts of [batch, vocab]), one such
    sort, and the whole draw (the filter, the Gumbel noise, the argmax);
    the forward again with the int8 and the int4 tree; three steps (forward
    and draw) profiled: the card's busy share and its kernels."""
    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand.sampling import sample_token, top_k_top_p_filter
    from improving_learned_index_tpu_torch.models.quantization import quantize_params_int4, quantize_params_int8
    from improving_learned_index_tpu_torch.models.t5 import T5Model, make_t5_kv_caches

    dev = cfg.device
    model = T5Model(config, device="meta")
    g = torch.Generator(device=dev)
    g.manual_seed(cfg.seed)
    ids = torch.randint(3, 32000, (batch, enc_len), generator=g, device=dev)
    mask = torch.ones_like(ids)
    gen = GenerationConfig(top_k=cfg.top_k, top_p=cfg.top_p)
    with torch.no_grad():
        encoder_ms = cuda_ms(lambda: model.encode(ids, mask, params=params), iters=3, warmup=1)
        enc_out = model.encode(ids, mask, params=params)
        cross = model.compute_cross_kvs(enc_out, params=params)
        caches = make_t5_kv_caches(config, batch, cfg.new_tokens + 1, device=dev)
        cur = torch.randint(3, 32000, (batch, 1), generator=g, device=dev)
        t = cfg.new_tokens // 2

        self_bias = model.decoder_self_bias(0, cfg.new_tokens, cfg.new_tokens + 1, params, dev)[:, :, t:t + 1]

        def step(tree):
            return model.decode(cur, enc_out, mask, kv_caches=caches, cache_index=t, cross_kvs=cross, params=tree,
                                self_bias=self_bias)

        logits = step(params)[0][:, 0]
        x = torch.randn(batch, 1, config.d_model, generator=g, device=dev)
        out = {"batch": batch, "encoder_length": enc_len, "cache_slots": cfg.new_tokens + 1,
               "encoder_ms": encoder_ms, "decoder_forward_ms": cuda_ms(lambda: step(params), iters=5),
               "head_ms": cuda_ms(lambda: model._logits(x, params)),
               "filter_ms": cuda_ms(lambda: top_k_top_p_filter(logits, cfg.top_k, cfg.top_p), iters=5),
               "one_sort_ms": cuda_ms(lambda: torch.sort(logits, dim=-1), iters=5),
               "draw_ms": cuda_ms(lambda: sample_token(logits, gen, g), iters=5)}
        for name, quant in (("int8", quantize_params_int8), ("int4", quantize_params_int4)):
            tree = quant(params)
            out[f"decoder_forward_{name}_ms"] = cuda_ms(lambda: step(tree), iters=5)
            del tree
        profile = profile_window(lambda: [sample_token(step(params)[0][:, 0], gen, g) for _ in range(3)], top=8)
    out["step_ms"] = out["decoder_forward_ms"] + out["draw_ms"]
    out["profile_3_steps"] = {k: profile[k] for k in ("wall_ms", "device_ms", "device_busy_share", "top_kernels")}
    log(f"mT5-base at {batch} rows: encoder (S={enc_len}) {encoder_ms:.2f} ms; a decode step {out['step_ms']:.2f} ms "
        f"= the forward {out['decoder_forward_ms']:.2f} (the fp32 head {out['head_ms']:.2f}; int8 tree "
        f"{out['decoder_forward_int8_ms']:.2f}, int4 {out['decoder_forward_int4_ms']:.2f}) + the draw "
        f"{out['draw_ms']:.2f} (top-k/top-p filter {out['filter_ms']:.2f}, one full sort {out['one_sort_ms']:.2f}); "
        f"3 profiled steps: {json.dumps(out['profile_3_steps'])}")
    del caches, cross, enc_out
    torch.cuda.empty_cache()
    return out


def t5_greedy_check(cfg, params, config, tok, passages) -> dict:
    """Greedy decoding at mT5-base width and depth in fp32 compute: the cache
    route's ``cfg.greedy_steps`` tokens against the argmax of one
    teacher-forced forward over the decoder-start id and the chosen tokens
    (JAX ``tests/test_t5.py``'s check): each chosen token is that argmax,
    or within 1e-3 of its row's largest logit (a near-tie), up to and with
    the row's EOS."""
    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand import T5QueryGenerator
    from improving_learned_index_tpu_torch.models.t5 import T5Model

    fcfg = dataclasses.replace(config, dtype="float32")
    steps = cfg.greedy_steps
    gen = GenerationConfig(num_return_sequences=1, max_new_tokens=steps, do_sample=False, max_tokens=cfg.max_tokens)
    generator = T5QueryGenerator(params, fcfg, tok, gen, pad_token_id=tok.PAD, eos_token_id=tok.EOS,
                                 device=cfg.device)
    ids, mask = generator.tokenize(passages)
    got = generator.sampler.generate(generator.params, ids, mask)
    dec = np.concatenate([np.zeros((len(passages), 1), np.int64), got[:, :-1]], 1)
    dev = cfg.device
    with torch.no_grad():
        logits = T5Model(fcfg, device="meta")(torch.as_tensor(ids, dtype=torch.long, device=dev),
                                              torch.as_tensor(mask, dtype=torch.long, device=dev),
                                              torch.as_tensor(dec, device=dev), params=generator.params)
    logits = logits.double().cpu().numpy()
    ended = got == tok.EOS
    lengths = np.where(ended.any(1), ended.argmax(1) + 1, steps)
    exact, worst = 0, 0.0
    for i, n in enumerate(lengths):
        row = logits[i, :n]
        chosen = np.take_along_axis(row, got[i, :n, None].astype(np.int64), 1)[:, 0]
        exact += int((row.argmax(1) == got[i, :n]).sum())
        worst = max(worst, float(((row.max(1) - chosen) / (1.0 + np.abs(row).max(1))).max()))
    out = {"prompts": len(passages), "encoder_length": int(ids.shape[1]), "tokens": int(lengths.sum()),
           "argmax_equal": exact, "worst_relative_gap": worst}
    if worst > 1e-3:
        raise AssertionError(f"mT5-base greedy: the cache route's tokens are not the teacher-forced argmax: {out}")
    log(f"mT5-base greedy (fp32): {exact} of {out['tokens']} cached-route tokens are the teacher-forced argmax, "
        f"the largest relative gap {worst:.3g}")
    del generator
    torch.cuda.empty_cache()
    return out


def t5_cut_inputs(tok, passages):
    """Teacher-forcing inputs from two passages: their first 32 tokens (the
    shorter right-padded) for the encoder, and the decoder-start id followed
    by 7 of them for the decoder; numpy int64."""
    ids = [tok.encode(p)[:32] for p in passages[:2]]
    length = max(map(len, ids))
    enc = np.zeros((2, length), np.int64)
    mask = np.zeros((2, length), np.int64)
    for i, e in enumerate(ids):
        enc[i, :len(e)], mask[i, :len(e)] = e, 1
    return enc, mask, np.concatenate([np.zeros((2, 1), np.int64), enc[:, :7]], 1)


def t5_card_vs_cpu(cfg, params, config, tok, passages) -> dict:
    """A 2-layer cut of mT5-base (2 encoder and 2 decoder layers, the full
    vocabulary): the relative-position buckets the card computes from
    ``relative_position_bucket`` against the CPU's over [-4096, 4096] both
    ways (printed: the model builds its tables on the host), then, for
    ``cfg.cut_trees`` trees (the full params' first layers, then cuts drawn
    anew from the next seeds) on two passages each, the model's
    position-bias tables on the card equal to the CPU's and teacher-forced
    logits on the card against the CPU's: fp32 compute within 1e-3
    absolute; bf16 within half of the smaller of the two devices' own
    bf16-from-fp32 gaps on the same tree and input.  Both devices round the
    same tensors to bf16 at the same places and differ only where another
    summation order flips a rounding, which a random tree amplifies as it
    amplifies bf16's rounding itself (each device's bf16 logits stand
    19-33% of the largest |logit| from its fp32 ones, the card's from the
    CPU's 4.2-7.5%, on 3 trees).  A card that skipped a bf16 rounding would
    read near the bf16-from-fp32 gap, and a wrong weight or bias further."""
    from improving_learned_index_tpu_torch.models.llama import tree_to
    from improving_learned_index_tpu_torch.models.t5 import T5Model, init_t5_params, relative_position_bucket

    rel = torch.arange(-4096, 4097)
    card_buckets = {str(b): int((relative_position_bucket(rel.to(cfg.device), b, config.relative_attention_num_buckets,
                                                          config.relative_attention_max_distance).cpu()
                                 != relative_position_bucket(rel, b, config.relative_attention_num_buckets,
                                                             config.relative_attention_max_distance)).sum())
                    for b in (True, False)}
    cut = dataclasses.replace(config, num_encoder_layers=cfg.cut_layers, num_decoder_layers=cfg.cut_layers)
    keep = {"shared", "lm_head", "encoder_final_norm", "decoder_final_norm", "encoder_rel_bias", "decoder_rel_bias",
            *(f"{s}_layer_{i}" for s in ("encoder", "decoder") for i in range(cfg.cut_layers))}
    out = {"card_bucket_cells_differing": card_buckets, "readings": []}
    failed = []
    with torch.no_grad():
        for r in range(cfg.cut_trees):
            card = {k: v for k, v in params.items() if k in keep} if r == 0 \
                else init_t5_params(cut, seed=cfg.seed + r, device=cfg.device)
            cpu = tree_to(card, "cpu")
            enc, mask, dec = t5_cut_inputs(tok, passages[2 * r:2 * r + 2])
            logits, tables = {}, {}
            for dtype in ("float32", "bfloat16"):
                model = T5Model(dataclasses.replace(cut, dtype=dtype), device="meta")
                for where, tree, dev in (("card", card, cfg.device), ("cpu", cpu, "cpu")):
                    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
                    tables[where] = model.decoder_self_bias(3, 1, cfg.new_tokens + 1, tree, dev).cpu()
                    logits[dtype, where] = model(t(enc), t(mask), t(dec), params=tree).float().cpu()
            scale = float(logits["float32", "cpu"].abs().max())

            def gap(a, b):
                return float((logits[a] - logits[b]).abs().max())

            reading = {"tree": "phase params" if r == 0 else f"seed {cfg.seed + r}", "encoder_length": enc.shape[1],
                       "max_abs_logit": scale, "bias_tables_equal": bool(torch.equal(tables["card"], tables["cpu"])),
                       "fp32_card_vs_cpu": gap(("float32", "card"), ("float32", "cpu")),
                       "bf16_card_vs_cpu_share": gap(("bfloat16", "card"), ("bfloat16", "cpu")) / scale,
                       "bf16_vs_fp32_card_share": gap(("bfloat16", "card"), ("float32", "card")) / scale,
                       "bf16_vs_fp32_cpu_share": gap(("bfloat16", "cpu"), ("float32", "cpu")) / scale}
            reading["bf16_limit_share"] = 0.5 * min(reading["bf16_vs_fp32_card_share"],
                                                    reading["bf16_vs_fp32_cpu_share"])
            out["readings"].append(reading)
            if not reading["bias_tables_equal"] or reading["fp32_card_vs_cpu"] > 1e-3 \
                    or reading["bf16_card_vs_cpu_share"] > reading["bf16_limit_share"]:
                failed.append(reading)
            del card, cpu
    log(f"mT5-base cut to {cfg.cut_layers}+{cfg.cut_layers} layers, card vs CPU: {json.dumps(out)}")
    if failed:
        raise AssertionError(f"mT5-base cut, card vs CPU: {failed} past 1e-3 (fp32) or the bf16 limit")
    torch.cuda.empty_cache()
    return out


def t5_port_vs_hf(cfg, path: Path, params, config, tok, passages) -> dict:
    """The port's teacher-forced fp32 logits on ``load_hf_t5``'s tree
    against ``T5ForConditionalGeneration``'s own forward from the same
    directory, both on the card, within 1e-4 of the largest |logit| (fp32,
    TF32 off: only the summation order differs); and HF's relative
    position buckets on the card against the port's host table (HF leaves
    out the ``1e-6``; printed)."""
    import transformers
    from transformers.models.t5.modeling_t5 import T5Attention as HFT5Attention

    from improving_learned_index_tpu_torch.models.llama import tree_to
    from improving_learned_index_tpu_torch.models.t5 import T5Model, relative_position_bucket

    dev = cfg.device
    rel = torch.arange(-4096, 4097)
    buckets = {str(b): int((HFT5Attention._relative_position_bucket(
        rel.to(dev), bidirectional=b, num_buckets=config.relative_attention_num_buckets,
        max_distance=config.relative_attention_max_distance).cpu()
        != relative_position_bucket(rel, b, config.relative_attention_num_buckets,
                                    config.relative_attention_max_distance)).sum()) for b in (True, False)}
    hf = transformers.T5ForConditionalGeneration.from_pretrained(str(path), local_files_only=True)
    hf = hf.to(dev).float().eval()
    enc, mask, dec = (torch.as_tensor(a, device=dev) for a in t5_cut_inputs(tok, passages))
    with torch.no_grad():
        want = hf(input_ids=enc, attention_mask=mask, decoder_input_ids=dec).logits.float()
        got = T5Model(dataclasses.replace(config, dtype="float32"), device="meta")(
            enc, mask, dec, params=tree_to(params, dev))
    out = {"layers": [config.num_encoder_layers, config.num_decoder_layers], "encoder_length": int(enc.shape[1]),
           "hf_bucket_cells_differing": buckets, "max_abs_logit": float(want.abs().max()),
           "max_abs_diff": float((got - want).abs().max())}
    del hf
    torch.cuda.empty_cache()
    log(f"mT5-base from the HF directory, the port against T5ForConditionalGeneration on the card (fp32): "
        f"{json.dumps(out)}")
    if out["max_abs_diff"] > 1e-4 * out["max_abs_logit"]:
        raise AssertionError(f"the port's logits from load_hf_t5 differ from HF's own forward: {out}")
    return out


def hf_t5_model(config, seed: int, device: str):
    """A seeded ``transformers.T5ForConditionalGeneration`` of ``config``'s
    shape (its feed-forward and its head's tie) built on ``device``, with
    both stacks embedding through ``shared``, as a T5 checkpoint does."""
    import transformers

    tie = config.tie_word_embeddings
    hf = transformers.T5Config(
        vocab_size=config.vocab_size, d_model=config.d_model, d_kv=config.d_kv, num_heads=config.num_heads,
        d_ff=config.d_ff, num_layers=config.num_encoder_layers, num_decoder_layers=config.num_decoder_layers,
        relative_attention_num_buckets=config.relative_attention_num_buckets,
        relative_attention_max_distance=config.relative_attention_max_distance,
        feed_forward_proj="gated-gelu" if config.gated_act else "relu", tie_word_embeddings=tie, dropout_rate=0.0,
        decoder_start_token_id=0, eos_token_id=1, pad_token_id=0)
    # transformers 5 forces the keyword to True (an untied head's unscaled
    # outputs become scale_decoder_outputs=False): set both after the fact
    hf.tie_word_embeddings = hf.scale_decoder_outputs = tie
    torch.manual_seed(seed)
    with torch.device(device):
        model = transformers.T5ForConditionalGeneration(hf)
    # transformers 5 unties an untied config's embed_tokens from shared too
    # and draws each anew: give them shared's values, as in an mT5 checkpoint
    with torch.no_grad():
        for stack in (model.encoder, model.decoder):
            stack.embed_tokens.weight.copy_(model.shared.weight)
    return model.eval()


def write_hf_t5(path: Path, config, words, seed: int, device: str) -> None:
    """A local HF T5 directory of ``config``'s shape: ``hf_t5_model``, and a
    word-level fast tokenizer with T5's conventions (pad 0, EOS 1 appended to
    every text, unk 2, then ``words``)."""
    os.environ["HF_HUB_OFFLINE"] = os.environ["TRANSFORMERS_OFFLINE"] = "1"  # local directories only
    import huggingface_hub.constants
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    huggingface_hub.constants.HF_HUB_OFFLINE = True
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2, **{w: i + 3 for i, w in enumerate(words)}}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.WhitespaceSplit()
    tk.post_processor = processors.TemplateProcessing(single="$A </s>", special_tokens=[("</s>", 1)])
    transformers.PreTrainedTokenizerFast(tokenizer_object=tk, eos_token="</s>", unk_token="<unk>",
                                         pad_token="<pad>").save_pretrained(path)
    model = hf_t5_model(config, seed, device)
    model.save_pretrained(path)
    del model
    torch.cuda.empty_cache()


def t5_cli_route(cfg, workdir: Path, words, passages) -> dict:
    """``cli.expand --t5`` on a seeded local HF directory at mT5-base width:
    greedy over ``cfg.cli_passages`` passages, ``cfg.cli_greedy_returns``
    sequences each (the file must equal what the in-process
    ``T5QueryGenerator`` writes from the same directory), then ``--int8``
    (sampled at the CLI's defaults): a row per passage, 80 queries each."""
    from improving_learned_index_tpu_torch.cli.expand import main as expand_main
    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand import T5QueryGenerator, generate_expansions
    from improving_learned_index_tpu_torch.models.t5 import T5Config, load_hf_t5

    d = workdir / "t5"
    d.mkdir(exist_ok=True)
    seconds = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        rc = fn()
        seconds[name] = time.perf_counter() - t0
        if rc not in (0, None):
            raise AssertionError(f"{name} exited {rc}")

    config = T5Config.mt5_base()
    timed("write_hf_model", lambda: write_hf_t5(d / "hf", config, words, cfg.seed, cfg.device))
    coll = d / "collection.tsv"
    coll.write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(passages[: cfg.cli_passages])))
    gen = GenerationConfig(num_return_sequences=cfg.cli_greedy_returns, max_new_tokens=cfg.new_tokens,
                           max_tokens=cfg.max_tokens, do_sample=False)
    common = ["--collection_path", str(coll), "--t5", str(d / "hf"), "--seed", str(cfg.seed), "--device", cfg.device,
              "--max_new_tokens", str(cfg.new_tokens), "--max_tokens", str(cfg.max_tokens)]
    timed("cli.expand --t5 --greedy", lambda: expand_main(common + ["--output_path", str(d / "greedy.jsonl"),
                                                                    "--greedy", "--num_return_sequences",
                                                                    str(cfg.cli_greedy_returns)]))
    t0 = time.perf_counter()
    params, hf_config, tok, ids = load_hf_t5(str(d / "hf"))
    if hf_config != config or ids != {"pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0}:
        raise AssertionError(f"the HF directory reads back as {hf_config}, ids {ids}")
    hf_check = t5_port_vs_hf(cfg, d / "hf", params, config, tok, passages)
    generator = T5QueryGenerator(params, config, tok, gen, device=cfg.device, **ids)
    del params
    generate_expansions(generator, coll, d / "in_process.jsonl", seed=cfg.seed)
    seconds["in-process T5QueryGenerator"] = time.perf_counter() - t0
    del generator
    torch.cuda.empty_cache()
    if not files_equal(d / "greedy.jsonl", d / "in_process.jsonl"):
        raise AssertionError("cli.expand --t5 --greedy differs from the in-process T5QueryGenerator")
    timed("cli.expand --t5 --int8", lambda: expand_main(common + [
        "--output_path", str(d / "int8.jsonl"), "--int8", "--num_return_sequences", str(cfg.returns),
        "--top_k", str(cfg.top_k), "--top_p", str(cfg.top_p)]))
    out = {"seconds": seconds, "port_vs_hf": hf_check}
    for name, returns in (("greedy", cfg.cli_greedy_returns), ("int8", cfg.returns)):
        rows = [json.loads(line) for line in (d / f"{name}.jsonl").read_text().splitlines()]
        if [r["doc_id"] for r in rows] != [str(i) for i in range(cfg.cli_passages)] \
                or any(len(r["queries"]) != returns for r in rows):
            raise AssertionError(f"cli.expand --t5 ({name}) wrote the wrong rows")
        out[f"{name}_nonempty_queries"] = sum(bool(q) for r in rows for q in r["queries"])
    log(f"cli.expand --t5 (mT5-base, {cfg.cli_passages} passages): {json.dumps(seconds)}; the greedy file equals "
        f"the in-process generator's; non-empty queries {out['greedy_nonempty_queries']} greedy, "
        f"{out['int8_nonempty_queries']} int8")
    shutil.rmtree(d)
    return out


def precomputed_reference(passages, store, vocab_path: Path, style: str, percentile: float) -> list:
    """The precomputed expansions, written here from their definitions:
    doc2query-- keeps a passage's queries scoring at or above the numpy
    percentile of all scores and appends the set of their terms that the
    passage lacks (a set: the order is the process's); TILDE appends, in
    order, each stored term not among the passage's terms.  Terms are the
    WordPiece tokenizer's ``process_query``.  Returns (doc id, passage,
    suffix) a line: the suffix a set for doc2query--, a string for TILDE."""
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    tok = ImpactTokenizer(WordPieceVocab.load(vocab_path), 512)
    threshold = float(np.percentile(np.array([s for qs in store for _, s in qs], np.float64), percentile))
    rows = []
    for i, (doc, qs) in enumerate(zip(passages, store)):
        doc_terms = tok.process_query(doc)
        if style == "tilde":
            rows.append((str(i), doc, " ".join(q for q, _ in qs if q not in doc_terms)))
        else:
            kept = [q for q, s in qs if s >= threshold]
            rows.append((str(i), doc, set(tok.process_query(" ".join(kept))) - set(doc_terms) if kept else set()))
    return rows


def t5_precomputed_route(cfg, workdir: Path, words, passages) -> dict:
    """``cli.expand_precomputed`` in both styles over a seeded store of
    ``cfg.store_passages`` passages x ``cfg.store_queries`` scored queries
    (2-6 of the first 4,000 words each, scores in [0, 1)), every line
    against ``precomputed_reference``."""
    from improving_learned_index_tpu_torch.cli.expand_precomputed import main as precomputed_main

    d = workdir / "precomputed"
    d.mkdir(exist_ok=True)
    rng = np.random.default_rng(cfg.seed)
    docs = passages[: cfg.store_passages]
    pool = np.array(words[:4000])
    store = []
    for _ in docs:
        lens = rng.integers(2, 7, cfg.store_queries)
        picks = rng.choice(pool, int(lens.sum()))
        cuts = np.concatenate([[0], np.cumsum(lens)])
        scores = np.round(rng.random(cfg.store_queries), 4)
        store.append([(" ".join(picks[a:b]), float(s)) for a, b, s in zip(cuts[:-1], cuts[1:], scores)])
    (d / "collection.tsv").write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(docs)))
    with open(d / "store.jsonl", "w", encoding="utf-8") as f:
        for i, qs in enumerate(store):
            f.write(json.dumps({"doc_id": str(i), "queries": [{"query": q, "score": s} for q, s in qs]}) + "\n")
    out = {"passages": len(docs), "queries": len(docs) * cfg.store_queries, "seconds": {}}
    # --threshold 0.7, a fraction, is the 70th percentile (0.7 * 100, as the CLI reads it)
    for style, flags in (("doc2query_mm", ["--threshold", "0.7"]), ("tilde", ["--style", "tilde"])):
        t0 = time.perf_counter()
        rc = precomputed_main(["--vocab_path", str(workdir / "vocab.txt"), "--collection_path",
                               str(d / "collection.tsv"), "--queries_path", str(d / "store.jsonl"),
                               "--output_path", str(d / f"{style}.tsv"), *flags])
        out["seconds"][style] = time.perf_counter() - t0
        want = precomputed_reference(docs, store, workdir / "vocab.txt", style, 0.7 * 100)
        lines = (d / f"{style}.tsv").read_text(encoding="utf-8").splitlines()
        if rc != 0 or len(lines) != len(want):
            raise AssertionError(f"cli.expand_precomputed --style {style}: rc {rc}, {len(lines)} lines")
        grown = 0
        for line, (doc_id, doc, suffix) in zip(lines, want):
            got_id, text = line.split("\t", 1)
            got_doc, sep, got_suffix = text.partition(" [SEP] ")
            same = got_suffix == suffix if style == "tilde" else set(got_suffix.split()) == suffix
            if got_id != doc_id or (got_doc != doc if sep else text != doc) or not same or bool(sep) != bool(suffix):
                raise AssertionError(f"cli.expand_precomputed --style {style}, doc {doc_id}: {line[:200]!r}")
            grown += bool(sep)
        out[f"{style}_grown"] = grown
    log(f"cli.expand_precomputed over {len(docs)} passages x {cfg.store_queries} scored queries: every line equals "
        f"the reference; {json.dumps(out)}")
    shutil.rmtree(d)
    return out


def run_t5(cfg, workdir: Path) -> dict:
    """Phase 16: expansion's T5/mT5 route at mT5-base width, and the
    precomputed-expansion tools."""
    from improving_learned_index_tpu_torch.models.t5 import T5Config, init_t5_params

    log("== phase 16: the T5/mT5 route at mT5-base width (generation, greedy, card vs CPU, cli.expand --t5), "
        "cli.expand_precomputed")
    t_phase = time.perf_counter()
    for k in six_kernels():
        k.calls.clear()
    words = word_tokenizer(workdir, 32000).words
    tok = T5WordTokenizer(words)
    with open(workdir / "collection.tsv", encoding="utf-8") as f:
        passages = [line.split("\t", 1)[1].rstrip("\n") for line in islice(f, cfg.store_passages)]
    config = T5Config.mt5_base()
    t0 = time.perf_counter()
    params = init_t5_params(config, seed=cfg.seed, device=cfg.device)
    torch.cuda.synchronize()
    seconds = {"build": time.perf_counter() - t0}
    log(f"mT5-base parameters (fp32, seeded) built on the card in {seconds['build']:.1f} s, "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; TF32 for fp32 matmuls {torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the fp32 head would round its inputs")
    parts = {}
    for name, fn in (
            ("generation", lambda: t5_generation_runs(cfg, params, config, tok, passages)),
            ("step_breakdown", lambda: t5_step_breakdown(cfg, params, config, cfg.batch_docs * cfg.returns,
                                                         max(parts["generation"]["fp32"]["encoder_lengths"]))),
            ("greedy", lambda: t5_greedy_check(cfg, params, config, tok, passages[: cfg.greedy_docs])),
            ("card_vs_cpu", lambda: t5_card_vs_cpu(cfg, params, config, tok, passages))):
        t0 = time.perf_counter()
        parts[name] = fn()
        seconds[name] = time.perf_counter() - t0
    del params
    torch.cuda.empty_cache()
    for name, fn in (("cli", lambda: t5_cli_route(cfg, workdir, words, passages)),
                     ("precomputed", lambda: t5_precomputed_route(cfg, workdir, words, passages))):
        t0 = time.perf_counter()
        parts[name] = fn()
        seconds[name] = time.perf_counter() - t0
    launches = {k.name: k.launches for k in six_kernels()}
    if any(launches.values()):
        raise AssertionError(f"the T5 route launched kernels: {launches}")
    seconds["phase"] = time.perf_counter() - t_phase
    log(f"phase 16 in {seconds['phase']:.1f} s ({json.dumps(seconds)}); kernel launches {json.dumps(launches)} "
        f"(the T5 route reaches no kernel)")
    return {**parts, "launches": launches, "seconds": seconds}


def main() -> int:
    log("== phase 1: environment")
    if shutil.which("nvidia-smi"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True,
        )
        log(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    else:
        log("nvidia-smi not found")
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, cuda available {torch.cuda.is_available()}")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    build_kernels()
    # phase 3's work directory (index, vocabulary, queries, phase 4's run
    # file) lives until phase 12; the encode one until phase 11
    qdir, workdir = Path(SMOKE.workdir), Path(ENCODE.workdir)
    for d in (qdir, workdir):
        shutil.rmtree(d, ignore_errors=True)
        d.mkdir(parents=True)
    try:
        query = run_query(SMOKE, qdir)
        torch.cuda.empty_cache()
        encode = run_encode(ENCODE, workdir)
        torch.cuda.empty_cache()
        train = run_train(TRAIN, workdir, encode.pop("passages"))
        torch.cuda.empty_cache()
        evaluation = run_eval(EVAL, workdir, workdir / "ckpt" / "DeepImpact_final.pt",
                              train.pop("train_args"))
        torch.cuda.empty_cache()
        rerank = run_rerank(RERANK, workdir, workdir / "ckpt" / "DeepImpact_final.pt")
        torch.cuda.empty_cache()
        store = run_store(STORE, workdir, encode["errors"]["tolerance"])
        # phase 14 reads phase 6's passages and vocabulary and phase 7's trunk
        for p in workdir.iterdir():
            if p.name not in ("collection.tsv", "vocab.txt", "bert"):
                shutil.rmtree(p) if p.is_dir() else p.unlink()
        torch.cuda.empty_cache()
        inputs = query.pop("inputs")
        lifecycle = run_lifecycle(LIFECYCLE, qdir, inputs)
        torch.cuda.empty_cache()
        multi = run_multidevice(MULTI, qdir, inputs, query["qps"])
        shutil.rmtree(qdir, ignore_errors=True)
        torch.cuda.empty_cache()
        remainder = run_remainder(REMAINDER, workdir)
        torch.cuda.empty_cache()
        expansion = run_expansion(EXPAND, workdir)
        torch.cuda.empty_cache()
        t5 = run_t5(T5, workdir)
    finally:
        for d in (qdir, workdir):
            shutil.rmtree(d, ignore_errors=True)
    g_row, s_row, c_row, b_row = query["kernels"]
    nano_beir, train_eval = evaluation["main_path"]["launches"], evaluation["train_eval"]["launches"]
    a_row = encode["row"]
    a_row["launches_by_path"] = {"cli.index": a_row["launches"], "cli.train": train["launches"],
                                 "cli.nano_beir": nano_beir["short_attention"],
                                 "cli.train with eval": train_eval["short_attention"],
                                 **rerank.pop("launches"), **store["launches"]}
    a_row["launches_by_path"]["DeepImpact (2 replicas)"] = sum(
        e["launches"] for e in multi["encode"].values())
    a_row["launches_by_path"].update(remainder["launches"])
    served, sharded, rem = lifecycle["launches"], multi["launches"], remainder["routes"]["msgpack"]
    s_row["launches_by_path"] = {"cli.rank": s_row["launches"], "cli.nano_beir": nano_beir["scatter_scores"],
                                 "cli.train with eval": train_eval["scatter_scores"],
                                 "RetrievalServer (in-process)": served["scatter_scores"],
                                 "ShardedSearchEngine (4 shards)": sharded["scatter_scores"],
                                 "cli.rank (msgpack-built index)": rem["scatter_scores"]}
    # phase 9's gather launches are all the fp32 instance (float rows)
    g_row["launches_by_path"] = {"cli.rank": g_row["launches"],
                                 "cli.nano_beir (fp32 rows)": nano_beir["gather_rows"],
                                 "RetrievalServer (in-process)": served["gather_rows"],
                                 "ShardedSearchEngine (4 shards)": sharded["gather_rows"],
                                 "cli.rank (msgpack-built index)": rem["gather_rows"]}
    c_row["launches_by_path"] = {"cli.rank": c_row["launches"],
                                 "RetrievalServer (in-process)": served["count_ge"],
                                 "ShardedSearchEngine (4 shards)": sharded["count_ge"],
                                 "cli.rank (msgpack-built index)": rem["count_ge"]}
    for row in (a_row, s_row, g_row, c_row):
        row["launches"] = sum(row["launches_by_path"].values())
    log(json.dumps({"query": {k: v for k, v in query.items() if k != "kernels"}}))
    log(json.dumps({"encode": {k: v for k, v in encode.items() if k != "row"}}))
    log(json.dumps({"train": {k: v for k, v in train.items() if k != "profile"}}))
    log(json.dumps({"eval": evaluation}))
    log(json.dumps({"rerank": rerank}))
    log(json.dumps({"store": store}))
    log(json.dumps({"lifecycle": lifecycle}))
    log(json.dumps({"multidevice": multi}))
    log(json.dumps({"remainder": remainder}))
    f_row = expansion.pop("row")
    log(json.dumps({"expansion": expansion}))
    log(json.dumps({"t5": t5}))
    print(json.dumps({"kernels": [g_row, s_row, a_row, c_row, b_row, f_row]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
