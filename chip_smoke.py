#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port's query path, at MS MARCO passage scale.

    python3 chip_smoke.py            # needs one CUDA card; exits non-zero without

Phases, in order; any failed check raises and the script exits non-zero:

1. Environment: the card's name and power limit (nvidia-smi), torch and CUDA
   versions.
2. Build: both CUDA kernels of the query path from ``csrc/``, one ``nvcc`` per
   source, started together.
3. Set-up, then kernels against their plain versions: a synthetic index at
   MS MARCO passage geometry is generated on the card from a seed (8.8M docs,
   30k-term Zipf vocabulary, ~388M postings, impacts 1..255), saved with the
   port's ``save``, and loaded into an engine through ``build_engine``.  Each
   kernel runs on the inputs the first 64-query batch gives it and must equal
   its plain PyTorch version exactly; kernel, plain and library-call times
   (CUDA events) are printed beside the least time the card could take.
4. Main path: ``cli.rank.main`` ranks every query (k=1000) on the card, with
   the kernels' launch counts set to 0 just before and read just after.
   Every query has one planted relevant doc holding all its terms at impact
   255, so MRR@10 must be ~1; four sampled queries must match an independent
   numpy scorer rank by rank; ``score_stream`` (depth 2) over 64-query
   batches must reproduce the run file and gives the pipelined q/s.

The second-to-last line is the ``kernels`` JSON object, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
# The configuration: MS MARCO passage geometry (benchmarks/INDEX_BUILD_8M8.json),
# 8 batches of 64 queries of 8 Zipf terms, the CLI's default 4 GB dense budget.
SMOKE = SimpleNamespace(
    docs=8_800_000, terms=30_000, postings=387_717_182, batches=8, nq=64,
    query_terms=8, dense_budget_gb=4.0, seed=0, workdir=REPO / "build" / "chip_smoke",
)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM, fp32 outside the tensor cores


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
    come out doc-ascending; posting order inside a list does not change
    scores).  Queries draw ``query_terms`` distinct Zipf terms; query i's
    planted doc ``num_docs - n_queries + i`` holds each of its terms at
    impact 255.  Returns host arrays (offsets, doc_ids uint32, impacts
    uint8), the queries as term-id lists, and each query's planted doc."""
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
    del term_of, i, ct, pl_idx
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


def bound_ms(bytes_moved: float, ops: float) -> tuple:
    t_bytes, t_ops = bytes_moved / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def gather_row(engine, heavy, nq):
    """Gather kernel against its plain version on one batch's heavy inputs."""
    from improving_learned_index_tpu_torch.ops import gather_rows as gr

    ids, pairs, counts = heavy
    dense = engine.dense
    out_k = gr.accumulate_rows(dense, ids, pairs, counts, nq)
    out_p = gr.accumulate_rows_plain(dense, ids, pairs, counts, nq)
    torch.cuda.synchronize()
    err = float((out_k - out_p).abs().max())
    if not torch.equal(out_k, out_p):
        raise AssertionError(f"gather_rows kernel != plain (max abs err {err})")
    n_hit, n_pairs = (int(x) for x in counts.tolist())
    t_heavy, n_pad = dense.shape
    # the same function as one library call: one-hot [nq, t_heavy] times the
    # whole dense matrix, bf16 operands and an fp32 result (torch.mm's
    # out_dtype, CUDA only, where this torch version has it)
    q_of, slot = pairs[:n_pairs].long().unbind(1)
    w = torch.zeros(nq, t_heavy, dtype=torch.float32, device=dense.device)
    w.index_put_((q_of, ids.long()[slot]), torch.ones_like(q_of, dtype=torch.float32), accumulate=True)
    w = w.to(dense.dtype)
    try:
        library_equal = torch.equal(torch.mm(w, dense, out_dtype=torch.float32), out_p)
        library = lambda: torch.mm(w, dense, out_dtype=torch.float32)  # noqa: E731
    except (TypeError, RuntimeError, NotImplementedError) as exc:
        log(f"no single-call library yardstick for gather_rows: {exc!r:.200}")
        library, library_equal = None, None
    b, by = bound_ms(n_hit * n_pad * dense.element_size() + nq * n_pad * 4 + pairs.numel() * 4, n_pairs * n_pad)
    row = {
        "name": "gather_rows",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/gather_rows.cu",
        "replaces": "improving_learned_index_tpu/ops/gather_rows.py:39",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: gr.accumulate_rows(dense, ids, pairs, counts, nq)),
        "plain_ms": cuda_ms(lambda: gr.accumulate_rows_plain(dense, ids, pairs, counts, nq)),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": cuda_ms(library) if library else None,
        "shape": {"dense": [t_heavy, n_pad], "dtype": str(dense.dtype), "nq": nq,
                  "hit_rows": n_hit, "pairs": n_pairs, "library_equal": library_equal},
    }
    return row, out_p


def scatter_row(base, tail):
    """Scatter kernel against its plain version on one batch's tail updates,
    applied to that batch's heavy-stage scores."""
    from improving_learned_index_tpu_torch.ops import scatter_scores as ss

    d, v, r = tail
    s_k = ss.apply_tail_updates(base.clone(), d, v, r)
    s_p = ss.apply_tail_updates_plain(base.clone(), d, v, r)
    torch.cuda.synchronize()
    err = float((s_k - s_p).abs().max())
    if not torch.equal(s_k, s_p):
        raise AssertionError(f"scatter_scores kernel != plain (max abs err {err})")
    del s_k, s_p
    nq, n_pad = base.shape
    live = v != 0
    cells = int(torch.unique((r.long() * n_pad + d.long())[live]).numel())
    n_live = int(live.sum())
    scratch = base.clone()
    r64, d64 = r.long(), d.long()
    b, by = bound_ms(d.numel() * 12 + cells * 8, n_live)
    row = {
        "name": "scatter_scores",
        "route": "cuda",
        "source": "improving_learned_index_tpu_torch/csrc/scatter_scores.cu",
        "replaces": "improving_learned_index_tpu/ops/scatter_scores.py:45",
        "max_abs_err": err,
        "ms": cuda_ms(lambda: ss.apply_tail_updates(scratch, d, v, r)),
        "plain_ms": cuda_ms(lambda: ss.apply_tail_updates_plain(scratch, d, v, r)),
        "bound_ms": b,
        "bound_by": by,
        "library_ms": cuda_ms(lambda: scratch.index_put_((r64, d64), v, accumulate=True)),
        "shape": {"scores": [nq, n_pad], "updates": d.numel(), "live_updates": n_live,
                  "touched_cells": cells},
    }
    return row


def profile_stream(engine, batches, top: int = 12) -> dict:
    """Where a pipelined window's time goes: torch.profiler over
    ``score_stream`` of ``batches``; device time by kernel (device-side
    events only, so an operator and its kernel never count twice) and the
    device's busy share of the window's wall time (one stream: its kernels
    do not overlap).  The profiler's own overhead stretches the wall time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        list(engine.score_stream(batches, top_k=1000, depth=2))
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    ops = [
        (e.key, e.count, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if e.device_type == DeviceType.CUDA
    ]
    ops = sorted((o for o in ops if o[2] > 0), key=lambda o: -o[2])
    device_ms = sum(o[2] for o in ops)
    return {
        "batches": len(batches),
        "wall_ms": wall_ms,
        "device_ms": device_ms if ops else "not measured",
        "device_busy_share": device_ms / wall_ms if ops else "not measured",
        "top_kernels": [{"kernel": k[:100], "calls": c, "ms": ms} for k, c, ms in ops[:top]],
    }


# -- phases ------------------------------------------------------------------------


def run(cfg) -> dict:
    from improving_learned_index_tpu_torch.cli.rank import main as rank_main
    from improving_learned_index_tpu_torch.evaluation.run_metrics import Metrics
    from improving_learned_index_tpu_torch.ops import _kernels, gather_rows, scatter_scores
    from improving_learned_index_tpu_torch.search.select import build_engine
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    kernels = [gather_rows.KERNEL, scatter_scores.KERNEL]
    dev = torch.device("cuda")

    log("== phase 2: build kernels")
    t0 = time.perf_counter()
    _kernels.build(kernels)
    for k in kernels:
        k.lib()
    log(f"built {[k.name for k in kernels]} in {time.perf_counter() - t0:.1f} s")

    log("== set-up: synthetic index on the card")
    n_queries = cfg.batches * cfg.nq
    t0 = time.perf_counter()
    offsets, docs, vals, queries, planted = make_corpus(
        cfg.docs, cfg.terms, cfg.postings, n_queries, cfg.query_terms, cfg.seed, dev
    )
    torch.cuda.empty_cache()
    log(f"generated {len(docs)} postings over {cfg.terms} terms, {cfg.docs} docs "
        f"in {time.perf_counter() - t0:.1f} s")
    workdir = Path(cfg.workdir)
    shutil.rmtree(workdir, ignore_errors=True)
    workdir.mkdir(parents=True)
    try:
        t0 = time.perf_counter()
        index_dir, vocab, qpath, qrels = write_inputs(
            workdir, offsets, docs, vals, cfg.docs, queries, planted
        )
        log(f"saved index + queries in {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        engine = build_engine(index_dir, dense_budget_bytes=int(cfg.dense_budget_gb * (1 << 30)))
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

        log("== phase 3: kernels against their plain versions (first batch)")
        heavy, tail = engine.stage_inputs(batches[0])
        if heavy is None or tail is None:
            raise AssertionError("the first batch must reach both stages")
        g_row, base = gather_row(engine, heavy, cfg.nq)
        s_row = scatter_row(base, tail)
        del base, heavy, tail
        for row in (g_row, s_row):
            log(f"{row['name']}: equal to plain; {json.dumps(row)}")

        log("== phase 4: main path (cli.rank on the card)")
        run_file = workdir / "run.tsv"
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        rank_main([
            "--index_path", str(index_dir), "--queries_path", str(qpath),
            "--output_path", str(run_file), "--vocab_path", str(vocab),
            "--qrels_path", str(qrels), "--top_k", "1000",
            "--dense_budget_gb", str(cfg.dense_budget_gb),
        ])
        torch.cuda.synchronize()
        launches = {k.name: k.launches for k in kernels}
        log(f"cli.rank: {n_queries} queries in {time.perf_counter() - t0:.1f} s "
            f"(index load and engine build included); launches {launches}")
        for name, n in launches.items():
            if n == 0:
                raise AssertionError(f"main path never launched {name}")
        g_row["launches"], s_row["launches"] = launches["gather_rows"], launches["scatter_scores"]

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
        log(json.dumps({"profile": profile_stream(engine, batches[:2])}))
        return {
            "kernels": [g_row, s_row],
            "mrr10": metrics["MRR@10"],
            "qps": qps,
        }
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


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

    result = run(SMOKE)
    print(json.dumps({"kernels": result["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
