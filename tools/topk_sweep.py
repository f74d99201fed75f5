#!/usr/bin/env python3
"""The exact top-k's routes and kernels on one CUDA card, at the query
path's shape: a [64, 8,847,360] fp32 score matrix, k=1000.

    python3 tools/topk_sweep.py [--out build/topk_sweep.json] [--rows 64] [--docs 8847360]

The matrix is made on the card from a seed in the shape of the benchmark's
MS MARCO-scale index: each row sums 2-12 terms drawn Zipf(0.9) over 30,522
terms ranked by list length, the term of rank r covering min(1, 4.02 / r)
of the docs (Zipf(1) lists of 387.7M postings capped at the doc count),
each covered doc an impact uniform in 1..255.  The last 5,537 columns (the
padding past 8,841,823 docs) score 0.

- ``check``: the histogram route (kernels), its plain version, and the
  n-ary route (``count_ge``) give the same values and doc ids, and
  ``torch.topk`` the same values;
- ``kernels``: ``value_histogram``, ``kth_scores``, ``block_counts`` with
  the block maxima (reads only the blocks that reach s_k) and without,
  ``count_ge`` with 7 thresholds (one n-ary search pass);
- ``routes``: the whole ``exact_topk_integer`` on each route, its plain
  version, ``torch.topk`` as the yardstick, and the host's seconds to
  launch the histogram route (no synchronise);
- ``bounds``: one and two reads of the matrix at 3.35 TB/s.

CUDA events over 10 calls after 2 warm-up calls, routes in turns (A B B A).
Prints one JSON object and writes it to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

from improving_learned_index_tpu_torch.ops import _kernels, count_ge, plain_versions, topk_select  # noqa: E402
from improving_learned_index_tpu_torch.ops.count_ge import KERNEL as COUNT_GE  # noqa: E402
from improving_learned_index_tpu_torch.ops.exact_topk import exact_topk_integer  # noqa: E402

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
NUM_TERMS = 30_522
LENGTHS = list(range(2, 13))
SHARES = [0.06, 0.12, 0.15, 0.16, 0.15, 0.12, 0.09, 0.06, 0.04, 0.03, 0.02]


def score_matrix(rows: int, docs: int, real: int, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    dev = torch.device("cuda")
    zipf = 1.0 / torch.arange(1, NUM_TERMS + 1, device=dev, dtype=torch.float64) ** 0.9
    n_terms = torch.multinomial(torch.tensor(SHARES, device=dev), rows, replacement=True, generator=g)
    scores = torch.zeros(rows, docs, device=dev)
    for r in range(rows):
        t = int(LENGTHS[int(n_terms[r])])
        ranks = torch.multinomial(zipf, t, replacement=False, generator=g) + 1
        for rank in ranks.tolist():
            cover = min(1.0, 4.02 / rank)
            hit = torch.rand(real, device=dev, generator=g) < cover
            vals = torch.randint(1, 256, (real,), device=dev, generator=g, dtype=torch.int32)
            scores[r, :real] += torch.where(hit, vals, 0).float()
    return scores


def shape_cases(seed: int) -> dict:
    """Small cases that take the kernels' other paths: ragged widths, a
    sliced view, a view whose rows are not 16-byte aligned (scalar loads),
    one row, a tie run over many blocks, the top bin, exactly k positives;
    each (scores, k) on the card."""
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)

    def ints(hi, *shape):
        return torch.randint(0, hi, shape, device="cuda", generator=g).float()

    exact = torch.zeros(2, 5000, device="cuda")
    exact[:, torch.randperm(5000, device="cuda", generator=g)[:300]] = ints(300, 300) + 1
    top = ints(40, 3, 20000)
    top[:, 7777] = topk_select.BINS - 1
    return {
        "one_row_ragged": (ints(50, 1, 1000), 100),
        "sliced_view": (ints(40, 5, 3200)[:, :3001], 250),
        "unaligned_view": (ints(30, 3, 1001)[:, 3:780], 64),
        "ties_over_blocks": (ints(4, 4, 70000), 5000),
        "top_bin": (top, 10),
        "exactly_k_positives": (exact, 300),
    }


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


def in_turns(fns: dict, rounds: int = 2) -> dict:
    """Each function timed ``rounds`` times, the order reversed every other
    round; the mean of its rounds."""
    got = {name: [] for name in fns}
    names = list(fns)
    for r in range(rounds):
        for name in (names if r % 2 == 0 else names[::-1]):
            got[name].append(cuda_ms(fns[name]))
    return {name: sum(v) / len(v) for name, v in got.items()}


def ptxas_report() -> str:
    src = topk_select.KERNEL.source
    out = _kernels.BUILD_DIR / "topk_select_ptxas.o"
    proc = subprocess.run([_kernels._nvcc(), *[f for f in _kernels.NVCC_FLAGS if f != "-shared"],
                           "-Xptxas", "-v", "-c", "-o", str(out), str(src)],
                          capture_output=True, text=True)
    return proc.stdout + proc.stderr


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--out", default=str(REPO / "build" / "topk_sweep.json"))
    p.add_argument("--rows", type=int, default=64)
    p.add_argument("--docs", type=int, default=8_847_360)
    p.add_argument("--real_docs", type=int, default=8_841_823)
    p.add_argument("--k", type=int, default=1000)
    p.add_argument("--seed", type=int, default=2_147_483_701)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("topk_sweep: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _kernels.build([topk_select.KERNEL, COUNT_GE])
    result = {"card": smi, "torch": torch.__version__, "shape": [args.rows, args.docs], "k": args.k,
              "ptxas": ptxas_report()}
    print(result["ptxas"], flush=True)

    scores = score_matrix(args.rows, args.docs, args.real_docs, args.seed)
    k, bound = args.k, topk_select.BINS - 1
    row_max = scores.amax(dim=1)
    result["row_max"] = [float(row_max.min()), float(row_max.max())]

    # -- check: every route the same answer ----------------------------------
    v_h, i_h = exact_topk_integer(scores, k, max_score=bound)
    with plain_versions():
        v_p, i_p = exact_topk_integer(scores, k, max_score=bound)
    v_n, i_n = exact_topk_integer(scores, k)
    v_l = torch.topk(scores, k, dim=1).values
    hist, block_max = topk_select.value_histogram(scores)
    hist_p, block_max_p = topk_select.value_histogram_plain(scores)
    s_k = topk_select.kth_scores(hist, k)
    counts_skip = topk_select.block_counts(scores, s_k, block_max)
    counts_full = topk_select.block_counts(scores, s_k)
    counts_plain = topk_select.block_counts_plain(scores, s_k)
    torch.cuda.synchronize()
    check = {
        "histogram_route_vs_plain": bool(torch.equal(v_h, v_p) and torch.equal(i_h, i_p)),
        "histogram_route_vs_nary": bool(torch.equal(v_h, v_n) and torch.equal(i_h, i_n)),
        "values_vs_torch_topk": bool(torch.equal(v_h, v_l)),
        "hist_vs_plain": bool(torch.equal(hist, hist_p) and torch.equal(block_max, block_max_p)),
        "kth_vs_plain": bool(torch.equal(s_k, topk_select.kth_scores_plain(hist_p, k))),
        "block_counts_skip_vs_plain": all(torch.equal(a, b) for a, b in zip(counts_skip, counts_plain)),
        "block_counts_full_vs_plain": all(torch.equal(a, b) for a, b in zip(counts_full, counts_plain)),
    }
    for name, (x, kk) in shape_cases(args.seed).items():
        v1, i1 = exact_topk_integer(x, kk, max_score=topk_select.BINS - 1)
        with plain_versions():
            v2, i2 = exact_topk_integer(x, kk, max_score=topk_select.BINS - 1)
        v3, i3 = exact_topk_integer(x, kk)
        check[name] = bool(torch.equal(v1, v2) and torch.equal(i1, i2) and torch.equal(v1, v3)
                           and torch.equal(i1, i3)
                           and all(torch.equal(a, b) for a, b in zip(topk_select.value_histogram(x),
                                                                      topk_select.value_histogram_plain(x))))
    result["check"] = check
    result["s_k"] = [float(s_k.min()), float(s_k.max())]
    result["blocks_read_share"] = float((block_max >= s_k).float().mean())
    print(json.dumps({"check": check, "s_k": result["s_k"], "blocks_read_share": result["blocks_read_share"]}),
          flush=True)

    # -- kernels and routes, timed in turns ----------------------------------
    result["kernels_ms"] = in_turns({
        "value_histogram": lambda: topk_select.value_histogram(scores),
        "kth_scores": lambda: topk_select.kth_scores(hist, k),
        "block_counts_skip": lambda: topk_select.block_counts(scores, s_k, block_max),
        "block_counts_full": lambda: topk_select.block_counts(scores, s_k),
        "count_ge_7": lambda: count_ge(scores, torch.ones(args.rows, 7, device="cuda")),
    })
    print(json.dumps({"kernels_ms": result["kernels_ms"]}), flush=True)
    result["routes_ms"] = in_turns({
        "histogram": lambda: exact_topk_integer(scores, k, max_score=bound),
        "nary": lambda: exact_topk_integer(scores, k),
        "torch_topk": lambda: torch.topk(scores, k, dim=1),
    })
    with plain_versions():
        result["routes_ms"]["histogram_plain"] = cuda_ms(
            lambda: exact_topk_integer(scores, k, max_score=bound), iters=3, warmup=1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(20):
        exact_topk_integer(scores, k, max_score=bound)
    result["histogram_route_launch_ms"] = (time.perf_counter() - t0) / 20 * 1e3
    torch.cuda.synchronize()
    read = args.rows * args.docs * 4
    result["bounds_ms"] = {"one_read": read / HBM_BYTES_PER_S * 1e3, "two_reads": 2 * read / HBM_BYTES_PER_S * 1e3}
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    exact_topk_integer(scores, k, max_score=bound)
    torch.cuda.synchronize()
    hist_peak = torch.cuda.max_memory_allocated() - base
    torch.cuda.reset_peak_memory_stats()
    exact_topk_integer(scores, k)
    torch.cuda.synchronize()
    result["temporary_bytes"] = {"histogram": hist_peak, "nary": torch.cuda.max_memory_allocated() - base}
    del result["ptxas"]
    print(json.dumps(result), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result, indent=1))
    return 0 if all(check.values()) else 1


if __name__ == "__main__":
    sys.exit(main())
