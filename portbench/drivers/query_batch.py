"""Offline batch ranking in a closed loop, the work ``cli.rank`` does for an
MS MARCO dev run: query text -> ``ImpactTokenizer.process_query`` ->
``HybridSearchEngine.score_stream`` in batches of ``batch`` queries,
``depth`` batches in flight, top ``k``; the ranked lists come back in
memory.  The window runs until ``--seconds`` have passed and the batches
in flight are answered; the rate is every query answered over the whole
window.

Traffic parameters: ``batch``, ``k``, ``depth``, the query mix
(``lengths``, ``zipf_s``), ``max_rate`` (queries made for the window: the
window ends early, with a warning, if the program answers them all),
``warm_batches``; traced runs add ``trace_batches``.  Check parameters: ``sample_every``.
"""

from __future__ import annotations

import math
import time
from contextlib import nullcontext
from typing import Dict, List

from ..harness import index_setup
from ..harness.common import Cell, Check, Outcome, log


def term_batches(texts: List[str], nq: int, tok, deadline: float = None, spans: Dict = None, sent: List = None):
    """Batches of term sets, tokenized as they are pulled, until ``deadline``."""
    from torch.profiler import record_function

    for i in range(0, len(texts), nq):
        if deadline is not None and time.monotonic() >= deadline:
            return
        t = time.perf_counter()
        with record_function("portbench/tokenize") if spans is not None else nullcontext():
            sets = [tok.process_query(x) for x in texts[i:i + nq]]
        if spans is not None:
            spans["tokenize"] += time.perf_counter() - t
        if sent is not None:
            sent[0] += len(sets)
        yield sets


def timed_stage_inputs(engine, spans: Dict) -> None:
    """Time the engine's host prep of each batch, by the benchmark's own
    span around its call (the engine looks the method up on itself)."""
    from torch.profiler import record_function

    inner = engine.stage_inputs

    def stage_inputs(term_sets):
        t = time.perf_counter()
        with record_function("portbench/stage_inputs"):
            out = inner(term_sets)
        spans["stage"] += time.perf_counter() - t
        return out

    engine.stage_inputs = stage_inputs


def drain(engine, texts, nq, tok, k, depth, spans=None) -> int:
    n = 0
    for out in engine.score_stream(term_batches(texts, nq, tok, spans=spans), top_k=k, depth=depth):
        n += len(out)
    return n


def run(cell: Cell) -> Outcome:
    import torch

    tr = cell.workload["traffic"]
    nq, k, depth = int(tr["batch"]), int(tr["k"]), int(tr["depth"])
    dev = torch.device(cell.device)
    setup = index_setup.build(cell)
    engine, tok = setup.engine, setup.tokenizer

    engine.warmup(max_batch=nq, top_k=k)
    _, warm = index_setup.queries(setup, nq * int(tr["warm_batches"]), tr, cell.seed, stream=1)
    drain(engine, warm, nq, tok, k, depth)
    n = math.ceil(cell.seconds * float(tr["max_rate"]) / nq) * nq
    qs, texts = index_setup.queries(setup, n, tr, cell.seed)
    every = int(cell.workload["check"]["sample_every"])
    picks = set(index_setup.sample(n, every, cell.seed).tolist())
    # the longest query of each stretch of positions is checked too
    block = every * 8
    for lo in range(0, n, block):
        picks.add(max(range(lo, min(lo + block, n)), key=lambda i: setup.work(qs[i])))
    spans = {"tokenize": 0.0, "stage": 0.0} if cell.trace else None
    if cell.trace:
        timed_stage_inputs(engine, spans)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    sent = [0]
    kept = {}
    answered = 0
    t0 = cell.open_window()
    stream = term_batches(texts, nq, tok, t0 + cell.seconds, spans, sent)
    for bi, out in enumerate(engine.score_stream(stream, top_k=k, depth=depth)):
        for j, rows in enumerate(out):
            if bi * nq + j in picks:
                kept[bi * nq + j] = rows
        answered += len(out)
    t1 = cell.close_window()
    if sent[0] == n:
        log(f"all {n} queries answered before the window's end: raise max_rate")
    metrics = {"queries_per_s": answered / (t1 - t0)}
    readings = {}
    if cell.trace:
        # the window's own host prep: the traced run below passes through stage_inputs too
        readings = traced(cell, setup, tr, spans["tokenize"] + spans["stage"], sent[0] // nq)
    peak = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0

    index_setup.free_engine(setup)
    sampled = {i: (qs[i], kept.get(i)) for i in sorted(picks) if i < sent[0]}
    bad = index_setup.mismatches(setup, cell.config["num_docs"], sampled, k, dev)
    log(f"{answered} queries in {t1 - t0:.3f} s; {len(sampled)} sampled answers checked")
    checks = [Check("mismatched_answers", bad if sampled else math.nan, cell.limit("mismatched_answers"))]
    return Outcome(attempted=sent[0], failed=sent[0] - answered, metrics=metrics, checks=checks,
                   memory_peak_bytes=int(peak), readings=readings)


def traced(cell: Cell, setup, tr, host_prep_s: float, batches: int) -> Dict:
    """A profiled run of the mix after the window, a whole ``score_stream``
    (its device work inside the profile), with the benchmark's span
    ``portbench/topk`` around the engine's calls into ``exact_topk_integer``,
    and that run's inputs as the roofline counts read them."""
    import torch
    from torch.profiler import record_function

    from improving_learned_index_tpu_torch.search import hybrid_engine

    from ..harness.trace import Window

    nq, k, depth = int(tr["batch"]), int(tr["k"]), int(tr["depth"])
    engine, tok = setup.engine, setup.tokenizer
    qs, texts = index_setup.queries(setup, nq * int(tr["trace_batches"]), tr, cell.seed, stream=2)
    inner = hybrid_engine.exact_topk_integer

    def exact_topk_integer(*args, **kwargs):
        with record_function("portbench/topk"):
            return inner(*args, **kwargs)

    hybrid_engine.exact_topk_integer = exact_topk_integer
    try:
        with Window(annotations=("portbench/topk",)) as w:
            drain(engine, texts, nq, tok, k, depth)
    finally:
        hybrid_engine.exact_topk_integer = inner
    w.profile.units = int(tr["trace_batches"])
    dev = torch.device(cell.device)
    inputs = [index_setup.batch_inputs(setup, qs[i:i + nq], dev) for i in range(0, len(qs), nq)]
    return {"profile": w.profile, "inputs": inputs, "host_prep_s": host_prep_s, "batches": batches,
            "num_docs": cell.config["num_docs"]}
