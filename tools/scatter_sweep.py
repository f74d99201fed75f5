#!/usr/bin/env python3
"""Where the tail scatter's time goes, on one CUDA card, at the shape of
``chip_smoke.py``'s phase 3.

    python3 tools/scatter_sweep.py [--out sweep.json]

The first 64-query batch of ``chip_smoke.py``'s synthetic MS MARCO-scale
index (same seed, same engine) gives the tail: its chunk table and the flat
updates ``gather_updates`` makes of it.  Every variant must equal the plain
version exactly and is timed as a whole call (CUDA events), and by kernel
(torch.profiler) where it runs several:

- ``shipped``: the one-pass kernels of ``csrc/scatter_scores.cu``, flat and
  chunk entries, and the tail stage as it was before the chunk entry
  (``gather_updates`` then the flat entry);
- ``address_sorted``: the flat entry on the live updates sorted by cell,
  the nearest any reordering can come (the ceiling of a binning design);
- ``chunks_by_first_doc``: the chunk entry on the table reordered by (row,
  first doc of the chunk), a reordering the host could make for free;
- ``binned``: ``tools/scatter_binned.cu`` (count, scan, bin and apply
  passes) built once for each region width below; a region of 2^24 docs is
  wider than any row here, so it bins by query row alone and applies in
  chunk-table order;
- ``l2_fetch_32``: the shipped entries again with the device's L2 fetch
  granularity set to 32 bytes (restored afterwards);
- ``padded``: the one-pass flat kernel plus an exact +0 to every other
  32-byte sector of the update's aligned 64- or 128-byte block, so that L2
  writes whole blocks back (does a partial-sector write cost device memory
  a read-modify-write?);
- ``few_chunks``: the chunk entry on the first few chunks (small E).

Prints one JSON object a measurement and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

REGION_LOG2 = (12, 13, 14, 15, 16, 24)
BINNED_PASSES = ("scatter_count", "scatter_scan", "scatter_bin", "scatter_apply")
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def binned_builds():
    """One library of ``scatter_binned.cu`` for each region width."""
    from improving_learned_index_tpu_torch.ops import _kernels

    source = Path(__file__).resolve().parent / "scatter_binned.cu"
    text = source.read_text()
    pattern = r"constexpr int kRegionLog2 = \d+;"
    src_dir = _kernels.BUILD_DIR / "sweep"
    src_dir.mkdir(parents=True, exist_ok=True)
    out = {}
    for log2 in REGION_LOG2:
        k = _kernels.CudaKernel("scatter_binned", {
            "ili_scatter_region_docs": [],
            "ili_l2_fetch_granularity": [_I],
            "ili_scatter_padded": [_P] * 4 + [_L, _I, _L, _I, _P],
            "ili_scatter_scores": [_P] * 4 + [_L, _I, _L] + [_P] * 3,
            "ili_scatter_chunks": [_P] * 6 + [_L, _I, _I, _L] + [_P] * 3,
        })
        k.name = f"sweep_w{log2}"  # no pass name inside the kernels' mangled names
        k.source = src_dir / f"{k.name}.cu"
        k.source.write_text(re.sub(pattern, f"constexpr int kRegionLog2 = {log2};", text))
        out[log2] = k
    _kernels.build(out.values())
    return out


def kernel_passes(fn, passes, calls: int = 5) -> dict:
    """Device ms a call of ``fn`` spends in each kernel whose name holds one
    of ``passes`` (the profiler's device events over ``calls`` calls); the
    rest of its device time under "other"."""
    prof = cs.profile_window(lambda: [fn() for _ in range(calls)], top=50)
    if prof["device_ms"] == "not measured":
        return {"not measured": True}
    out = {p: 0.0 for p in passes}
    out["other"] = 0.0
    for k in prof["top_kernels"]:
        name = next((p for p in passes if p in k["kernel"]), "other")
        out[name] += k["ms"] / calls
    return out


def binned_call(kernel, scores, entry, *args, slots):
    """One call of a binned build; its scratch is allocated here, as a
    wrapper would."""
    nq, n_pad = scores.shape
    w = kernel.lib().ili_scatter_region_docs()
    counts = torch.zeros(nq * -(-n_pad // w) + 1, dtype=torch.int32, device=scores.device)
    binned = torch.empty(slots, dtype=torch.int64, device=scores.device)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    kernel.call(entry, scores.data_ptr(), *ptrs, nq, n_pad, counts.data_ptr(), binned.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
    return scores


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("scatter_sweep: no CUDA device")
    from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
    from improving_learned_index_tpu_torch.ops import gather_rows as gr
    from improving_learned_index_tpu_torch.ops import scatter_scores as ss
    from improving_learned_index_tpu_torch.search.hybrid_engine import TAIL_CHUNK, HybridSearchEngine

    results = []

    def emit(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    cfg, dev = cs.SMOKE, torch.device("cuda")
    offsets, docs, vals, queries, _ = cs.make_corpus(
        cfg.docs, cfg.terms, cfg.postings, cfg.batches * cfg.nq, cfg.query_terms, cfg.seed, dev)
    terms = [f"t{i:05d}" for i in range(cfg.terms)]
    engine = HybridSearchEngine(InvertedIndexData(terms, offsets, docs, vals, num_docs=cfg.docs),
                                dense_budget_bytes=int(cfg.dense_budget_gb * (1 << 30)), device=dev)
    del docs, vals
    heavy, tail = engine.stage_inputs([{terms[t] for t in q} for q in queries[: cfg.nq]])
    base = gr.accumulate_grouped(engine.dense, heavy, cfg.nq)
    table = (engine.doc_ids, engine.impacts, *tail, TAIL_CHUNK)
    d, v, r = ss.gather_updates(*table)
    slots = d.numel()
    want = ss.apply_tail_updates_plain(base.clone(), d, v, r)
    scratch = base.clone()

    def check(name, fn):
        got = fn(base.clone())
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"{name}: kernel != plain")

    live = v != 0
    _, order = torch.sort(r[live].long() * base.shape[1] + d[live].long())
    sd, sv, sr = d[live][order], v[live][order], r[live][order]
    first = engine.doc_ids[tail[0].long()].long()
    _, corder = torch.sort(tail[2].long() * base.shape[1] + first)
    by_first = (engine.doc_ids, engine.impacts, *(t[corder].contiguous() for t in tail), TAIL_CHUNK)
    del order, corder, first

    shipped = {
        "flat": lambda s: ss.apply_tail_updates(s, d, v, r),
        "chunks": lambda s: ss.apply_tail_chunks(s, *table),
        "gather_then_flat": lambda s: ss.apply_tail_updates(s, *ss.gather_updates(*table)),
        "address_sorted": lambda s: ss.apply_tail_updates(s, sd, sv, sr),
        "chunks_by_first_doc": lambda s: ss.apply_tail_chunks(s, *by_first),
    }
    for name, fn in shipped.items():
        check(name, fn)

    def shipped_times(name, **extra):
        emit(dict({k: cs.cuda_ms(lambda: fn(scratch)) for k, fn in shipped.items()},
                  name=name, live_updates=sd.numel(), slots=slots, **extra))

    shipped_times("shipped")
    builds = binned_builds()
    for log2, kernel in builds.items():
        flat = lambda s: binned_call(kernel, s, "ili_scatter_scores", d, v, r, slots, slots=slots)  # noqa: E731
        chunks = lambda s: binned_call(  # noqa: E731
            kernel, s, "ili_scatter_chunks", *table[:5], tail[0].numel(), TAIL_CHUNK, slots=slots)
        check(f"binned 2^{log2} flat", flat)
        check(f"binned 2^{log2} chunks", chunks)
        emit({"name": "binned", "region_log2": log2,
              "flat_ms": cs.cuda_ms(lambda: flat(scratch)),
              "chunks_ms": cs.cuda_ms(lambda: chunks(scratch)),
              "flat_passes_ms": kernel_passes(lambda: flat(scratch), BINNED_PASSES),
              "chunks_passes_ms": kernel_passes(lambda: chunks(scratch), BINNED_PASSES)})
    k14 = builds[14]
    sorted_binned = lambda s: binned_call(k14, s, "ili_scatter_scores", sd, sv, sr, sd.numel(),  # noqa: E731
                                          slots=sd.numel())
    check("binned address_sorted", sorted_binned)
    emit({"name": "binned_address_sorted", "region_log2": 14,
          "flat_ms": cs.cuda_ms(lambda: sorted_binned(scratch)),
          "flat_passes_ms": kernel_passes(lambda: sorted_binned(scratch), BINNED_PASSES)})

    def padded(s, sectors, dd=d, vv=v, rr=r):
        k14.call("ili_scatter_padded", s.data_ptr(), dd.data_ptr(), vv.data_ptr(), rr.data_ptr(),
                 dd.numel(), s.shape[0], s.shape[1], sectors, torch.cuda.current_stream().cuda_stream)
        return s

    for sectors in (1, 2, 4):
        check(f"padded {sectors}", lambda s: padded(s, sectors))
        check(f"padded {sectors} sorted", lambda s: padded(s, sectors, sd, sv, sr))
        emit({"name": "padded", "sectors": sectors,
              "flat_ms": cs.cuda_ms(lambda: padded(scratch, sectors)),
              "address_sorted_ms": cs.cuda_ms(lambda: padded(scratch, sectors, sd, sv, sr))})

    lib = k14.lib()
    default = lib.ili_l2_fetch_granularity(0)
    try:
        now = lib.ili_l2_fetch_granularity(32)
        shipped_times("l2_fetch_32", l2_fetch_bytes=now, default_bytes=default)
    finally:
        lib.ili_l2_fetch_granularity(default)
    shipped_times("shipped_again", l2_fetch_bytes=lib.ili_l2_fetch_granularity(0))

    for n in (2, 64, 2048):
        part = (engine.doc_ids, engine.impacts, *(t[:n] for t in tail), TAIL_CHUNK)
        emit({"name": "few_chunks", "chunks": n, "slots": n * TAIL_CHUNK,
              "chunks_ms": cs.cuda_ms(lambda: ss.apply_tail_chunks(scratch, *part)),
              "gather_then_flat_ms": cs.cuda_ms(
                  lambda: ss.apply_tail_updates(scratch, *ss.gather_updates(*part)))})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
