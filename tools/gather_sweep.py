#!/usr/bin/env python3
"""Where the heavy stage's time goes, on one CUDA card, at the shapes of
``chip_smoke.py``'s phase 3 (bf16 rows) and phase 9 (fp32 rows).

    python3 tools/gather_sweep.py [--old_source OLD.cu] [--out sweep.json]

Shapes: phase 3's first 64-query batch (the queries ``chip_smoke.make_corpus``
draws with the same seed: 8 Zipf terms each over 30,000 terms, the 242 most
frequent of them dense rows of 8,847,360 docs) and phase 9's ``large`` batch
as PR 7 measured it (50 queries, 66 of 352 fp32 rows hit, 88 pairs, 131,072
docs).  Cells are seeded random values: the time does not depend on them.

- ``variants``: ``csrc/gather_rows.cu`` built once for each setting of its
  constants (rows a stage, stages, consumer warps, queries a warp), the
  shipped one first; each must agree with the plain version (within 4 x
  2^-23 of each cell's sum of |terms|) and is timed in turns with the
  others (CUDA events, four rounds, order reversed every other round);
- ``old``: with ``--old_source``, a ``gather_rows.cu`` of the earlier design
  (one block a (query, 2,048-doc strip), C entries ``ili_gather_rows_*`` on
  rows grouped by query and their ranges): its kernel alone and with the
  pair tables its wrapper built on the card (sort, searchsorted), in the
  same turns;
- ``torch.mm`` of the one-hot [nq, t_heavy] matrix by every row, fp32 out;
- ``card_rates``: the card's copy, fill and read rates on the bf16 case's
  volumes (a copy of the [64, 8,847,360] fp32 output, a fill of it, an
  ``amax`` over 111 rows), the practical ceiling beside the data sheet's.

Prints one JSON object a measurement and writes them all to ``--out``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

CONSTANTS = ("kRowsPerStage", "kStages", "kConsumerWarps", "kQueriesPerWarp")
VARIANTS = {
    "shipped": None,
    "3_stages": (32, 3, 16, 4),
    "16_rows_12_stages": (16, 12, 16, 4),
    "24_warps": (32, 6, 24, 3),
    "8_warps": (32, 6, 8, 8),
}


def build(name, text, out_dir):
    """Compile one source with ``-Xptxas -v``; (library path, registers by
    instance, spill bytes, error text)."""
    from improving_learned_index_tpu_torch.ops import _kernels

    src, lib = out_dir / f"{name}.cu", out_dir / f"lib{name}.so"
    src.write_text(text)
    r = subprocess.run([_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    return (lib, re.findall(r"Used (\d+) registers", r.stderr),
            re.findall(r"(\d+) bytes spill stores", r.stderr), r.stderr[-800:] if r.returncode else "")


def load(path, entries, argtypes):
    lib = ctypes.CDLL(str(path))
    for fn in entries:
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old_source", type=Path, default=None)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gather_sweep: no CUDA device")
    from improving_learned_index_tpu_torch.ops import gather_rows as gr

    results = []

    def emit(obj):
        results.append(obj)
        print(json.dumps(obj), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})

    out_dir = REPO / "build" / "gather_sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    source = gr.KERNEL.source.read_text()
    texts = {}
    for name, values in VARIANTS.items():
        text = source
        for const, val in zip(CONSTANTS, values or ()):
            text, n = re.subn(rf"constexpr int {const} = \d+;", f"constexpr int {const} = {val};", text)
            if n != 1:
                raise SystemExit(f"gather_sweep: {const} not found once in {gr.KERNEL.source}")
        texts[name] = text
    if args.old_source:
        texts["old"] = args.old_source.read_text()
    with ThreadPoolExecutor(len(texts)) as ex:
        builds = dict(zip(texts, ex.map(lambda kv: build(kv[0], kv[1], out_dir), texts.items())))
    grouped = ("ili_gather_grouped_bf16", "ili_gather_grouped_f32")
    libs = {}
    for name, (path, regs, spills, err) in builds.items():
        emit({"build": name, "constants": dict(zip(CONSTANTS, VARIANTS.get(name) or ())),
              "registers_f32_bf16": regs, "spill_store_bytes": spills, "error": err})
        if err:
            raise SystemExit(f"gather_sweep: {name} did not build")
        if name == "old":
            libs[name] = load(path, ("ili_gather_rows_bf16", "ili_gather_rows_f32"),
                              [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                                                       ctypes.c_void_p])
        else:
            libs[name] = load(path, grouped, gr._ARGS)

    def run(lib, dense, table, nq):
        out = torch.empty(nq, dense.shape[1], dtype=torch.float32, device="cuda")
        fn = grouped[dense.dtype == torch.float32]
        err = getattr(lib, fn)(dense.data_ptr(), table.data_ptr(), table.numel(), out.data_ptr(), nq,
                               dense.shape[0], dense.shape[1], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: cudaError {err}")
        return out

    def run_old(dense, rows, qptr, nq):
        out = torch.empty(nq, dense.shape[1], dtype=torch.float32, device="cuda")
        fn = "ili_gather_rows_f32" if dense.dtype == torch.float32 else "ili_gather_rows_bf16"
        err = getattr(libs["old"], fn)(dense.data_ptr(), rows.data_ptr(), qptr.data_ptr(), out.data_ptr(),
                                       nq, dense.shape[0], dense.shape[1],
                                       torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{fn}: cudaError {err}")
        return out

    def old_tables(ids, pairs, counts, nq):
        """The earlier wrapper's pair tables, built on the card."""
        dev = pairs.device
        live = torch.arange(pairs.shape[0], device=dev) < counts[1]
        key, order = torch.sort(torch.where(live, pairs[:, 0], nq), stable=True)
        rows = ids[torch.where(live, pairs[:, 1], 0)[order].long()]
        qptr = torch.searchsorted(key, torch.arange(nq + 1, device=dev, dtype=torch.int32), out_int32=True)
        return rows.contiguous(), qptr

    def case(label, dtype, t_heavy, n_pad, nq, pair_q, pair_rows, seed):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        if dtype == torch.bfloat16:
            dense = torch.randint(0, 256, (t_heavy, n_pad), generator=g, device="cuda",
                                  dtype=torch.uint8).to(dtype)
        else:
            dense = torch.rand(t_heavy, n_pad, generator=g, device="cuda") * 3
        host = gr.group_pairs(pair_q, pair_rows, nq)
        table = torch.from_numpy(host).cuda()
        h = int(host[0])
        qptr, hits = host[1 : nq + 2], host[nq + 2 : nq + 2 + h]
        slots = host[nq + 2 + h :]
        q_of = np.repeat(np.arange(nq), np.diff(qptr))
        to = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.int32)).cuda()  # noqa: E731
        ids, pairs, counts = to(hits), to(np.stack([q_of, slots], 1)), to([h, len(slots)])
        want = gr.accumulate_grouped_plain(dense, table, nq)
        tol = 4 * 2.0 ** -23 * gr.accumulate_grouped_plain(dense.abs(), table, nq)
        fns = {name: (lambda lib=lib: run(lib, dense, table, nq)) for name, lib in libs.items() if name != "old"}
        if "old" in libs:
            rows, old_qptr = old_tables(ids, pairs, counts, nq)
            fns["old_kernel"] = lambda: run_old(dense, rows, old_qptr, nq)
            fns["old_wrapper"] = lambda: run_old(dense, *old_tables(ids, pairs, counts, nq), nq)
        agree = {name: bool(((fn() - want).abs() <= tol).all()) for name, fn in fns.items()}
        del tol
        w = torch.zeros(nq, t_heavy, device="cuda")
        w.index_put_((to(q_of).long(), to(hits[slots]).long()), torch.ones(len(slots), device="cuda"),
                     accumulate=True)
        w = w.to(dtype)
        fns["torch_mm"] = ((lambda: torch.mm(w, dense)) if dtype == torch.float32
                           else (lambda: torch.mm(w, dense, out_dtype=torch.float32)))
        bound, by = cs.bound_ms(h * n_pad * dense.element_size() + nq * n_pad * 4 + table.numel() * 4,
                                len(slots) * n_pad)
        ms = {name: [] for name in fns}
        names = list(fns)
        for order in (names, names[::-1], names, names[::-1]):
            for name in order:
                ms[name].append(cs.cuda_ms(fns[name], iters=20))
        emit({"case": label, "dense": [t_heavy, n_pad], "dtype": str(dtype), "nq": nq, "hit_rows": h,
              "pairs": len(slots), "bound_ms": bound, "bound_by": by, "agree_with_plain": agree, "ms": ms})
        del dense, want

    n_terms = cs.SMOKE.terms
    p = 1.0 / np.arange(1, n_terms + 1)
    qrng = np.random.default_rng(cs.SMOKE.seed + 1)
    queries = [qrng.choice(n_terms, size=cs.SMOKE.query_terms, replace=False, p=p / p.sum())
               for _ in range(cs.SMOKE.nq)]
    heavy = 242
    pq = np.array([i for i, q in enumerate(queries) for t in q if t < heavy])
    pr = np.array([t for q in queries for t in q if t < heavy])
    case("phase 3 bf16", torch.bfloat16, heavy, 8_847_360, cs.SMOKE.nq, pq, pr, 0)
    rng = np.random.default_rng(2)
    hit = rng.choice(352, 66, replace=False)
    case("phase 9 fp32", torch.float32, 352, 131_072, 50, rng.integers(0, 50, 88),
         np.concatenate([hit, rng.choice(hit, 22)]), 1)

    x = torch.empty(cs.SMOKE.nq, 8_847_360, device="cuda")
    y = torch.empty_like(x)
    rows = torch.ones(111, 8_847_360, dtype=torch.bfloat16, device="cuda")
    rates = {}
    for name, fn, nbytes in (("copy", lambda: y.copy_(x), 2 * x.numel() * 4),
                             ("fill", lambda: y.fill_(1.0), x.numel() * 4),
                             ("read_amax", lambda: rows.amax(), rows.numel() * 2)):
        ms = cs.cuda_ms(fn, iters=20)
        rates[name] = {"ms": ms, "bytes": nbytes, "TB_per_s": nbytes / ms / 1e9}
    emit({"card_rates": rates, "data_sheet_TB_per_s": cs.HBM_BYTES_PER_S / 1e12})
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
