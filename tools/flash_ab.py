#!/usr/bin/env python3
"""A/B of ``csrc/flash_attention.cu``'s head walking, on one CUDA card.

    python3 tools/flash_ab.py [--rounds 2] [--out build/flash_ab.json]

Builds the committed source and variants made from it by named text edits
(one ``nvcc`` each, started together), then times the forward and the
backward of each at ``chip_smoke.py``'s two row-6 shapes (``flash_shapes``:
[1, 32, 2048, 128] causal with a padded tail, [64, 12, 512, 64] packed) in
one process, the variants in their order, then in the reverse order,
``--rounds`` times.  Each variant's outputs are held to the committed
build's (within 1% of the largest entry, the log-sum-exp within 1e-4)
before it is timed.

Variants:

- ``committed``: the source as it is.
- ``one_head``: ``heads_per_block`` returns 1, so every block takes one head
  (forward) or one kv head (backward); the forward's second Q buffer goes
  unused.
- ``q_one_buffer``: heads walked as committed, but the forward keeps Q in
  one buffer (``NQB = 1``): a head's Q load waits for the last head's
  products.

Prints one JSON line a measurement, then each variant's median ms and the
card's name and power limit; writes every measurement to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from improving_learned_index_tpu_torch.ops import _kernels  # noqa: E402
from improving_learned_index_tpu_torch.ops import flash_attention as fa  # noqa: E402

VARIANTS = {
    "committed": [],
    "one_head": [("  *hpb = (heads + groups - 1) / groups;", "  *hpb = 1;")],
    "q_one_buffer": [("NQB = 2;", "NQB = 1;")],
}


def variant_kernel(name: str, edits) -> _kernels.CudaKernel:
    """A ``CudaKernel`` over the committed source with ``edits`` applied,
    written under ``build/flash_ab/<name>/``."""
    src = fa.KERNEL.source.read_text()
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"variant {name}: {old!r} occurs {src.count(old)} times in the source")
        src = src.replace(old, new)
    path = REPO / "build" / "flash_ab" / name / "flash_attention.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    kernel = _kernels.CudaKernel("flash_attention", fa.KERNEL.functions)
    kernel.source = path
    return kernel


def run(kernel, case):
    """(o, lse, dq, dk, dv) of one forward and backward through ``kernel``."""
    b, h, s, d, causal, seg, seed = case
    fa.KERNEL = kernel
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    q, k, v, do = (torch.randn(b, h, s, d, generator=g, device="cuda").to(torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = fa.flash_attention_forward(q, k, v, seg, seg, causal, scale)
    grads = fa.flash_attention_backward(q, k, v, seg, seg, o, lse, do, causal, scale)
    fwd = cs.cuda_ms(lambda: fa.flash_attention_forward(q, k, v, seg, seg, causal, scale), iters=20)
    bwd = cs.cuda_ms(lambda: fa.flash_attention_backward(q, k, v, seg, seg, o, lse, do, causal, scale),
                     iters=20)
    return (o, lse, *grads), fwd, bwd


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out", default=str(REPO / "build" / "flash_ab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_ab: no CUDA device", file=sys.stderr)
        return 1
    committed = fa.KERNEL
    kernels = {name: committed if not edits else variant_kernel(name, edits) for name, edits in VARIANTS.items()}
    _kernels.build(kernels.values())
    shapes = cs.flash_shapes()
    want = {}
    rows = []
    order = list(kernels)
    try:
        for _ in range(args.rounds):
            for name in order + order[::-1]:
                for shape, case in shapes.items():
                    outs, fwd, bwd = run(kernels[name], case)
                    if shape not in want:
                        want[shape] = outs
                    for label, a, w in zip(("o", "lse", "dq", "dk", "dv"), outs, want[shape]):
                        err = float((a.float() - w.float()).abs().max())
                        limit = 1e-4 if label == "lse" else 1e-2 * float(w.float().abs().max())
                        if not err <= limit:
                            raise AssertionError(f"{name} at {shape}: {label} {err} from the committed build's")
                    row = {"variant": name, "shape": shape, "fwd_ms": fwd, "bwd_ms": bwd}
                    rows.append(row)
                    print(json.dumps(row), flush=True)
    finally:
        fa.KERNEL = committed
    for name in order:
        for shape in shapes:
            mine = [r for r in rows if r["variant"] == name and r["shape"] == shape]
            print(f"{name} {shape}: forward median {statistics.median(r['fwd_ms'] for r in mine):.4f} ms "
                  f"({min(r['fwd_ms'] for r in mine):.4f}-{max(r['fwd_ms'] for r in mine):.4f}), backward "
                  f"median {statistics.median(r['bwd_ms'] for r in mine):.4f} "
                  f"({min(r['bwd_ms'] for r in mine):.4f}-{max(r['bwd_ms'] for r in mine):.4f})")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip() or f"nvidia-smi failed: {smi.stderr.strip()}")
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
