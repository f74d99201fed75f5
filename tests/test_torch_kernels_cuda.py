"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs an NVIDIA CUDA device: marked ``cuda``, each skips without
one.  This file imports no JAX (the card's machine has none), so it runs
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Integer impacts keep every fp32 sum exact, so each comparison is equality.
"""

import numpy as np
import pytest
import torch

from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.ops import gather_rows as gr
from improving_learned_index_tpu_torch.ops import scatter_scores as ss
from improving_learned_index_tpu_torch.search.hybrid_engine import HybridSearchEngine

TILE = 1 << 16


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_gather_kernel_equals_plain(cuda, dtype):
    """Ragged strip (n_pad not a multiple of the block), 67 queries, pairs in
    random order with duplicates and dead entries past counts[1]."""
    g, dev = cuda, "cuda"
    t_heavy, n_pad, nq, p = 50, 3 * TILE + 1024, 67, 300
    dense = torch.randint(0, 257, (t_heavy, n_pad), generator=g, device=dev).to(dtype)
    ids = torch.randperm(t_heavy, generator=g, device=dev)[:40].int()
    pairs = torch.stack(
        [torch.randint(0, nq, (p,), generator=g, device=dev),
         torch.randint(0, 40, (p,), generator=g, device=dev)], 1
    ).int().contiguous()
    counts = torch.tensor([40, p - 7], dtype=torch.int32, device=dev)
    before = gr.KERNEL.launches
    got = gr.accumulate_rows(dense, ids, pairs, counts, nq)
    want = gr.accumulate_rows_plain(dense, ids, pairs, counts, nq)
    torch.cuda.synchronize()
    assert gr.KERNEL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_scatter_kernel_equals_plain(cuda):
    g, dev = cuda, "cuda"
    nq, n_pad, e = 67, 3 * TILE + 1024, 200_003
    base = torch.randint(0, 300, (nq, n_pad), generator=g, device=dev).float()
    d = torch.randint(0, n_pad, (e,), generator=g, device=dev).int()
    v = torch.randint(0, 256, (e,), generator=g, device=dev).float()  # zeros: padding
    r = torch.randint(0, nq, (e,), generator=g, device=dev).int()
    before = ss.KERNEL.launches
    got = ss.apply_tail_updates(base.clone(), d, v, r)
    want = ss.apply_tail_updates_plain(base.clone(), d, v, r)
    torch.cuda.synchronize()
    assert ss.KERNEL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_engine_kernels_equal_plain_and_cpu(cuda):
    """The engine on the card through both kernels, the same engine on the
    plain versions, and the CPU engine: identical ranked lists."""
    rng = np.random.default_rng(3)
    num_docs, n_terms = 70_000, 40
    offsets, doc_ids, impacts = [0], [], []
    for t in range(n_terms):
        n_post = int(rng.integers(1500, 2500)) if t < 5 else int(rng.integers(3, 200))
        docs = np.unique(rng.integers(0, num_docs, n_post))
        offsets.append(offsets[-1] + len(docs))
        doc_ids.append(docs)
        impacts.append(rng.integers(1, 256, len(docs)))
    idx = InvertedIndexData(
        [f"t{t}" for t in range(n_terms)], np.asarray(offsets, np.int64),
        np.concatenate(doc_ids).astype(np.uint32),
        np.concatenate(impacts).astype(np.uint8), num_docs=num_docs,
    )
    batch = [{f"t{i}" for i in rng.choice(n_terms, 4, replace=False)} for _ in range(62)]
    batch += [set(), {"t0"}, {"t30"}, {"t31", "zz"}, {"zz"}]
    g0, s0 = gr.KERNEL.launches, ss.KERNEL.launches
    got = HybridSearchEngine(idx, device="cuda").score_batch(batch, 50)
    assert gr.KERNEL.launches > g0 and ss.KERNEL.launches > s0
    assert got == HybridSearchEngine(idx, device="cuda", use_kernels=False).score_batch(batch, 50)
    assert got == HybridSearchEngine(idx, device="cpu").score_batch(batch, 50)
