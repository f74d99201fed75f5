"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every case needs an NVIDIA CUDA device: marked ``cuda``, each skips without
one.  This file imports no JAX (the card's machine has none), so it runs
there without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels_cuda.py

Integer impacts keep every fp32 sum exact and counts are integers, so the
query kernels' comparisons (``gather_rows``, both ``scatter_scores``
entries, ``count_ge``, the blocked scoring kernel) are equality.  Float
impacts (the hybrid engine's float mode) are summed in another order by the
kernels than by their plain versions: ``gather_rows``' fp32 instance is
held within 4 x 2^-23 of each cell's sum of absolute values (at least 4
fp32 ulps of it), and the float engine's scores within 1e-5 relative, its
doc order exact except between two scores that close; dyadic impacts
(multiples of 2^-8) sum exactly in any order and are compared equal.  ``short_attention`` is held to its plain version within two
bf16 ulps of the largest output: both round the same fp32 context to bf16
once, and only the fp32 summation order differs.  Its backward is one
recompute for both routes (equal gradients); a training step's loss and
gradients on the kernel route are held to the plain route's.
``flash_attention``'s forward and its backward kernels are held to the
twin within 1e-2 of the largest |output| or |gradient| (p is rounded to
bf16 against a running maximum in the kernel, against the final one in the
twin) and the log-sum-exp within 1e-4, and two backward runs, whose fp32
dq sums are atomic adds in another order each run, to each other within
the same 1e-2; the tile pairs they computed, by their own count, equal the
tile rule's (``tile_pairs``); the Llama forward and a fine-tune step through
them to the twin route within stated tolerances.  The encoder's epilogue
kernels (bias, residual, LayerNorm, GELU) are held to their twins within 1
bf16 ulp of each output (the same roundings; only the LayerNorm's fp32 sums
run in another order), engage on every forward without grad and on none
with it, and keep an encode batch within the encode cells' impact-gap
limits of the twin route.  ``linear_gelu`` (the FFN's first product, bias
and GELU) is held to its twin up to the product's order of summation: each
output is the twin's bias and GELU of the library's bf16 product or of one
of its two bf16 neighbours (a one-ulp change of the product moves the
output by one ulp, or by many where the bias add nearly cancels it or on
the GELU's left tail); its GELU equals ``ili_bias_gelu``'s at every finite
bf16 input.  The T5 route reaches no kernel: a tiny fp32
T5's greedy tokens on the card equal the CPU's.
"""

from contextlib import nullcontext

import numpy as np
import pytest
import torch

from improving_learned_index_tpu_torch.index.inverted import InvertedIndexData
from improving_learned_index_tpu_torch.ops import gather_rows as gr
from improving_learned_index_tpu_torch.ops import scatter_scores as ss
from improving_learned_index_tpu_torch.ops import pallas_scoring as ps
from improving_learned_index_tpu_torch.ops import flash_attention as fa
from improving_learned_index_tpu_torch.ops import short_attention as sa
from improving_learned_index_tpu_torch.ops import encoder_epilogue as epi
from improving_learned_index_tpu_torch.ops import linear_gelu as lg
from improving_learned_index_tpu_torch.ops import plain_versions
from improving_learned_index_tpu_torch.ops._kernels import launches
from improving_learned_index_tpu_torch.ops.count_ge import KERNEL as COUNT_KERNEL
from improving_learned_index_tpu_torch.ops.count_ge import count_ge, count_ge_plain
from improving_learned_index_tpu_torch.ops import topk_select as tks
from improving_learned_index_tpu_torch.ops.exact_topk import exact_topk_integer
from improving_learned_index_tpu_torch.search.dense_engine import DenseSearchEngine
from improving_learned_index_tpu_torch.search.device_engine import DeviceSearchEngine
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


_GROUPED_CASES = ["ragged", "narrow", "one_query", "many_queries", "rows_past_the_ring",
                  "no_pairs", "queries_without_pairs", "rows_out_of_range"]


def _grouped_case(name, dtype, g):
    """(dense, table, nq) for ``accumulate_grouped``: integer cells, the
    table from the host builder, pairs drawn in random order.  n_pad is
    ragged against both dtypes' tiles (256 and 128 docs); rows_past_the_ring
    has 500 hit rows, more than the 12 stages of 32 rows hold."""
    dev = "cuda"
    t_heavy, n_pad, nq, n_hit, n_pairs = 60, 3 * TILE + 1032, 67, 40, 300
    if name == "narrow":
        n_pad = 24
    elif name == "one_query":
        nq, n_pairs = 1, 12
    elif name == "many_queries":
        nq, n_pairs = 300, 1500
    elif name == "rows_past_the_ring":
        t_heavy, n_hit, n_pairs = 600, 500, 1200
    elif name == "no_pairs":
        n_pairs = 0
    dense = torch.randint(0, 257, (t_heavy, n_pad), generator=g, device=dev).to(dtype)
    rows = torch.randperm(t_heavy, generator=g, device=dev)[:n_hit]
    q = torch.randint(0, nq, (n_pairs,), generator=g, device=dev)
    if name == "queries_without_pairs":
        q = q % 5 * 13
    r = rows[torch.randint(0, n_hit, (n_pairs,), generator=g, device=dev)]
    if name == "rows_out_of_range":
        r[::7] = -2
        r[1::7] = t_heavy + 3
    table = torch.from_numpy(gr.group_pairs(q.cpu().numpy(), r.cpu().numpy(), nq)).to(dev)
    return dense, table, nq


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("name", _GROUPED_CASES)
def test_gather_grouped_kernel_equals_plain(cuda, name, dtype):
    """The engines' entry, one launch a call, equal to its plain version."""
    dense, table, nq = _grouped_case(name, dtype, cuda)
    before = gr.KERNEL.launches
    got = gr.accumulate_grouped(dense, table, nq)
    want = gr.accumulate_grouped_plain(dense, table, nq)
    torch.cuda.synchronize()
    assert gr.KERNEL.launches == before + 1
    assert got.shape == (nq, dense.shape[1]) and torch.equal(got, want)
    if name == "no_pairs":
        assert not got.any()


@pytest.mark.cuda
def test_gather_grouped_kernel_refuses_what_it_cannot_take(cuda):
    """A table past the kernel's int32 indexing (8 GiB of int32) and an
    n_pad that is no multiple of 16 bytes raise before any launch."""
    dense = torch.zeros(2, 64, dtype=torch.bfloat16, device="cuda")
    before = gr.KERNEL.launches
    with pytest.raises(ValueError, match="exceeds"):
        gr.accumulate_grouped(dense, torch.zeros(2**31, dtype=torch.int32, device="cuda"), 1)
    torch.cuda.empty_cache()
    with pytest.raises(ValueError, match="n_pad"):
        gr.accumulate_grouped(dense[:, :60].contiguous(), torch.zeros(3, dtype=torch.int32, device="cuda"), 1)
    assert gr.KERNEL.launches == before


def _scatter_case(name, g):
    """(base scores, d, v, r) flat updates on the card.  v == 0 marks
    padding; the out_of_range case holds docs and rows outside the matrix,
    which the kernel drops."""
    dev = "cuda"
    nq, n_pad, e = 67, 3 * TILE + 1024, 200_003
    if name == "narrow":  # a matrix narrower than one warp's sweep
        nq, n_pad, e = 5, 7, 5000
    e = {"one_update": 1, "no_update": 0, "one_cell": 10_000}.get(name, e)

    def ints(lo, hi, n=e):
        return torch.randint(lo, hi, (n,), generator=g, device=dev).int()

    d, r, v = ints(0, n_pad), ints(0, nq), ints(0, 256).float()
    if name == "one_row":
        r.fill_(nq // 2)
    elif name == "one_cell":  # 10,000 adds to one cell
        d.fill_(n_pad - 1)
        r.fill_(3)
        v = ints(1, 256).float()
    elif name == "edges":  # the first and last doc of each row, tile edges
        edges = torch.tensor([0, TILE - 1, TILE, n_pad - 1], device=dev, dtype=torch.int32)
        d = edges[ints(0, len(edges))]
        r = torch.where(ints(0, 2) == 0, 0, nq - 1).int()
    elif name == "out_of_range":
        bad = ints(0, 6)
        d = torch.where(bad == 0, n_pad + ints(0, 9), torch.where(bad == 1, -1 - ints(0, 9), d))
        r = torch.where(bad == 2, nq + ints(0, 3), torch.where(bad == 3, -1 - ints(0, 3), r))
    base = torch.randint(0, 300, (nq, n_pad), generator=g, device=dev).float()
    return base, d, v, r


_SCATTER_CASES = ["random", "one_row", "one_cell", "edges", "out_of_range",
                  "one_update", "no_update", "narrow"]


@pytest.mark.cuda
@pytest.mark.parametrize("entry", ["flat", "chunks"])
@pytest.mark.parametrize("name", _SCATTER_CASES)
def test_scatter_kernel_equals_plain(cuda, name, entry):
    """Both entries against the plain version on the in-range updates.  The
    chunk entry takes the same updates as a table of one-slot chunks
    (starts = positions, lengths 1, rows = r)."""
    base, d, v, r = _scatter_case(name, cuda)
    nq, n_pad = base.shape
    keep = (d >= 0) & (d < n_pad) & (r >= 0) & (r < nq)
    want = ss.apply_tail_updates_plain(base.clone(), d[keep], v[keep], r[keep])
    before = ss.KERNEL.launches
    if entry == "flat":
        got = ss.apply_tail_updates(base.clone(), d, v, r)
    else:
        pos = torch.arange(d.numel(), device="cuda", dtype=torch.int32)
        got = ss.apply_tail_chunks(base.clone(), d, v, pos, torch.ones_like(pos), r, 1)
    torch.cuda.synchronize()
    assert ss.KERNEL.launches == before + (d.numel() > 0)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [7, 512, 1024, 2048])
def test_scatter_chunks_kernel_equals_plain(cuda, chunk):
    """Random tables over posting arrays with -1 docs: lengths past the
    chunk, empty chunks, rows of 67 queries, chunk not a power of two."""
    g, dev = cuda, "cuda"
    nq, n_pad, n_post, n_chunks = 67, 3 * TILE + 1024, 3_000_000, 20_000
    docs = torch.randint(-1, n_pad, (n_post,), generator=g, device=dev).int()
    vals = torch.randint(1, 256, (n_post,), generator=g, device=dev).float()
    starts = torch.randint(0, n_post - chunk - 3, (n_chunks,), generator=g, device=dev).int()
    lengths = torch.randint(0, chunk + 3, (n_chunks,), generator=g, device=dev).int()
    rows = torch.randint(0, nq, (n_chunks,), generator=g, device=dev).int()
    base = torch.randint(0, 300, (nq, n_pad), generator=g, device=dev).float()
    before = ss.KERNEL.launches
    got = ss.apply_tail_chunks(base.clone(), docs, vals, starts, lengths, rows, chunk)
    want = ss.apply_tail_chunks_plain(base.clone(), docs, vals, starts, lengths, rows, chunk)
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
    g0, s0, c0, t0 = gr.KERNEL.launches, ss.KERNEL.launches, COUNT_KERNEL.launches, tks.KERNEL.launches
    got = HybridSearchEngine(idx, device="cuda").score_batch(batch, 50)
    assert gr.KERNEL.launches > g0 and ss.KERNEL.launches > s0 and tks.KERNEL.launches > t0
    assert COUNT_KERNEL.launches == c0  # the batch's bound takes the histogram route
    with plain_versions():
        assert got == HybridSearchEngine(idx, device="cuda").score_batch(batch, 50)
    assert got == HybridSearchEngine(idx, device="cpu").score_batch(batch, 50)


def _segments(rng, b, s, packed):
    """Key-padding masks (a full row, a padded tail) or packed segment ids
    (runs of 1..n with a padded tail, one row of a single segment)."""
    seg = np.zeros((b, s), np.int32)
    for i in range(b):
        n = s if i == 0 else int(rng.integers(s // 4, s))
        if not packed:
            seg[i, :n] = 1
            continue
        cuts = np.sort(rng.choice(np.arange(1, n), size=min(i, n - 1), replace=False))
        for j, (lo, hi) in enumerate(zip(np.r_[0, cuts], np.r_[cuts, n])):
            seg[i, lo:hi] = j + 1
    return seg


_ATTENTION_CASES = [
    # every (S, D) instance; B*H = 15 items, fewer than the card's SMs; the
    # scale D**-0.5 is a power of two at D = 16 and 64 (the kernel's fused
    # multiply-add) and not at D = 32 and 128 (separate multiply and add)
    *(((3, 5, s, d), torch.bfloat16, "strided") for s in (128, 256) for d in (16, 32, 64, 128)),
    # the encoder's shape, B*H = 24
    ((2, 12, 256, 64), torch.bfloat16, "strided"),
    # B*H = 133 and 300: more items than SMs, not a multiple of the grid
    ((133, 1, 256, 64), torch.bfloat16, "strided"),
    ((300, 1, 128, 32), torch.bfloat16, "strided"),
    # fp32 in and out (operands rounded to bf16), one stage and two
    ((2, 3, 256, 128), torch.float32, "strided"),
    ((4, 2, 128, 32), torch.float32, "strided"),
    # contiguous [B, H, S, D]; a batch row whose padding mask is all zero
    ((2, 12, 256, 64), torch.bfloat16, "contiguous"),
    ((3, 2, 256, 64), torch.bfloat16, "zero_row"),
    ((3, 2, 128, 16), torch.bfloat16, "zero_row"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("shape,dtype,layout", _ATTENTION_CASES)
def test_short_attention_kernel_equals_plain(cuda, shape, dtype, layout, packed):
    """Inputs as the encoder gives them, [B, S, H, D] projections seen as
    [B, H, S, D] strided views, unless ``layout`` says otherwise."""
    b, h, s, d = shape
    rng = np.random.default_rng(b + h + s + d + int(packed))
    if layout == "contiguous":
        q, k, v = (torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32) * 1.5)
                   .to("cuda", dtype) for _ in range(3))
    else:
        q, k, v = (
            torch.from_numpy(rng.standard_normal((b, s, h, d), dtype=np.float32) * 1.5)
            .to("cuda", dtype).permute(0, 2, 1, 3)
            for _ in range(3)
        )
    seg = _segments(rng, b, s, packed)
    if layout == "zero_row":
        seg[-1] = 0
    seg = torch.from_numpy(seg).cuda()
    before = sa.KERNEL.launches
    got = sa.short_attention(q, k, v, seg, d ** -0.5, packed)
    want = sa.short_attention_plain(q, k, v, seg, d ** -0.5, packed)
    torch.cuda.synchronize()
    assert sa.KERNEL.launches == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype == dtype
    err = float((got.float() - want.float()).abs().max())
    peak = float(want.float().abs().max())
    assert err <= 2 * 2.0 ** (np.floor(np.log2(peak)) - 7), (err, peak)


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [False, True])
def test_short_attention_backward_through_plain(cuda, packed):
    """The kernel route's backward is the plain route's (inside
    ``plain_versions()``) and ``reference_attention``'s under autograd: one
    recompute for both."""
    b, h, s, d = 2, 2, 128, 16
    rng = np.random.default_rng(9)
    leaves = [torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32)).cuda().requires_grad_()
              for _ in range(3)]
    seg = torch.from_numpy(_segments(rng, b, s, packed)).cuda()
    g = torch.from_numpy(rng.standard_normal((b, h, s, d), dtype=np.float32)).cuda()
    before = sa.KERNEL.launches
    sa.short_attention(*leaves, seg, 0.25, packed).backward(g)
    assert sa.KERNEL.launches == before + 1
    got = [t.grad.clone() for t in leaves]
    for route in (sa.short_attention, sa.reference_attention):
        for t in leaves:
            t.grad = None
        with plain_versions():
            route(*leaves, seg, 0.25, packed).backward(g)
        for x, y in zip(got, (t.grad for t in leaves)):
            assert torch.equal(x, y)
    assert sa.KERNEL.launches == before + 1


def _train_batch(seed, groups, max_length):
    """A seeded vocabulary and triples (each query three words of its
    positive passage, the negative another passage), collated and packed."""
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.train import COLLATES
    from improving_learned_index_tpu_torch.train.packed import pack_collated

    rng = np.random.default_rng(seed)
    words = [f"w{i}x" for i in range(400)]
    passages = [" ".join(rng.choice(words, int(rng.integers(20, 120)))) for _ in range(2 * groups)]
    tok = ImpactTokenizer(WordPieceVocab.build(passages, max_size=1000), max_length=max_length)
    triples = [(" ".join(passages[i].split()[:3]), passages[i], passages[groups + i]) for i in range(groups)]
    return tok, pack_collated(COLLATES["pairwise_ce"](triples, tok, max_length))


@pytest.mark.cuda
def test_train_step_kernel_route_matches_plain(cuda, tmp_path):
    """BERT-base width (768 wide, 12 heads of 64) with 2 layers at S=256, a
    packed batch of 32 query groups: the kernel route's loss within 1% of
    the plain route's, the global gradient norm within 2%, the flattened
    gradients' cosine >= 0.99 (the forwards differ by a bf16 ulp of an
    attention output, the backwards are one recompute); then one Trainer
    step leaves finite params."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.train import Trainer, make_loss_fn

    tok, batch = _train_batch(3, 32, 256)
    config = EncoderConfig(vocab_size=len(tok.vocab), num_layers=2, impact_activation="softplus")
    model = DeepImpact(config, tok, seed=0, device="cuda")
    trainer = Trainer(model, TrainConfig(batch_size=32, lr=1e-4, save_every=10**6, eval_every=10**9),
                      tmp_path)
    put = trainer._put_batch(batch)
    out = {}
    for kernels in (True, False):
        before = sa.KERNEL.launches
        with nullcontext() if kernels else plain_versions():
            loss = make_loss_fn(model.module, "pairwise_ce")(put)
            loss.backward()
        torch.cuda.synchronize()
        assert sa.KERNEL.launches - before == (config.num_layers if kernels else 0)
        grads = torch.cat([p.grad.flatten() for p in model.module.parameters()])
        out[kernels] = (loss.item(), grads)
        for p in model.module.parameters():
            p.grad = None
    (lk, gk), (lp, gp) = out[True], out[False]
    assert np.isfinite(lk) and abs(lk - lp) <= 0.01 * abs(lp)
    nk, npl = float(gk.norm()), float(gp.norm())
    assert npl > 0 and abs(nk - npl) <= 0.02 * npl
    assert float(torch.dot(gk, gp)) / (nk * npl) >= 0.99
    before = [p.detach().clone() for p in model.module.parameters()]
    trainer.train([batch], total_steps=1)
    assert trainer.manager.step == 1
    after = list(model.module.parameters())
    assert all(bool(torch.isfinite(p).all()) for p in after)
    assert any(not torch.equal(a, b) for a, b in zip(before, after))


def _impacts_close(got, want, rel_max=0.05, rel_mean=0.002):
    """Flat score lists: every difference within ``rel_max`` of the largest
    |want|, the mean difference within ``rel_mean`` of it (the kernel and
    plain routes differ by a bf16 ulp of an attention output)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    peak, diff = float(np.abs(want).max()), np.abs(got - want)
    assert peak > 0 and diff.max() <= rel_max * peak and diff.mean() <= rel_mean * peak, (
        float(diff.max()), float(diff.mean()), peak)


@pytest.mark.cuda
def test_cross_encoder_kernel_route_matches_plain(cuda, tmp_path):
    """BERT-base width (768 wide, 12 heads of 64) with 2 layers at S=256:
    64 candidates' cross-encoder scores on the kernel route against the
    plain route (every score within 5% of the largest, the mean within
    0.2%), one launch a layer; then a cross-encoder training batch's loss
    within 1%, gradient norm within 2%, cosine >= 0.99."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig, TrainConfig
    from improving_learned_index_tpu_torch.models import DeepImpactCrossEncoder
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.train import COLLATES, Trainer, make_loss_fn

    rng = np.random.default_rng(4)
    words = [f"w{i}x" for i in range(400)]
    passages = [" ".join(rng.choice(words, int(rng.integers(20, 120)))) for _ in range(64)]
    tok = ImpactTokenizer(WordPieceVocab.build(passages, max_size=1000), max_length=256)
    config = EncoderConfig(vocab_size=len(tok.vocab), num_layers=2, impact_activation="softplus")
    model = DeepImpactCrossEncoder(config, tok, seed=0, device="cuda")
    encs = model.process_cross_encoder_documents_and_query(passages, " ".join(words[:4]))
    before = sa.KERNEL.launches
    got = model.score_batch(encs)
    torch.cuda.synchronize()
    assert sa.KERNEL.launches - before == config.num_layers
    with plain_versions():
        _impacts_close(got, model.score_batch(encs))

    triples = [(" ".join(passages[i].split()[:3]), passages[i], passages[32 + i]) for i in range(16)]
    trainer = Trainer(model, TrainConfig(batch_size=16, loss="cross_encoder", save_every=10**6,
                                         eval_every=10**9), tmp_path)
    put = trainer._put_batch(COLLATES["cross_encoder"](triples, tok, 256))
    out = {}
    for kernels in (True, False):
        with nullcontext() if kernels else plain_versions():
            loss = make_loss_fn(model.module, "cross_encoder")(put)
            loss.backward()
        out[kernels] = (loss.item(), torch.cat([p.grad.flatten() for p in model.module.parameters()]))
        for p in model.module.parameters():
            p.grad = None
    (lk, gk), (lp, gp) = out[True], out[False]
    assert np.isfinite(lk) and abs(lk - lp) <= 0.01 * abs(lp)
    nk, npl = float(gk.norm()), float(gp.norm())
    assert npl > 0 and abs(nk - npl) <= 0.02 * npl
    assert float(torch.dot(gk, gp)) / (nk * npl) >= 0.99


@pytest.mark.cuda
def test_reranker_on_the_card_equals_cpu(cuda, tmp_path):
    """ReRanker with one fp32 model (2 heads of 64, S=128) on the card (the
    kernel, one launch a layer an encode batch) and on the CPU (its plain
    version): the cached impacts within 5% of the largest (mean within
    0.2%), each query's candidates in the same order except where two CPU
    scores lie within twice what three such impacts may add up to (a query
    has at most 3 terms)."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.evaluation import ReRanker
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    rng = np.random.default_rng(5)
    words = [f"w{i}x" for i in range(60)]
    passages = [" ".join(rng.choice(words, int(rng.integers(5, 60)))) for _ in range(40)]
    tok = ImpactTokenizer(WordPieceVocab.build(passages, max_size=200), max_length=128)
    (tmp_path / "c.tsv").write_text("".join(f"{i}\t{p}\n" for i, p in enumerate(passages)))
    (tmp_path / "q.tsv").write_text("".join(f"{q}\t{' '.join(rng.choice(words, 3))}\n" for q in range(5)))
    (tmp_path / "run.tsv").write_text("".join(
        f"{q}\t{p}\t{r + 1}\t1.0\n" for q in range(5) for r, p in enumerate(rng.permutation(40)[:30])))
    config = EncoderConfig(vocab_size=len(tok.vocab), hidden_size=128, num_layers=2, num_heads=2,
                           intermediate_size=256, max_position_embeddings=128, dtype="float32")
    card = DeepImpact(config, tok, seed=0, device="cuda")
    cpu = DeepImpact(config, tok, state_dict={k: v.cpu() for k, v in card.module.state_dict().items()},
                     device="cpu")
    args = (tmp_path / "run.tsv", tmp_path / "q.tsv", tmp_path / "c.tsv")
    calls, encode = [], card.encode_term_scores
    card.encode_term_scores = lambda *a, **k: calls.append(1) or encode(*a, **k)
    before = sa.KERNEL.launches
    rr_card = ReRanker(card, *args, tmp_path / "card.run", batch_size=16)
    rr_cpu = ReRanker(cpu, *args, tmp_path / "cpu.run", batch_size=16)
    assert rr_card.run() == rr_cpu.run() == 5
    assert len(calls) >= 3 and sa.KERNEL.launches - before == config.num_layers * len(calls)
    assert rr_card.cache.keys() == rr_cpu.cache.keys()
    pids = sorted(rr_cpu.cache)
    assert all(list(rr_card.cache[p]) == list(rr_cpu.cache[p]) for p in pids)
    flat = [(rr_card.cache[p][t], rr_cpu.cache[p][t]) for p in pids for t in rr_cpu.cache[p]]
    _impacts_close([g for g, _ in flat], [w for _, w in flat])
    tol = 0.05 * max(abs(w) for _, w in flat)

    def read(path):
        out = {}
        for line in path.read_text().splitlines():
            q, p, _, s = line.split("\t")
            out.setdefault(q, []).append((p, float(s)))
        return out

    got, want = read(tmp_path / "card.run"), read(tmp_path / "cpu.run")
    assert got.keys() == want.keys()
    for q in want:
        wv = dict(want[q])
        assert sorted(dict(got[q])) == sorted(wv)
        for (gp, _), (wp, _) in zip(got[q], want[q]):
            assert gp == wp or abs(wv[gp] - wv[wp]) <= 2 * 3 * tol, (q, gp, wp)


@pytest.mark.cuda
def test_short_attention_kernel_refuses_other_shapes(cuda):
    q = torch.zeros(1, 1, 128, 24, device="cuda", dtype=torch.bfloat16)
    seg = torch.ones(1, 128, dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="kernel takes"):
        sa.short_attention(q, q, q, seg, 0.2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided_odd", "unaligned", "thresholds_128"])
def test_count_ge_kernel_equals_plain(cuda, layout):
    """A contiguous [67, 3 tiles + 1024] matrix; a sliced view with an odd
    width (row stride of the wider matrix, 16-byte aligned rows); a view
    whose rows start 4 bytes off alignment (scalar loads); 128 thresholds
    (16 groups of 8)."""
    g, dev = cuda, "cuda"
    wide = torch.randint(0, 3000, (67, 3 * TILE + 1024), generator=g, device=dev).float()
    scores = {"contiguous": wide, "strided_odd": wide[:, : 2 * TILE + 1001],
              "unaligned": wide[:, 1 : TILE + 7], "thresholds_128": wide}[layout]
    n_thresh = 128 if layout == "thresholds_128" else 7
    t = torch.randint(0, 3100, (67, n_thresh), generator=g, device=dev).float()
    before = COUNT_KERNEL.launches
    got = count_ge(scores, t)
    want = count_ge_plain(scores, t)
    torch.cuda.synchronize()
    assert COUNT_KERNEL.launches == before + 1
    assert got.dtype == torch.int32 and torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "strided_odd", "unaligned", "one_row", "ties", "top_bin"])
def test_topk_select_kernels_equal_plain(cuda, layout):
    """The histogram, the k-th scores and both block counts (with and
    without the block maxima) equal their plain versions; the histogram
    route of ``exact_topk_integer`` equals its plain version and the n-ary
    route, values and doc ids."""
    g, dev = cuda, "cuda"
    wide = torch.randint(0, 3000, (67, 3 * 65536 + 1024), generator=g, device=dev).float()
    scores = {"contiguous": wide, "strided_odd": wide[:, : 2 * 65536 + 1001],
              "unaligned": wide[:, 1 : 65536 + 7], "one_row": wide[:1, :100_001],
              "ties": torch.randint(0, 4, (9, 70_000), generator=g, device=dev).float(),
              "top_bin": wide.clamp(max=tks.BINS - 1).index_fill_(1, torch.tensor([5, 777], device=dev),
                                                                   float(tks.BINS - 1))}[layout]
    k = 5000 if layout == "ties" else 1000
    before = dict(tks.KERNEL.calls)
    hist, block_max = tks.value_histogram(scores)
    want_hist, want_max = tks.value_histogram_plain(scores)
    s_k = tks.kth_scores(hist, k)
    counts = [tks.block_counts(scores, s_k, block_max), tks.block_counts(scores, s_k)]
    want_counts = tks.block_counts_plain(scores, s_k)
    torch.cuda.synchronize()
    assert {f: tks.KERNEL.calls.get(f, 0) - before.get(f, 0) for f in tks.KERNEL.functions} == {
        "ili_topk_histogram": 1, "ili_topk_kth": 1, "ili_topk_block_counts": 2}
    assert torch.equal(hist, want_hist) and torch.equal(block_max, want_max)
    assert torch.equal(s_k, tks.kth_scores_plain(want_hist, k))
    for got in counts:
        assert all(torch.equal(a, b) for a, b in zip(got, want_counts))
    v, i = exact_topk_integer(scores, k, max_score=tks.BINS - 1)
    with plain_versions():
        plain = exact_topk_integer(scores, k, max_score=tks.BINS - 1)
    for other in (plain, exact_topk_integer(scores, k)):
        assert torch.equal(v, other[0]) and torch.equal(i, other[1])


def _gap_and_edge_index():
    """Heavy terms with empty blocks (unaligned and aligned starts, so the
    tables hold zero-width chunks) and docs on every block edge, tail terms,
    num_docs not a multiple of the block."""
    rng = np.random.default_rng(12)
    blk = ps.BLK
    num_docs = 6 * blk + 77
    edges = np.array([0, blk - 1, blk, 2 * blk - 1, 2 * blk, 5 * blk, num_docs - 1])
    lists = {
        "gap": np.concatenate([rng.choice(blk, 3000, replace=False),
                               3 * blk + rng.choice(blk, 2000, replace=False)]),
        "aligned": np.concatenate([np.arange(blk), 4 * blk + rng.choice(blk, 100, replace=False)]),
        "edges": np.unique(np.concatenate([edges, rng.choice(num_docs, 5000, replace=False)])),
    }
    for i in range(20):
        lists[f"tail{i}"] = rng.choice(num_docs, int(rng.integers(1, 400)), replace=False)
    offsets, docs, vals = [0], [], []
    for d in lists.values():
        offsets.append(offsets[-1] + len(d))
        docs.append(d)
        vals.append(rng.integers(1, 256, len(d)))
    idx = InvertedIndexData(list(lists), np.asarray(offsets, np.int64),
                            np.concatenate(docs).astype(np.uint32),
                            np.concatenate(vals).astype(np.uint8), num_docs=num_docs)
    names = list(lists)
    batch = [{names[i] for i in rng.choice(len(names), 3, replace=False)} for _ in range(20)]
    batch += [{"gap"}, {"aligned"}, {"edges"}, {"gap", "aligned", "edges"}, set(), {"zz"}]
    return idx, batch


@pytest.mark.cuda
def test_blocked_kernel_equals_plain(cuda):
    idx, batch = _gap_and_edge_index()
    eng = ps.PallasBlockedEngine(idx, device="cuda")
    padded = batch + [set()] * (-len(batch) % ps.QG)
    cell_offsets, starts, meta, _ = eng._tables(padded)
    lo, hi = (meta >> 14) & 0x3FFF, meta & 0x3FFF
    assert (lo == hi).any() and (np.diff(cell_offsets) == 0).any()  # zero-width chunks, empty cells
    put = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()  # noqa: E731
    args = (put(cell_offsets), put(starts), put(meta), eng.docs, eng.vals, len(padded), eng.num_blocks)
    before = ps.KERNEL.launches
    got = ps.blocked_scores(*args)
    want = ps.blocked_scores_plain(*args)
    torch.cuda.synchronize()
    assert ps.KERNEL.launches == before + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_other_engines_on_card_equal_cpu(cuda):
    """Blocked, device and dense engines on the card (kernels), on the card
    with the plain versions, and on the CPU: identical ranked lists."""
    idx, batch = _gap_and_edge_index()
    b0, c0 = ps.KERNEL.launches, COUNT_KERNEL.launches
    for cls in (ps.PallasBlockedEngine, DeviceSearchEngine, DenseSearchEngine):
        s0 = ss.KERNEL.launches
        got = cls(idx, device="cuda").score_batch(batch, 100)
        # the blocked engine's tail and the device engine's scatter take the
        # chunk entry; the dense engine has no tail
        assert (ss.KERNEL.launches > s0) == (cls is not DenseSearchEngine), cls
        with plain_versions():
            assert got == cls(idx, device="cuda").score_batch(batch, 100), cls
        assert got == cls(idx, device="cpu").score_batch(batch, 100), cls
    assert ps.KERNEL.launches > b0 and COUNT_KERNEL.launches > c0


def _ulp_tolerance(dense, ids, pairs, counts, nq):
    """4 x 2^-23 of each cell's sum of absolute values: the bound on two
    fp32 sums of the same few terms in different orders."""
    return 4 * 2.0 ** -23 * gr.accumulate_rows_plain(dense.abs(), ids, pairs, counts, nq)


@pytest.mark.cuda
def test_gather_kernel_fp32_float_rows_within_ulps(cuda):
    """The fp32 instance on float rows (the hybrid engine's float mode):
    not bit-equal to the plain ``w @ rows``, within 4 ulps of each cell's
    sum of absolute values; exact where a cell has one term."""
    g, dev = cuda, "cuda"
    t_heavy, n_pad, nq, p = 60, 2 * TILE + 512, 50, 400
    dense = torch.rand(t_heavy, n_pad, generator=g, device=dev) * 3
    dense[:, ::7] = 0
    ids = torch.randperm(t_heavy, generator=g, device=dev)[:48].int()
    pairs = torch.stack(
        [torch.randint(0, nq, (p,), generator=g, device=dev),
         torch.randint(0, 48, (p,), generator=g, device=dev)], 1
    ).int().contiguous()
    counts = torch.tensor([48, p], dtype=torch.int32, device=dev)
    before = gr.KERNEL.launches
    got = gr.accumulate_rows(dense, ids, pairs, counts, nq)
    want = gr.accumulate_rows_plain(dense, ids, pairs, counts, nq)
    torch.cuda.synchronize()
    assert gr.KERNEL.launches == before + 1 and got.dtype == torch.float32
    assert bool(((got - want).abs() <= _ulp_tolerance(dense, ids, pairs, counts, nq)).all())
    one = torch.tensor([[0, 0]], dtype=torch.int32, device=dev)
    single = torch.tensor([1, 1], dtype=torch.int32, device=dev)
    assert torch.equal(gr.accumulate_rows(dense, ids, one, single, 1),
                       gr.accumulate_rows_plain(dense, ids, one, single, 1))


def _float_docs(rng, num_docs, n_terms, dyadic):
    """Per-doc (term, impact) lists: 5 terms with 1,500-2,500 postings (dense
    rows at heavy_min 1,000), the rest short (tail)."""
    per_doc = [[] for _ in range(num_docs)]
    for t in range(n_terms):
        n_post = int(rng.integers(1500, 2500)) if t < 5 else int(rng.integers(3, 200))
        for d in np.unique(rng.integers(0, num_docs, n_post)).tolist():
            v = rng.integers(1, 9) / 256 if dyadic else rng.random() * 3
            per_doc[d].append((f"t{t}", float(v)))
    return per_doc


def _float_rankings_close(got, want, rel=1e-5):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        gs, ws = np.array([s for _, s in g]), np.array([s for _, s in w])
        np.testing.assert_allclose(gs, ws, rtol=rel)
        score = dict(g)
        for (gd, sg), (wd, _) in zip(g, w):
            if gd != wd:  # a swap between two scores within the tolerance
                assert abs(score[wd] - sg) <= 2 * rel * sg, (gd, wd)


@pytest.mark.cuda
@pytest.mark.parametrize("dyadic", [True, False])
def test_hybrid_float_engine_on_card_equals_cpu(cuda, dyadic):
    """The float hybrid engine on the card (both kernels, no count_ge: the
    float top-k is a sort), on the card with the plain versions, and on the
    CPU; every doc with a positive score comes back (k = num_docs)."""
    rng = np.random.default_rng(5)
    num_docs, n_terms = 70_000, 40
    docs = _float_docs(rng, num_docs, n_terms, dyadic)
    batch = [{f"t{i}" for i in rng.choice(n_terms, 4, replace=False)} for _ in range(14)]
    batch += [set(), {"t0"}, {"t30", "zz"}, {"zz"}]
    g0, s0, c0 = gr.KERNEL.launches, ss.KERNEL.launches, COUNT_KERNEL.launches
    card = HybridSearchEngine.from_term_impacts(docs, heavy_min=1000, device="cuda")
    assert card.t_heavy == 5 and card.dense.dtype == torch.float32
    got = card.score_batch(batch, num_docs)
    assert gr.KERNEL.launches > g0 and ss.KERNEL.launches > s0 and COUNT_KERNEL.launches == c0
    plain = HybridSearchEngine.from_term_impacts(docs, heavy_min=1000, device="cuda")
    cpu = HybridSearchEngine.from_term_impacts(docs, heavy_min=1000, device="cpu")
    device = DeviceSearchEngine.from_term_impacts(docs, device="cuda")
    with plain_versions():
        plain_lists = plain.score_batch(batch, num_docs)
    for want in (plain_lists, cpu.score_batch(batch, num_docs),
                 device.score_batch(batch, num_docs)):
        if dyadic:
            assert got == want
        else:
            _float_rankings_close(got, want)
    assert sum(map(len, got)) > 10_000


@pytest.mark.cuda
@pytest.mark.parametrize("n_docs", [5_000, 100_000])
def test_sparse_search_on_card_kernels_equal_plain(cuda, n_docs):
    """SparseSearch on the card on both sides of its engine switch, with the
    kernels and with their plain versions (``plain_versions()``): equal
    results for dyadic impacts (a word's length / 8)."""
    from improving_learned_index_tpu_torch.evaluation import SparseSearch

    class Stub:
        device = "cuda"

        def process_query(self, query):
            return set(query.split())

        def get_impact_scores_batch(self, texts):
            return [[(t, len(t) / 8) for t in dict.fromkeys(text.split())] for text in texts]

    rng = np.random.default_rng(2)
    # 100 common words (dense rows past 100,000 docs) and 20,000 rare ones
    # (the tail): each doc 4 of the first and 2 of the second
    common = np.array([f"w{i}" for i in range(100)])
    rare = np.array([f"rare{i}" for i in range(20_000)])
    corpus = {str(i): " ".join([*rng.choice(common, 4), *rng.choice(rare, 2)]) for i in range(n_docs)}
    queries = {str(q): " ".join([*rng.choice(common, 2), *rng.choice(rare, 1)]) for q in range(40)}
    g0, s0 = gr.KERNEL.launches, ss.KERNEL.launches
    card = SparseSearch(Stub(), batch_size=4096)
    got = card.search(queries, corpus, k=100)
    want_engine = HybridSearchEngine if n_docs >= 100_000 else DeviceSearchEngine
    assert type(card.engine) is want_engine and card.engine.device.type == "cuda"
    assert ss.KERNEL.launches > s0 and (gr.KERNEL.launches > g0) == (want_engine is HybridSearchEngine)
    with plain_versions():
        assert got == SparseSearch(Stub(), batch_size=4096).search(queries, corpus, k=100)
    assert got == SparseSearch(Stub(), batch_size=4096, device="cpu").search(queries, corpus, k=100)


@pytest.mark.cuda
def test_retrieval_server_on_card_answers_as_cpu(cuda):
    """A ``RetrievalServer`` over a small hybrid engine on the card (its
    pipelined ``score_batch_async`` route, the batch thread launching the
    kernels) answers 48 pipelined requests as the CPU engine scores them,
    and a staged swap to a filtered index on the card answers as the CPU
    engine over that index."""
    import json
    import socket

    from improving_learned_index_tpu_torch.serve import RetrievalServer

    rng = np.random.default_rng(5)
    # Zipf terms: the 15 commonest become dense rows, the rest the tail
    p = 1.0 / np.arange(1, 201)
    docs = [(d, {f"t{t}": int(rng.integers(1, 256))
                 for t in rng.choice(200, rng.integers(1, 9), replace=False, p=p / p.sum())})
            for d in range(5_000)]
    idx = InvertedIndexData.build(iter(docs), num_docs=len(docs))
    filtered = idx.delete_docs(range(0, len(docs), 7))
    queries = [sorted(f"t{t}" for t in rng.choice(200, 3, replace=False)) for _ in range(48)]

    def ask(srv):
        with socket.create_connection(("127.0.0.1", srv.port), timeout=30) as sock:
            f = sock.makefile("rb")
            sock.sendall(b"".join(json.dumps({"id": i, "terms": q, "k": 50}).encode() + b"\n"
                                  for i, q in enumerate(queries)))
            got = {r["id"]: r["results"] for r in (json.loads(f.readline()) for _ in queries)}
        return [got[i] for i in range(len(queries))]

    def want(index):
        rows = HybridSearchEngine(index, heavy_min=256, device="cpu").score_batch([set(q) for q in queries], 50)
        return [[[int(d), float(s)] for d, s in r] for r in rows]

    g0, s0, c0 = gr.KERNEL.launches, ss.KERNEL.launches, tks.KERNEL.launches
    srv = RetrievalServer(HybridSearchEngine(idx, heavy_min=256, device="cuda"), top_k=50, max_batch=16,
                          max_wait_ms=1.0)
    assert srv.engine.t_heavy > 0 and srv.engine.doc_ids.numel() > 0
    srv.start()
    try:
        assert ask(srv) == want(idx)
        srv.swap_engine_staged(lambda: HybridSearchEngine(filtered, heavy_min=256, device="cuda"))
        assert ask(srv) == want(filtered)
    finally:
        srv.stop()
    assert gr.KERNEL.launches > g0 and ss.KERNEL.launches > s0 and tks.KERNEL.launches > c0


def _zipf_index(num_docs, n_terms=200, seed=5):
    """Zipf terms, 1-8 a doc (ROADMAP trap k: the commonest lists become
    dense rows, the rest stay tail, so both scoring kernels launch)."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, n_terms + 1)
    docs = [(d, {f"t{t}": int(rng.integers(1, 256))
                 for t in rng.choice(n_terms, rng.integers(1, min(9, n_terms + 1)), replace=False,
                                     p=p / p.sum())})
            for d in range(num_docs)]
    return InvertedIndexData.build(iter(docs), num_docs=num_docs), rng


@pytest.mark.cuda
def test_sharded_engine_on_card_equals_hybrid(cuda):
    """Four shards on one card: the single hybrid engine's ranked lists,
    ``plain_versions()``' and the CPU shards'; each shard launches the
    heavy and the tail kernel once a batch, and its top-k's histogram."""
    from improving_learned_index_tpu_torch.search import ShardedSearchEngine

    idx, rng = _zipf_index(20_000)
    batch = [{f"t{t}" for t in rng.choice(200, 4, replace=False)} for _ in range(60)]
    batch += [set(), {"t0"}, {"t150"}, {"t1", "zz"}, {"zz"}]
    want = HybridSearchEngine(idx, heavy_min=256, device="cuda").score_batch(batch, 100)
    eng = ShardedSearchEngine(idx, ["cuda:0"] * 4, heavy_min=256)
    assert eng.t_heavy > 0 and all(s.doc_ids.numel() > 0 for s in eng.shards)
    g0, s0 = gr.KERNEL.launches, ss.KERNEL.launches
    h0, c0 = tks.KERNEL.calls.get("ili_topk_histogram", 0), COUNT_KERNEL.launches
    got = eng.score_batch(batch, 100)
    assert gr.KERNEL.launches - g0 == 4 and ss.KERNEL.launches - s0 == 4
    assert tks.KERNEL.calls["ili_topk_histogram"] - h0 == 4 and COUNT_KERNEL.launches == c0
    assert got == want
    with plain_versions():
        assert got == ShardedSearchEngine(idx, ["cuda:0"] * 4, heavy_min=256).score_batch(batch, 100)
    assert got == ShardedSearchEngine(idx, ["cpu"] * 4, heavy_min=256).score_batch(batch, 100)
    assert list(eng.score_stream([batch, batch[:7]], top_k=100)) == [got, got[:7]]


@pytest.mark.cuda
def test_sharded_engine_on_card_with_empty_shards(cuda):
    """Ten docs over four shards: every doc in shard 0, three empty."""
    from improving_learned_index_tpu_torch.search import ShardedSearchEngine

    idx, _ = _zipf_index(10, n_terms=6, seed=2)
    batch = [{"t0", "t1"}, {"t2", "t5"}, {"t4"}, {"zz"}]
    for heavy_min in (3, 10**9):  # the empty shards: all-zero dense rows, then no inputs at all
        eng = ShardedSearchEngine(idx, ["cuda:0"] * 4, heavy_min=heavy_min)
        assert eng.shard_docs == 128 and [s.doc_ids.numel() for s in eng.shards[1:]] == [0] * 3
        got = eng.score_batch(batch, 7)
        assert any(got) and got == HybridSearchEngine(idx, heavy_min=3, device="cpu").score_batch(batch, 7)


@pytest.mark.cuda
def test_data_parallel_encode_on_card_equals_single(cuda):
    """``DeepImpact(devices=["cuda:0"] * 2)`` against the single-device
    route on the same weights (S=128, the kernel route): identical term
    lists, impacts within the encode rule, ``short_attention`` launched
    once a layer for each part."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    rng = np.random.default_rng(7)
    words = [f"w{i}" for i in range(300)]
    docs = [" ".join(rng.choice(words, rng.integers(3, 60))) for _ in range(40)]
    vocab = WordPieceVocab.build(docs, max_size=512)
    tok = ImpactTokenizer(vocab, max_length=128)
    cfg = EncoderConfig.tiny(vocab_size=len(vocab))
    single = DeepImpact(cfg, tok, seed=0, device="cuda")
    two = DeepImpact(cfg, tok, seed=0, devices=["cuda:0"] * 2)
    encs = [tok.process_document(d) for d in docs]
    a0 = sa.KERNEL.launches
    got, terms = two.encode_term_scores(encs)
    assert sa.KERNEL.launches - a0 == cfg.num_layers * 2
    want, want_terms = single.encode_term_scores(encs)
    assert terms == want_terms
    valid = np.arange(got.shape[1])[None, :] < np.array([len(t) for t in terms])[:, None]
    _impacts_close(got[valid], want[valid])
    packed = two.get_impact_scores_batch_packed(docs, rows=8)
    packed_one = single.get_impact_scores_batch_packed(docs, rows=8)
    assert [[t for t, _ in d] for d in packed] == [[t for t, _ in d] for d in packed_one]
    _impacts_close([v for d in packed for _, v in d], [v for d in packed_one for _, v in d])


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [["cuda:0", "cpu"], ["cpu", "cuda:0"]])
def test_data_parallel_encode_across_card_and_cpu_equals_single(cuda, devices):
    """``DeepImpact`` over the card and the CPU (one fp32 model, 2 heads of
    64, S=128): a real replica on the second device, each part launched
    with its own device current (the card's part through the kernel, one
    launch a layer), the parts gathered on ``devices[0]``; term lists
    identical to the one-module routes, impacts within the encode rule of
    the card's route and of the CPU's."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    rng = np.random.default_rng(9)
    words = [f"w{i}x" for i in range(80)]
    docs = [" ".join(rng.choice(words, int(rng.integers(3, 60)))) for _ in range(24)]
    tok = ImpactTokenizer(WordPieceVocab.build(docs, max_size=200), max_length=128)
    config = EncoderConfig(vocab_size=len(tok.vocab), hidden_size=128, num_layers=2, num_heads=2,
                           intermediate_size=256, max_position_embeddings=128, dtype="float32")
    card = DeepImpact(config, tok, seed=0, device="cuda:0")
    weights = {k: v.cpu() for k, v in card.module.state_dict().items()}
    cpu = DeepImpact(config, tok, state_dict=weights, device="cpu")
    mixed = DeepImpact(config, tok, state_dict=weights, devices=devices)
    assert len(mixed._replicas) == 2 and mixed.device == torch.device(devices[0])
    encs = [tok.process_document(d) for d in docs]
    a0 = sa.KERNEL.launches
    got, terms = mixed.encode_term_scores(encs)
    assert sa.KERNEL.launches - a0 == config.num_layers
    valid = np.arange(got.shape[1])[None, :] < np.array([len(t) for t in terms])[:, None]
    for one in (card, cpu):
        want, want_terms = one.encode_term_scores(encs)
        assert terms == want_terms
        _impacts_close(got[valid], want[valid])
    packed = mixed.get_impact_scores_batch_packed(docs, rows=8)
    for one in (card, cpu):
        packed_one = one.get_impact_scores_batch_packed(docs, rows=8)
        assert [[t for t, _ in d] for d in packed] == [[t for t, _ in d] for d in packed_one]
        _impacts_close([v for d in packed for _, v in d], [v for d in packed_one for _, v in d])


@pytest.mark.cuda
@pytest.mark.parametrize("devices", [["cuda:0", "cpu"], ["cpu", "cuda:0"]])
def test_sharded_engine_across_card_and_cpu_equals_hybrid(cuda, devices):
    """Two shards, one on the card (its kernels) and one on the CPU (the
    plain versions), merged on ``devices[0]``: the single hybrid engine's
    ranked lists."""
    from improving_learned_index_tpu_torch.search import ShardedSearchEngine

    idx, rng = _zipf_index(20_000)
    batch = [{f"t{t}" for t in rng.choice(200, 4, replace=False)} for _ in range(40)]
    batch += [set(), {"t0"}, {"t150"}, {"zz"}]
    eng = ShardedSearchEngine(idx, devices, heavy_min=256)
    assert eng.t_heavy > 0 and [launches(s.dense) for s in eng.shards] == [d == "cuda:0" for d in devices]
    g0, s0 = gr.KERNEL.launches, ss.KERNEL.launches
    got = eng.score_batch(batch, 100)
    assert gr.KERNEL.launches - g0 == 1 and ss.KERNEL.launches - s0 == 1
    assert got == HybridSearchEngine(idx, heavy_min=256, device="cuda").score_batch(batch, 100)


@pytest.mark.cuda
def test_msgpack_model_on_card_equals_pt_route(cuda, tmp_path):
    """A JAX-format checkpoint (the flax tree of a seeded BERT-width
    2-layer model, written as the JAX ``CheckpointManager``'s payload)
    loads on the card to the same model as its ``.pt``: equal impacts at
    S=256 through the ``short_attention`` kernel."""
    from chip_smoke import port_params_to_flax
    from improving_learned_index_tpu_torch.core import flax_msgpack
    from improving_learned_index_tpu_torch.core.checkpoint import save_params
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import DeepImpact

    tok, _ = _train_batch(5, 8, 256)
    config = EncoderConfig(vocab_size=len(tok.vocab), num_layers=2, impact_activation="softplus")
    seeded = DeepImpact(config, tok, seed=3, device="cpu").module.state_dict()
    save_params(tmp_path / "m.pt", seeded)
    flax_msgpack.write(tmp_path / "m.msgpack", {"params": port_params_to_flax(seeded, config)})
    docs = [" ".join(f"w{(7 * i + j) % 400}x" for j in range(20 + 9 * i)) for i in range(24)]
    out = {}
    for name in ("m.pt", "m.msgpack"):
        model = DeepImpact.load(config, tok, tmp_path / name, device="cuda")
        before = sa.KERNEL.launches
        out[name] = model.get_impact_scores_batch(docs)
        torch.cuda.synchronize()
        assert sa.KERNEL.launches - before == config.num_layers
    assert out["m.pt"] == out["m.msgpack"]
    assert sum(len(d) for d in out["m.pt"]) > 0


@pytest.mark.cuda
def test_async_snapshot_of_card_state(cuda, tmp_path):
    """The snapshot holds the card state at ``on_step``: an in-place update
    queued right after it (as the next optimizer step is) does not reach
    the file."""
    from improving_learned_index_tpu_torch.core.async_checkpoint import AsyncCheckpointManager

    mgr = AsyncCheckpointManager(tmp_path, name="M", save_every=1)
    w = torch.randn(4096, 1024, device="cuda", generator=cuda)
    want = w.cpu().clone()
    opt = {"state": {0: {"step": torch.tensor(1.0), "exp_avg": w * 2}}, "param_groups": [{"lr": 0.1}]}
    for _ in range(2):
        mgr.on_step({"w": w}, opt)
        w.mul_(3.0).add_(1.0)
        opt["state"][0]["exp_avg"].zero_()
    mgr.wait()
    first = torch.load(tmp_path / "M_1.pt", weights_only=True)
    assert torch.equal(first["params"]["w"], want)
    assert torch.equal(first["opt_state"]["state"][0]["exp_avg"], want * 2)
    second = torch.load(tmp_path / "M_2.pt", weights_only=True)
    assert torch.equal(second["params"]["w"], (want.cuda() * 3.0 + 1.0).cpu())


FLASH_CASES = [
    # B, H, Hkv, S, D, causal, segments, dtype
    (2, 4, 4, 256, 64, False, "padded", torch.bfloat16),
    (2, 4, 2, 256, 128, True, "padded", torch.bfloat16),
    (1, 4, 4, 384, 128, True, "packed", torch.float32),
    (2, 2, 1, 128, 64, False, None, torch.bfloat16),
    (3, 12, 12, 512, 64, False, "packed", torch.bfloat16),
    (1, 8, 8, 1024, 128, True, "padded", torch.bfloat16),
    # segments of 128 keys: whole key tiles disjoint, dropped
    (2, 4, 4, 512, 64, False, "tiles", torch.bfloat16),
    (1, 4, 4, 512, 128, True, "tiles", torch.bfloat16),
    # one segment only: every tile below the diagonal unmasked
    (2, 4, 4, 384, 64, True, "one", torch.bfloat16),
    (2, 4, 4, 256, 128, False, "one", torch.bfloat16),
    # ids not sorted within a row (padding in the middle, ids 1 and 65
    # equal modulo 64): a [least, largest] range test would keep tiles
    (2, 4, 4, 512, 64, False, "unsorted", torch.bfloat16),
    (2, 4, 2, 512, 128, True, "unsorted", torch.bfloat16),
    # kv heads shared by 3 query heads, both head dims
    (2, 6, 2, 384, 64, True, "padded", torch.bfloat16),
    (1, 6, 2, 256, 128, False, "packed", torch.bfloat16),
    # fp32 output at S = 128, one tile
    (2, 2, 2, 128, 128, True, "padded", torch.float32),
    # seg_kv another tensor than seg_q: every tile computed; its rows whose
    # keys are all forbidden take the library's uniform average
    (2, 4, 4, 256, 64, False, "distinct", torch.bfloat16),
    (1, 4, 2, 384, 128, True, "distinct", torch.bfloat16),
    # more than 4 blocks an SM: a block walks 2-4 heads (the last group of
    # 7 heads shorter), the next head's loads beside the last one's stores
    (72, 8, 4, 512, 64, True, "unsorted", torch.bfloat16),
    (48, 7, 7, 512, 64, False, "packed", torch.bfloat16),
    (64, 7, 7, 384, 128, True, "padded", torch.bfloat16),
    # past the first 256 tiles of 64 rows, which alone are summarised
    (1, 2, 1, 16512, 64, True, "tiles", torch.bfloat16),
]


def _flash_inputs(g, b, h, hkv, s, d, segments, dtype):
    q, do = (torch.randn(b, h, s, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    k, v = (torch.randn(b, hkv, s, d, generator=g, device="cuda").to(dtype) for _ in range(2))
    seg = None
    if segments == "padded":
        seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
        seg[0, s - s // 5:] = 0
    elif segments in ("packed", "distinct"):
        seg = (torch.arange(s, device="cuda")[None].expand(b, s) // 100 + 1).int().contiguous()
        seg[:, -30:] = 0
    elif segments == "tiles":
        seg = (torch.arange(s, device="cuda")[None].expand(b, s) // 128 + 1).int().contiguous()
    elif segments == "one":
        seg = torch.ones(b, s, dtype=torch.int32, device="cuda")
    elif segments == "unsorted":
        runs = [(65, 90), (3, 70), (0, 40), (1, 100), (2, 60), (65, 30)]
        row = torch.cat([torch.full((n,), i, dtype=torch.int32) for i, n in runs])
        row = torch.cat([row, torch.full((s - len(row),), 7, dtype=torch.int32)])
        seg = torch.stack([row.roll(77 * i) for i in range(b)]).to("cuda")
    return q, k, v, do, seg


def _seg_kv(seg, segments):
    # the same values in another tensor, shifted so some rows allow no key
    return seg.roll(37, dims=1).contiguous() if segments == "distinct" else seg


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_kernels_equal_twin(cuda, case):
    b, h, hkv, s, d, causal, segments, dtype = case
    q, k, v, do, seg = _flash_inputs(cuda, b, h, hkv, s, d, segments, dtype)
    seg_kv = _seg_kv(seg, segments)
    scale = d ** -0.5
    before = dict(fa.KERNEL.calls)
    o, lse = fa.flash_attention_forward(q, k, v, seg, seg_kv, causal, scale)
    o2, lse2 = fa.flash_attention_plain(q, k, v, seg, seg_kv, causal, scale)
    assert o.dtype == dtype and o.shape == (b, h, s, d)
    assert (o.float() - o2.float()).abs().max() <= 1e-2 * o2.float().abs().max()
    assert (lse - lse2).abs().max() <= 1e-4
    got = fa.flash_attention_backward(q, k, v, seg, seg_kv, o2, lse2, do, causal, scale)
    want = fa.flash_attention_plain_bwd(q, k, v, seg, seg_kv, o2, lse2, do, causal, scale)
    again = fa.flash_attention_backward(q, k, v, seg, seg_kv, o2, lse2, do, causal, scale)
    for a, w, a2 in zip(got, want, again):
        assert a.dtype == w.dtype and a.shape == w.shape
        assert torch.isfinite(a).all()
        assert (a.float() - w.float()).abs().max() <= 1e-2 * w.float().abs().max()
        # dq's fp32 sums are atomic adds, in another order each run
        assert (a.float() - a2.float()).abs().max() <= 1e-2 * w.float().abs().max()
    for fn, n in (("ili_flash_fwd", 1), ("ili_flash_bwd_prep", 2), ("ili_flash_bwd", 2)):
        assert fa.KERNEL.calls[fn] == before.get(fn, 0) + n
    # the tile pairs the kernels computed, by their own count: the tile
    # rule's where tiles are dropped (one segment tensor), else every one
    fwd_tiles, bwd_tiles = fa.computed_tile_pairs(q, k, v, seg, seg_kv, causal, scale)
    if seg_kv is seg:
        want_tiles = h * int(fa.tile_pairs(seg, seg, causal, s, batch=b)[0].sum())
    else:
        want_tiles = b * h * (s // fa.TILE_Q) * (s // fa.TILE_K)
    assert fwd_tiles == bwd_tiles == want_tiles


@pytest.mark.cuda
def test_flash_autograd_launches_kernels_and_refuses_other_shapes(cuda):
    q, k, v, do, seg = _flash_inputs(cuda, 1, 2, 2, 256, 64, "padded", torch.bfloat16)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    before = fa.KERNEL.launches
    out = fa.flash_attention(*leaves, seg, seg, causal=True, sm_scale=0.125)
    out.backward(do)
    assert fa.KERNEL.launches == before + 3
    ref = [t.detach().requires_grad_() for t in (q, k, v)]
    with plain_versions():
        fa.flash_attention(*ref, seg, seg, causal=True, sm_scale=0.125).backward(do)
    assert fa.KERNEL.launches == before + 3
    for a, w in zip(leaves, ref):
        assert (a.grad.float() - w.grad.float()).abs().max() <= 1e-2 * w.grad.float().abs().max()
    with pytest.raises(ValueError, match="multiple of 128"):
        fa.flash_attention(q[:, :, :200], k[:, :, :200], v[:, :, :200], causal=True)
    with pytest.raises(ValueError, match="D in"):
        fa.flash_attention(q[..., :32], k[..., :32], v[..., :32])



@pytest.mark.cuda
@pytest.mark.parametrize("seq,maps,route", [(512, False, "flash"), (256, False, "short"), (512, True, "plain")])
def test_encoder_route_on_the_card(cuda, seq, maps, route):
    """An XLM-R-geometry trunk (two layers, 12 heads of 64, bf16) on packed
    rows: at S=512 its default route launches ``ili_flash_fwd`` once a
    layer, at S=256 the short-attention kernel, and with attention maps
    neither; the hidden state within 2e-2 of the largest entry of the
    ``plain_versions()`` route's (bf16 states, probabilities rounded to
    bf16 against another running maximum in each kernel)."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models.encoder import TransformerEncoder, attention_route, init_weights

    config = EncoderConfig.xlmr_base(vocab_size=1000, num_layers=2)
    assert attention_route(config, seq, torch.device("cuda"), output_attentions=maps) == route
    trunk = TransformerEncoder(config)
    init_weights(trunk, torch.Generator().manual_seed(0))
    trunk = trunk.cuda().eval()
    seg = torch.zeros(4, seq, dtype=torch.int32)
    seg[0, :seq // 3], seg[0, seq // 3:seq - 40] = 1, 2
    seg[1, :], seg[2, :200] = 1, 1
    seg[3, :7], seg[3, 7:90], seg[3, 90:seq - 9] = 1, 2, 3
    ids = torch.randint(4, 1000, seg.shape, generator=torch.Generator().manual_seed(1))
    ids[seg == 0] = config.pad_token_id
    ids, seg = ids.cuda(), seg.cuda()
    counters = {"flash": fa.KERNEL, "short": sa.KERNEL}
    before = {name: k.launches for name, k in counters.items()}
    with torch.no_grad():
        got = trunk(ids, (seg > 0).int(), segment_ids=seg, output_attentions=maps)
        with plain_versions():
            want = trunk(ids, (seg > 0).int(), segment_ids=seg, output_attentions=maps)
    if maps:
        got, want = got[0], want[0]
    launched = {name: k.launches - before[name] for name, k in counters.items()}
    assert launched == {name: config.num_layers * (name == route) for name in counters}
    real = seg > 0
    assert (got[real] - want[real]).abs().max() <= 2e-2 * want[real].abs().max()


# (token rows, hidden width): the BERT cell's [512, 256] and the XLM-R cell's
# [64, 512] batches, XLM-R-large's width, and a T that no block's rows divide
_EPILOGUE_SHAPES = [(512 * 256, 768), (64 * 512, 768), (4096, 1024), (37, 768), (1001, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,width", _EPILOGUE_SHAPES)
def test_encoder_epilogue_kernels_equal_twins(cuda, rows, width):
    """Each ``encoder_epilogue`` kernel against its twin (the former
    PyTorch ops, on the card) within 1 bf16 ulp of each output: the same
    roundings in the same places.  The LayerNorm's fp32 sums run in another
    order, so its outputs are held within 1 bf16 ulp plus what that order
    may move them by (``chip_smoke.layernorm_order_slack``).  One launch
    each, q, k and v in one."""
    from chip_smoke import bf16_ulps, layernorm_order_slack

    g, dev, bf = cuda, "cuda", torch.bfloat16

    def bf16(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g, device=dev) * scale).to(bf)

    def fp32(n, scale, shift=0.0):
        return torch.randn(n, generator=g, device=dev) * scale + shift

    calls = dict(epi.KERNEL.calls)
    ys, bs = [bf16(rows, width) for _ in range(3)], [fp32(width, 0.5) for _ in range(3)]
    want = [epi.bias_add_plain(y, b) for y, b in zip(ys, bs)]
    got = epi.bias_add(*(y.clone() for y in ys), *bs)
    h, hb = bf16(rows, 4 * width, scale=2.0), fp32(4 * width, 0.5)
    got_gelu, want_gelu = epi.bias_gelu(h, hb), epi.bias_gelu_plain(h, hb)
    h2, b2, x = bf16(rows, width), fp32(width, 0.5), bf16(rows, width, scale=4.0)
    w, nb = fp32(width, 0.2, 1.0), fp32(width, 0.2)
    got_ln = epi.bias_residual_layernorm(h2, b2, x, w, nb, 1e-12)
    want_ln = epi.bias_residual_layernorm_plain(h2, b2, x, w, nb, 1e-12)
    torch.cuda.synchronize()
    assert {k: epi.KERNEL.calls.get(k, 0) - calls.get(k, 0) for k in epi.KERNEL.functions} == {
        "ili_bias_add": 1, "ili_bias_gelu": 1, "ili_bias_residual_layernorm": 1}
    for a, b in [*zip(got, want), (got_gelu, want_gelu)]:
        assert a.dtype == bf and a.shape == b.shape
        assert float(bf16_ulps(a, b).max()) <= 1.0
    assert got_ln.dtype == bf and got_ln.shape == want_ln.shape
    assert bool((bf16_ulps(got_ln, want_ln) <= 1.0 + layernorm_order_slack(h2, b2, x, w, nb, 1e-12, want_ln)).all())


@pytest.mark.cuda
def test_encoder_epilogue_wrappers_refuse_what_the_kernels_cannot_take(cuda):
    dev = "cuda"
    y, b = torch.zeros(16, 768, dtype=torch.bfloat16, device=dev), torch.zeros(768, device=dev)
    w, nb = torch.ones(768, device=dev), torch.zeros(768, device=dev)
    with pytest.raises(ValueError, match="bf16"):
        epi.bias_gelu(y.float(), b)
    with pytest.raises(ValueError, match="bf16"):
        epi.bias_residual_layernorm(y.float(), b, y.float(), w, nb, 1e-5)
    with pytest.raises(ValueError, match="contiguous"):
        epi.bias_add(y, y, torch.zeros(16, 1536, dtype=torch.bfloat16, device=dev)[:, :768], b, b, b)
    with pytest.raises(ValueError, match="contiguous"):
        epi.bias_residual_layernorm(y, b, torch.zeros(768, 16, dtype=torch.bfloat16, device=dev).t(), w, nb, 1e-5)
    wide = torch.zeros(4, 1032, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="width 1032"):
        epi.bias_residual_layernorm(wide, torch.zeros(1032, device=dev), wide, torch.ones(1032, device=dev),
                                    torch.zeros(1032, device=dev), 1e-5)
    odd = torch.zeros(4, 100, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="multiple of 8"):
        epi.bias_gelu(odd, torch.zeros(100, device=dev))
    with pytest.raises(ValueError, match="no backward"):
        epi.bias_gelu(y, b.clone().requires_grad_())
    assert not epi.takes(1032, 4128) and not epi.takes(100, 400)


@pytest.mark.cuda
@pytest.mark.parametrize("family,seq", [("bert", 128), ("xlmr", 512)])
def test_encoder_epilogue_engages_on_every_inference_forward(cuda, family, seq):
    """BERT-base and XLM-R-base geometry (12 layers): one forward under
    ``inference_mode`` and one under ``no_grad`` launch 12 x (1 + 2 + 1)
    kernels, one ``ili_bias_add``, two ``ili_bias_residual_layernorm`` and
    one ``ili_linear_gelu`` a layer, and no ``ili_bias_gelu`` (the FFN's bias
    and GELU run inside ``linear_gelu``); a forward under autograd launches
    none, and its output equals the ``no_grad`` forward's on the twins."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import encoder as enc
    config = (EncoderConfig.bert_base if family == "bert" else EncoderConfig.xlmr_base)(vocab_size=1000)
    model = enc.DeepImpactModel(config)
    enc.init_weights(model, torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    ids = torch.randint(4, 1000, (2, seq), generator=cuda, device="cuda")
    mask = torch.ones_like(ids, dtype=torch.int32)
    mask[1, seq // 2:] = 0
    per_layer = {"ili_bias_add": 1, "ili_bias_gelu": 0, "ili_bias_residual_layernorm": 2, "ili_linear_gelu": 1}

    def launched(run):
        before = {**epi.KERNEL.calls, **lg.KERNEL.calls}
        out = run()
        torch.cuda.synchronize()
        after = {**epi.KERNEL.calls, **lg.KERNEL.calls}
        return out, {k: after.get(k, 0) - before.get(k, 0) for k in per_layer}

    for mode in (torch.inference_mode, torch.no_grad):
        with mode():
            _, counts = launched(lambda: model(ids, mask))
        assert counts == {k: config.num_layers * n for k, n in per_layer.items()}
    out, counts = launched(lambda: model(ids, mask))
    assert out.requires_grad and counts == dict.fromkeys(per_layer, 0)
    with torch.no_grad(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(enc, "epilogue_route", lambda *a: False)
        twin, counts = launched(lambda: model(ids, mask))
    assert counts == dict.fromkeys(per_layer, 0) and torch.equal(out.detach(), twin)


@pytest.mark.cuda
@pytest.mark.parametrize("family,seq,limits", [("bert", 256, (0.5, 0.055)), ("xlmr", 512, (0.2, 0.025))])
def test_encode_packed_on_epilogue_kernels_within_the_cells_limits(cuda, family, seq, limits):
    """One ``DeepImpact.encode_packed`` batch at the cell's geometry and
    sequence length on the epilogue kernels against the same batch on their
    twins (``epilogue_route`` patched off): the widest and mean |impact gap|
    over the twin route's mean impact within the cell's limits
    (``impact_gap_max``, ``impact_gap_mean``).  Weights as the benchmark
    draws them: matrices and embeddings N(0, 0.02), BERT's initialization,
    and the head calibrated to unit spread and median 0 of its input's
    projection.  (At ``init_weights``' flax scales a random 12-layer trunk
    drives every token toward one vector, the calibration then magnifies
    the hidden state's last bits, and a LayerNorm computed in float64 alone
    moves the impacts past both limits on the CPU.)"""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.models import encoder as enc
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
    from improving_learned_index_tpu_torch.text.packing import pack_documents

    rng = np.random.default_rng(3)
    words = [f"w{i}q" for i in range(2000)]
    docs = [" ".join(rng.choice(words, int(rng.integers(20, 400)))) for _ in range(96)]
    tok = ImpactTokenizer(WordPieceVocab.build(docs, max_size=4000), max_length=seq)
    config = (EncoderConfig.bert_base if family == "bert" else EncoderConfig.xlmr_base)(vocab_size=len(tok.vocab))
    model = DeepImpact(config, tok, seed=0, device="cuda")
    batch = next(iter(pack_documents([tok.process_document(d) for d in docs], seq, 16)))
    head = model.module.impact_head.dense
    with torch.no_grad():
        for p in model.module.parameters():
            if p.dim() == 2:
                p.normal_(0.0, 0.02, generator=cuda)
        seg = torch.as_tensor(batch.segment_ids, device="cuda")
        hidden = model.module.encoder(torch.as_tensor(batch.input_ids, device="cuda"), (seg > 0).int(),
                                      torch.as_tensor(batch.type_ids, device="cuda"), segment_ids=seg)
        z = hidden[seg > 0] @ head.weight[0]
        scale, mid = float(z.std()), float(z.median())
        head.weight.div_(scale)
        head.bias.fill_(-mid / scale)
    before = epi.KERNEL.launches, lg.KERNEL.launches
    got = model.encode_packed(batch)
    assert (epi.KERNEL.launches - before[0], lg.KERNEL.launches - before[1]) == (3 * config.num_layers,
                                                                               config.num_layers)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(enc, "epilogue_route", lambda *a: False)
        want = model.encode_packed(batch)
    gap = np.abs(got.astype(np.float64) - want) / np.mean(want)
    assert np.mean(want) > 0 and gap.max() <= limits[0] and gap.mean() <= limits[1], (gap.max(), gap.mean())


# (token rows, K, N): the XLM-R cell's [64 x 512] and the BERT cell's
# [512 x 256] batches at the FFN's 768 into 3,072, T that no 128-row tile
# divides, and XLM-R-large's 1,024 into 4,096 (no multiple of the 192-wide
# tile: a ragged last column tile)
_LINEAR_GELU_SHAPES = [(64 * 512, 768, 3072), (512 * 256, 768, 3072), (1, 768, 3072), (37, 768, 3072),
                       (1000, 1024, 4096), (32845, 1024, 4096)]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,k,n", _LINEAR_GELU_SHAPES)
def test_linear_gelu_kernel_equals_twin(cuda, rows, k, n):
    """``linear_gelu``'s kernel against its twin (``F.linear`` and
    ``bias_gelu_plain``, on the card): the two sum the product over K in
    other orders, so every output must equal the twin's bias and GELU of
    the library's bf16 product or of one of its two bf16 neighbours
    (``chip_smoke.linear_gelu_check``, which raises otherwise); the share
    of outputs off the twin's and their widest gap in bf16 ulps are
    printed.  One launch."""
    from chip_smoke import linear_gelu_check

    g, dev = cuda, "cuda"
    x = torch.randn(rows, k, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    b = torch.randn(n, generator=g, device=dev) * 0.1
    before = lg.KERNEL.launches
    out = linear_gelu_check(x, w, b)
    torch.cuda.synchronize()
    assert lg.KERNEL.launches - before == 1 and out["outside"] == 0
    print(f"linear_gelu [{rows}, {k}] x [{k}, {n}]: {out}")


@pytest.mark.cuda
def test_linear_gelu_every_bf16_input(cuda):
    """The kernel's bias and GELU at every finite bf16 value equal
    ``ili_bias_gelu``'s (``chip_smoke.linear_gelu_every_input``)."""
    from chip_smoke import linear_gelu_every_input

    out = linear_gelu_every_input()
    assert out["off_ili_bias_gelu"] == 0 and out["values"] == 65280, out


@pytest.mark.cuda
def test_linear_gelu_wrapper_refuses_what_the_kernel_cannot_take(cuda):
    dev, bf = "cuda", torch.bfloat16
    x, w, b = torch.zeros(16, 768, dtype=bf, device=dev), torch.zeros(3072, 768, dtype=bf, device=dev), \
        torch.zeros(3072, device=dev)
    with pytest.raises(ValueError, match="bfloat16"):
        lg.linear_gelu(x.float(), w, b)
    with pytest.raises(ValueError, match="float32"):
        lg.linear_gelu(x, w, b.to(bf))
    with pytest.raises(ValueError, match="contiguous"):
        lg.linear_gelu(torch.zeros(16, 1536, dtype=bf, device=dev)[:, :768], w, b)
    with pytest.raises(ValueError, match="K % 64"):
        lg.linear_gelu(x[:, :96].contiguous(), w[:, :96].contiguous(), b)
    with pytest.raises(ValueError, match="no backward"):
        lg.linear_gelu(x, w, b.clone().requires_grad_())
    assert lg.linear_gelu(x[:0], w, b).shape == (0, 3072)


@pytest.mark.cuda
def test_llama_flash_forward_and_finetune_step_equal_twin_route(cuda):
    """A 2-layer Llama at head dim 128 (rep 2), bf16: the cache-less forward
    through the kernels against ``plain_versions()`` (logits within 0.1,
    bf16 rounding of the attention output moved by the kernel's order), and
    one layerwise int8-base fine-tune step's loss within 1% and adapter
    gradients' cosine >= 0.99."""
    import dataclasses

    from improving_learned_index_tpu_torch.expand.finetune import Doc2QueryFineTuner
    from improving_learned_index_tpu_torch.expand.lora import lora_leaves
    from improving_learned_index_tpu_torch.models import llama as tl

    cfg = dataclasses.replace(tl.LlamaConfig.tiny(vocab_size=300), hidden_size=512, num_heads=4,
                              num_kv_heads=2, intermediate_size=1024, use_flash_attention=True)
    params = tl.init_llama_params(cfg, seed=0, device="cuda")
    ids = torch.randint(4, 300, (2, 256), generator=cuda, device="cuda")
    mask = torch.ones_like(ids)
    mask[0, 200:] = 0
    model = tl.LlamaModel(cfg, device="meta")
    before = fa.KERNEL.calls.get("ili_flash_fwd", 0)
    a, _ = model(ids, mask, params=params)
    assert fa.KERNEL.calls["ili_flash_fwd"] == before + cfg.num_layers
    with plain_versions():
        b, _ = model(ids, mask, params=params)
    assert (a[0, :200] - b[0, :200]).abs().max() <= 0.1 and (a[1] - b[1]).abs().max() <= 0.1

    class Tok:
        def encode(self, t):
            return [1] + [4 + (ord(ch) % 290) for ch in t]

    pairs = [("a passage about flash attention kernels " * 5, "flash kernels"),
             ("another passage on the decoder " * 4, "decoder")]
    grads, losses = [], []
    for kernels in (True, False):
        ft = Doc2QueryFineTuner(params, cfg, Tok(), quantize_base="int8", layerwise=True, device="cuda")
        batch = ft._to_device(ft.make_batch(pairs))
        with nullcontext() if kernels else plain_versions():  # the checkpointed recompute too
            loss = ft.loss(batch)
            g = torch.autograd.grad(loss, lora_leaves(ft.lora))
        grads.append(torch.cat([x.flatten() for x in g]))
        losses.append(float(loss.detach()))
    assert abs(losses[0] - losses[1]) <= 0.01 * abs(losses[1])
    cos = torch.nn.functional.cosine_similarity(grads[0], grads[1], dim=0)
    assert cos >= 0.99, float(cos)


@pytest.mark.cuda
def test_t5_greedy_on_card_equals_cpu(cuda):
    """A tiny T5 in fp32 compute (gated, untied, as mT5): greedy tokens on the
    card equal the CPU's with fp32 and int8 trees, teacher-forced logits
    within 1e-4, the bucket function on card tensors equal to the CPU's
    over [-4096, 4096] both ways; the T5 route launches none of the port's
    kernels (its attention is plain torch, as the JAX package's is XLA)."""
    import dataclasses

    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand.t5_generate import T5Sampler
    from improving_learned_index_tpu_torch.models import t5 as tt5
    from improving_learned_index_tpu_torch.models.llama import tree_to
    from improving_learned_index_tpu_torch.models.quantization import quantize_params_int8

    rel = torch.arange(-4096, 4097)
    for bidirectional in (True, False):
        assert torch.equal(tt5.relative_position_bucket(rel.cuda(), bidirectional, 32, 128).cpu(),
                           tt5.relative_position_bucket(rel, bidirectional, 32, 128))
    cfg = dataclasses.replace(tt5.T5Config.tiny(vocab_size=300), dtype="float32")
    params = tt5.init_t5_params(cfg, seed=0)
    rng = np.random.default_rng(0)
    ids = rng.integers(3, 300, (3, 11)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    dec = torch.as_tensor(rng.integers(3, 300, (3, 6)))
    dec[:, 0] = 0
    model = tt5.T5Model(cfg, device="meta")
    with torch.no_grad():
        cpu = model(torch.as_tensor(ids).long(), torch.as_tensor(mask).long(), dec, params=params)
        card = model(torch.as_tensor(ids).long().cuda(), torch.as_tensor(mask).long().cuda(), dec.cuda(),
                     params=tree_to(params, "cuda"))
    assert (card.cpu() - cpu).abs().max() <= 1e-4
    sampler = T5Sampler(cfg, GenerationConfig(max_new_tokens=8, do_sample=False))
    counters = (fa.KERNEL, sa.KERNEL, gr.KERNEL, ss.KERNEL, ps.KERNEL, COUNT_KERNEL, tks.KERNEL, epi.KERNEL)
    before = [k.launches for k in counters]
    for tree in (params, quantize_params_int8(params)):
        want = sampler.generate(tree, ids, mask, num_return_sequences=2)
        got = sampler.generate(tree_to(tree, "cuda"), ids, mask, num_return_sequences=2)
        np.testing.assert_array_equal(got, want)
    assert [k.launches for k in counters] == before
