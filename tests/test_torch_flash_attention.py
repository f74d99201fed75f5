"""``ops.flash_attention``'s twin against the JAX library's reference, and
the encoder's flash route, on the CPU.

The library's own references ``mha_reference`` and ``mha_reference_bwd``
(``jax/experimental/pallas/ops/tpu/flash_attention.py``) run on the CPU
(the Pallas TPU kernel has no interpret mode).  They compute in the inputs'
dtype, so the inputs are fp32 holding bf16 values: the twin's bf16 rounding
of q, k, v is then exact, and only its bf16 rounding of p (forward, dv) and
of ds (dq, dk) remains.  ``mha_reference_bwd`` takes ``sm_scale`` 1 only.
Tolerances: the output within 2e-3 of the largest |output| (~4 here),
each gradient within 1e-2 of its largest entry.

GQA (kv heads shared by 2 query heads) equals the twin on repeated kv
heads with the shared heads' gradients summed, to fp32 rounding (1e-6).

The kernels' tile rule (``tile_pairs``) never drops a tile pair that holds
an allowed (query, key) pair, over seeded segment ids, causal and not; at
``chip_smoke.py``'s two masks the twin with the dropped tiles' keys
excluded equals the full twin within 1e-6 relative.

The encoder's flash route (``use_flash_attention``, where short attention
does not apply) gives the plain route's outputs on the real tokens within
2e-3 (fp32 model; the twin rounds q, k, v, p to bf16) and stays finite on
padding; the JAX encoder takes its XLA route on the CPU, so the same holds
against it.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas.ops.tpu import flash_attention as lib

from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.models.encoder import DeepImpactModel as JaxModel
from improving_learned_index_tpu.models.encoder import init_params
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models import DeepImpactModel, flax_params_to_port
from improving_learned_index_tpu_torch.ops import flash_attention as fa

B, H, S, D = 2, 3, 256, 64


def _bf16_values(rng, shape):
    return np.asarray(jnp.asarray(rng.standard_normal(shape).astype(np.float32), jnp.bfloat16)
                      .astype(jnp.float32))


def _segments(kind):
    if kind is None:
        return None
    seg = np.ones((B, S), np.int32)
    if kind == "padded":
        seg[0, 200:] = 0
        seg[1, 230:] = 0
    else:  # packed: three documents and a padding tail
        seg[:, 100:] = 2
        seg[:, 180:] = 3
        seg[:, 240:] = 0
    return seg


@pytest.fixture(scope="module")
def qkv():
    rng = np.random.default_rng(0)
    return [_bf16_values(rng, (B, H, S, D)) for _ in range(4)]


def test_mask_value_is_the_library_s():
    assert fa.DEFAULT_MASK_VALUE == lib.DEFAULT_MASK_VALUE


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("segments", [None, "padded", "packed"])
def test_twin_matches_library_reference(qkv, causal, segments):
    q, k, v, do = qkv
    seg = _segments(segments)
    sid = None if seg is None else lib.SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = np.asarray(lib.mha_reference(jq, jk, jv, None, sid, causal=causal, sm_scale=1.0))
    o, (_, _, _, _, _, o_ref, l, m) = lib._mha_reference_fwd(jq, jk, jv, None, sid, causal,
                                                               lib.DEFAULT_MASK_VALUE, 1.0, False)
    dq, dk, dv, _ = lib.mha_reference_bwd(jq, jk, jv, None, sid, o_ref, l, m, jnp.asarray(do), causal=causal)

    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    ts = None if seg is None else torch.tensor(seg)
    out = fa.flash_attention(tq, tk, tv, ts, ts, causal=causal, sm_scale=1.0)
    out.backward(torch.tensor(do))
    assert out.dtype == torch.float32 and np.isfinite(out.detach().numpy()).all()
    np.testing.assert_allclose(out.detach().numpy(), want, rtol=0, atol=2e-3 * np.abs(want).max())
    for got, ref in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=1e-2 * np.abs(ref).max())
    # the forward's log-sum-exp is the library's m + log(l)
    _, lse = fa.flash_attention_plain(tq, tk, tv, ts, ts, causal, 1.0)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(m + jnp.log(l)), rtol=0, atol=1e-4)


def test_gqa_equals_repeated_kv_heads():
    rng = np.random.default_rng(1)
    q, do = (torch.tensor(_bf16_values(rng, (B, 4, 128, D))) for _ in range(2))
    k, v = (torch.tensor(_bf16_values(rng, (B, 2, 128, D))) for _ in range(2))
    seg = torch.ones(B, 128, dtype=torch.int32)
    seg[1, 90:] = 0
    scale = D ** -0.5
    o, lse = fa.flash_attention_plain(q, k, v, seg, seg, True, scale)
    kr, vr = k.repeat_interleave(2, dim=1), v.repeat_interleave(2, dim=1)
    o2, lse2 = fa.flash_attention_plain(q, kr, vr, seg, seg, True, scale)
    assert torch.allclose(o, o2, atol=1e-6) and torch.allclose(lse, lse2, atol=1e-6)
    dq, dk, dv = fa.flash_attention_plain_bwd(q, k, v, seg, seg, o, lse, do, True, scale)
    dq2, dk2, dv2 = fa.flash_attention_plain_bwd(q, kr, vr, seg, seg, o2, lse2, do, True, scale)
    assert torch.allclose(dq, dq2, atol=1e-6)
    assert torch.allclose(dk, dk2.view(B, 2, 2, 128, D).sum(2), atol=1e-6)
    assert torch.allclose(dv, dv2.view(B, 2, 2, 128, D).sum(2), atol=1e-6)


def test_bf16_inputs_give_bf16_outputs_and_grads():
    rng = np.random.default_rng(2)
    q, k, v = (torch.tensor(_bf16_values(rng, (1, 2, 128, D))).bfloat16().requires_grad_() for _ in range(3))
    out = fa.flash_attention(q, k, v, causal=True, sm_scale=D ** -0.5)
    out.float().sum().backward()
    assert out.dtype == q.grad.dtype == k.grad.dtype == v.grad.dtype == torch.bfloat16


def test_kernel_shapes_checked():
    """The kernels take S a multiple of 128 and D in {64, 128}; mismatched
    k/v or segment ids are refused on every device."""
    with pytest.raises(ValueError, match="multiple of 128"):
        fa._shape(torch.empty(1, 2, 200, 64), torch.empty(1, 2, 200, 64))
    with pytest.raises(ValueError, match="D in"):
        fa._shape(torch.empty(1, 2, 256, 32), torch.empty(1, 2, 256, 32))
    with pytest.raises(ValueError, match="kv heads"):
        fa.flash_attention_forward(torch.empty(1, 3, 128, 64), torch.empty(1, 2, 128, 64),
                                   torch.empty(1, 2, 128, 64))
    with pytest.raises(ValueError, match="both segment ids"):
        fa.flash_attention_forward(torch.empty(1, 2, 128, 64), torch.empty(1, 2, 128, 64),
                                   torch.empty(1, 2, 128, 64), torch.ones(1, 128))


def _segment_ids(rng, kind, b, s):
    """Seeded segment ids: runs of random lengths and ids (negative ones and
    ones equal modulo 64 among them), per-position noise over 4 ids, one id
    with a few others sprinkled, or none."""
    if kind == "none":
        return None
    if kind == "noise":
        return torch.from_numpy(rng.integers(0, 4, (b, s)).astype(np.int32))
    if kind == "sparse":
        seg = np.full((b, s), 5, np.int32)
        seg[rng.random((b, s)) < 0.01] = 69
        return torch.from_numpy(seg)
    rows = []
    for _ in range(b):
        row = []
        while len(row) < s:
            row += [int(rng.integers(-3, 200))] * int(rng.integers(1, 200))
        rows.append(row[:s])
    return torch.tensor(rows, dtype=torch.int32)


def _tile_blocks(seg, causal, b, s):
    """The allowed pairs, [B, S/64, 64, S/128, 128]."""
    if seg is None:
        seg = torch.zeros(b, s, dtype=torch.int32)
    allowed = seg[:, :, None] == seg[:, None, :]
    if causal:
        allowed = allowed.tril()
    return allowed.view(b, s // 64, 64, s // 128, 128)


@pytest.mark.parametrize("s", [128, 384, 1024])
@pytest.mark.parametrize("kind", ["runs", "noise", "sparse", "none"])
@pytest.mark.parametrize("causal", [False, True])
def test_tile_rule_never_drops_an_allowed_pair(causal, kind, s):
    """Over seeded segment ids, every (64-row, 128-key) tile pair holding an
    allowed pair is kept, and every pair called full holds only allowed
    pairs: the kernels drop a tile, or skip its per-element mask, by this
    rule."""
    rng = np.random.default_rng([s, len(kind), causal])
    for _ in range(4):
        seg = _segment_ids(rng, kind, 3, s)
        may, full = fa.tile_pairs(seg, seg, causal, s, batch=3)
        blocks = _tile_blocks(seg, causal, 3, s)
        assert may.shape == full.shape == (3, s // 64, s // 128)
        assert not (blocks.any(4).any(2) & ~may).any()
        assert not (full & ~blocks.all(4).all(2)).any()


def test_tile_rule_keeps_every_tile_past_the_summarised(monkeypatch):
    """Tiles past the first ``SUMMARISED`` 64-row tiles are not summarised:
    kept (causal pairs aside), never full."""
    monkeypatch.setattr(fa, "SUMMARISED", 4)
    seg = _segment_ids(np.random.default_rng(5), "runs", 2, 1024)
    may, full = fa.tile_pairs(seg, seg, False, 1024)
    assert may[:, 4:].all() and may[:, :, 2:].all() and not full[:, 4:].any() and not full[:, :, 2:].any()
    causal_may, _ = fa.tile_pairs(seg, seg, True, 1024)
    assert not (_tile_blocks(seg, True, 2, 1024).any(4).any(2) & ~causal_may).any()


def test_tile_rule_summarises_as_many_tiles_as_the_kernels():
    """``SUMMARISED`` is the kernels' ``MAXT``, and their tiles ``TILE_Q`` by
    ``TILE_K``; the card tests hold the kernels' own count of the tiles they
    computed to ``tile_pairs`` past it.  The count is read on the card only."""
    src = fa.KERNEL.source.read_text()
    assert re.search(r"constexpr int MAXT = (\d+);", src).group(1) == str(fa.SUMMARISED)
    assert (fa.TILE_Q, fa.TILE_K) == (64, fa.BLOCK) == (64, 128)
    q = torch.zeros(1, 1, 128, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fa.computed_tile_pairs(q, q, q)


def test_tile_rule_is_applied_only_to_one_segment_tensor():
    """Tiles are dropped only where every row's own key is allowed: no
    segment ids, or one tensor for both sides."""
    seg = torch.ones(2, 256, dtype=torch.int32)
    assert fa._skip(None, None) == 1 and fa._skip(seg, seg) == 1
    assert fa._skip(seg, seg[:, :]) == 1
    assert fa._skip(seg, seg.clone()) == 0


@pytest.mark.parametrize("mask", ["decoder", "encoder"])
def test_twin_without_dropped_tiles_equals_full_twin(mask):
    """At ``chip_smoke.py``'s two masks (the 7B fine-tune's causal 2048 with a
    padded eighth, the encoder's packed 512: segments of 100 and 72 and 40
    of padding), the twin with the keys of every dropped tile excluded gives
    the full twin's output and log-sum-exp within 1e-6 relative: a dropped
    tile's p are exactly 0.  The share of tile pairs computed is the
    rule's: 216 of 512 and half."""
    rng = np.random.default_rng(7)
    if mask == "decoder":
        b, s, causal, share = 1, 2048, True, 216 / 512
        seg = torch.ones(b, s, dtype=torch.int32)
        seg[0, s - s // 8:] = 0
    else:
        b, s, causal, share = 8, 512, False, 0.5
        seg = (torch.arange(s)[None].expand(b, s) // 100 + 1).int().contiguous()
        seg[:, -40:] = 0
    q, k, v = (torch.tensor(_bf16_values(rng, (b, 2, s, 16))) for _ in range(3))
    scale = 0.25
    may, _ = fa.tile_pairs(seg, seg, causal, s)
    assert float(may.float().mean()) == share
    o, lse = fa.flash_attention_plain(q, k, v, seg, seg, causal, scale)
    keep = may.repeat_interleave(64, 1).repeat_interleave(128, 2)[:, None]
    logits = fa._logits(q, k, seg, seg, causal, scale).masked_fill(~keep, float("-inf"))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m)
    l = p.sum(-1, keepdim=True)
    o2 = torch.matmul(p.to(torch.bfloat16).float(), v) / l
    lse2 = (m + torch.log(l))[..., 0]
    assert (o2 - o).abs().max() <= 1e-6 * o.abs().max()
    assert (lse2 - lse).abs().max() <= 1e-6 * lse.abs().max()


ENC = dict(vocab_size=128, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
           max_position_embeddings=512, hidden_dropout=0.0, attention_dropout=0.0, dtype="float32")


@pytest.mark.parametrize("seq,short", [(384, True), (128, False)])
@pytest.mark.parametrize("packed", [False, True])
def test_encoder_flash_route_matches_plain_route(seq, short, packed):
    """S=384 (past short attention) and S=128 with short attention off: the
    flash route against the port's plain route and the JAX encoder (XLA on
    the CPU), on real tokens."""
    jc = JaxConfig(**ENC, use_short_attention=short, use_flash_attention=True)
    params = init_params(JaxModel(jc), jc, jax.random.PRNGKey(0))
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, params), EncoderConfig(**ENC))
    rng = np.random.default_rng(3)
    ids = rng.integers(2, 128, (2, seq)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, seq - 70:] = 0
    seg = None
    if packed:
        seg = np.ones_like(ids)
        seg[:, seq // 3:] = 2
        seg[0, seq - 70:] = 0
        mask = (seg > 0).astype(np.int32)
    ids[mask == 0] = 0
    outs = {}
    for flash in (False, True):
        tm = DeepImpactModel(EncoderConfig(**ENC, use_short_attention=short, use_flash_attention=flash))
        tm.load_state_dict(sd)
        with torch.no_grad():
            outs[flash] = tm(torch.from_numpy(ids), torch.from_numpy(mask),
                             segment_ids=None if seg is None else torch.from_numpy(seg))[..., 0].numpy()
    want = np.asarray(JaxModel(jc).apply({"params": params}, ids, mask, np.zeros_like(ids),
                                         segment_ids=seg))[..., 0]
    real = mask.astype(bool)
    assert np.isfinite(outs[True]).all()
    np.testing.assert_allclose(outs[True][real], outs[False][real], rtol=0, atol=2e-3)
    np.testing.assert_allclose(outs[True][real], want[real], rtol=0, atol=2e-3)


def test_encoder_flash_route_reaches_flash_attention(monkeypatch):
    """The route is taken (and short attention and the plain math are not)."""
    import improving_learned_index_tpu_torch.models.encoder as enc

    calls = []
    real = enc.flash_attention
    monkeypatch.setattr(enc, "flash_attention", lambda *a, **k: calls.append(a[0].shape) or real(*a, **k))
    monkeypatch.setattr(enc, "short_attention", lambda *a, **k: pytest.fail("short attention taken"))
    tm = DeepImpactModel(EncoderConfig(**ENC, use_flash_attention=True))
    ids = torch.randint(2, 128, (2, 384))
    with torch.no_grad():
        tm(ids, torch.ones_like(ids))
    assert calls == [(2, 4, 384, 16)] * 2
