"""The port's short attention (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode: both masks, fp32 and bf16 inputs,
and gradients against ``jax.vjp`` of the JAX ``custom_vjp``.

Tolerances: fp32 inputs are rounded to bf16 inside both (the kernel's
first step), so the two compute the same bf16 products; what differs is the
fp32 summation order, which can move a probability across a bf16 rounding
boundary (one bf16 ulp, 2^-8 relative, of one probability).  For bf16
outputs the bound is one output ulp.  Both backwards recompute through
the XLA route's math (``_reference_attention`` and its copy
``reference_attention``: bf16 products with bf16-rounded logits and
probabilities), so gradients agree to a bf16 rounding that the fp32
summation order moves by one ulp: within 2^-6 of each gradient's largest
entry.  The encoder's plain route (``use_kernels=False``, every CPU run)
reaches the same backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import improving_learned_index_tpu.ops.short_attention as jsa
from improving_learned_index_tpu_torch.ops import short_attention as sa


@pytest.fixture(autouse=True)
def _interpret(monkeypatch):
    monkeypatch.setattr(jsa, "interpret", True)


def _inputs(seed, b=3, h=2, s=128, d=16):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, h, s, d)).astype(np.float32) * 1.5 for _ in range(3))
    pad = np.ones((b, s), np.int32)
    pad[1, 90:] = 0
    pad[2, 17:] = 0
    seg = np.zeros((b, s), np.int32)
    seg[0, :] = 1                                   # one segment, no padding
    seg[1, :40], seg[1, 40:100], seg[1, 100:120] = 1, 2, 3
    seg[2, :5], seg[2, 5:128] = 1, 2                 # a 5-token document
    return q, k, v, pad, seg


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_jax_kernel(packed, dtype):
    q, k, v, pad, seg = _inputs(0)
    mask = seg if packed else pad
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = np.asarray(
        jsa.short_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)), jnp.asarray(mask), 0.25, packed)
    ).astype(np.float32)
    got = sa.short_attention(*(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
                             torch.from_numpy(mask), 0.25, packed)
    assert got.dtype == tdt and got.shape == q.shape
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-3
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=tol)


def test_dispatch_and_plain_agree_on_cpu():
    """On CPU tensors the wrapper runs the plain version itself: equal, and
    no kernel launch is counted."""
    q, k, v, pad, _ = _inputs(1)
    t = [torch.from_numpy(x) for x in (q, k, v)]
    before = sa.KERNEL.launches
    got = sa.short_attention(*t, torch.from_numpy(pad), 0.25)
    assert torch.equal(got, sa.short_attention_plain(*t, torch.from_numpy(pad), 0.25))
    assert sa.KERNEL.launches == before


@pytest.mark.parametrize("packed", [False, True])
def test_gradients_match_jax_vjp(packed):
    q, k, v, pad, seg = _inputs(2)
    mask = seg if packed else pad
    g = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    _, vjp = jax.vjp(
        lambda a, b, c: jsa.short_attention(a, b, c, jnp.asarray(mask), 0.25, packed),
        *(jnp.asarray(x) for x in (q, k, v)),
    )
    want = [np.asarray(x) for x in vjp(jnp.asarray(g))]
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    sa.short_attention(*leaves, torch.from_numpy(mask), 0.25, packed).backward(torch.from_numpy(g))
    for leaf, w in zip(leaves, want):
        scale = np.abs(w).max()
        assert np.abs(leaf.grad.numpy() - w).max() <= 2.0 ** -6 * scale


@pytest.mark.parametrize("packed", [False, True])
def test_plain_route_reaches_the_same_backward(packed, monkeypatch):
    """``use_kernel=False`` (the encoder's plain route) runs the plain
    forward and the same ``reference_attention`` recompute as the default
    route: equal gradients, and the encoder's ``use_kernels=False`` layer
    calls it."""
    q, k, v, pad, seg = _inputs(4)
    mask = torch.from_numpy(seg if packed else pad)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(q.shape).astype(np.float32))
    grads = []
    for use_kernel in (True, False):
        leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        sa.short_attention(*leaves, mask, 0.25, packed, use_kernel=use_kernel).backward(g)
        grads.append([t.grad for t in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    sa.reference_attention(*leaves, mask, 0.25, packed).backward(g)
    for a, b in zip(grads[1], (t.grad for t in leaves)):
        assert torch.equal(a, b)

    from improving_learned_index_tpu_torch.core.config import EncoderConfig
    from improving_learned_index_tpu_torch.models import encoder

    seen = []
    real = encoder.short_attention
    monkeypatch.setattr(encoder, "short_attention",
                        lambda *a, **kw: seen.append(kw["use_kernel"]) or real(*a, **kw))
    model = encoder.DeepImpactModel(EncoderConfig.tiny(vocab_size=64))
    ids = torch.from_numpy(np.random.default_rng(6).integers(5, 64, (2, 128)).astype(np.int32))
    model(ids, torch.ones_like(ids), use_kernels=False)[..., 0].sum().backward()
    assert seen == [False, False]


def test_gate_matches_jax():
    """The JAX gate with its backend check out of the way (interpret mode)."""
    for s, d in ((128, 64), (256, 64), (256, 8), (384, 64), (192, 64), (128, 12), (64, 64)):
        assert sa.can_use_short_attention(s, d) == jsa.can_use_short_attention(s, d)


def test_cpu_wrapper_rejects_bad_shapes():
    q = torch.zeros(1, 2, 128, 16)
    with pytest.raises(ValueError, match="segment_mask"):
        sa.short_attention(q, q, q, torch.ones(1, 64, dtype=torch.int32), 0.25)
    with pytest.raises(ValueError, match="one shape"):
        sa.short_attention(q, q[:, :1], q, torch.ones(1, 128, dtype=torch.int32), 0.25)
