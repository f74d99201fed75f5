"""The port's short attention (its plain version, on the CPU) against the JAX
package's Pallas kernel in interpret mode: both masks, fp32 and bf16 inputs,
and gradients against ``jax.vjp`` of the JAX ``custom_vjp``.

Tolerances: fp32 inputs are rounded to bf16 inside both (the kernel's
first step), so the two compute the same bf16 products; what differs is the
fp32 summation order, which can move a probability across a bf16 rounding
boundary (one bf16 ulp, 2^-8 relative, of one probability).  For bf16
outputs the bound is one output ulp.  The JAX backward recomputes through
``_reference_attention``, which rounds the logits to bf16; the port's
backward recomputes through the plain version (fp32 logits, the kernel's
math), so gradients agree to bf16 logit rounding, a few percent.
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
        assert np.abs(leaf.grad.numpy() - w).max() <= 0.05 * scale


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
