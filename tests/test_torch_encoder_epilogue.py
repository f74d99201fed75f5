"""``ops.encoder_epilogue``'s plain versions and the encoder's route to its
kernels, on the CPU.

The twins are the encoder layer's former PyTorch expressions, moved: each is
held bit for bit to that expression, written out here as it stood in
``models/encoder.py`` (``F.linear(...) + bias.to(dt)``, ``norm((x +
attn).float()).to(dt)``, ``F.gelu(..., approximate="none")``), at BERT's and
XLM-R-large's widths and a ragged token count.  The route is a pure function
of what a forward can see; an ``EncoderLayer`` forward on the CPU, with and
without grad, equals the former layer's bit for bit, gradients included.
The kernels themselves are held to the twins on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import contextlib
import itertools

import pytest
import torch
import torch.nn.functional as F

from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models.encoder import EncoderLayer, epilogue_route, init_weights
from improving_learned_index_tpu_torch.ops import encoder_epilogue as epi
from improving_learned_index_tpu_torch.ops import plain_versions

T = 37  # token rows: not a multiple of any block's rows


def _bf16(*shape, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(*shape, generator=g) * scale).to(torch.bfloat16)


def _fp32(*shape, seed, scale=1.0, shift=0.0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(*shape, generator=g) * scale + shift


@pytest.mark.parametrize("width", [768, 1024])
def test_bias_add_twin_equals_former_expression(width):
    dt = torch.bfloat16
    ys = [_bf16(T, width, seed=s) for s in range(3)]
    bs = [_fp32(width, seed=10 + s, scale=0.1) for s in range(3)]
    want = [y + b.to(dt) for y, b in zip(ys, bs)]
    with plain_versions():
        switched = epi.bias_add(*ys, *bs)
    for got in ([epi.bias_add_plain(y, b) for y, b in zip(ys, bs)], epi.bias_add(*ys, *bs), switched):
        assert len(got) == 3
        for g, w in zip(got, want):
            assert g.dtype == dt and torch.equal(g, w)


@pytest.mark.parametrize("width", [768, 1024])
def test_bias_gelu_twin_equals_former_expression(width):
    h, b = _bf16(T, 4 * width, seed=1, scale=2.0), _fp32(4 * width, seed=2, scale=0.1)
    want = F.gelu(h + b.to(torch.bfloat16), approximate="none")
    for got in (epi.bias_gelu_plain(h, b), epi.bias_gelu(h, b)):
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)


@pytest.mark.parametrize("width", [768, 1024])
def test_bias_residual_layernorm_twin_equals_former_expression(width):
    dt = torch.bfloat16
    norm = torch.nn.LayerNorm(width, eps=1e-5)
    with torch.no_grad():
        norm.weight.copy_(_fp32(width, seed=3, scale=0.1, shift=1.0))
        norm.bias.copy_(_fp32(width, seed=4, scale=0.1))
    h, b, x = _bf16(T, width, seed=5), _fp32(width, seed=6, scale=0.1), _bf16(T, width, seed=7, scale=3.0)
    with torch.no_grad():
        want = norm((x + (h + b.to(dt))).float()).to(dt)
        for got in (epi.bias_residual_layernorm_plain(h, b, x, norm.weight, norm.bias, norm.eps),
                    epi.bias_residual_layernorm(h, b, x, norm.weight, norm.bias, norm.eps)):
            assert got.dtype == dt and torch.equal(got, want)


def test_twins_keep_leading_dims_and_gradients():
    """[B, S, H] products as the layer passes them; the twins are
    differentiable (the training route)."""
    h = _bf16(2, 5, 64, seed=8).float().requires_grad_()
    b = _fp32(64, seed=9).requires_grad_()
    out = epi.bias_add(h, h, h, b, b, b)
    sum(out).sum().backward()
    assert [t.shape for t in out] == [(2, 5, 64)] * 3
    assert torch.equal(h.grad, torch.full_like(h, 3.0)) and torch.equal(b.grad, torch.full((64,), 30.0))


_ROUTE_CASES = list(itertools.product(["cuda", "cpu"], [True, False], [False, True],
                                      [torch.bfloat16, torch.float32], [(768, 3072), (1024, 4096), (100, 400)]))


@pytest.mark.parametrize("device_type,kernels,grad,dtype,widths", _ROUTE_CASES)
def test_epilogue_route_is_cuda_kernels_no_grad_bf16_and_a_width_it_takes(device_type, kernels, grad, dtype,
                                                                          widths):
    """``kernels`` False: inside ``plain_versions()``."""
    want = device_type == "cuda" and kernels and not grad and dtype == torch.bfloat16 and widths[0] % 8 == 0
    with contextlib.nullcontext() if kernels else plain_versions():
        assert epilogue_route(torch.device(device_type), grad, dtype, *widths) is want


@pytest.mark.parametrize("hidden,intermediate,ok", [(768, 3072, True), (64, 128, True), (1024, 4096, True),
                                                     (1032, 4128, False), (768, 3076, False), (0, 8, False)])
def test_kernels_take_widths(hidden, intermediate, ok):
    assert epi.takes(hidden, intermediate) is ok


def test_wrappers_refuse_other_devices():
    y = torch.zeros(4, 8, dtype=torch.bfloat16, device="meta")
    b = torch.zeros(8, device="meta")
    with pytest.raises(ValueError, match="device"):
        epi.bias_gelu(y, b)
    with pytest.raises(ValueError, match="device"):
        epi.bias_add(y, y, y, b, b, b)
    with pytest.raises(ValueError, match="device"):
        epi.bias_residual_layernorm(y, b, y, b, b, 1e-5)


def _former_layer_forward(layer, x, mask):
    """``EncoderLayer.forward`` as it stood before the epilogue route, on
    the short-attention plain route (S=128)."""
    from improving_learned_index_tpu_torch.ops.short_attention import short_attention

    c = layer.config
    dt = torch.bfloat16 if c.dtype == "bfloat16" else torch.float32

    def linear(t, lin):
        return F.linear(t.to(dt), lin.weight.to(dt)) + lin.bias.to(dt)

    a = layer.attention
    b, s, hid = x.shape
    hd = hid // c.num_heads
    q, k, v = (linear(x, lin).view(b, s, c.num_heads, hd).permute(0, 2, 1, 3) for lin in (a.query, a.key, a.value))
    ctx = short_attention(q, k, v, mask, 1.0 / hd ** 0.5, False)
    attn = linear(ctx.permute(0, 2, 1, 3).reshape(b, s, hid), a.output_dense)
    x = layer.attention_norm((x + attn).float()).to(dt)
    h = F.gelu(linear(x, layer.intermediate), approximate="none")
    h = linear(h, layer.output)
    return layer.output_norm((x + h).float()).to(dt)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("grad", [False, True])
def test_encoder_layer_on_cpu_equals_former_layer(dtype, grad):
    config = EncoderConfig(vocab_size=64, hidden_size=64, num_layers=1, num_heads=4, intermediate_size=256,
                           max_position_embeddings=128, dtype=dtype)
    layer = EncoderLayer(config)
    init_weights(layer, torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in layer.parameters():  # biases and LayerNorm parameters away from 0 and 1
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())) * 0.05)
    dt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    x0 = _fp32(2, 128, 64, seed=11).to(dt)
    mask = torch.ones(2, 128, dtype=torch.int32)
    mask[1, 70:] = 0
    outs, grads = [], []
    for forward in (lambda x: layer(x, None, mask, False, "short", False)[0],
                    lambda x: _former_layer_forward(layer, x, mask)):
        layer.zero_grad()
        x = x0.float().requires_grad_() if grad else x0
        with torch.set_grad_enabled(grad):
            out = forward(x.to(dt))
        outs.append(out)
        if grad:
            out.float().square().sum().backward()
            grads.append([x.grad] + [p.grad.clone() for p in layer.parameters()])
    assert outs[0].dtype == dt and torch.equal(outs[0], outs[1])
    if grad:
        for a, b in zip(*grads):
            assert torch.equal(a, b)
