"""``ops.linear_gelu``'s plain version and the encoder's route to its kernel,
on the CPU.

The twin is the former pair moved into one entry: the bias-free product
(``F.linear``) and ``encoder_epilogue.bias_gelu_plain``.  It is held bit for
bit to that pair and to the encoder layer's former expression
(``F.gelu(F.linear(x, w) + b.to(bf16), approximate="none")``) at ragged token
counts and at the widths of BERT-base and XLM-R-base (768 into 3,072) and of
their large versions (1,024 into 4,096).  The layer's inference route sends
the FFN's first product to ``linear_gelu`` where the kernel takes the widths
and to ``encoder_epilogue.bias_gelu`` elsewhere, and a forward under
autograd takes neither.  The kernel itself is held to the twin on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import pytest
import torch
import torch.nn.functional as F

from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models import encoder as enc
from improving_learned_index_tpu_torch.ops import encoder_epilogue as epi
from improving_learned_index_tpu_torch.ops import linear_gelu as lg
from improving_learned_index_tpu_torch.ops import plain_versions

WIDTHS = [(768, 3072), (1024, 4096)]


def _operands(rows, k, n, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(rows, k, generator=g).to(torch.bfloat16)
    w = (torch.randn(n, k, generator=g) * 0.02).to(torch.bfloat16)
    b = torch.randn(n, generator=g) * 0.1
    return x, w, b


@pytest.mark.parametrize("rows", [1, 33, 1000])
@pytest.mark.parametrize("k,n", WIDTHS)
def test_linear_gelu_twin_equals_the_pair_and_the_former_expression(rows, k, n):
    x, w, b = _operands(rows, k, n, seed=rows + n)
    want = F.gelu(F.linear(x, w) + b.to(torch.bfloat16), approximate="none")
    pair = epi.bias_gelu_plain(F.linear(x, w), b)
    with plain_versions():
        switched = lg.linear_gelu(x, w, b)
    for got in (lg.linear_gelu_plain(x, w, b), lg.linear_gelu(x, w, b), switched, pair):
        assert got.dtype == torch.bfloat16 and got.shape == (rows, n) and torch.equal(got, want)


def test_linear_gelu_keeps_leading_dims_and_is_differentiable():
    """[B, S, K] inputs as the layer passes them; the twin is differentiable
    (the training route)."""
    x, w, b = _operands(2 * 5, 64, 192, seed=3)
    x = x.view(2, 5, 64).float().requires_grad_()
    out = lg.linear_gelu(x, w.float(), b)
    out.sum().backward()
    assert out.shape == (2, 5, 192) and x.grad.shape == x.shape and bool(x.grad.abs().sum() > 0)


@pytest.mark.parametrize("k,n,ok", [(768, 3072, True), (1024, 4096, True), (64, 192, True), (64, 200, True),
                                    (96, 3072, False), (768, 3004, False), (0, 192, False), (64, 0, False)])
def test_kernel_takes_widths(k, n, ok):
    assert lg.takes(k, n) is ok


def test_wrapper_refuses_other_devices():
    x = torch.zeros(4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="device"):
        lg.linear_gelu(x, torch.zeros(192, 64, dtype=torch.bfloat16, device="meta"), torch.zeros(192, device="meta"))


def _counting(monkeypatch):
    """Count the layer's calls of ``linear_gelu`` and of ``bias_gelu``."""
    calls = {"linear_gelu": 0, "bias_gelu": 0}

    def wrap(module, name):
        real = getattr(module, name)

        def counted(*a):
            calls[name] += 1
            return real(*a)
        monkeypatch.setattr(module, name, counted)

    wrap(lg, "linear_gelu")
    wrap(epi, "bias_gelu")
    return calls


@pytest.mark.parametrize("hidden,want", [(64, "linear_gelu"), (72, "bias_gelu")])
@pytest.mark.parametrize("grad", [False, True])
def test_inference_route_sends_the_ffn_product_where_the_widths_go(monkeypatch, hidden, want, grad):
    """``epilogue_route`` on (kernels launch on the device, here the CPU
    stands in): without grad each layer's FFN product goes to
    ``linear_gelu`` where it takes the widths (hidden 64) and to
    ``bias_gelu`` after a bias-free product where it does not (hidden 72, no
    multiple of the kernel's k-tile); under autograd the route is off and
    neither runs."""
    config = EncoderConfig(vocab_size=64, hidden_size=hidden, num_layers=2, num_heads=4, intermediate_size=256,
                           max_position_embeddings=128, dtype="bfloat16")
    model = enc.TransformerEncoder(config)
    enc.init_weights(model, torch.Generator().manual_seed(0))
    ids = torch.randint(2, 64, (2, 128), generator=torch.Generator().manual_seed(1))
    mask = torch.ones(2, 128, dtype=torch.int32)
    monkeypatch.setattr(enc, "launches", lambda device: True)
    calls = _counting(monkeypatch)
    with torch.set_grad_enabled(grad):
        model(ids, mask)
    expected = {"linear_gelu": 0, "bias_gelu": 0}
    if not grad:
        expected[want] = config.num_layers
    assert calls == expected
