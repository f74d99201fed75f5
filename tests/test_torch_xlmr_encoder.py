"""The port's XLM-R DeepImpact (``models.factory.deep_impact_xlmr``)
against a plain float32 reference (``tests/reference/xlmr_deep_impact.py``,
torch only), on seeded weights at a small size on the CPU, and the
encoder's attention route.

The model is fp32 (``dtype="float32"``), and so is the reference; the
one rounding between them is the attention's.  At S=256 the route is
short attention and at S=512 flash attention, and the CPU versions of
both round q, k, v and p to bf16 as their kernels do: bf16's 2^-9 relative
rounding of logits of size ~4 moves probabilities by ~1e-2 relative,
which two layers and the Softplus head carry to the impacts (~2 here) as
gaps of up to 6.5e-3.  So each impact is held within 2e-2 of the
reference's, three times that.  Packed rows hold several documents, with
positions restarting and attention block-diagonal; a document's impacts
are those it has alone.

The route: ``short`` where ``short_attention`` takes the shape, ``flash``
where S % 128 == 0 and the kernel takes the head dim on CUDA (64 or 128;
the twin takes any elsewhere), ``plain`` when attention maps are asked
for or ``use_flash_attention`` is off.  ``tests/test_torch_kernels_cuda.py``
runs the route on the card.
"""

import contextlib
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models.encoder import TransformerEncoder, attention_route
from improving_learned_index_tpu_torch.models.factory import deep_impact_xlmr
from improving_learned_index_tpu_torch.models.hf_import import hf_deep_impact_to_port
from improving_learned_index_tpu_torch.ops import plain_versions

_spec = importlib.util.spec_from_file_location(
    "xlmr_deep_impact", Path(__file__).parent / "reference" / "xlmr_deep_impact.py")
ref = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(ref)

HF = {"vocab_size": 1000, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
      "intermediate_size": 128, "max_position_embeddings": 514, "type_vocab_size": 1, "layer_norm_eps": 1e-5,
      "pad_token_id": 1}
CONFIG = EncoderConfig.xlmr_base(vocab_size=1000, hidden_size=64, num_layers=2, num_heads=4, intermediate_size=128,
                                 hidden_dropout=0.0, attention_dropout=0.0, dtype="float32")
TOL = 2e-2


@pytest.fixture(scope="module")
def weights():
    return ref.make_weights(HF, seed=5)


def _rows(seq, packed, seed=0):
    """ids and segments [3, seq]: documents of several lengths, padding,
    and (packed) three documents in one row."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((3, seq), np.int64)
    if packed:
        seg[0, :seq // 3], seg[0, seq // 3:seq - 40] = 1, 2
        seg[1, :] = 1
        seg[2, :7], seg[2, 7:90], seg[2, 90:seq - 9] = 1, 2, 3
    else:
        seg[0, :seq - 70], seg[1, :], seg[2, :50] = 1, 1, 1
    ids = rng.integers(4, 1000, seg.shape)
    ids[seg == 0] = HF["pad_token_id"]
    return torch.from_numpy(ids), torch.from_numpy(seg)


def _model(weights, tokenizer=None, max_length=512):
    sd = hf_deep_impact_to_port({k: v.numpy() for k, v in weights.items()}, CONFIG)
    return deep_impact_xlmr(tokenizer, CONFIG, state_dict=sd, device="cpu")


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seq", [256, 512])
def test_forward_matches_reference(weights, seq, packed):
    ids, seg = _rows(seq, packed)
    module = _model(weights).module
    with torch.no_grad():
        if packed:
            got = module(ids, (seg > 0).int(), segment_ids=seg.int())[..., 0]
        else:
            got = module(ids, seg.int())[..., 0]
    want = ref.forward(weights, HF, ids, seg)
    real = seg > 0
    assert torch.isfinite(got).all()
    assert (got[real] - want[real]).abs().max() <= TOL


def _hf_tokenizer():
    """A small XLM-R-style fast tokenizer: Unigram pieces over seeded
    words (a third of them whole), Metaspace, ``<s> ... </s>``, XLM-R's
    special ids and ``<mask>`` last."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    rng = np.random.default_rng(0)
    words = sorted({"".join(rng.choice(list("bdgklmnprstaeiou"), int(rng.integers(2, 9)))) for _ in range(900)})
    vocab = [("<s>", 0.0), ("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0), ("▁", -8.0)]
    for ch in "bdgklmnprstaeiou.":
        vocab += [("▁" + ch, -8.0), (ch, -9.0)]
    vocab += [("▁" + w, -3.0 - i * 1e-3) for i, w in enumerate(words[:300])]
    vocab += [(f"▁x{i}", -20.0) for i in range(999 - len(vocab))] + [("<mask>", 0.0)]
    tk = Tokenizer(models.Unigram(vocab, unk_id=3, byte_fallback=False))
    tk.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tk.post_processor = processors.TemplateProcessing(single="<s> $A </s>", special_tokens=[("<s>", 0), ("</s>", 2)])
    hf = transformers.PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>", eos_token="</s>",
                                              unk_token="<unk>", pad_token="<pad>", mask_token="<mask>")
    texts = [" ".join(rng.choice(words, n)) + "." for n in (3, 40, 17, 120, 64, 9, 200, 31)]
    texts.append(" ".join(rng.choice(words, 700)))  # cut at max_length
    return hf, texts


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("seq", [256, 512])
def test_term_impacts_match_reference(weights, seq, packed):
    """``get_impact_scores_batch`` (``encode_term_scores``) and its packed
    twin (``encode_packed``) through ``HFImpactTokenizer``, against the
    reference's impacts of each document alone at its terms' first
    pieces; the long document is cut at ``seq``."""
    from improving_learned_index_tpu_torch.text.hf_adapter import HFImpactTokenizer

    hf, texts = _hf_tokenizer()
    model = _model(weights, HFImpactTokenizer(hf, max_length=seq))
    got = (model.get_impact_scores_batch_packed(texts, rows=4) if packed
           else model.get_impact_scores_batch(texts))
    encodings = [model.process_document(t) for t in texts]
    assert sum(encodings[-1].attention_mask) == seq  # the cut
    for enc, doc in zip(encodings, got):
        n = sum(enc.attention_mask)
        ids = torch.tensor([enc.ids[:n]])
        want = ref.forward(weights, HF, ids, torch.ones_like(ids))[0]
        assert [t for t, _ in doc] == list(enc.term_to_token_index)
        gaps = [abs(v - float(want[enc.term_to_token_index[t]])) for t, v in doc]
        assert max(gaps) <= TOL


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("seq,hd,device,kw,route", [
    (512, 64, CUDA, {}, "flash"),
    (384, 128, CUDA, {}, "flash"),
    (256, 64, CUDA, {}, "short"),
    (128, 64, CUDA, {}, "short"),
    (512, 64, CUDA, {"output_attentions": True}, "plain"),
    (256, 64, CUDA, {"output_attentions": True}, "plain"),
    (512, 16, CUDA, {}, "plain"),
    (512, 16, CUDA, {"plain_versions": True}, "flash"),
    (512, 16, CPU, {}, "flash"),
    (500, 64, CUDA, {}, "plain"),
    (512, 64, CUDA, {"use_flash_attention": False}, "plain"),
])
def test_attention_route(seq, hd, device, kw, route):
    kw = dict(kw)
    cfg = dataclasses.replace(EncoderConfig.xlmr_base(), hidden_size=hd * 12,
                              use_flash_attention=kw.pop("use_flash_attention", True))
    with plain_versions() if kw.pop("plain_versions", False) else contextlib.nullcontext():
        assert attention_route(cfg, seq, device, **kw) == route


@pytest.mark.parametrize("seq,maps,route", [(512, False, "flash"), (256, False, "short"), (512, True, "plain"),
                                            (200, False, "plain")])
def test_forward_takes_its_route(monkeypatch, seq, maps, route):
    """Each forward reaches the route's attention, and no other."""
    import improving_learned_index_tpu_torch.models.encoder as enc

    calls = []
    for name in ("flash_attention", "short_attention"):
        inner = getattr(enc, name)
        monkeypatch.setattr(enc, name, lambda *a, _n=name, _f=inner, **k: calls.append(_n) or _f(*a, **k))
    trunk = TransformerEncoder(CONFIG).eval()
    ids, seg = _rows(seq if seq % 128 == 0 else 256, packed=True)
    ids, seg = ids[:, :seq], seg[:, :seq]
    with torch.no_grad():
        trunk(ids, (seg > 0).int(), segment_ids=seg.int(), output_attentions=maps)
    want = {"flash": ["flash_attention"], "short": ["short_attention"], "plain": []}[route]
    assert calls == want * CONFIG.num_layers
