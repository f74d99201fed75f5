"""Set-up of the XLM-R encode cell: the document source and its generated
tokenizer, the seeded weights (HuggingFace's ``roberta.`` layout, on the
device), the flash-attention kernel built, and the program's model loaded
from the weights through its HuggingFace import.

The tokenizer is made in memory from the source's vocabulary
(``traffic/documents.py``): a ``tokenizers`` Unigram model of exactly the
configuration's ``vocab_size`` pieces at XLM-R's special ids, the ``▁``
Metaspace pre-tokenizer, and ``<s> ... </s>`` around each text, wrapped as
a ``transformers`` ``PreTrainedTokenizerFast`` and handed to the program's
``HFImpactTokenizer``.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from ..reference.encoder import HEAD
from ..reference.encoder_xlmr import forward, make_weights, padded
from ..reference.unigram import UnigramTokenizer
from ..traffic.documents import MASK, SPACE, SPECIALS, DocumentSource
from .encoder_setup import encoder_config as bert_encoder_config


def encoder_config(config: Dict):
    """The program's ``EncoderConfig`` of the configuration: BERT's fields
    and RoBERTa's positions, which count from ``pad_token_id + 1``."""
    return dataclasses.replace(bert_encoder_config(config), position_offset=config["pad_token_id"] + 1)


def build_kernels(device) -> None:
    if device.type == "cuda":
        from improving_learned_index_tpu_torch.ops import flash_attention

        flash_attention.KERNEL.lib()


def source(config: Dict, traffic: Dict) -> DocumentSource:
    return DocumentSource(config["vocab_size"], traffic)


def hf_tokenizer(src: DocumentSource):
    """The generated XLM-R-style fast tokenizer (``transformers``)."""
    import transformers
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    bos, pad, eos, unk = SPECIALS
    tk = Tokenizer(models.Unigram(src.vocab, unk_id=SPECIALS.index(unk), byte_fallback=False))
    tk.pre_tokenizer = pre_tokenizers.Metaspace(replacement=SPACE, prepend_scheme="always")
    tk.post_processor = processors.TemplateProcessing(single=f"{bos} $A {eos}",
                                                      special_tokens=[(bos, 0), (eos, 2)])
    return transformers.PreTrainedTokenizerFast(tokenizer_object=tk, bos_token=bos, eos_token=eos, unk_token=unk,
                                                pad_token=pad, cls_token=bos, sep_token=eos, mask_token=MASK)


def tokenizer(src: DocumentSource, max_length: int):
    """The program's ``HFImpactTokenizer`` over ``hf_tokenizer``."""
    from improving_learned_index_tpu_torch.text.hf_adapter import HFImpactTokenizer

    return HFImpactTokenizer(hf_tokenizer(src), max_length=max_length)


def model(config: Dict, weights: Dict, tok, device):
    """The program's ``DeepImpact`` on ``device`` with ``weights``."""
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.models.hf_import import hf_deep_impact_to_port

    ecfg = encoder_config(config)
    return DeepImpact(ecfg, tok, state_dict=hf_deep_impact_to_port(weights, ecfg), device=device)


def weights(config: Dict, seed: int, device, src: DocumentSource, calibration: int = 64):
    """The seeded weights, with the impact head set so that its input over
    ``calibration`` documents of the mix (their own stream, cut at 512
    tokens) has unit spread and median 0: Softplus impacts around ln 2.  As
    drawn, a random 12-layer trunk drives every token toward one shared
    vector, so the head's scale and sign on it would decide every impact.
    The calibration runs the reference, in float32; both sides get the
    weights it leaves."""
    import torch

    from ..reference.encoder import exact_fp32

    w = make_weights(config, seed, device)
    tok = UnigramTokenizer(src.vocab)
    docs = [tok.document(t, 512)[0] for t in src.documents(calibration, seed, stream=9)]
    ids, segments = padded(docs, tok.pad, device)
    head = make_weights(config, seed + 1, device)[f"{HEAD}.weight"]
    with torch.no_grad(), exact_fp32():
        w[f"{HEAD}.weight"].copy_(head)
        w[f"{HEAD}.bias"].zero_()
        z = forward(w, config, ids, segments, head=False)[segments > 0]
        scale = float(z.std()) or 1.0
        w[f"{HEAD}.weight"].copy_(head / scale)
        w[f"{HEAD}.bias"].fill_(-float(z.median()) / scale)
    return w
