"""Set-up shared by the cells of an encoder configuration: the text source
and its vocabulary, the seeded weights (HuggingFace layout, on the device),
the program's model loaded from them through its HuggingFace import, and
the reading of the program's forward-index file."""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..reference.encoder import make_weights
from ..reference.tokenizer import Tokenizer
from ..traffic.passages import TextSource


def encoder_config(config: Dict):
    """The program's ``EncoderConfig`` of a BERT-geometry configuration."""
    from improving_learned_index_tpu_torch.core.config import EncoderConfig

    return EncoderConfig(
        vocab_size=config["vocab_size"], hidden_size=config["hidden_size"],
        num_layers=config["num_hidden_layers"], num_heads=config["num_attention_heads"],
        intermediate_size=config["intermediate_size"], max_position_embeddings=config["max_position_embeddings"],
        type_vocab_size=config["type_vocab_size"], layer_norm_eps=config["layer_norm_eps"],
        pad_token_id=config["pad_token_id"], impact_activation=config["impact_head"]["activation"],
        dtype=config["compute_dtype"],
    )


def build_kernels(device) -> None:
    if device.type == "cuda":
        from improving_learned_index_tpu_torch.ops import short_attention

        short_attention.KERNEL.lib()


def model(config: Dict, weights: Dict, vocab: List[str], max_length: int, device):
    """The program's ``DeepImpact`` on ``device`` with ``weights``."""
    from improving_learned_index_tpu_torch.models import DeepImpact
    from improving_learned_index_tpu_torch.models.hf_import import hf_deep_impact_to_port
    from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

    ecfg = encoder_config(config)
    tok = ImpactTokenizer(WordPieceVocab(vocab), max_length=max_length)
    return DeepImpact(ecfg, tok, state_dict=hf_deep_impact_to_port(weights, ecfg), device=device)


def source(config: Dict, traffic: Dict) -> TextSource:
    return TextSource(config["vocab_size"], traffic)


def pieces_table(src: TextSource) -> np.ndarray:
    """WordPiece pieces of each word of the source, by the reference
    tokenizer."""
    tok = Tokenizer(src.vocab)
    return np.array([len(tok.pieces(w)) for w in src.words], np.int64)


def read_lines(path, wanted: Sequence[int]) -> Dict[int, Dict[str, float]]:
    """The forward file's lines at positions ``wanted``, each as
    {term: impact} (``term: impact`` pairs joined by ``, ``)."""
    want = set(wanted)
    out = {}
    with open(path, encoding="utf-8") as f:
        for i, line in enumerate(f):
            if i in want:
                row = {}
                line = line.rstrip("\n")
                for pair in line.split(", ") if line else []:
                    term, value = pair.rsplit(": ", 1)
                    row[term] = float(value)
                out[i] = row
    return out


def impact_gaps(got: Dict[int, Dict[str, float]], want: Dict[int, Dict[str, float]]) -> Dict[str, float]:
    """Passages whose term lists differ (order included), and the largest
    and mean |impact difference| over the terms of the rest, each over the
    mean reference impact of the sample's terms (a scale that one large
    impact does not move)."""
    differ, diffs, scale, where = 0, [], [], []
    for i, w in want.items():
        g = got.get(i)
        scale.extend(w.values())
        if g is None or list(g) != list(w):
            differ += 1
            continue
        diffs.extend(abs(g[t] - w[t]) for t in w)
        where.extend((i, t, g[t], w[t]) for t in w)
    d = np.asarray(diffs or [np.nan])
    unit = float(np.mean(scale)) if scale else 1.0
    worst = [where[j] for j in np.argsort(-d)[:3]] if diffs else []
    return {"term_lists_differ": differ, "impact_gap_max": float(d.max() / unit),
            "impact_gap_mean": float(d.mean() / unit), "mean_impact": unit,
            "worst": [[int(i), t, round(a, 4), round(b, 4)] for i, t, a, b in worst]}


def weights(config: Dict, seed: int, device, src: TextSource, calibration: int = 64):
    """The seeded weights, with the impact head set so that the trunk's
    outputs over ``calibration`` passages of the mix (their own stream)
    give impacts of unit spread, about half of them above 0.  A random
    12-layer trunk drives every token toward one shared vector; left as
    drawn, the head's sign on that vector decides whether nearly all
    impacts are 0, and on some seeds they are (mean impact 0.0005).  The
    calibration is part of making the inputs: it runs the reference, in
    float32, and both sides get the weights it leaves."""
    import torch

    from ..reference.encoder import HEAD, exact_fp32, forward, padded

    w = make_weights(config, seed, device)
    tok = Tokenizer(src.vocab)
    docs = [tok.document(t, 256)[0] for t in src.passages(calibration, seed, stream=9)]
    ids, mask = padded(docs, tok.pad, device)
    w[f"{HEAD}.weight"].zero_()
    w[f"{HEAD}.bias"].zero_()
    head = make_weights(config, seed + 1, device)[f"{HEAD}.weight"]
    with torch.no_grad(), exact_fp32():
        w[f"{HEAD}.weight"].copy_(head)
        # the head's pre-activation: forward() applies the ReLU, so read it
        # through a head with the sign flipped too
        up = forward(w, config, ids, mask)[mask]
        w[f"{HEAD}.weight"].neg_()
        down = forward(w, config, ids, mask)[mask]
        z = up - down
        scale = float(z.std()) or 1.0
        w[f"{HEAD}.weight"].copy_(head / scale)
        w[f"{HEAD}.bias"].fill_(-float(z.median()) / scale)
    return w


# the program's parameter names -> HuggingFace's (the layout the weights are made in)
_EMBEDDINGS = {"word_embeddings": "word_embeddings", "position_embeddings": "position_embeddings",
               "token_type_embeddings": "token_type_embeddings", "layer_norm": "LayerNorm"}
_LAYER = {"attention.query": "attention.self.query", "attention.key": "attention.self.key",
          "attention.value": "attention.self.value", "attention.output_dense": "attention.output.dense",
          "attention_norm": "attention.output.LayerNorm", "intermediate": "intermediate.dense",
          "output": "output.dense", "output_norm": "output.LayerNorm"}


def hf_name(name: str) -> str:
    """``encoder.layers.3.attention.query.weight`` ->
    ``bert.encoder.layer.3.attention.self.query.weight``."""
    stem, part = name.rsplit(".", 1)
    if stem == "impact_head.dense":
        return f"impact_score_encoder.0.{part}"
    if stem.startswith("encoder.embeddings."):
        return f"bert.embeddings.{_EMBEDDINGS[stem.split('.', 2)[2]]}.{part}"
    if stem.startswith("encoder.layers."):
        _, _, i, rest = stem.split(".", 3)
        return f"bert.encoder.layer.{i}.{_LAYER[rest]}.{part}"
    raise KeyError(f"no HuggingFace name for {name}")
