"""Term-dependency analysis: cross-attention between term pairs.

Counterpart of ``improving_learned_index_tpu/analysis/attention.py``, with
the reference term_dependencies study's output
(src/term_dependencies/attention.py:21-69): for every pair of document
terms, the max over both directions of the mean-head attention between
their first tokens, one value a layer.  The batch runs through one forward
of the model's trunk with ``output_attentions=True``, which returns each
layer's head-mean map [B, L, L] already (``models/encoder.py``); the JAX
function takes the per-head maps and averages them itself.  Maps need the
plain attention route, so this launches no ``short_attention`` kernel, as
the JAX route runs XLA attention.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.device import device_scope
from ..text.processor import batch_arrays


@torch.inference_mode()
def extract_term_pair_attention(
    model,  # models.DeepImpact
    documents: Sequence[str],
) -> List[Dict[Tuple[str, str], np.ndarray]]:
    """Per document: {(term1, term2): per-layer max-direction mean-head
    attention} for all term pairs (token order)."""
    encodings = [model.process_document(d) for d in documents]
    arrays = batch_arrays(encodings)
    with device_scope(model.device):
        ids, mask, types = (model._upload(arrays[k])
                            for k in ("input_ids", "attention_mask", "type_ids"))
        _, maps = model.module.encoder(ids, mask, types, use_kernels=model.use_kernels,
                                       output_attentions=True)
        mean_attn = torch.stack(maps).cpu().numpy()  # [layers, B, L, L]

    results: List[Dict[Tuple[str, str], np.ndarray]] = []
    for b, enc in enumerate(encodings):
        items = sorted(enc.term_to_token_index.items(), key=lambda x: x[1])
        pair_attn: Dict[Tuple[str, str], np.ndarray] = {}
        for (t1, i), (t2, j) in combinations(items, 2):
            pair_attn[(t1, t2)] = np.maximum(mean_attn[:, b, i, j], mean_attn[:, b, j, i])
        results.append(pair_attn)
    return results
