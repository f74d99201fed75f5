"""DeepPairwiseImpact: term-*pair* impact scores.

Counterpart of ``improving_learned_index_tpu/models/pairwise.py`` (reference
pairwise model, src/deep_impact/models/pairwise_impact.py): besides the
per-term impacts, each term pair is scored from the features [max
cross-layer attention between the pair's first tokens (detached),
hidden(i), hidden(j)] through a ``Linear(2H+1, 1) + ReLU`` head in fp32,
and emitted as a ``term1|term2`` composite posting.

Pairs are a fixed-shape [B, max_pairs, 2] slot array with a validity mask
(``build_pair_slots``).  The attention feature needs the maps, so the trunk
runs its plain attention route at every S (``output_attentions``), as the
JAX package turns its kernels off there: the pairwise routes launch no
``short_attention`` kernel.  The max over layers is taken one head-mean map
at a time; [L, B, heads, S, S] is never held.
"""

from __future__ import annotations

from itertools import combinations
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..core.config import EncoderConfig
from ..text.processor import batch_arrays
from .deep_impact import DeepImpact
from .encoder import ImpactHead, TransformerEncoder, init_weights


class PairwiseImpactModel(nn.Module):
    """Trunk + per-token impact head + pair head."""

    def __init__(self, config: EncoderConfig):
        super().__init__()
        self.config = config
        self.encoder = TransformerEncoder(config)
        self.impact_head = ImpactHead(config.hidden_size, config.impact_activation)
        self.pairwise_head = nn.Linear(2 * config.hidden_size + 1, 1)

    def forward(self, input_ids, attention_mask, type_ids, pair_indices, pair_mask,
                use_kernels: bool = True):
        """(single [B, L, 1], pair_scores [B, P], max_attn [B, P]); both pair
        outputs are 0 outside ``pair_mask``."""
        hidden, maps = self.encoder(input_ids, attention_mask, type_ids, use_kernels=use_kernels,
                                    output_attentions=True)
        single = self.impact_head(hidden)
        pair_indices = pair_indices.long()
        i_idx, j_idx = pair_indices[..., 0], pair_indices[..., 1]  # [B, P]
        b_idx = torch.arange(hidden.shape[0], device=hidden.device)[:, None]
        # attention(i->j) and (j->i) of each layer's head mean, max over both
        # and the layers; detached (reference :66, JAX stop_gradient)
        with torch.no_grad():
            max_attn = None
            for m in maps:  # [B, L, L]
                a = torch.maximum(m[b_idx, i_idx, j_idx], m[b_idx, j_idx, i_idx])
                max_attn = a if max_attn is None else torch.maximum(max_attn, a)
        del maps
        h_i = torch.take_along_dim(hidden, i_idx[..., None], dim=1)  # [B, P, H]
        h_j = torch.take_along_dim(hidden, j_idx[..., None], dim=1)
        feat = torch.cat([max_attn[..., None], h_i, h_j], dim=-1)  # [B, P, 2H+1] fp32
        pair_scores = F.relu(self.pairwise_head(feat))[..., 0]
        pair_scores = torch.where(pair_mask, pair_scores, 0.0)
        max_attn = torch.where(pair_mask, max_attn, 0.0)
        return single, pair_scores, max_attn


def build_pair_slots(
    token_indices: Sequence[Sequence[int]], max_pairs: int, directed: bool = False
) -> Tuple[np.ndarray, np.ndarray]:
    """Fixed-shape pair index arrays from per-doc first-token indices.

    Undirected (indexing): combinations of the sorted indices (reference
    compute_term_impacts, pairwise_impact.py:120).  Directed (training):
    both orders (reference training/pairwise_trainer.py:11-17).
    """
    bsz = len(token_indices)
    pairs = np.zeros((bsz, max_pairs, 2), dtype=np.int32)
    mask = np.zeros((bsz, max_pairs), dtype=bool)
    for b, idxs in enumerate(token_indices):
        idxs = sorted(idxs)
        combos = list(combinations(idxs, 2))
        if directed:
            combos = combos + [(j, i) for i, j in combos]
        combos = combos[:max_pairs]
        for p, (i, j) in enumerate(combos):
            pairs[b, p] = (i, j)
            mask[b, p] = True
    return pairs, mask


class DeepPairwiseImpact(DeepImpact):
    """Wrapper with the pairwise forward and the composite-term impact API.

    A state dict without ``pairwise_head.*`` (a DeepImpact checkpoint: the
    trunk and impact head) loads with the pair head drawn from ``seed``."""

    module_class = PairwiseImpactModel

    def __init__(
        self,
        config: EncoderConfig,
        tokenizer,
        state_dict: Optional[Dict[str, torch.Tensor]] = None,
        seed: int = 0,
        device: Optional[Union[str, torch.device]] = None,
        use_kernels: Optional[bool] = None,
        max_pairs: int = 256,
    ):
        self.max_pairs = max_pairs
        super().__init__(config, tokenizer, state_dict, seed, device, use_kernels)

    def _load_state_dict(self, state_dict: Dict[str, torch.Tensor], seed: int) -> None:
        head = self.module.pairwise_head
        if not any(k.startswith("pairwise_head.") for k in state_dict):
            g = torch.Generator()
            g.manual_seed(seed)
            init_weights(head, g)
            state_dict = {**state_dict, **{f"pairwise_head.{k}": v for k, v in head.state_dict().items()}}
        self.module.load_state_dict(state_dict)

    @torch.inference_mode()
    def __call__(self, input_ids, attention_mask, type_ids, pair_indices, pair_mask):
        """(single [B, L, 1], pair_scores [B, P], max_attn [B, P]) as host
        numpy fp32."""
        out = self.module(
            self._upload(np.asarray(input_ids, np.int32)),
            self._upload(np.asarray(attention_mask, np.int32)),
            self._upload(np.asarray(type_ids, np.int32)),
            self._upload(np.asarray(pair_indices, np.int32)),
            self._upload(np.asarray(pair_mask, bool)),
            use_kernels=self.use_kernels,
        )
        return tuple(t.float().cpu().numpy() for t in out)

    def get_impact_scores_batch(self, documents: Sequence[str]) -> List[List[Tuple[str, float]]]:
        """Single-term impacts plus ``term1|term2`` pair impacts, pairs in
        token order, zero (rounded to 3dp) pairs dropped, all sorted by score
        descending (reference pairwise_impact.py:97-129)."""
        if not documents:
            return []
        encodings = [self.process_document(d) for d in documents]
        arrays = batch_arrays(encodings)
        sorted_items = [sorted(e.term_to_token_index.items(), key=lambda x: x[1]) for e in encodings]
        pair_idx, pair_mask = build_pair_slots(
            [[i for _, i in items] for items in sorted_items], self.max_pairs
        )
        single, pair_scores, _ = self(
            arrays["input_ids"], arrays["attention_mask"], arrays["type_ids"], pair_idx, pair_mask
        )
        single = single[..., 0]

        out: List[List[Tuple[str, float]]] = []
        for d, items in enumerate(sorted_items):
            impacts = [(term, float(single[d, tok])) for term, tok in items]
            terms_in_order = [t for t, _ in items]
            for p, (t1, t2) in enumerate(combinations(terms_in_order, 2)):
                if p >= self.max_pairs:
                    break
                score = float(pair_scores[d, p])
                if round(score, 3):
                    impacts.append((f"{t1}|{t2}", score))
            impacts.sort(key=lambda x: x[1], reverse=True)
            out.append(impacts)
        return out
