"""Collate functions: dataset items -> fixed-shape numpy batches.

The port's copy of ``improving_learned_index_tpu/train/collate.py`` (numpy
only: the same arrays for the same items and tokenizer).  Mirrors the
reference collates (src/deep_impact/train.py:18-82):

- triples        : interleaved (pos, neg) per query -> encoded [2B, L],
                   query-term masks [2B, L]
- distillation   : (query, [(passage, score) x G]) -> encoded [B*G, L],
                   masks [B*G, L], teacher scores [B, G]
- in-batch negs  : per query, positive + own negative, masks expanded so
                   every query scores against all B negatives
                   (reference train.py:63-82, training/in_batch_negatives.py)
- cross-encoder  : "{doc} [SEP] {query}" per (pos, neg) -> encoded [2B, L]
- pairwise impact: triples + directed pair slots [2B, P, 2] and their mask
                   from each row's query-matching tokens
                   (reference training/pairwise_trainer.py:11-17)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np

from ..text.processor import batch_arrays


def collate_triples(
    batch: Sequence[Tuple[str, str, str]], tokenizer, max_length: int
) -> Dict[str, np.ndarray]:
    encoded_list, masks = [], []
    for query, positive, negative in batch:
        for doc in (positive, negative):
            enc, mask = tokenizer.process_query_and_document(query, doc, max_length)
            encoded_list.append(enc)
            masks.append(mask)
    arrays = batch_arrays(encoded_list)
    arrays["masks"] = np.asarray(masks, dtype=np.float32)
    arrays["group_size"] = 2
    return arrays


def collate_distillation(
    batch: Sequence[Tuple[str, List[Tuple[str, float]]]], tokenizer, max_length: int
) -> Dict[str, np.ndarray]:
    encoded_list, masks, scores = [], [], []
    group = None
    for query, pid_score_list in batch:
        group = len(pid_score_list) if group is None else group
        if len(pid_score_list) != group:
            raise ValueError("ragged distillation groups")
        for passage, score in pid_score_list:
            enc, mask = tokenizer.process_query_and_document(query, passage, max_length)
            encoded_list.append(enc)
            masks.append(mask)
            scores.append(score)
    arrays = batch_arrays(encoded_list)
    arrays["masks"] = np.asarray(masks, dtype=np.float32)
    arrays["scores"] = np.asarray(scores, dtype=np.float32).reshape(len(batch), group)
    arrays["group_size"] = group
    return arrays


def collate_in_batch_negatives(
    batch: Sequence[Tuple[str, str, str]], tokenizer, max_length: int
) -> Dict[str, np.ndarray]:
    queries, positives, negatives = zip(*batch)
    query_terms = [tokenizer.process_query(q) for q in queries]
    neg_encoded = [tokenizer.process_document(d, max_length) for d in negatives]

    encoded_list, masks = [], []
    for i, (terms, positive) in enumerate(zip(query_terms, positives)):
        enc = tokenizer.process_document(positive, max_length)
        encoded_list.append(enc)
        masks.append(
            tokenizer.get_query_document_token_mask(
                terms, enc.term_to_token_index, max_length
            )
        )
        encoded_list.append(neg_encoded[i])
        for neg in neg_encoded:
            masks.append(
                tokenizer.get_query_document_token_mask(
                    terms, neg.term_to_token_index, max_length
                )
            )
    arrays = batch_arrays(encoded_list)  # [2B, L]
    arrays["masks"] = np.asarray(masks, dtype=np.float32)  # [B*(B+1), L]
    arrays["group_size"] = 2
    return arrays


def collate_cross_encoder(
    batch: Sequence[Tuple[str, str, str]], tokenizer, max_length: int
) -> Dict[str, np.ndarray]:
    encoded_list = []
    for query, positive, negative in batch:
        for doc in (positive, negative):
            encoded_list.append(tokenizer.process_document(f"{doc} [SEP] {query}", max_length))
    arrays = batch_arrays(encoded_list)
    arrays["group_size"] = 2
    return arrays


def collate_pairwise_impact(
    batch: Sequence[Tuple[str, str, str]],
    tokenizer,
    max_length: int,
    max_pairs: int = 256,
) -> Dict[str, np.ndarray]:
    """Triples collate + directed pair slots built from the query-matching
    token indices (reference training/pairwise_trainer.py:11-17: nonzero
    mask indices, combinations in both orders)."""
    from ..models.pairwise import build_pair_slots

    arrays = collate_triples(batch, tokenizer, max_length)
    token_indices = [np.flatnonzero(m).tolist() for m in arrays["masks"]]
    pair_idx, pair_mask = build_pair_slots(token_indices, max_pairs, directed=True)
    arrays["pair_indices"] = pair_idx
    arrays["pair_mask"] = pair_mask
    return arrays


COLLATES = {
    "pairwise_ce": collate_triples,
    "distil_kl": collate_distillation,
    "distil_mse": collate_distillation,
    "in_batch_negatives": collate_in_batch_negatives,
    "cross_encoder": collate_cross_encoder,
    "pairwise_impact": collate_pairwise_impact,
}
