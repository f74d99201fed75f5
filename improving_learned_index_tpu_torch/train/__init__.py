from .collate import (
    COLLATES,
    collate_cross_encoder,
    collate_distillation,
    collate_in_batch_negatives,
    collate_triples,
)
from .losses import LOSSES, distil_kl, distil_margin_mse, pairwise_ce
from .trainer import Trainer, make_loss_fn, masked_doc_scores

__all__ = [
    "COLLATES",
    "collate_cross_encoder",
    "collate_distillation",
    "collate_in_batch_negatives",
    "collate_triples",
    "LOSSES",
    "distil_kl",
    "distil_margin_mse",
    "pairwise_ce",
    "Trainer",
    "make_loss_fn",
    "masked_doc_scores",
]
