"""Training objectives: the port of ``improving_learned_index_tpu/train/losses.py``.

- ``pairwise_ce``    : cross-entropy over (positive, negatives) score rows
  with the positive at column 0 (reference training/trainer.py:163-167:
  ``CrossEntropyLoss`` with all-zero labels).
- ``distil_margin_mse``: MSE between student and teacher (pos - neg) margins
  (reference training/distil_trainer.py:6-31, arXiv:2010.02666).
- ``distil_kl``      : KL(softmax(teacher) || log_softmax(student)), summed
  over the score dim, averaged over batch; 1-D and 2-D aware
  (reference distil_trainer.py:34-75, arXiv:2010.11386).

Each is a function of (student_scores, targets) tensors, written op for op
as the JAX one so that both give the same fp32 values.
"""

from __future__ import annotations

import torch


def pairwise_ce(scores: torch.Tensor) -> torch.Tensor:
    """scores: [B, n] with the positive document's score in column 0.
    Cross-entropy with label 0 == -log_softmax(scores)[:, 0], averaged."""
    return -torch.log_softmax(scores, dim=-1)[:, 0].mean()


def distil_margin_mse(scores: torch.Tensor, teacher_scores: torch.Tensor) -> torch.Tensor:
    """scores/teacher_scores: [B, n], column 0 positive, rest negatives.
    MSE over per-negative margins."""
    student_margin = scores[:, :1] - scores[:, 1:]
    teacher_margin = teacher_scores[:, :1] - teacher_scores[:, 1:]
    return ((student_margin - teacher_margin) ** 2).mean()


def distil_kl(scores: torch.Tensor, teacher_scores: torch.Tensor) -> torch.Tensor:
    """KL divergence distillation.

    2-D [B, n]: sum KL over n, mean over B.  1-D [n]: sum (a single group --
    the reference's flattened path, distil_trainer.py:48-53)."""
    if scores.dim() == 1:
        scores = scores[None, :]
        teacher_scores = teacher_scores[None, :]
    student_log = torch.log_softmax(scores, dim=-1)
    teacher = torch.softmax(teacher_scores, dim=-1)
    # torch KLDivLoss: target * (log(target) - input); 0 * log(0) := 0.
    positive = teacher > 0
    teacher_log = torch.where(positive, torch.log(torch.where(positive, teacher, 1.0)), 0.0)
    kl = teacher * (teacher_log - student_log)
    return kl.sum(dim=-1).mean()


LOSSES = {
    "pairwise_ce": pairwise_ce,
    "distil_kl": distil_kl,
    "distil_mse": distil_margin_mse,
}
