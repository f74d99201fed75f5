from .count_ge import count_ge, count_ge_plain
from .exact_topk import exact_topk_integer
from .gather_rows import (
    accumulate_grouped,
    accumulate_grouped_plain,
    accumulate_rows,
    accumulate_rows_plain,
    group_pairs,
)
from .pallas_scoring import PallasBlockedEngine, blocked_scores, blocked_scores_plain
from .scatter_scores import (
    apply_tail_chunks,
    apply_tail_chunks_plain,
    apply_tail_updates,
    apply_tail_updates_plain,
)

__all__ = [
    "PallasBlockedEngine",
    "accumulate_grouped",
    "accumulate_grouped_plain",
    "accumulate_rows",
    "accumulate_rows_plain",
    "apply_tail_chunks",
    "apply_tail_chunks_plain",
    "apply_tail_updates",
    "apply_tail_updates_plain",
    "blocked_scores",
    "blocked_scores_plain",
    "count_ge",
    "count_ge_plain",
    "exact_topk_integer",
    "group_pairs",
]
