from .exact_topk import exact_topk_integer
from .gather_rows import accumulate_rows, accumulate_rows_plain
from .scatter_scores import apply_tail_updates, apply_tail_updates_plain

__all__ = [
    "accumulate_rows",
    "accumulate_rows_plain",
    "apply_tail_updates",
    "apply_tail_updates_plain",
    "exact_topk_integer",
]
