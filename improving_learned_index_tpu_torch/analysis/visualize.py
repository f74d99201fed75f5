"""Plots for the term-dependency study
(reference src/term_dependencies/visualize.py: attention histograms and
per-layer series).  The port's copy of
``improving_learned_index_tpu/analysis/visualize.py``: numpy in, PNG out;
matplotlib is imported only inside the plotting functions."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Sequence, Tuple, Union

import numpy as np


def plot_attention_histogram(
    pair_attentions: Sequence[Dict[Tuple[str, str], np.ndarray]],
    layer: int,
    output_path: Union[str, Path],
    bins: int = 50,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    values = [
        float(per_layer[layer])
        for doc in pair_attentions
        for per_layer in doc.values()
    ]
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(values, bins=bins)
    ax.set_xlabel(f"max mean-head attention (layer {layer})")
    ax.set_ylabel("term pairs")
    fig.tight_layout()
    fig.savefig(output_path)
    plt.close(fig)


def plot_layer_series(
    pair_attentions: Sequence[Dict[Tuple[str, str], np.ndarray]],
    output_path: Union[str, Path],
    top_pairs: int = 10,
) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    flat: List[Tuple[Tuple[str, str], np.ndarray]] = [
        (pair, series) for doc in pair_attentions for pair, series in doc.items()
    ]
    flat.sort(key=lambda x: float(np.max(x[1])), reverse=True)
    fig, ax = plt.subplots(figsize=(7, 4))
    for pair, series in flat[:top_pairs]:
        ax.plot(range(len(series)), series, marker="o", label="|".join(pair))
    ax.set_xlabel("layer")
    ax.set_ylabel("max mean-head attention")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(output_path)
    plt.close(fig)
