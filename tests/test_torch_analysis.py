"""The port's term-pair attention against the JAX package's: the same tiny
fp32 model (weights carried across by ``flax_params_to_port``), the same
documents; the same pairs, each layer's value within 1e-5 (fp32, summation
order only).  The plots are written (matplotlib on the CPU only)."""

import dataclasses

import jax
import numpy as np
import pytest

from improving_learned_index_tpu.analysis import extract_term_pair_attention as jax_extract
from improving_learned_index_tpu.core.config import EncoderConfig as JaxConfig
from improving_learned_index_tpu.models import DeepImpact as JaxDeepImpact
from improving_learned_index_tpu_torch.analysis import extract_term_pair_attention
from improving_learned_index_tpu_torch.core.config import EncoderConfig
from improving_learned_index_tpu_torch.models import DeepImpact, flax_params_to_port
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab

DOCS = ["the quick fox", "lazy dog sleeps", "the quick brown fox jumps over the lazy dog",
        "inverted indexes map terms to document postings, the end"]


@pytest.fixture(scope="module")
def results(tiny_corpus, tiny_tokenizer):
    jc = dataclasses.replace(JaxConfig.tiny(vocab_size=len(tiny_tokenizer.vocab)), dtype="float32")
    jm = JaxDeepImpact(jc, tiny_tokenizer, seed=0)
    tc = dataclasses.replace(EncoderConfig.tiny(vocab_size=len(tiny_tokenizer.vocab)), dtype="float32")
    tok = ImpactTokenizer(WordPieceVocab.build(tiny_corpus, max_size=512), max_length=32)
    sd = flax_params_to_port(jax.tree_util.tree_map(np.asarray, jm.params), tc)
    pm = DeepImpact(tc, tok, state_dict=sd, device="cpu")
    return jax_extract(jm, DOCS), extract_term_pair_attention(pm, DOCS), pm


def test_pairs_match_jax(results):
    want, got, _ = results
    assert len(got) == len(want) == len(DOCS)
    assert ("the", "quick") in got[0]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for pair in w:
            assert g[pair].shape == (2,)  # tiny model: 2 layers
            np.testing.assert_allclose(g[pair], w[pair], atol=1e-5, rtol=0)
            assert np.all(g[pair] >= 0) and np.all(g[pair] <= 1)


def test_pairs_are_the_max_of_both_directions(results):
    """Each value is max(a[i, j], a[j, i]) of the head-mean maps that
    ``output_attentions`` returns."""
    import torch

    _, got, pm = results
    enc = pm.process_document(DOCS[2])
    ids = torch.tensor([enc.ids], dtype=torch.int32)
    mask = torch.tensor([enc.attention_mask], dtype=torch.int32)
    with torch.no_grad():
        _, maps = pm.module.encoder(ids, mask, output_attentions=True)
    items = sorted(enc.term_to_token_index.items(), key=lambda x: x[1])
    for (t1, i), (t2, j) in zip(items, items[1:]):
        want = [max(float(m[0, i, j]), float(m[0, j, i])) for m in maps]
        np.testing.assert_allclose(got[2][(t1, t2)], want, atol=1e-6, rtol=0)


def test_plots(results, tmp_path):
    pytest.importorskip("matplotlib")
    from improving_learned_index_tpu_torch.analysis.visualize import (
        plot_attention_histogram,
        plot_layer_series,
    )

    _, got, _ = results
    plot_attention_histogram(got, layer=0, output_path=tmp_path / "hist.png")
    plot_layer_series(got, output_path=tmp_path / "series.png")
    for name in ("hist.png", "series.png"):
        assert (tmp_path / name).read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
