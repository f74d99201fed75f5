"""Long-document encoding with the fork's default encoder: ``cli.index
--model_kind xlmr --hf_tokenizer <dir> --pack --max_length 512
--model_batch_size 64``, that is ``Indexer.index_to_file`` over an
XLM-R-geometry ``DeepImpact`` (Softplus head, RoBERTa positions) whose
tokenizer is the program's ``HFImpactTokenizer`` over a fast tokenizer,
writing the text forward index into the run's temporary directory.

Documents are cut to their first 512 tokens (FirstP) by the tokenizer and
packed, 64 rows of 512 a batch.  They reach the program through a named
pipe from a feed process, as in the passage encode cell
(``drivers/encode.py``, whose pipe and feed this reuses), until
``--seconds`` have passed.  The end-to-end metric, ``device_us_per_doc``,
is read after the window from one profiled ``index_to_file`` over a fixed
file of ``trace_docs`` documents of the mix: the seconds in which an
operation ran on the card, over its documents.

Traffic parameters: ``words``, ``median_words``, ``sigma``,
``min_words``, ``max_words``, ``whole_words`` (the text and the
vocabulary, ``traffic/documents.py``), ``max_length``, ``rows``,
``max_rate`` (documents made for the window: it ends early, with a
warning, if the program encodes them all), ``warm_docs``, ``trace_docs``.
Check parameters: ``sample_every``.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..harness import encoder_setup, xlmr_setup
from ..harness.common import Cell, Check, Outcome, log
from .encode import collection_chunks, encode_stream


def packed_rows(tokens: np.ndarray, length: int) -> int:
    """Rows that the program's packer (next fit, in arrival order) fills
    with documents of ``tokens`` tokens."""
    rows, col = 0, length
    for n in tokens.tolist():
        if col + n > length:
            rows, col = rows + 1, 0
        col += n
    return rows


def sample(lengths: np.ndarray, every: int, seed: int) -> List[int]:
    """The documents checked: each with chance 1 / ``every``, and the
    longest (in words) of every ``8 every``."""
    n = len(lengths)
    rng = np.random.default_rng([int(seed), 6])
    picks = set(np.nonzero(rng.random(n) < 1.0 / every)[0].tolist())
    for lo in range(0, n, every * 8):
        picks.add(max(range(lo, min(lo + every * 8, n)), key=lambda i: lengths[i]))
    return sorted(picks)


def run(cell: Cell) -> Outcome:
    import torch

    from improving_learned_index_tpu_torch.core.config import IndexConfig
    from improving_learned_index_tpu_torch.index.indexer import Indexer

    cfg, tr = cell.config, cell.workload["traffic"]
    dev = torch.device(cell.device)
    length, rows = int(tr["max_length"]), int(tr["rows"])
    xlmr_setup.build_kernels(dev)
    src = xlmr_setup.source(cfg, tr)
    weights = xlmr_setup.weights(cfg, cell.seed, dev, src)
    model = xlmr_setup.model(cfg, weights, xlmr_setup.tokenizer(src, length), dev)
    indexer = Indexer(model, IndexConfig(max_length=length, max_terms=length, model_batch_size=rows,
                                         pack_sequences=True))

    warm = cell.tmpdir / "warm.tsv"
    warm.write_bytes(b"".join(collection_chunks(src.documents(int(tr["warm_docs"]), cell.seed, stream=1))))
    indexer.index_to_file(warm, cell.tmpdir / "warm.forward.txt")
    n = math.ceil(cell.seconds * float(tr["max_rate"]))
    texts, ids, ends, lengths = src.draw(n, cell.seed)
    collection = cell.tmpdir / "collection.tsv"
    collection.write_bytes(b"".join(collection_chunks(texts)))
    out = cell.tmpdir / "forward.txt"
    if dev.type == "cuda":
        torch.cuda.synchronize()

    written, fed, t0 = encode_stream(indexer, cell, collection, out)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = cell.close_window()
    if fed == n:
        log(f"all {n} documents encoded before the window's end: raise max_rate")
    readings = {"window_s": t1 - t0, "window_docs": written}
    readings.update(traced(cell, indexer, src))
    profile, (p_ids, p_ends, p_lengths) = readings["profile"], readings.pop("profile_draw")
    metrics = {"device_us_per_doc": 1e6 * profile.busy_s / profile.units}
    pieces = pieces_table(src)
    p_tokens = src.token_counts(p_ids, p_ends, p_lengths, pieces, length)
    p_rows = packed_rows(p_tokens, length)
    log(f"profiled pass: {len(p_tokens)} documents, {100.0 * float(np.mean(p_tokens == length)):.2f}% cut at "
        f"{length}, {p_rows} rows ({math.ceil(p_rows / rows)} batches), "
        f"{float(p_tokens.sum()) / p_rows:.2f} real tokens a row")
    if cell.trace:
        tokens = src.token_counts(ids, ends, lengths, pieces, length)[:written]
        readings.update({"window_tokens": tokens.tolist(), "config": cfg, "profile_tokens": p_tokens.tolist()})
    peak = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0
    del indexer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    picks = sample(lengths[:written], int(cell.workload["check"]["sample_every"]), cell.seed)
    got = encoder_setup.read_lines(out, picks)
    want = reference_impacts(cfg, weights, src, [texts[i] for i in picks], length, dev)
    gaps = encoder_setup.impact_gaps(got, dict(zip(picks, want)))
    log(f"{written} documents in {t1 - t0:.3f} s ({fed} fed, {written / (t1 - t0):.4f} docs/s); "
        f"profiled: {profile.units} documents, the card busy {profile.busy_s:.6f} s of {profile.window_s:.3f}; "
        f"{len(picks)} checked: {gaps}")
    checks = [Check(name, gaps[name], cell.limit(name)) for name in ("term_lists_differ", "impact_gap_max",
                                                                      "impact_gap_mean")]
    return Outcome(attempted=fed, failed=fed - written, metrics=metrics, checks=checks,
                   memory_peak_bytes=int(peak), readings=readings)


def pieces_table(src) -> np.ndarray:
    """Pieces of each word of the source, by the reference tokenizer."""
    from ..reference.unigram import UnigramTokenizer

    tok = UnigramTokenizer(src.vocab)
    return np.array([len(tok.pieces(tok.terms(w)[0])) for w in src.words], np.int64)


def reference_impacts(cfg, weights, src, texts, length, device, **fault) -> List[Dict[str, float]]:
    from ..reference.encoder_xlmr import term_impacts
    from ..reference.unigram import UnigramTokenizer

    return term_impacts(weights, cfg, UnigramTokenizer(src.vocab), texts, length, device, **fault)


def traced(cell: Cell, indexer, src) -> dict:
    """One profiled ``index_to_file`` over a fixed file of the mix after
    the window, and the draw of its documents."""
    from ..harness.trace import Window

    texts, ids, ends, lengths = src.draw(int(cell.workload["traffic"]["trace_docs"]), cell.seed, stream=2)
    path = cell.tmpdir / "trace.tsv"
    path.write_bytes(b"".join(collection_chunks(texts)))
    with Window() as w:
        indexer.index_to_file(path, cell.tmpdir / "trace.forward.txt")
    w.profile.units = len(texts)
    return {"profile": w.profile, "profile_draw": (ids, ends, lengths)}
