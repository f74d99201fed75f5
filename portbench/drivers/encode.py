"""Corpus encoding, the work ``cli.index`` does for the 8.8M MS MARCO
passages: ``Indexer.index_to_file`` with the ``IndexConfig`` that
``cli.index --pack --model_batch_size <rows> --max_length <length>`` sets,
writing the text forward index into the run's temporary directory.

The collection reaches the program through a named pipe, as a collection
streamed from another process would: a process of its own
(``traffic/feed.py``) writes the passages into it until ``--seconds`` have
passed, then closes it, and ``index_to_file`` encodes what it read and
returns.  The feed is no thread of this process, so it takes no share of
the interpreter that the program's tokenizer thread and its writer share.
The rate, ``docs_per_s.encode`` (per layer), is every passage written to
the forward index over the whole window, the pipeline's fill and drain
included.  The end-to-end metric, ``device_us_per_doc``, is read after the
window from one profiled ``index_to_file`` over a fixed file of the mix:
the seconds in which an operation ran on the card, over its passages.

Traffic parameters: ``words``, ``mean_words`` (the text), ``max_length``,
``rows``, ``max_rate`` (passages made for the window: it ends early, with
a warning, if the program encodes them all), ``warm_passages``,
``trace_passages`` (the profiled pass).  Check parameters: ``sample_every``.
"""

from __future__ import annotations

import math
import os
import subprocess
import sys
from pathlib import Path
from typing import List

import numpy as np

from ..harness import encoder_setup
from ..harness.common import Cell, Check, Outcome, log

CHUNK = 64  # passages a write into the pipe


def collection_chunks(passages: List[str], first_id: int = 0) -> List[bytes]:
    """The collection's lines (``pid<TAB>passage``), ``CHUNK`` a block."""
    return ["".join(f"{first_id + at + i}\t{p}\n" for i, p in enumerate(passages[at:at + CHUNK])).encode()
            for at in range(0, len(passages), CHUNK)]


def encode_stream(indexer, cell: Cell, collection: Path, out: Path) -> tuple:
    """(passages written by the program, passages fed, the window's ends):
    the feed process writes ``collection`` into a named pipe, which
    ``index_to_file`` reads, until ``--seconds`` after the window opens."""
    fifo = cell.tmpdir / "collection.fifo"
    if fifo.exists():
        fifo.unlink()
    os.mkfifo(fifo)
    feed = subprocess.Popen([sys.executable, str(Path(__file__).parents[1] / "traffic" / "feed.py"),
                             str(collection), str(fifo), str(CHUNK)],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    try:
        if feed.stdout.readline().strip() != "ready":  # started, before the window opens
            raise RuntimeError("the feed process did not start")
        t0 = cell.open_window()
        feed.stdin.write(f"{t0 + cell.seconds!r}\n")
        feed.stdin.close()
        written = indexer.index_to_file(fifo, out)
        fed = int(feed.stdout.read() or -1)
        if feed.wait() != 0 or fed < 0:
            raise RuntimeError(f"the feed process failed (exit code {feed.returncode})")
        return written, fed, t0
    finally:
        if feed.poll() is None:
            feed.kill()
        feed.wait()
        fifo.unlink()


def run(cell: Cell) -> Outcome:
    import torch

    from improving_learned_index_tpu_torch.core.config import IndexConfig
    from improving_learned_index_tpu_torch.index.indexer import Indexer

    cfg, tr = cell.config, cell.workload["traffic"]
    dev = torch.device(cell.device)
    length, rows = int(tr["max_length"]), int(tr["rows"])
    encoder_setup.build_kernels(dev)
    src = encoder_setup.source(cfg, tr)
    weights = encoder_setup.weights(cfg, cell.seed, dev, src)
    model = encoder_setup.model(cfg, weights, src.vocab, length, dev)
    indexer = Indexer(model, IndexConfig(max_length=length, max_terms=length, model_batch_size=rows,
                                         pack_sequences=True))

    warm = cell.tmpdir / "warm.tsv"
    warm.write_bytes(b"".join(collection_chunks(src.passages(int(tr["warm_passages"]), cell.seed, stream=1))))
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
        log(f"all {n} passages encoded before the window's end: raise max_rate")
    readings = {"window_s": t1 - t0, "window_docs": written}
    readings.update(traced(cell, indexer, src, length))
    profile, (p_ids, p_ends, p_lengths) = readings["profile"], readings.pop("profile_draw")
    metrics = {"device_us_per_doc": 1e6 * profile.busy_s / profile.units}
    if cell.trace:
        pieces = encoder_setup.pieces_table(src)
        tokens = src.token_counts(ids, ends, lengths, pieces, length)[:written]
        readings.update({"window_tokens": tokens.tolist(), "config": cfg,
                         "profile_tokens": src.token_counts(p_ids, p_ends, p_lengths, pieces, length).tolist()})
    peak = torch.cuda.max_memory_reserved() if dev.type == "cuda" else 0
    del indexer, model
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    every = int(cell.workload["check"]["sample_every"])
    rng = np.random.default_rng([int(cell.seed), 6])
    picks = set(np.nonzero(rng.random(written) < 1.0 / every)[0].tolist())
    block = every * 8
    for lo in range(0, written, block):  # the longest passage of each stretch too
        picks.add(max(range(lo, min(lo + block, written)), key=lambda i: lengths[i]))
    picks = sorted(picks)
    got = encoder_setup.read_lines(out, picks)
    want = reference_impacts(cfg, weights, src.vocab, [texts[i] for i in picks], length, dev)
    gaps = encoder_setup.impact_gaps(got, dict(zip(picks, want)))
    log(f"{written} passages in {t1 - t0:.3f} s ({fed} fed, {written / (t1 - t0):.4f} docs/s); "
        f"profiled: {profile.units} passages, the card busy {profile.busy_s:.6f} s of {profile.window_s:.3f}; "
        f"{len(picks)} checked: {gaps}")
    checks = [Check(name, gaps[name], cell.limit(name)) for name in ("term_lists_differ", "impact_gap_max",
                                                                      "impact_gap_mean")]
    return Outcome(attempted=fed, failed=fed - written, metrics=metrics, checks=checks,
                   memory_peak_bytes=int(peak), readings=readings)


def reference_impacts(cfg, weights, vocab, texts, length, device, fp8: bool = False):
    from ..reference.encoder import term_impacts
    from ..reference.tokenizer import Tokenizer

    return term_impacts(weights, cfg, Tokenizer(vocab), texts, length, device, fp8=fp8)


def traced(cell: Cell, indexer, src, length: int) -> dict:
    """One profiled ``index_to_file`` over a fixed file of the mix after
    the window (busy time, breakdown, attention time), and the draw of its
    passages, whose real tokens a traced run counts."""
    from ..harness.trace import Window

    texts, ids, ends, lengths = src.draw(int(cell.workload["traffic"]["trace_passages"]), cell.seed, stream=2)
    path = cell.tmpdir / "trace.tsv"
    path.write_bytes(b"".join(collection_chunks(texts)))
    with Window() as w:
        indexer.index_to_file(path, cell.tmpdir / "trace.forward.txt")
    w.profile.units = len(texts)
    return {"profile": w.profile, "profile_draw": (ids, ends, lengths)}
