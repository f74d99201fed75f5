"""The traffic generators: the same seed gives the same inputs, another
seed the same amount of work in another order."""

from pathlib import Path

import numpy as np

from portbench.traffic.index import make_index, zipf_counts
from portbench.traffic.passages import TextSource, make_triples
from portbench.traffic.queries import make_queries

TINY = {"num_docs": 5000, "num_terms": 300, "num_postings": 60000, "impact_bits": 8, "zipf_s": 1.0}
MIX = {"zipf_s": 0.9, "lengths": {"2": 0.25, "3": 0.25, "6": 0.5}}
TEXT = {"words": 3000, "mean_words": 60, "query_words": [3, 8]}
BIG_SEED = 2**31 + 12345


def test_index_by_seed():
    a = make_index(TINY, BIG_SEED, "cpu")
    b = make_index(TINY, BIG_SEED, "cpu")
    c = make_index(TINY, BIG_SEED + 1, "cpu")
    assert all(np.array_equal(x, y) for x, y in zip(a, b))
    assert np.array_equal(a[0], c[0]) and not np.array_equal(a[1], c[1])
    offsets, docs, vals = a
    assert offsets[-1] == len(docs) and vals.min() >= 1
    for t in range(TINY["num_terms"]):
        d, v = docs[offsets[t]:offsets[t + 1]], vals[offsets[t]:offsets[t + 1]]
        assert len(np.unique(d)) == len(d) and d.max() < TINY["num_docs"]
        # impact-descending, doc-ascending among equal impacts
        key = (255 - v.astype(np.int64)) * TINY["num_docs"] + d
        assert np.all(np.diff(key) > 0)


def test_zipf_counts_sum():
    c = zipf_counts(300, 60000, 5000)
    assert abs(int(c.sum()) - 60000) < 300 and c.max() <= 5000


def test_queries_by_seed():
    terms = [f"t{i:05d}" for i in range(300)]
    a = make_queries(400, terms, MIX, BIG_SEED)
    assert a == make_queries(400, terms, MIX, BIG_SEED)
    b = make_queries(400, terms, MIX, BIG_SEED + 1)
    assert a != b
    assert sorted(map(len, a)) == sorted(map(len, b)) == sorted([2] * 100 + [3] * 100 + [6] * 200)
    assert all(len(set(q)) == len(q) for q in a)
    assert make_queries(400, terms, MIX, BIG_SEED, stream=1) != a


def test_passages_and_triples_by_seed():
    src = TextSource(1000, TEXT)
    a = src.passages(300, BIG_SEED)
    assert a == src.passages(300, BIG_SEED)
    b = src.passages(300, BIG_SEED + 1)
    assert a != b
    assert sorted(len(p.split()) for p in a) == sorted(len(p.split()) for p in b)
    q, t = make_triples(a, 150, TEXT, BIG_SEED)
    assert (q, t) == make_triples(a, 150, TEXT, BIG_SEED)
    assert len({d for _, p, n in t for d in (p, n)}) == 300
    assert all(3 <= len(x.split()) <= 8 and set(x.split()) <= {w.rstrip(".") for w in a[i].split()}
               for i, x in enumerate(q))


def test_feed_writes_the_file_until_its_deadline(tmp_path):
    """The feed process writes every line before a far deadline, and none
    after a deadline already past."""
    import os
    import subprocess
    import sys
    import threading
    import time

    feed = Path(__file__).parents[1] / "traffic" / "feed.py"
    src = tmp_path / "c.tsv"
    src.write_bytes(b"".join(f"{i}\tword {i}\n".encode() for i in range(1000)))
    for deadline, want in ((time.monotonic() + 600, src.read_bytes()), (0.0, b"")):
        fifo = tmp_path / "c.fifo"
        os.mkfifo(fifo)
        p = subprocess.Popen([sys.executable, str(feed), str(src), str(fifo), "64"], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE, text=True)
        assert p.stdout.readline().strip() == "ready"
        p.stdin.write(f"{deadline!r}\n")
        p.stdin.close()
        got = []
        reader = threading.Thread(target=lambda: got.append(fifo.read_bytes()))
        reader.start()
        reader.join(60)
        assert p.wait(60) == 0 and got == [want]
        assert int(p.stdout.read()) == want.count(b"\n")
        fifo.unlink()
