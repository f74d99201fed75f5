"""The port's Anserini export against the JAX package's: a text forward
index and a binary impact store (float and quantized), through the library
call and the CLI, byte-equal JSONL."""

import numpy as np
import pytest

from improving_learned_index_tpu.cli.convert_to_anserini import main as jax_main
from improving_learned_index_tpu.index.anserini import convert_to_anserini as jax_convert
from improving_learned_index_tpu_torch.cli.convert_to_anserini import main as port_main
from improving_learned_index_tpu_torch.index.anserini import convert_to_anserini
from improving_learned_index_tpu_torch.index.impact_store import (
    quantize_store,
    store_from_forward_text,
)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """A seeded forward index (empty documents and unicode terms
    included), its float store and its quantized store."""
    d = tmp_path_factory.mktemp("anserini")
    rng = np.random.default_rng(0)
    terms = [f"t{i}" for i in range(50)] + ["naïve", "café", "#hash", "a\"q"]
    lines = []
    for i in range(40):
        n = 0 if i % 13 == 5 else int(rng.integers(1, 12))
        picked = rng.choice(len(terms), n, replace=False)
        lines.append(", ".join(f"{terms[j]}: {round(float(rng.random() * 3), 3)}" for j in picked))
    (d / "fwd.txt").write_text("".join(l + "\n" for l in lines), encoding="utf-8")
    store_from_forward_text(d / "fwd.txt", d / "fwd.store")
    quantize_store(d / "fwd.store", d / "q.store")
    return d


@pytest.mark.parametrize("src", ["fwd.txt", "fwd.store", "q.store"])
def test_convert_matches_jax(tmp_path, inputs, src):
    n = convert_to_anserini(inputs / src, tmp_path / "port.jsonl")
    assert n == jax_convert(inputs / src, tmp_path / "jax.jsonl") == 40
    got = (tmp_path / "port.jsonl").read_bytes()
    assert got == (tmp_path / "jax.jsonl").read_bytes()
    assert got.count(b"\n") == 40


@pytest.mark.parametrize("src", ["fwd.txt", "q.store"])
def test_cli_matches_jax(tmp_path, inputs, src, capsys):
    assert port_main(["-i", str(inputs / src), "-o", str(tmp_path / "port.jsonl")]) == 0
    assert jax_main(["-i", str(inputs / src), "-o", str(tmp_path / "jax.jsonl")]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].replace("port.jsonl", "X") == out[1].replace("jax.jsonl", "X")
    assert (tmp_path / "port.jsonl").read_bytes() == (tmp_path / "jax.jsonl").read_bytes()


def test_text_and_store_routes_agree(tmp_path, inputs):
    """The float store gives the text route's lines."""
    convert_to_anserini(inputs / "fwd.txt", tmp_path / "a.jsonl")
    convert_to_anserini(inputs / "fwd.store", tmp_path / "b.jsonl")
    assert (tmp_path / "a.jsonl").read_bytes() == (tmp_path / "b.jsonl").read_bytes()
