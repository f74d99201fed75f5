"""The yardstick's counts against shapes worked by hand."""

import json
from pathlib import Path

import pytest

from portbench.harness import roofline as r

BERT = json.loads((Path(__file__).resolve().parents[1] / "configs" / "deepimpact-bert-base.json").read_text())
H100 = "NVIDIA H100 80GB HBM3"


def test_query_bytes():
    # 2 hit rows of 1,000 docs in bf16, a 4 x 1,000 fp32 score matrix
    assert r.heavy_bytes(2, 4, 1000) == 2 * 1000 * 2 + 4 * 1000 * 4
    # 10 postings of 5 bytes, 3 sectors of 32 bytes read and written
    assert r.tail_bytes(10, 3) == 50 + 3 * 64
    assert r.topk_bytes(4, 1000) == 16000


def test_bound_takes_the_larger_side():
    assert r.bound_s(3.35e12, 0.0, H100) == pytest.approx(1.0)
    assert r.bound_s(0.0, 989e12, H100) == pytest.approx(1.0)
    assert r.bound_s(3.35e12, 2 * 989e12, H100) == pytest.approx(2.0)


def test_bert_base_parameters():
    # 12 x (4 x (768^2 + 768) + 2 x 768 x 3072 + 3072 + 768 + 4 x 768) + 2 x 768 + 769
    per_layer = 4 * (768 * 768 + 768) + (768 * 3072 + 3072) + (3072 * 768 + 768) + 4 * 768
    assert per_layer == 7087872
    p = r.encoder_params(BERT)
    assert p["non_embedding"] == 12 * per_layer + 2 * 768 + 769
    assert p["embedding"] == (30522 + 512 + 2) * 768


def test_encoder_flops_by_hand():
    n = r.encoder_params(BERT)["non_embedding"]
    assert r.encoder_flops([10, 20], BERT) == 2 * n * 30 + 4 * 768 * 12 * (100 + 400)


def test_attention_bound_by_hand():
    # 100 tokens: q, k, v and the context in bf16 at 768 wide, int32 segment ids
    bytes_moved = 100 * 768 * 2 * 4 + 100 * 4
    flops = 4 * 768 * 100 * 100
    assert r.attention_bound_s([100], BERT, H100) == pytest.approx(max(bytes_moved / 3.35e12, flops / 989e12))
