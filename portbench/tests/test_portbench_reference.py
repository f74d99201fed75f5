"""Each reference against a brute-force computation at a tiny size."""

import math

import numpy as np
import torch

from portbench.reference.encoder import forward, make_weights, term_impacts
from portbench.reference.scoring import Scorer
from portbench.reference.tokenizer import Tokenizer
from portbench.reference.training import AdamW, step_loss_and_grads
from portbench.traffic.index import make_index
from portbench.traffic.passages import TextSource

TINY_INDEX = {"num_docs": 3000, "num_terms": 200, "num_postings": 30000, "impact_bits": 8, "zipf_s": 1.0}
TINY_BERT = {"vocab_size": 400, "hidden_size": 16, "num_hidden_layers": 2, "num_attention_heads": 2,
             "intermediate_size": 32, "max_position_embeddings": 64, "type_vocab_size": 2,
             "initializer_range": 0.3, "layer_norm_eps": 1e-12}


def test_scorer_against_a_loop():
    offsets, docs, vals = make_index(TINY_INDEX, 7, "cpu")
    scorer = Scorer(offsets, docs, vals, TINY_INDEX["num_docs"], "cpu")
    rng = np.random.default_rng(0)
    for _ in range(10):
        q = rng.choice(200, size=4, replace=False).tolist()
        scores = {}
        for t in q:
            for d, v in zip(docs[offsets[t]:offsets[t + 1]], vals[offsets[t]:offsets[t + 1]]):
                scores[int(d)] = scores.get(int(d), 0) + int(v)
        want = sorted(scores.items(), key=lambda dv: (-dv[1], dv[0]))[:50]
        assert scorer.topk(q, 50) == want
    control = Scorer(offsets, docs, vals, TINY_INDEX["num_docs"], "cpu", impact_bits=4)
    assert control.topk([0, 1], 50) != scorer.topk([0, 1], 50)


def test_tokenizer_by_hand():
    tok = Tokenizer(["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]", "a", "b", "c", "##a", "##b", "##c", ".",
                     "ab", "abc", "##bc"])
    ids, first = tok.document("ABC abca. cab", 8)
    # [CLS] abc | abc ##a | . | c ##a (##b cut to leave room for [SEP] at 8)
    assert ids == [2, 13, 13, 8, 11, 7, 8, 3]
    assert first == {"abc": 1, "abca": 2, "cab": 5}
    assert tok.query("abc, ab!") == {"abc", "ab"}


def naive_forward(w, cfg, ids, length):
    """One sequence, attention written as explicit sums."""
    h, heads = cfg["hidden_size"], cfg["num_attention_heads"]
    d = h // heads

    def ln(x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + cfg["layer_norm_eps"]) * w[name + ".weight"] + w[name + ".bias"]

    def lin(x, name):
        return x @ w[name + ".weight"].t() + w[name + ".bias"]

    e = "bert.embeddings"
    x = torch.stack([w[f"{e}.word_embeddings.weight"][ids[i]] + w[f"{e}.position_embeddings.weight"][i]
                     + w[f"{e}.token_type_embeddings.weight"][0] for i in range(length)])
    x = ln(x, f"{e}.LayerNorm")
    for layer in range(cfg["num_hidden_layers"]):
        p = f"bert.encoder.layer.{layer}"
        q, k, v = (lin(x, f"{p}.attention.self.{n}") for n in ("query", "key", "value"))
        ctx = torch.zeros(length, h)
        for hd in range(heads):
            sl = slice(hd * d, (hd + 1) * d)
            for i in range(length):
                logits = torch.tensor([float((q[i, sl] * k[j, sl]).sum()) / math.sqrt(d) for j in range(length)])
                p_ = torch.exp(logits - logits.max())
                p_ = p_ / p_.sum()
                ctx[i, sl] = sum(p_[j] * v[j, sl] for j in range(length))
        x = ln(x + lin(ctx, f"{p}.attention.output.dense"), f"{p}.attention.output.LayerNorm")
        inner = lin(x, f"{p}.intermediate.dense")
        inner = 0.5 * inner * (1 + torch.erf(inner / math.sqrt(2)))
        x = ln(x + lin(inner, f"{p}.output.dense"), f"{p}.output.LayerNorm")
    return torch.relu(lin(x, "impact_score_encoder.0"))[:, 0]


def test_encoder_against_explicit_sums():
    w = make_weights(TINY_BERT, 3, "cpu")
    rows = [[2, 10, 11, 12, 3], [2, 20, 3]]
    ids = torch.tensor([rows[0], rows[1] + [0, 0]])
    mask = torch.tensor([[True] * 5, [True] * 3 + [False] * 2])
    got = forward(w, TINY_BERT, ids, mask)
    for b, r in enumerate(rows):
        want = naive_forward(w, TINY_BERT, r, len(r))
        assert torch.allclose(got[b, :len(r)], want, atol=1e-5, rtol=1e-5)
    assert not torch.allclose(forward(w, TINY_BERT, ids, mask, fp8=True), got, atol=1e-4)


def test_training_gradient_against_finite_differences():
    src = TextSource(400, {"words": 500, "mean_words": 12})
    tok = Tokenizer(src.vocab)
    texts = src.passages(4, 5)
    triples = [(" ".join(texts[0].split()[:3]).replace(".", ""), texts[0], texts[1]),
               (" ".join(texts[2].split()[:3]).replace(".", ""), texts[2], texts[3])]
    cfg = dict(TINY_BERT, vocab_size=len(src.vocab))
    w = {k: v.double() for k, v in make_weights(cfg, 4, "cpu").items()}
    loss, grads = step_loss_and_grads(w, cfg, tok, triples, 64, "cpu")
    name = "bert.encoder.layer.1.output.dense.weight"
    for idx in [(0, 0), (3, 5), (7, 11)]:
        for sign, store in ((1, "plus"), (-1, "minus")):
            w2 = {k: v.clone() for k, v in w.items()}
            w2[name][idx] += sign * 1e-6
            locals()[store] = step_loss_and_grads(w2, cfg, tok, triples, 64, "cpu")[0]
        fd = (locals()["plus"] - locals()["minus"]) / 2e-6
        assert abs(fd - float(grads[name][idx])) <= 1e-6 + 1e-4 * abs(fd)


def test_adamw_against_torch():
    torch.manual_seed(0)
    p = torch.randn(5, 3)
    grads = [torch.randn(5, 3) for _ in range(3)]
    mine = {"p": p.clone()}
    opt = AdamW(1e-2, weight_decay=0.01)
    theirs = p.clone().requires_grad_(True)
    topt = torch.optim.AdamW([theirs], lr=1e-2, weight_decay=0.01)
    for g in grads:
        opt.step(mine, {"p": g.clone()})
        theirs.grad = g.clone()
        topt.step()
    assert torch.allclose(mine["p"], theirs.detach(), atol=1e-7)


def test_term_impacts_match_a_full_forward():
    src = TextSource(400, {"words": 500, "mean_words": 12})
    tok = Tokenizer(src.vocab)
    cfg = dict(TINY_BERT, vocab_size=len(src.vocab))
    w = make_weights(cfg, 4, "cpu")
    texts = src.passages(5, 9)
    got = term_impacts(w, cfg, tok, texts, 32, "cpu", rows=2)
    for text, row in zip(texts, got):
        ids, first = tok.document(text, 32)
        full = forward(w, cfg, torch.tensor([ids]), torch.ones(1, len(ids), dtype=torch.bool))[0]
        assert list(row) == list(first)
        assert all(abs(row[t] - float(full[p])) < 1e-5 for t, p in first.items())
