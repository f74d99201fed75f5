"""The port's doc2query generation, merge and local generators against the
JAX package on the CPU.

A tiny fp32 decoder over a word vocabulary (the JAX tree carried across).
Under greedy decoding the expansion JSONL (resumed mid-way, with a blank
input line) and ``cli.merge``'s output are byte-equal to the JAX package's;
prompts (document truncation, 64-token buckets) are equal; a local
generator written by either package loads in the other with equal params,
and the same fp32 tree gives the same ``params.msgpack`` bytes; a local HF
Llama directory loads as the JAX conversion reads it.  The JAX
expansion is computed once per module (``jax_side``).
"""

import dataclasses
import json

import jax
import numpy as np
import pytest

from improving_learned_index_tpu.cli.merge import main as jax_merge_main
from improving_learned_index_tpu.core.config import GenerationConfig as JaxGen
from improving_learned_index_tpu.expand import generate as jgen
from improving_learned_index_tpu.models import llama as jl
from improving_learned_index_tpu.utils import text_utils as jtext
from improving_learned_index_tpu_torch.cli.expand import main as expand_main
from improving_learned_index_tpu_torch.cli.merge import main as merge_main
from improving_learned_index_tpu_torch.core.config import GenerationConfig
from improving_learned_index_tpu_torch.expand import generate as tgen
from improving_learned_index_tpu_torch.models import llama as tl
from improving_learned_index_tpu_torch.text import ImpactTokenizer, WordPieceVocab
from improving_learned_index_tpu_torch.utils import text_utils as ttext

DOCS = [
    ("d1", "the quick brown fox jumps over the lazy dog"),
    ("d2", "rivers run to the sea and the sea is wide"),
    ("d3", "a long passage " + " ".join(f"word{i}" for i in range(40))),
    ("d4", "cats sleep all day in the warm sun"),
    ("d5", "search engines rank passages by learned term impacts"),
]
GEN = dict(num_return_sequences=2, max_new_tokens=6, do_sample=False, max_tokens=24)


def _collection(path):
    lines = [f"{i}\t{d}\n" for i, d in DOCS]
    lines.insert(2, "\n")  # a blank line is skipped and never counted
    path.write_text("".join(lines))
    return path


@pytest.fixture(scope="module")
def jax_side(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_expand")
    words = sorted({w for _, t in DOCS for w in t.split()} | {"---", "Predict", "possible"})
    tok = jgen.WordTokenizer(words)
    cfg = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=tok.vocab_size), dtype="float32")
    params = jax.device_get(jl.init_llama_params(cfg, jax.random.PRNGKey(4)))
    generator = jgen.QueryGenerator(params, cfg, tok, JaxGen(**GEN))
    coll = _collection(d / "c.tsv")
    out = d / "exp.jsonl"
    jgen.generate_expansions(generator, coll, out, batch_size=2, num_docs=2)
    jgen.generate_expansions(generator, coll, out, batch_size=2)  # resume
    prompts = generator.prompt_and_tokenize([t for _, t in DOCS])
    jgen.save_local_generator(d / "gen", params, cfg, tok)
    return dict(tok=tok, cfg=cfg, params=params, jsonl=out.read_bytes(), prompts=prompts, gen_dir=d / "gen",
                dir=d)


def _port_generator(jax_side):
    cfg = tl.LlamaConfig(**dataclasses.asdict(jax_side["cfg"]))
    params = tl.llama_flax_params_to_port(jax_side["params"], cfg)
    return tgen.QueryGenerator(params, cfg, tgen.WordTokenizer(jax_side["tok"].words), GenerationConfig(**GEN),
                               device="cpu")


def test_prompts_equal_jax(jax_side):
    ids, mask = _port_generator(jax_side).prompt_and_tokenize([t for _, t in DOCS])
    assert ids.shape[1] == 24  # the long document is cut to the budget
    np.testing.assert_array_equal(ids, jax_side["prompts"][0])
    np.testing.assert_array_equal(mask, jax_side["prompts"][1])


def test_greedy_expansions_byte_equal_with_resume(jax_side, tmp_path):
    generator = _port_generator(jax_side)
    coll = _collection(tmp_path / "c.tsv")
    out = tmp_path / "exp.jsonl"
    assert tgen.generate_expansions(generator, coll, out, batch_size=2, num_docs=2) == 2
    assert tgen.generate_expansions(generator, coll, out, batch_size=2) == len(DOCS) - 2
    assert out.read_bytes() == jax_side["jsonl"]
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["doc_id"] for r in rows] == [i for i, _ in DOCS]
    assert all(len(r["queries"]) == 2 for r in rows)


def test_cli_merge_byte_equal(jax_side, tmp_path):
    corpus = [t for _, t in DOCS] + [" ".join(q for q in json.loads(line)["queries"])
                                     for line in jax_side["jsonl"].decode().splitlines()]
    WordPieceVocab.build(corpus, max_size=400, min_freq=1).save(tmp_path / "vocab.txt")
    coll = tmp_path / "c.tsv"
    coll.write_text("".join(f"{i}\t{d}\n" for i, d in DOCS))
    (tmp_path / "exp.jsonl").write_bytes(jax_side["jsonl"])
    args = ["--collection_path", str(coll), "--queries_path", str(tmp_path / "exp.jsonl"),
            "--vocab_path", str(tmp_path / "vocab.txt")]
    assert merge_main(args + ["--output_path", str(tmp_path / "port.tsv")]) == 0
    assert jax_merge_main(args + ["--output_path", str(tmp_path / "jax.tsv")]) == 0
    assert (tmp_path / "port.tsv").read_bytes() == (tmp_path / "jax.tsv").read_bytes()
    # the helper itself (the port's copy of utils.text_utils)
    tok = ImpactTokenizer(WordPieceVocab.load(tmp_path / "vocab.txt"), 128)
    qs = ["quick_fox river", "sea  of   words"]
    assert ttext.merge_document_and_queries("the fox\nran", qs, tok) == \
        jtext.merge_document_and_queries("the fox\nran", qs, tok)


def test_merge_doc_id_mismatch_raises(tmp_path):
    from improving_learned_index_tpu_torch.expand import merge_collection_and_expansions

    (tmp_path / "c.tsv").write_text("1\ta b\n")
    (tmp_path / "q.jsonl").write_text(json.dumps({"doc_id": "2", "queries": ["c"]}) + "\n")
    WordPieceVocab.build(["a b c"], max_size=32, min_freq=1).save(tmp_path / "v.txt")
    tok = ImpactTokenizer(WordPieceVocab.load(tmp_path / "v.txt"), 32)
    with pytest.raises(ValueError, match="mismatch"):
        merge_collection_and_expansions(tmp_path / "c.tsv", tmp_path / "q.jsonl", tmp_path / "o.tsv", tok)


def test_local_generators_cross_load(jax_side, tmp_path):
    """JAX-written -> port, port-written -> JAX; the same tree writes the
    same ``params.msgpack`` bytes."""
    params, cfg, tok = tgen.load_local_generator(jax_side["gen_dir"])
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jax_side["cfg"]) and tok.words == jax_side["tok"].words
    for path, leaf in jax.tree_util.tree_leaves_with_path(jax_side["params"]):
        node = params
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    tgen.save_local_generator(tmp_path / "gen", params, cfg, tok)
    assert (tmp_path / "gen" / "params.msgpack").read_bytes() == \
        (jax_side["gen_dir"] / "params.msgpack").read_bytes()
    assert (tmp_path / "gen" / "config.json").read_text() == (jax_side["gen_dir"] / "config.json").read_text()
    jparams, jcfg, jtok = jgen.load_local_generator(tmp_path / "gen")
    assert jcfg == jax_side["cfg"] and jtok.words == tok.words


def test_cli_expand_routes(jax_side, tmp_path, monkeypatch):
    """``--local_path`` (greedy) writes what the API writes; ``--tiny`` with
    int8 weights and an int8 cache runs; ``--t5`` on a local tiny HF T5
    directory runs and writes one line per document."""
    coll = _collection(tmp_path / "c.tsv")
    out = tmp_path / "cli.jsonl"
    assert expand_main(["--collection_path", str(coll), "--output_path", str(out), "--local_path",
                        str(jax_side["gen_dir"]), "--greedy", "--num_return_sequences", "2",
                        "--max_new_tokens", "6", "--max_tokens", "24", "--batch_size", "2",
                        "--device", "cpu"]) == 0
    assert out.read_bytes() == jax_side["jsonl"]
    tiny = tmp_path / "tiny.jsonl"
    assert expand_main(["--collection_path", str(coll), "--output_path", str(tiny), "--tiny", "--int8",
                        "--kv_quant", "int8", "--num_return_sequences", "3", "--max_new_tokens", "4",
                        "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in tiny.read_text().splitlines()]
    assert len(rows) == len(DOCS) and all(len(r["queries"]) == 3 for r in rows)
    pytest.importorskip("transformers")
    import huggingface_hub.constants as hc

    from test_torch_t5 import write_hf_t5_dir

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(hc, "HF_HUB_OFFLINE", True)
    write_hf_t5_dir(tmp_path / "t5", sorted({w for _, t in DOCS for w in t.split()}))
    t5 = tmp_path / "t5.jsonl"
    assert expand_main(["--collection_path", str(coll), "--output_path", str(t5), "--t5", str(tmp_path / "t5"),
                        "--num_return_sequences", "2", "--max_new_tokens", "4", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in t5.read_text().splitlines()]
    assert [r["doc_id"] for r in rows] == [i for i, _ in DOCS] and all(len(r["queries"]) == 2 for r in rows)


def test_sampled_generation_is_seeded(jax_side):
    """Sampling draws from the call's seed: the same seed, the same queries."""
    generator = _port_generator(jax_side)
    generator.gen = dataclasses.replace(generator.gen, do_sample=True, top_k=20, top_p=0.9)
    generator.sampler.gen = generator.gen
    docs = [t for _, t in DOCS[:2]]
    assert generator.generate(docs, seed=3) == generator.generate(docs, seed=3)


def test_hf_llama_directory_loads_as_jax_does(tmp_path, monkeypatch):
    """A local HF Llama directory (a seeded tiny ``LlamaForCausalLM`` and a
    word-level fast tokenizer, both saved here): ``load_hf_llama`` gives the
    JAX conversion's tree and config and the same token ids, and
    ``cli.expand --llama_path`` (int8 weights, a merged ``--peft_path``
    adapter) writes every row.  Local files only: the hub is switched off."""
    transformers = pytest.importorskip("transformers")
    import huggingface_hub.constants as hc
    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers

    from improving_learned_index_tpu_torch.expand.finetune import Doc2QueryFineTuner
    from improving_learned_index_tpu_torch.expand.lora import LoraConfig, lora_leaves

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(hc, "HF_HUB_OFFLINE", True)
    words = sorted({w for _, t in DOCS for w in t.split()})
    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, **{w: i + 3 for i, w in enumerate(words)}}
    tk = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tk.pre_tokenizer = pre_tokenizers.Whitespace()
    fast = transformers.PreTrainedTokenizerFast(tokenizer_object=tk, bos_token="<s>", eos_token="</s>",
                                                unk_token="<unk>", pad_token="<unk>")
    d = tmp_path / "hf"
    torch.manual_seed(0)
    hf_cfg = transformers.LlamaConfig(vocab_size=len(vocab), hidden_size=64, intermediate_size=128,
                                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                                      max_position_embeddings=128)
    transformers.LlamaForCausalLM(hf_cfg).save_pretrained(d)
    fast.save_pretrained(d)

    params, cfg, tok, eos = tl.load_hf_llama(str(d))
    want_cfg = jl.LlamaConfig(vocab_size=len(vocab), hidden_size=64, num_layers=2, num_heads=4, num_kv_heads=2,
                              intermediate_size=128, max_position_embeddings=128,
                              rms_norm_eps=hf_cfg.rms_norm_eps, rope_theta=getattr(hf_cfg, "rope_theta", 10000.0))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(want_cfg) and eos == 2
    with torch.no_grad():
        sd = transformers.LlamaForCausalLM.from_pretrained(d).state_dict()
    for path, leaf in jax.tree_util.tree_leaves_with_path(jl.hf_llama_to_flax(sd, want_cfg)):
        np.testing.assert_array_equal(tl._flat(params)[".".join(p.key for p in path)].numpy(), leaf)
    assert tok.encode(DOCS[0][1]) == fast.encode(DOCS[0][1])

    # cli.expand --peft_path merges with the default LoraConfig (r=16, alpha=32)
    ft = Doc2QueryFineTuner(params, cfg, tok, lora_config=LoraConfig(), device="cpu", seed=1)
    with torch.no_grad():
        for t in lora_leaves(ft.lora):
            t.add_(0.01)
    ft.save_adapter(tmp_path / "adapter.msgpack")
    coll = _collection(tmp_path / "c.tsv")
    out = tmp_path / "hf.jsonl"
    assert expand_main(["--collection_path", str(coll), "--output_path", str(out), "--llama_path", str(d),
                        "--peft_path", str(tmp_path / "adapter.msgpack"), "--int8", "--greedy",
                        "--num_return_sequences", "2", "--max_new_tokens", "3", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["doc_id"] for r in rows] == [i for i, _ in DOCS] and all(len(r["queries"]) == 2 for r in rows)
