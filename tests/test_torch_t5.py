"""The port's T5/mT5 route (model, sampler, query generator, ``cli.expand
--t5``) against the JAX package on the CPU.

The same numpy-seeded inputs and the JAX parameter tree (carried across with
``t5_flax_params_to_port``) go through both, at the tiny config (gated and
untied, as mT5; ReLU and tied, as T5 v1.0).  Tolerances:

- relative-position buckets, for every relative position in [-4096, 4096]
  in both directions: equal;
- fp32 logits (encode, teacher-forced decode, cached decode): within 1e-4
  absolute (logits up to ~4; only the fp32 summation order differs);
- bf16 logits: within 0.1 absolute (XLA's CPU fusions keep some bf16
  intermediates in fp32 where torch rounds each op: ~2% of the logits'
  scale over two layers), the fp32 encoder output within 0.05;
- greedy tokens with fp32, int8 and int4 trees (each package quantizes the
  same fp32 tree; the quantized bytes are held equal), greedy queries and
  the greedy ``cli.expand --t5`` file: equal, in fp32 compute (a random
  tiny model's bf16 logits hold near-ties that either package's rounding
  flips).  The CLI's bf16 default runs too and writes every row.

The JAX outputs are computed once per module (``jax_ref``).
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_learned_index_tpu.cli import expand as jcli
from improving_learned_index_tpu.core.config import GenerationConfig as JaxGen
from improving_learned_index_tpu.expand import t5_generate as jgen
from improving_learned_index_tpu.models import quantization as jq
from improving_learned_index_tpu.models import t5 as jt5
from improving_learned_index_tpu_torch.cli.expand import main as expand_main
from improving_learned_index_tpu_torch.core.config import GenerationConfig
from improving_learned_index_tpu_torch.expand import t5_generate as tgen
from improving_learned_index_tpu_torch.models import quantization as tq
from improving_learned_index_tpu_torch.models.llama import _flat
from improving_learned_index_tpu_torch.models import t5 as tt5

REPO = Path(__file__).resolve().parent.parent
# mT5's layout (gated-GELU, untied fp32 head) and T5 v1.0's (ReLU, tied head)
VARIANTS = {"gated": dict(gated_act=True, tie_word_embeddings=False),
            "relu_tied": dict(gated_act=False, tie_word_embeddings=True)}
GREEDY = dict(num_return_sequences=1, max_new_tokens=6, do_sample=False)


def jax_config(variant, dtype):
    return dataclasses.replace(jt5.T5Config.tiny(), dtype=dtype, **VARIANTS[variant])


def port_config(cfg):
    return tt5.T5Config(**dataclasses.asdict(cfg))


def inputs(seed=0):
    """Two encoder rows (the second padded past 7 tokens) and decoder ids
    starting with the decoder-start id 0."""
    rng = np.random.default_rng(seed)
    enc = rng.integers(2, 256, (2, 9)).astype(np.int32)
    mask = np.ones_like(enc)
    mask[1, 7:] = 0
    dec = rng.integers(2, 256, (2, 5)).astype(np.int32)
    dec[:, 0] = 0
    return enc, mask, dec


def long(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.long)


class ByteTok:
    """Bytes as ids 2..251, EOS (1) appended, as a T5 tokenizer appends it."""

    def encode(self, t):
        return [b % 250 + 2 for b in t.encode()[:50]] + [1]

    def decode(self, ids):
        return bytes((i - 2) % 256 for i in ids if i >= 2).decode("utf-8", "ignore")


DOCS = ["some document text", "another doc", "rivers run to the sea"]


@pytest.fixture(scope="module")
def jax_ref():
    """JAX params and outputs for every variant and dtype, computed once."""
    ref = {}
    enc, mask, dec = inputs()
    for v_i, variant in enumerate(VARIANTS):
        for dtype in ("float32", "bfloat16"):
            cfg = jax_config(variant, dtype)
            params = jax.device_get(jt5.init_t5_params(cfg, jax.random.PRNGKey(v_i)))
            model = jt5.T5Model(cfg)
            enc_out = model.apply({"params": params}, jnp.asarray(enc), jnp.asarray(mask), method=jt5.T5Model.encode)
            full = model.apply({"params": params}, jnp.asarray(enc), jnp.asarray(mask), jnp.asarray(dec))
            cross = model.apply({"params": params}, enc_out, method=jt5.T5Model.compute_cross_kvs)
            caches = jt5.make_t5_kv_caches(cfg, 2, 6)
            steps = []
            for t in range(dec.shape[1]):
                logits, caches = model.apply({"params": params}, jnp.asarray(dec[:, t:t + 1]), enc_out,
                                             jnp.asarray(mask), kv_caches=caches, cache_index=t, cross_kvs=cross,
                                             method=jt5.T5Model.decode)
                steps.append(np.asarray(logits[:, 0]))
            ref[variant, dtype] = dict(cfg=cfg, params=params, enc=np.asarray(enc_out), full=np.asarray(full),
                                       cross=[tuple(np.asarray(a, np.float32) for a in kv) for kv in cross],
                                       steps=np.stack(steps, 1))
    # greedy sampling in fp32 with fp32, int8 and int4 trees
    cfg = ref["gated", "float32"]["cfg"]
    fp = ref["gated", "float32"]["params"]
    trees = {"fp32": fp, "int8": jq.quantize_params_int8(fp), "int4": jq.quantize_params_int4(fp)}
    sampler = jgen.T5Sampler(cfg, JaxGen(**GREEDY), decoder_start_token_id=0, eos_token_id=1)
    ref["greedy"] = {k: sampler.generate(t, enc, mask) for k, t in trees.items()}
    ref["trees"] = trees
    # EOS: the first token row 0 draws at a step >= 1 that it had not drawn
    # before (so row 0 ends there; EOS 1 is never drawn by this model)
    row = ref["greedy"]["fp32"][0]
    step = next(k for k in range(1, len(row)) if row[k] not in row[:k])
    eos = int(row[step])
    ref["eos"], ref["eos_step"] = eos, step
    eos_sampler = jgen.T5Sampler(cfg, JaxGen(**GREEDY), decoder_start_token_id=0, eos_token_id=eos)
    ref["greedy_eos"] = eos_sampler.generate(fp, enc, mask)
    ref["greedy_eos_one_row"] = eos_sampler.generate(fp, enc[:1], mask[:1])
    # the query generator, 2 greedy returns a document
    qg = jgen.T5QueryGenerator(fp, cfg, ByteTok(), JaxGen(num_return_sequences=2, max_new_tokens=6,
                                                          do_sample=False, max_tokens=12))
    ref["queries"] = qg.generate(DOCS, seed=1)
    return ref


def port_tree(ref, variant, dtype):
    r = ref[variant, dtype]
    return port_config(r["cfg"]), tt5.t5_flax_params_to_port(r["params"], port_config(r["cfg"]))


def test_relative_position_buckets_equal_jax():
    rel = np.arange(-4096, 4097, dtype=np.int32)
    for bidirectional in (True, False):
        for nb, md in ((32, 128), (8, 16)):
            want = np.asarray(jt5.relative_position_bucket(jnp.asarray(rel), bidirectional, nb, md))
            got = tt5.relative_position_bucket(torch.as_tensor(rel), bidirectional, nb, md)
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)
    # the host table the model uses: queries at 5.., keys at 0..
    want = jt5.relative_position_bucket(jnp.arange(40)[None, :] - jnp.arange(5, 8)[:, None], False, 32, 128)
    np.testing.assert_array_equal(tt5._bucket_table(5, 3, 40, False, 32, 128).numpy(), np.asarray(want))


def test_flax_tree_carries_across(jax_ref):
    """Leaf for leaf, with the flax names and layouts; a tree of another
    config is refused."""
    for variant in VARIANTS:
        cfg, tree = port_tree(jax_ref, variant, "float32")
        params = jax_ref[variant, "float32"]["params"]
        for path, leaf in jax.tree_util.tree_leaves_with_path(params):
            node = tree
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        shapes = jax.tree_util.tree_map(lambda x: tuple(x.shape), params)
        assert tt5._map_shapes(lambda p, s: s, tt5.t5_param_shapes(cfg)) == shapes
        with pytest.raises((KeyError, ValueError)):
            tt5.t5_flax_params_to_port(params, dataclasses.replace(cfg, d_ff=96))
    # the tied variant has no lm_head; the gated one has wi_0/wi_1
    assert "lm_head" not in jax_ref["relu_tied", "float32"]["params"]
    assert set(jax_ref["gated", "float32"]["params"]["encoder_layer_0"]["ff"]) == {"wi_0", "wi_1", "wo"}


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_and_teacher_forced_logits_equal_jax(jax_ref, variant, dtype):
    cfg, tree = port_tree(jax_ref, variant, dtype)
    r = jax_ref[variant, dtype]
    enc, mask, dec = inputs()
    model = tt5.T5Model(cfg, device="meta")
    with torch.no_grad():
        enc_out = model.encode(long(enc), long(mask), params=tree)
        full = model(long(enc), long(mask), long(dec), params=tree)
        cross = model.compute_cross_kvs(enc_out, params=tree)
    assert enc_out.dtype == torch.float32 and full.dtype == torch.float32
    tol_enc, tol = (1e-4, 1e-4) if dtype == "float32" else (0.05, 0.1)
    np.testing.assert_allclose(enc_out.numpy(), r["enc"], atol=tol_enc, rtol=0)
    np.testing.assert_allclose(full.numpy(), r["full"], atol=tol, rtol=0)
    for (k, v), (jk, jv) in zip(cross, r["cross"]):
        assert k.dtype == tt5.compute_dtype(cfg)
        np.testing.assert_allclose(k.float().numpy(), jk, atol=tol_enc * 4, rtol=0)
        np.testing.assert_allclose(v.float().numpy(), jv, atol=tol_enc * 4, rtol=0)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cached_decode_equals_jax_and_teacher_forcing(jax_ref, variant, dtype):
    """Step by step through the cache (cross K/V precomputed): each step's
    logits equal JAX's cached step, and in fp32 the port's teacher-forced
    logits at that position."""
    cfg, tree = port_tree(jax_ref, variant, dtype)
    r = jax_ref[variant, dtype]
    enc, mask, dec = inputs()
    model = tt5.T5Model(cfg, device="meta")
    with torch.no_grad():
        enc_out = model.encode(long(enc), long(mask), params=tree)
        cross = model.compute_cross_kvs(enc_out, params=tree)
        caches = tt5.make_t5_kv_caches(cfg, 2, 6)
        steps = []
        for t in range(dec.shape[1]):
            logits, caches = model.decode(long(dec[:, t:t + 1]), enc_out, long(mask), kv_caches=caches,
                                          cache_index=t, cross_kvs=cross, params=tree)
            steps.append(logits[:, 0])
        steps = torch.stack(steps, 1).numpy()
        full = model(long(enc), long(mask), long(dec), params=tree).numpy()
    np.testing.assert_allclose(steps, r["steps"], atol=1e-4 if dtype == "float32" else 0.1, rtol=0)
    if dtype == "float32":
        np.testing.assert_allclose(steps, full, atol=1e-4, rtol=0)
    assert caches[0][0].shape == (2, 6, cfg.num_heads, cfg.d_kv)


def test_quantized_trees_equal_jax(jax_ref):
    """Each package quantizes the same fp32 tree: the same bytes; the
    embeddings (the shared one and both position-bias tables) and the norm
    scales stay fp32."""
    fp = jax_ref["gated", "float32"]["params"]
    for name, tq_fn in (("int8", tq.quantize_params_int8), ("int4", tq.quantize_params_int4)):
        ours = tq_fn(tt5.t5_flax_params_to_port(fp))
        theirs = jax_ref["trees"][name]
        for path, leaf in jax.tree_util.tree_leaves_with_path(theirs):
            node = ours
            for p in path:
                node = node[p.key]
            np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
        for table in ("shared", "encoder_rel_bias", "decoder_rel_bias"):
            assert isinstance(ours[table]["embedding"], torch.Tensor)
        assert set(ours["lm_head"]["kernel"]) in ({"q", "s"}, {"q4", "s"})


@pytest.mark.parametrize("tree", ["fp32", "int8", "int4"])
def test_greedy_sampler_tokens_equal_jax(jax_ref, tree):
    cfg = port_config(jax_ref["gated", "float32"]["cfg"])
    params = tt5.t5_flax_params_to_port(jax_ref["trees"][tree])
    enc, mask, _ = inputs()
    got = tgen.T5Sampler(cfg, GenerationConfig(**GREEDY)).generate(params, enc, mask)
    assert got.dtype == np.int32 and got.shape == (2, GREEDY["max_new_tokens"])
    np.testing.assert_array_equal(got, jax_ref["greedy"][tree])


def test_eos_buffer_and_early_stop(jax_ref, monkeypatch):
    """The buffer starts as EOS, a finished row is forced to EOS, and the loop
    stops once every row has finished (JAX's tokens with the same EOS id)."""
    cfg = port_config(jax_ref["gated", "float32"]["cfg"])
    params = tt5.t5_flax_params_to_port(jax_ref["trees"]["fp32"])
    enc, mask, _ = inputs()
    eos, k = jax_ref["eos"], jax_ref["eos_step"]
    sampler = tgen.T5Sampler(cfg, GenerationConfig(**GREEDY), decoder_start_token_id=0, eos_token_id=eos)
    got = sampler.generate(params, enc, mask)
    np.testing.assert_array_equal(got, jax_ref["greedy_eos"])
    assert (got[0, k:] == eos).all() and (got[0, :k] != eos).all()
    steps = []
    decode = sampler.module.decode
    monkeypatch.setattr(sampler.module, "decode", lambda *a, **k: steps.append(k["cache_index"]) or decode(*a, **k))
    one = sampler.generate(params, enc[:1], mask[:1])
    np.testing.assert_array_equal(one, jax_ref["greedy_eos_one_row"])
    assert steps == list(range(k + 1))  # stopped after the step that drew EOS
    np.testing.assert_array_equal(one[0, k:], eos)  # past it never drawn: the EOS-filled buffer
    # the decoder is fed the start id, then each step's token
    fed = []
    monkeypatch.setattr(sampler.module, "decode",
                        lambda ids, *a, **kw: fed.append(int(ids[0, 0])) or decode(ids, *a, **kw))
    sampler.generate(params, enc[:1], mask[:1])
    assert fed == [0, *one[0, :k].tolist()]


def test_seeded_sampling_is_reproducible(jax_ref):
    cfg = port_config(jax_ref["gated", "bfloat16"]["cfg"])
    params = tq.quantize_params_int8(tt5.t5_flax_params_to_port(jax_ref["gated", "bfloat16"]["params"]))
    enc, mask, _ = inputs()
    sampler = tgen.T5Sampler(cfg, GenerationConfig(num_return_sequences=3, max_new_tokens=5, top_k=8, top_p=0.9))
    a = sampler.generate(params, enc, mask, num_return_sequences=3, seed=3)
    b = sampler.generate(params, enc, mask, num_return_sequences=3, seed=3)
    assert a.shape == (6, 5) and a.min() >= 0 and a.max() < cfg.vocab_size
    np.testing.assert_array_equal(a, b)


def test_query_generator_greedy_equals_jax(jax_ref):
    cfg = port_config(jax_ref["gated", "float32"]["cfg"])
    params = tt5.t5_flax_params_to_port(jax_ref["gated", "float32"]["params"])
    gen = GenerationConfig(num_return_sequences=2, max_new_tokens=6, do_sample=False, max_tokens=12)
    qg = tgen.T5QueryGenerator(params, cfg, ByteTok(), gen, device="cpu")
    ids, mask = qg.tokenize(DOCS)
    assert ids.shape == (3, 12) and mask[1].sum() == len(ByteTok().encode(DOCS[1]))
    got = qg.generate(DOCS, seed=1)
    assert got == jax_ref["queries"]
    assert all(len(q) == 2 for q in got)


def _hf_t5(variant, vocab_size, seed=0):
    """A seeded tiny ``T5ForConditionalGeneration`` (``chip_smoke``'s
    builder)."""
    pytest.importorskip("transformers")
    from chip_smoke import hf_t5_model

    return hf_t5_model(dataclasses.replace(tt5.T5Config.tiny(vocab_size), **VARIANTS[variant]), seed, "cpu")


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_hf_t5_to_port_equals_hf_t5_to_flax(variant):
    """The HF conversion gives ``hf_t5_to_flax``'s tree leaf for leaf, and
    the port's fp32 logits equal the HF model's."""
    hf = _hf_t5(variant, 256)
    cfg = dataclasses.replace(tt5.T5Config.tiny(), dtype="float32", **VARIANTS[variant])
    sd = hf.state_dict()
    ours = tt5.hf_t5_to_port(sd, cfg)
    theirs = jt5.hf_t5_to_flax(sd, jt5.T5Config(**dataclasses.asdict(cfg)))
    leaves = jax.tree_util.tree_leaves_with_path(theirs)
    assert len(leaves) == len(_flat(ours))
    for path, leaf in leaves:
        np.testing.assert_array_equal(_flat(ours)[".".join(p.key for p in path)].numpy(), leaf)
    enc, mask, dec = inputs(1)
    with torch.no_grad():
        want = hf(input_ids=long(enc), attention_mask=long(mask), decoder_input_ids=long(dec)).logits.numpy()
        got = tt5.T5Model(cfg, device="meta")(long(enc), long(mask), long(dec), params=ours).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4, rtol=5e-4)


@pytest.mark.parametrize("table", ["encoder.embed_tokens.weight", "decoder.embed_tokens.weight"])
def test_hf_t5_to_port_refuses_input_embeddings_apart_from_shared(table):
    """The port embeds both stacks with ``shared.weight``; a state dict
    whose stack table holds other values (``transformers`` 5 keeps such
    tables untied) is refused, and one whose tables equal it is read."""
    hf = _hf_t5("gated", 256)
    cfg = dataclasses.replace(tt5.T5Config.tiny(), dtype="float32", **VARIANTS["gated"])
    sd = dict(hf.state_dict())
    sd[table] = sd["shared.weight"].clone()
    assert torch.equal(tt5.hf_t5_to_port(sd, cfg)["shared"]["embedding"], sd["shared.weight"])
    sd[table] = sd["shared.weight"] + 1e-3
    with pytest.raises(ValueError, match=table):
        tt5.hf_t5_to_port(sd, cfg)


def _offline(monkeypatch):
    import huggingface_hub.constants as hc

    monkeypatch.setenv("HF_HUB_OFFLINE", "1")
    monkeypatch.setenv("TRANSFORMERS_OFFLINE", "1")
    monkeypatch.setattr(hc, "HF_HUB_OFFLINE", True)


def write_hf_t5_dir(path: Path, words, seed: int = 0) -> None:
    """A local HF T5 directory (``chip_smoke``'s writer): a seeded tiny
    mT5-layout model and a word-level fast tokenizer (pad 0, EOS 1 appended
    to every text, unk 2)."""
    pytest.importorskip("transformers")
    from chip_smoke import write_hf_t5

    write_hf_t5(path, tt5.T5Config.tiny(vocab_size=len(words) + 3), words, seed, "cpu")


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("hf_t5")
    words = sorted({w for t in DOCS for w in t.split()} | {"query", "terms", "of", "a"})
    mp = pytest.MonkeyPatch()
    _offline(mp)
    write_hf_t5_dir(d / "hf", words)
    (d / "c.tsv").write_text("".join(f"d{i}\t{t}\n" for i, t in enumerate(DOCS)) + "\n")
    yield d, mp
    mp.undo()


def test_load_hf_t5_reads_a_local_directory(hf_dir):
    d, _ = hf_dir
    params, cfg, tok, ids = tt5.load_hf_t5(str(d / "hf"))
    assert cfg == dataclasses.replace(tt5.T5Config.tiny(vocab_size=cfg.vocab_size), dtype="bfloat16")
    assert ids == {"pad_token_id": 0, "eos_token_id": 1, "decoder_start_token_id": 0}
    assert tok.encode(DOCS[1]) == [*tok.tok.convert_tokens_to_ids(DOCS[1].split()), 1]
    assert tok.decode(tok.encode(DOCS[1])) == DOCS[1]


def test_load_hf_t5_reads_the_tie_flag_of_config_json(hf_dir, monkeypatch):
    """``transformers`` 5 reports ``tie_word_embeddings=True`` for every T5
    config (the checkpoint's own flag survives as ``scale_decoder_outputs``):
    ``load_hf_t5`` takes the flag from ``config.json``, so an mT5 directory
    keeps its untied head whatever the version."""
    import transformers

    d, _ = hf_dir
    real = transformers.AutoConfig.from_pretrained

    def forced(*args, **kwargs):
        config = real(*args, **kwargs)
        config.tie_word_embeddings = True
        return config

    monkeypatch.setattr(transformers.AutoConfig, "from_pretrained", forced)
    assert transformers.AutoConfig.from_pretrained(str(d / "hf")).tie_word_embeddings
    params, cfg, _, _ = tt5.load_hf_t5(str(d / "hf"))
    assert not cfg.tie_word_embeddings and "lm_head" in params


def test_load_hf_t5_refuses_a_model_with_its_own_input_embeddings(hf_dir, monkeypatch):
    """A directory that ``transformers`` loads with an encoder table apart
    from ``shared`` (as version 5 does when the checkpoint's tables
    differ) would run another model than the port's: ``load_hf_t5``
    refuses it."""
    import transformers

    d, _ = hf_dir
    real = transformers.T5ForConditionalGeneration.from_pretrained

    def untied(*args, **kwargs):
        model = real(*args, **kwargs)
        model.encoder.embed_tokens = torch.nn.Embedding(*model.shared.weight.shape)
        return model

    monkeypatch.setattr(transformers.T5ForConditionalGeneration, "from_pretrained", untied)
    with pytest.raises(ValueError, match="encoder.embed_tokens"):
        tt5.load_hf_t5(str(d / "hf"))


def test_cli_expand_t5_greedy_file_equals_jax(hf_dir, tmp_path, monkeypatch):
    """``cli.expand --t5 DIR --greedy`` writes the JAX CLI's file byte for
    byte, in fp32 compute (``T5Config``'s default dtype switched to float32
    in both packages for this comparison: see the module docstring), with
    ``--int8`` too; with the bf16 default it writes every row."""
    from improving_learned_index_tpu.models import t5 as jt5_mod

    d, _ = hf_dir
    args = ["--collection_path", str(d / "c.tsv"), "--t5", str(d / "hf"), "--greedy", "--num_return_sequences",
            "2", "--max_new_tokens", "5", "--batch_size", "2"]
    bf16 = tmp_path / "bf16.jsonl"
    assert expand_main(args + ["--output_path", str(bf16), "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in bf16.read_text().splitlines()]
    assert [r["doc_id"] for r in rows] == ["d0", "d1", "d2"] and all(len(r["queries"]) == 2 for r in rows)
    for cls_owner in (jt5_mod, tt5):
        base = cls_owner.T5Config
        monkeypatch.setattr(cls_owner, "T5Config", dataclasses.make_dataclass(
            "T5Config", [("dtype", str, dataclasses.field(default="float32"))], bases=(base,), frozen=True))
    for extra in ([], ["--int8"]):
        ours, theirs = tmp_path / f"port{len(extra)}.jsonl", tmp_path / f"jax{len(extra)}.jsonl"
        assert expand_main(args + extra + ["--output_path", str(ours), "--device", "cpu"]) == 0
        assert jcli.main(args + extra + ["--output_path", str(theirs)]) == 0
        assert ours.read_bytes() == theirs.read_bytes()
        assert len(ours.read_text().splitlines()) == len(DOCS)


def test_cli_expand_module_entry_reaches_t5_route(tmp_path):
    """``python -m ...cli.expand --t5 <missing dir>`` reaches the T5 route:
    it fails on the missing directory (local files only), not on the
    module's layout."""
    coll = tmp_path / "c.tsv"
    coll.write_text("d0\tdoc\n")
    env = dict(os.environ, HF_HUB_OFFLINE="1", TRANSFORMERS_OFFLINE="1", PYTHONPATH=str(REPO))
    proc = subprocess.run(
        [sys.executable, "-m", "improving_learned_index_tpu_torch.cli.expand", "--collection_path", str(coll),
         "--output_path", str(tmp_path / "o.jsonl"), "--t5", str(tmp_path / "no_such_model"), "--device", "cpu"],
        capture_output=True, text=True, timeout=300, cwd=str(REPO), env=env)
    assert proc.returncode != 0
    assert "NameError" not in proc.stderr and "load_hf_t5" in proc.stderr, proc.stderr[-2000:]
    assert not (tmp_path / "o.jsonl").exists()
