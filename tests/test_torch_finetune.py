"""The port's LoRA fine-tuning against the JAX package's on the CPU.

One tiny fp32 decoder (the JAX tree carried across), an int8 base, the
JAX adapters with B made non-zero copied into the port's fine-tuner.
Tolerances: the loss within 1e-5 relative of the JAX loss, each adapter
gradient within 1e-3 of its largest entry (fp32 summation order), the
adapters after one AdamW step within 1e-6 absolute (steps are ~lr = 2e-4);
the flash route's loss within 1e-2 relative of the XLA route's (the twin
rounds q, k, v and p to bf16).  Example building, collation and the CE are
equal.  The JAX side is computed once per module (``jax_side``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_learned_index_tpu.core.checkpoint import load_params as jax_load_params
from improving_learned_index_tpu.expand import finetune as jft
from improving_learned_index_tpu.expand import generate as jgen
from improving_learned_index_tpu.expand import lora as jlora
from improving_learned_index_tpu.models import llama as jl
from improving_learned_index_tpu.models import quantization as jq
from improving_learned_index_tpu_torch.cli.finetune import main as finetune_main
from improving_learned_index_tpu_torch.expand import finetune as tft
from improving_learned_index_tpu_torch.expand import generate as tgen
from improving_learned_index_tpu_torch.expand.lora import lora_leaves
from improving_learned_index_tpu_torch.models import llama as tl

CFG = dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=260), dtype="float32")
PAIRS = [("dogs are loyal pets and good friends", "loyal dog"), ("foxes are quick and brown", "quick fox"),
         ("the river runs to the sea", "river sea"), ("cats sleep all day long", "sleepy cats")]


class ByteTok:
    def encode(self, t):
        return [1] + [b % 250 + 4 for b in t.encode("utf-8")[:60]]

    def decode(self, ids):
        return bytes((i - 4) % 256 for i in ids if i >= 4).decode("utf-8", "ignore")


def port_cfg(**kw):
    return tl.LlamaConfig(**{**dataclasses.asdict(CFG), **kw})


_flat = tl._flat


def _set_adapters(ft, lora_np):
    with torch.no_grad():
        mine = _flat(ft.lora)
        for k, v in _flat(lora_np).items():
            mine[k].copy_(torch.from_numpy(np.asarray(v)))


@pytest.fixture(scope="module")
def jax_side():
    params = jax.device_get(jl.init_llama_params(CFG, jax.random.PRNGKey(0)))
    out = {"params": params}
    for variant in ("default", "trl_4bit"):
        make = jft.Doc2QueryFineTuner.trl_4bit if variant == "trl_4bit" else jft.Doc2QueryFineTuner
        kw = {} if variant == "trl_4bit" else {"quantize_base": "int8"}
        ft = make(params, CFG, ByteTok(), max_length=64, seed=1, **kw)
        rng = np.random.default_rng(2)
        lora = jax.tree_util.tree_map(lambda x: np.asarray(x) + 0.01 * rng.standard_normal(x.shape).astype(
            np.float32), jax.device_get(ft.lora))
        ft.lora = jax.tree_util.tree_map(jnp.asarray, lora)
        ft.opt_state = ft.tx.init(ft.lora)
        batch = ft.make_batch(PAIRS[:2])
        res = {"lora": lora, "batch": batch}
        for lw in (False, True):
            def f(l, lw=lw):
                if lw:
                    return jft.layerwise_lm_loss(CFG, ft.lora_config, l, ft.base_params, batch)
                base = jq.dequantize_params(ft.base_params, dtype=jnp.float32)
                logits, _ = ft.module.apply({"params": jlora.lora_forward_params(base, l, ft.lora_config)},
                                            batch["input_ids"], batch["attention_mask"])
                return jft.causal_lm_loss(logits, batch["labels"])
            loss, grads = jax.value_and_grad(f)(ft.lora)
            res[lw] = (float(loss), jax.device_get(grads))
        res["avg"] = ft.train(PAIRS, batch_size=2, total_steps=1)
        res["after"] = jax.device_get(ft.lora)
        out[variant] = res
    return out


def _port_ft(jax_side, variant, **kw):
    tparams = tl.llama_flax_params_to_port(jax_side["params"], port_cfg())
    make = tft.Doc2QueryFineTuner.trl_4bit if variant == "trl_4bit" else tft.Doc2QueryFineTuner
    base_kw = {} if variant == "trl_4bit" else {"quantize_base": "int8"}
    ft = make(tparams, kw.pop("config", port_cfg()), ByteTok(), max_length=64, seed=1, device="cpu",
              **base_kw, **kw)
    _set_adapters(ft, jax_side[variant]["lora"])
    return ft


@pytest.mark.parametrize("variant", ["default", "trl_4bit"])
@pytest.mark.parametrize("layerwise", [False, True])
def test_loss_and_adapter_grads_match_jax(jax_side, variant, layerwise):
    ft = _port_ft(jax_side, variant, layerwise=layerwise)
    batch = ft._to_device(jax_side[variant]["batch"])
    loss = ft.loss(batch)
    want_loss, want_grads = jax_side[variant][layerwise]
    assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    grads = torch.autograd.grad(loss, lora_leaves(ft.lora))
    mine = dict(zip(_flat(ft.lora), grads))
    for k, w in _flat(want_grads).items():
        w = np.asarray(w)
        np.testing.assert_allclose(mine[k].numpy(), w, rtol=0, atol=1e-3 * np.abs(w).max())


@pytest.mark.parametrize("variant", ["default", "trl_4bit"])
def test_one_adamw_step_matches_optax(jax_side, variant):
    """One ``train`` step (AdamW with the JAX default weight decay 1e-4, or
    the trl recipe's clip 0.3 and decay 0.001) moves the adapters as optax
    does; the base never changes."""
    ft = _port_ft(jax_side, variant)
    base_before = {k: v.clone() for k, v in _flat(ft.base_params).items()}
    avg = ft.train(PAIRS, batch_size=2, total_steps=1)
    assert abs(avg - jax_side[variant]["avg"]) <= 1e-5 * abs(avg)
    mine = _flat(ft.lora)
    for k, w in _flat(jax_side[variant]["after"]).items():
        np.testing.assert_allclose(mine[k].detach().numpy(), np.asarray(w), rtol=0, atol=1e-6)
    assert all(torch.equal(v, base_before[k]) for k, v in _flat(ft.base_params).items())
    assert ft.optimizer.param_groups[0]["weight_decay"] == (1e-3 if variant == "trl_4bit" else 1e-4)


def test_flash_route_loss_close_to_xla_route(jax_side):
    losses = []
    for flash in (False, True):
        ft = _port_ft(jax_side, "default", layerwise=True, config=port_cfg(use_flash_attention=True)
                      if flash else port_cfg())
        losses.append(float(ft.loss(ft._to_device(jax_side["default"]["batch"]))))
    assert abs(losses[1] - losses[0]) <= 1e-2 * abs(losses[0])


def test_examples_collate_and_loss_equal_jax():
    tok = ByteTok()
    for doc, q in PAIRS:
        for bos in (1, 5):
            assert tft.build_example(tok, doc, q, max_length=40, bos_token_id=bos) == \
                jft.build_example(tok, doc, q, max_length=40, bos_token_id=bos)
    ex = [tft.build_example(tok, d, q, max_length=64) for d, q in PAIRS]
    got, want = tft.collate_examples(ex, pad_token_id=0), jft.collate_examples(ex, pad_token_id=0)
    assert set(got) == set(want) and all(np.array_equal(got[k], want[k]) for k in want)
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(2, 6, 16)).astype(np.float32)
    labels = rng.integers(0, 16, (2, 6)).astype(np.int64)
    labels[0, :3] = tft.IGNORE_INDEX
    assert abs(float(tft.causal_lm_loss(torch.tensor(logits), torch.tensor(labels)))
               - float(jft.causal_lm_loss(logits, labels))) < 1e-6


def test_prequantized_params_rejected(jax_side):
    from improving_learned_index_tpu_torch.models.quantization import quantize_params_int8

    tparams = tl.llama_flax_params_to_port(jax_side["params"], port_cfg())
    with pytest.raises(ValueError, match="no LoRA targets"):
        tft.Doc2QueryFineTuner(quantize_params_int8(tparams), port_cfg(), ByteTok(), device="cpu")


def test_cli_finetune_tiny_and_local_generator(tmp_path, jax_side):
    """``cli.finetune --tiny`` writes an adapter and merged params that the
    JAX ``load_params`` reads; ``cli.expand --local_path`` over a
    JAX-written local generator with a JAX-written adapter (``--peft_path``)
    writes what the API writes from the port's merge of the two (greedy)."""
    from improving_learned_index_tpu.core.checkpoint import save_params as jax_save_params
    from improving_learned_index_tpu_torch.cli.expand import main as expand_main
    from improving_learned_index_tpu_torch.core.config import GenerationConfig
    from improving_learned_index_tpu_torch.expand.finetune import load_adapter
    from improving_learned_index_tpu_torch.expand.lora import LoraConfig, merge_lora

    pairs = tmp_path / "pairs.tsv"
    pairs.write_text("".join(f"{d}\t{q}\n" for d, q in PAIRS))
    assert finetune_main(["--dataset_path", str(pairs), "--output_adapter", str(tmp_path / "a.msgpack"),
                          "--output_merged", str(tmp_path / "m.msgpack"), "--tiny", "--device", "cpu",
                          "--total_steps", "1", "--batch_size", "2", "--max_length", "64"]) == 0
    base = jl.init_llama_params(jl.LlamaConfig.tiny(vocab_size=260), jax.random.PRNGKey(0))
    like = jlora.init_lora_params(base, jlora.LoraConfig(), jax.random.PRNGKey(0))
    restored = jax_load_params(tmp_path / "a.msgpack", like=like)
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(like)
    merged = jax_load_params(tmp_path / "m.msgpack", like=base)
    assert jax.tree_util.tree_structure(merged) == jax.tree_util.tree_structure(base)
    assert all(np.isfinite(np.asarray(x)).all() for x in jax.tree_util.tree_leaves(merged))

    words = sorted({w for d, q in PAIRS for w in (d + " " + q).split()})
    wt = jgen.WordTokenizer(words)
    cfg = dataclasses.replace(CFG, vocab_size=wt.vocab_size)
    jgen.save_local_generator(tmp_path / "gen", jl.init_llama_params(cfg, jax.random.PRNGKey(3)), cfg, wt)
    jax_save_params(tmp_path / "b.msgpack", jax_side["default"]["lora"])
    coll = tmp_path / "c.tsv"
    coll.write_text("".join(f"{i}\t{d}\n" for i, (d, _) in enumerate(PAIRS)))
    out = tmp_path / "cli.jsonl"
    assert expand_main(["--collection_path", str(coll), "--output_path", str(out), "--local_path",
                        str(tmp_path / "gen"), "--peft_path", str(tmp_path / "b.msgpack"), "--greedy",
                        "--num_return_sequences", "2", "--max_new_tokens", "4", "--device", "cpu"]) == 0
    params, config, tok = tgen.load_local_generator(tmp_path / "gen")
    assert config == port_cfg(vocab_size=wt.vocab_size) and tok.words == words
    merged = merge_lora(params, load_adapter(tmp_path / "b.msgpack"), LoraConfig())
    api = tgen.QueryGenerator(merged, config, tok, GenerationConfig(num_return_sequences=2, max_new_tokens=4,
                                                                    do_sample=False), device="cpu")
    tgen.generate_expansions(api, coll, tmp_path / "api.jsonl", batch_size=4)
    assert out.read_bytes() == (tmp_path / "api.jsonl").read_bytes()


def test_jax_written_adapter_loads_in_port(jax_side, tmp_path):
    """An adapter the JAX package saved (``save_adapter`` is ``save_params``
    of the adapter tree) loads through the port's ``load_adapter`` leaf for
    leaf, and merges as the JAX package merges it."""
    from improving_learned_index_tpu.core.checkpoint import save_params as jax_save_params
    from improving_learned_index_tpu_torch.expand.finetune import load_adapter
    from improving_learned_index_tpu_torch.expand.lora import LoraConfig, merge_lora

    lora = jax_side["default"]["lora"]
    jax_save_params(tmp_path / "a.msgpack", lora)
    got = load_adapter(tmp_path / "a.msgpack")
    want = _flat(lora)
    assert set(_flat(got)) == set(want)
    for k, v in _flat(got).items():
        np.testing.assert_array_equal(v.numpy(), np.asarray(want[k]))
    merged = merge_lora(tl.llama_flax_params_to_port(jax_side["params"], port_cfg()), got, LoraConfig())
    jmerged = jax.device_get(jlora.merge_lora(jax_side["params"], lora, jlora.LoraConfig()))
    for k, v in _flat(jmerged).items():
        np.testing.assert_array_equal(_flat(merged)[k].numpy(), np.asarray(v))
