"""The port's Llama decoder, quantization, LoRA merge and sampler against the
JAX package on the CPU.

The same seeded inputs and the JAX parameter tree (carried across with
``llama_flax_params_to_port``) go through both.  Tolerances:

- fp32 logits: within 1e-4 absolute (logits up to ~5; only the fp32
  summation order differs); with the int8 cache within 2e-3 (an fp32
  difference in k or v can move a quantized value by one step);
- bf16 logits: within 0.1 absolute (XLA's CPU fusions keep some bf16
  intermediates in fp32 where torch rounds each op, ~1% of the logits'
  scale over two layers);
- greedy tokens (fp32 compute: a random tiny model's bf16 logits hold
  near-ties that either package's rounding flips), quantized bytes, dequantized weights, merged LoRA weights
  and the top-k/top-p mask: equal;
- the flash route (``use_flash_attention``, the twin on the CPU) against
  the JAX XLA route on the real rows: within 3e-2 absolute (the flash twin
  rounds q, k, v and p to bf16, as the TPU's default-precision dots do);
- sampling: each token's frequency over 40,000 draws within 0.012 of the
  filtered softmax (>= 5 standard deviations).

The JAX outputs are computed once per module (``jax_ref``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improving_learned_index_tpu.core.config import GenerationConfig as JaxGen
from improving_learned_index_tpu.expand import lora as jlora
from improving_learned_index_tpu.expand import sampling as jsampling
from improving_learned_index_tpu.models import llama as jl
from improving_learned_index_tpu.models import quantization as jq
from improving_learned_index_tpu_torch.core.config import GenerationConfig
from improving_learned_index_tpu_torch.expand import lora as tlora
from improving_learned_index_tpu_torch.expand import sampling as tsampling
from improving_learned_index_tpu_torch.models import llama as tl
from improving_learned_index_tpu_torch.models import quantization as tq

VOCAB = 260
# the tiny config (head dim 16, rep 2) and one with head dim 128 and rep 2
CONFIGS = {
    "tiny": jl.LlamaConfig.tiny(vocab_size=VOCAB),
    "hd128": dataclasses.replace(jl.LlamaConfig.tiny(vocab_size=VOCAB), hidden_size=256, num_heads=2,
                                 num_kv_heads=1, intermediate_size=256),
}


def port_config(cfg, **kw):
    return tl.LlamaConfig(**{**dataclasses.asdict(cfg), **kw})


def inputs(seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    ids = rng.integers(4, 250, (b, s)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, s - 4:] = 0
    ids[0, s - 4:] = 0
    return ids, mask


def left_padded(ids, mask):
    """The same rows left-padded (the sampler's prompt layout)."""
    out, m = np.zeros_like(ids), np.zeros_like(mask)
    for i in range(ids.shape[0]):
        n = int(mask[i].sum())
        out[i, ids.shape[1] - n:] = ids[i, :n]
        m[i, ids.shape[1] - n:] = 1
    return out, m


@pytest.fixture(scope="module")
def jax_ref():
    """JAX params and outputs for every config and dtype, computed once."""
    ref = {}
    for name, cfg in CONFIGS.items():
        params = jax.device_get(jl.init_llama_params(cfg, jax.random.PRNGKey(0)))
        ref[name] = {"params": params}
        ids, mask = inputs()
        for dtype in ("float32", "bfloat16"):
            c = dataclasses.replace(cfg, dtype=dtype)
            logits, _ = jl.LlamaModel(c).apply({"params": params}, ids, mask)
            ref[name][dtype] = np.asarray(logits)
            lids, lmask = left_padded(ids, mask)
            for kvq in ("none", "int8"):
                ck = dataclasses.replace(c, kv_quant=kvq)
                model = jl.LlamaModel(ck)
                caches = jl.make_kv_caches(ck, 2, lids.shape[1] + 2)
                slot = np.concatenate([lmask, np.zeros((2, 2), np.int32)], axis=1)
                pos = np.maximum(np.cumsum(lmask, axis=1) - 1, 0)
                steps = []
                out, caches = model.apply({"params": params}, lids, slot, positions=pos, kv_caches=caches,
                                          cache_index=0)
                steps.append(np.asarray(out[:, -1]))
                tok = np.asarray(jnp.argmax(out[:, -1], axis=-1)).astype(np.int32)
                for t in range(2):
                    slot[:, lids.shape[1] + t] = 1
                    p = (lmask.sum(1) + t)[:, None].astype(np.int32)
                    out, caches = model.apply({"params": params}, tok[:, None], slot, positions=p,
                                              kv_caches=caches, cache_index=lids.shape[1] + t)
                    steps.append(np.asarray(out[:, 0]))
                    tok = np.asarray(jnp.argmax(out[:, 0], axis=-1)).astype(np.int32)
                ref[name][(dtype, kvq)] = steps
    cfg = dataclasses.replace(CONFIGS["tiny"], dtype="float32")
    params = ref["tiny"]["params"]
    gen = JaxGen(num_return_sequences=3, max_new_tokens=8, do_sample=False)
    lids, lmask = left_padded(*inputs(1))
    ref["greedy"] = {
        (q, kvq): jsampling.Sampler(dataclasses.replace(cfg, kv_quant=kvq), gen).generate(
            {"none": params, "int8": jq.quantize_params_int8(params), "int4": jq.quantize_params_int4(params)}[q],
            lids, lmask, num_return_sequences=3, seed=0)
        for q in ("none", "int8", "int4") for kvq in ("none", "int8")
    }
    ref["greedy_inputs"] = (lids, lmask)
    # flash route reference: the XLA route, fp32, head dim 128, padded tail
    fcfg = dataclasses.replace(CONFIGS["hd128"], dtype="float32")
    rng = np.random.default_rng(3)
    ids = rng.integers(4, 250, (2, 256)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[0, 200:] = 0
    ids[0, 200:] = 0
    ref["flash"] = (ids, mask, np.asarray(jl.LlamaModel(fcfg).apply({"params": ref["hd128"]["params"]}, ids,
                                                                    mask)[0]))
    return ref


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4), ("bfloat16", 0.1)])
def test_prefill_logits_match_jax(jax_ref, name, dtype, tol):
    cfg = port_config(CONFIGS[name], dtype=dtype)
    params = tl.llama_flax_params_to_port(jax_ref[name]["params"], cfg)
    ids, mask = inputs()
    logits, caches = tl.LlamaModel(cfg, device="meta")(torch.tensor(ids).long(), torch.tensor(mask).long(),
                                                        params=params)
    assert caches is None and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), jax_ref[name][dtype], rtol=0, atol=tol)


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("dtype,kv_quant,tol", [("float32", "none", 1e-4), ("float32", "int8", 2e-3),
                                                ("bfloat16", "none", 0.1), ("bfloat16", "int8", 0.1)])
def test_cache_decode_matches_jax(jax_ref, name, dtype, kv_quant, tol):
    """Prefill into the caches, then two one-token steps: each step's logits."""
    cfg = port_config(CONFIGS[name], dtype=dtype, kv_quant=kv_quant)
    params = tl.llama_flax_params_to_port(jax_ref[name]["params"], cfg)
    model = tl.LlamaModel(cfg, device="meta")
    lids, lmask = left_padded(*inputs())
    n = lids.shape[1]
    caches = tl.make_kv_caches(cfg, 2, n + 2)
    if kv_quant == "int8":
        assert caches[0][0].dtype == torch.int8 and caches[0][1].dtype == torch.float32
    slot = torch.cat([torch.tensor(lmask).long(), torch.zeros(2, 2, dtype=torch.long)], dim=1)
    pos = torch.clamp(torch.cumsum(torch.tensor(lmask).long(), 1) - 1, min=0)
    out, caches = model(torch.tensor(lids).long(), slot, pos, caches, 0, params=params)
    want = jax_ref[name][(dtype, kv_quant)]
    np.testing.assert_allclose(out[:, -1].numpy(), want[0], rtol=0, atol=tol)
    tok = torch.argmax(out[:, -1], -1)
    for t in range(2):
        slot[:, n + t] = 1
        p = (torch.tensor(lmask).sum(1) + t)[:, None]
        out, caches = model(tok[:, None], slot, p, caches, n + t, params=params)
        np.testing.assert_allclose(out[:, 0].numpy(), want[t + 1], rtol=0, atol=tol)
        tok = torch.argmax(out[:, 0], -1)


@pytest.mark.parametrize("quant", ["none", "int8", "int4"])
@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_greedy_tokens_equal_jax(jax_ref, quant, kv_quant):
    """fp32 decode over a full-precision, int8 or int4 tree (dequantized at
    each use), fp32 or int8 cache, 3 return sequences: the JAX tokens."""
    cfg = port_config(CONFIGS["tiny"], kv_quant=kv_quant, dtype="float32")
    params = tl.llama_flax_params_to_port(jax_ref["tiny"]["params"], cfg)
    params = {"none": lambda p: p, "int8": tq.quantize_params_int8, "int4": tq.quantize_params_int4}[quant](params)
    lids, lmask = jax_ref["greedy_inputs"]
    sampler = tsampling.Sampler(cfg, GenerationConfig(num_return_sequences=3, max_new_tokens=8, do_sample=False))
    got = sampler.generate(params, lids, lmask, num_return_sequences=3, seed=0)
    np.testing.assert_array_equal(got, jax_ref["greedy"][(quant, kv_quant)])


def test_quantized_bytes_equal_jax():
    """int8 and packed int4 leaves byte for byte (an odd contracted axis falls
    back to int8 in int4), and their dequantization in bf16 and fp32."""
    rng = np.random.default_rng(0)
    tree = {
        "embed_tokens": {"embedding": rng.standard_normal((32, 8)).astype(np.float32)},
        "a": {"kernel": rng.standard_normal((16, 4, 8)).astype(np.float32)},
        "b": {"kernel": rng.standard_normal((7, 12)).astype(np.float32)},
        "c": {"kernel": np.zeros((6, 5), np.float32)},
        "norm": {"scale": rng.standard_normal(8).astype(np.float32)},
    }
    port_tree = tl.tree_map(torch.from_numpy, tree)
    for jfn, tfn in ((jq.quantize_params_int8, tq.quantize_params_int8),
                     (jq.quantize_params_int4, tq.quantize_params_int4)):
        want, got = jfn(tree), tfn(port_tree)
        assert set(got) == set(want)
        for k in want:
            for leaf in want[k]:
                w, g = want[k][leaf], got[k][leaf]
                if isinstance(w, dict):
                    assert set(g) == set(w)
                    for part in w:
                        assert g[part].numpy().dtype == np.asarray(w[part]).dtype
                        np.testing.assert_array_equal(g[part].numpy(), np.asarray(w[part]))
                else:
                    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
            dw = jax.device_get(jq.dequantize_params(want, dtype=jdt))
            dg = tq.dequantize_params(got, tdt)
            for k in ("a", "b", "c"):
                np.testing.assert_array_equal(dg[k]["kernel"].float().numpy(),
                                              np.asarray(dw[k]["kernel"]).astype(np.float32))


def test_random_quantized_like_config_same_bytes():
    cfg = CONFIGS["tiny"]
    want = jq.random_quantized_like_config(cfg, np.random.default_rng(5))
    got = tq.random_quantized_like_config(port_config(cfg), np.random.default_rng(5))
    flat_w = jax.tree_util.tree_leaves_with_path(want)
    flat_g = dict(tl._flat(got))
    assert len(flat_w) == len(flat_g)
    for path, leaf in flat_w:
        key = ".".join(str(getattr(p, "key", p)) for p in path)
        np.testing.assert_array_equal(flat_g[key].numpy(), np.asarray(leaf))


def test_merge_lora_equal_jax(jax_ref):
    """The JAX adapters (B made non-zero) merged by both; 3-D kernels use
    the balanced matrix view (o_proj [heads * hd, hidden])."""
    params = jax_ref["tiny"]["params"]
    cfg = jlora.LoraConfig(r=4, alpha=8)
    lora = jax.device_get(jlora.init_lora_params(params, cfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    lora = jax.tree_util.tree_map(lambda x: x + 0.01 * rng.standard_normal(x.shape).astype(np.float32), lora)
    want = jax.device_get(jlora.merge_lora(params, lora, cfg))
    tcfg = tlora.LoraConfig(r=4, alpha=8)
    tparams = tl.llama_flax_params_to_port(params, port_config(CONFIGS["tiny"]))
    got = tlora.merge_lora(tparams, tl.tree_map(torch.from_numpy, lora), tcfg)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        key = ".".join(str(getattr(p, "key", p)) for p in path)
        np.testing.assert_array_equal(tl._flat(got)[key].numpy(), np.asarray(leaf))
    # the adapters' shapes come from the same target scan and factor split
    mine = tlora.init_lora_params(tparams, tcfg, seed=0)
    assert jax.tree_util.tree_map(np.shape, lora) == tl.tree_map(lambda t: tuple(t.shape), mine)
    assert tlora._factor_dims((64, 4, 16)) == jlora._factor_dims((64, 4, 16)) == (64, 64)
    assert tlora._factor_dims((4, 16, 64)) == jlora._factor_dims((4, 16, 64)) == (64, 64)


def test_flash_route_matches_xla_route_on_real_rows(jax_ref):
    """``use_flash_attention``: the cache-less forward through the flash
    twin (causal, the mask as segment ids) against the JAX XLA route, on
    the rows the padding does not touch (pads attend pads there)."""
    ids, mask, want = jax_ref["flash"]
    cfg = port_config(CONFIGS["hd128"], dtype="float32", use_flash_attention=True)
    params = tl.llama_flax_params_to_port(jax_ref["hd128"]["params"], cfg)
    got, _ = tl.LlamaModel(cfg, device="meta")(torch.tensor(ids).long(), torch.tensor(mask).long(), params=params)
    got = got.numpy()
    np.testing.assert_allclose(got[0, :200], want[0, :200], rtol=0, atol=3e-2)
    np.testing.assert_allclose(got[1], want[1], rtol=0, atol=3e-2)
    assert np.isfinite(got).all()


def test_module_parameters_equal_tree_route(jax_ref):
    """``load_llama_params`` into the module's own parameters gives the
    ``params=`` route's logits; ``llama_params`` reads the same tensors."""
    cfg = port_config(CONFIGS["tiny"], dtype="float32")
    params = tl.llama_flax_params_to_port(jax_ref["tiny"]["params"], cfg)
    model = tl.load_llama_params(tl.LlamaModel(cfg), params)
    ids, mask = (torch.tensor(a).long() for a in inputs())
    a, _ = model(ids, mask)
    b, _ = tl.LlamaModel(cfg, device="meta")(ids, mask, params=params)
    assert torch.equal(a, b)
    mine, given = tl._flat(tl.llama_params(model)), tl._flat(params)
    assert set(mine) == set(given) and all(torch.equal(mine[k], given[k]) for k in given)


def test_hf_import_and_tree_round_trip():
    """``hf_llama_to_port`` lays an HF state dict out as ``hf_llama_to_flax``
    does, and the port tree goes back to the JAX one unchanged."""
    cfg = CONFIGS["hd128"]
    rng = np.random.default_rng(4)
    H, hd, heads, kvh, inter = cfg.hidden_size, cfg.head_dim, cfg.num_heads, cfg.num_kv_heads, cfg.intermediate_size
    sd = {"model.embed_tokens.weight": rng.standard_normal((VOCAB, H)), "model.norm.weight": rng.standard_normal(H),
          "lm_head.weight": rng.standard_normal((VOCAB, H))}
    for i in range(cfg.num_layers):
        p = f"model.layers.{i}"
        sd.update({f"{p}.input_layernorm.weight": rng.standard_normal(H),
                   f"{p}.post_attention_layernorm.weight": rng.standard_normal(H),
                   f"{p}.self_attn.q_proj.weight": rng.standard_normal((heads * hd, H)),
                   f"{p}.self_attn.k_proj.weight": rng.standard_normal((kvh * hd, H)),
                   f"{p}.self_attn.v_proj.weight": rng.standard_normal((kvh * hd, H)),
                   f"{p}.self_attn.o_proj.weight": rng.standard_normal((H, heads * hd)),
                   f"{p}.mlp.gate_proj.weight": rng.standard_normal((inter, H)),
                   f"{p}.mlp.up_proj.weight": rng.standard_normal((inter, H)),
                   f"{p}.mlp.down_proj.weight": rng.standard_normal((H, inter))})
    sd = {k: v.astype(np.float32) for k, v in sd.items()}
    want = jl.hf_llama_to_flax(sd, cfg)
    got = tl.hf_llama_to_port({k: torch.from_numpy(v) for k, v in sd.items()}, port_config(cfg))
    back = tl.llama_port_params_to_flax(got)
    for path, leaf in jax.tree_util.tree_leaves_with_path(want):
        node = back
        for p in path:
            node = node[p.key]
        np.testing.assert_array_equal(node, leaf)
    with pytest.raises(ValueError, match="shape"):
        tl.llama_flax_params_to_port(want, port_config(cfg, hidden_size=128))


def test_top_k_top_p_filter_equal_jax():
    rng = np.random.default_rng(6)
    logits = (rng.standard_normal((8, 300)) * 3).astype(np.float32)
    for top_k, top_p in ((50, 0.95), (0, 0.9), (10, 1.0), (300, 0.5)):
        want = np.asarray(jsampling.top_k_top_p_filter(jnp.asarray(logits), top_k, top_p))
        got = tsampling.top_k_top_p_filter(torch.tensor(logits), top_k, top_p).numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        np.testing.assert_array_equal(got[~np.isinf(got)], want[~np.isinf(want)])


def test_sampling_frequencies_follow_filtered_softmax():
    """Sampling is compared in distribution: 40,000 draws from one row of
    logits (temperature 0.7, top-k 6, top-p 0.9) land on the kept tokens with
    the filtered softmax's frequencies."""
    gen = GenerationConfig(top_k=6, top_p=0.9, temperature=0.7, do_sample=True)
    sampler = tsampling.Sampler(port_config(CONFIGS["tiny"]), gen)
    logits = torch.tensor(np.random.default_rng(7).standard_normal(16).astype(np.float32) * 2)
    g = torch.Generator().manual_seed(0)
    draws = sampler._sample(logits.expand(40_000, 16), g)
    freq = np.bincount(draws.numpy(), minlength=16) / 40_000
    probs = torch.softmax(tsampling.top_k_top_p_filter(logits[None] / 0.7, 6, 0.9), -1)[0].numpy()
    assert (freq[probs == 0] == 0).all()
    np.testing.assert_allclose(freq, probs, rtol=0, atol=0.012)
