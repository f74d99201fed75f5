"""The XLM-R encode cell's own pieces on the CPU: what its modules load,
the generated tokenizer against the reference's term mapping, its metric
readers on hand-made traces, and whole tiny runs of the cell and of its
controls."""

import copy
import json
import time

import numpy as np
import pytest

from portbench import controls_xlmr, run
from portbench.harness import common
from portbench.harness.trace import DeviceOp, Profile
from portbench.tests.test_portbench_guard import modules_after

common.set_environment()
BENCH = common.load_json(common.ROOT / "BENCHMARK.json")
CELL = "encode-xlmr-docs512"
CONFIG = common.load_json(common.BENCH / "configs" / "deepimpact-xlmr-base.json")
TRAFFIC = common.load_json(common.BENCH / "workloads" / f"{CELL}.json")["traffic"]
TINY_XLMR = {"vocab_size": 250002, "hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
             "intermediate_size": 128, "max_position_embeddings": 514, "type_vocab_size": 1,
             "initializer_range": 0.02, "layer_norm_eps": 1e-5, "pad_token_id": 1,
             "impact_head": {"activation": "softplus"}, "compute_dtype": "bfloat16"}
SEED = 2**31 + 77


def reader(name):
    return common.load_module(common.BENCH / "layer_metrics" / f"{name}.py")


def test_cell_modules_load_no_jax_and_the_reference_nothing_of_the_program():
    tops = modules_after("import portbench.drivers.encode_xlmr, portbench.harness.xlmr_setup, "
                         "portbench.controls_xlmr, portbench.traffic.documents\n"
                         "import improving_learned_index_tpu_torch.index.indexer")
    assert not tops & {"improving_learned_index_tpu", "jax", "flax", "jaxlib"}
    tops = modules_after("import portbench.reference.encoder_xlmr, portbench.reference.unigram")
    assert not tops & {"improving_learned_index_tpu_torch", "improving_learned_index_tpu", "jax", "flax",
                       "jaxlib", "tokenizers", "transformers"}


@pytest.fixture(scope="module")
def source():
    from portbench.harness import xlmr_setup

    return xlmr_setup.source(CONFIG, TRAFFIC)


def test_generated_tokenizer_has_xlmr_pieces_and_ids(source):
    from portbench.harness import xlmr_setup

    hf = xlmr_setup.hf_tokenizer(source)
    assert len(hf) == len(source.vocab) == CONFIG["vocab_size"] == 250002
    got = [hf.bos_token_id, hf.pad_token_id, hf.eos_token_id, hf.unk_token_id, hf.mask_token_id]
    assert got == [CONFIG["bos_token_id"], CONFIG["pad_token_id"], CONFIG["eos_token_id"], 3, 250001]
    assert hf("a b")["input_ids"][0] == 0 and hf("a b")["input_ids"][-1] == 2
    assert len({p for p, _ in source.vocab}) == 250002


def test_reference_term_mapping_equals_the_programs(source):
    """The reference's Unigram segmentation and term map against
    ``HFImpactTokenizer`` over the generated tokenizer, documents cut at
    512 and not, and the token counts the traced metrics use."""
    from portbench.drivers.encode_xlmr import pieces_table
    from portbench.harness import xlmr_setup
    from portbench.reference.unigram import UnigramTokenizer

    tok = xlmr_setup.tokenizer(source, 512)
    ref = UnigramTokenizer(source.vocab)
    texts, ids, ends, lengths = source.draw(48, SEED, stream=5)
    counts = source.token_counts(ids, ends, lengths, pieces_table(source), 512)
    cut = 0
    for text, n in zip(texts, counts):
        enc = tok.process_document(text)
        real = sum(enc.attention_mask)
        want_ids, want_map = ref.document(text, 512)
        assert enc.ids[:real] == want_ids and real == n
        assert list(enc.term_to_token_index.items()) == list(want_map.items())
        cut += real == 512
    assert 0 < cut < len(texts)


def test_flash_roofline_by_hand():
    """Two documents of 100 and 412 tokens in one 512-token row, 2 layers:
    the bound of each layer's attention is the larger of its bytes (q, k, v
    and the context in bf16 at 768 wide, int32 segment ids, over 512 real
    tokens) and its operations (4 x 768 a pair, 100^2 + 412^2 pairs)."""
    cfg = {"hidden_size": 768, "num_hidden_layers": 2}
    bytes_moved = 512 * 768 * 2 * 4 + 512 * 4
    flops = 4 * 768 * (100 ** 2 + 412 ** 2)
    bound = max(bytes_moved / 3.35e12, flops / 989e12)
    ops = [DeviceOp("ili_flash_fwd_kernel", 0.0, 100.0, frozenset(["csrc/flash_attention.cu"])),
           DeviceOp("nvjet_gemm", 100.0, 400.0, frozenset())]
    readings = {"profile": Profile(window_s=1e-3, ops=ops, host=[]), "profile_tokens": [100, 412],
                "config": cfg, "kind": "NVIDIA H100 80GB HBM3"}
    assert reader("flash_roofline.xlmr").read(readings) == pytest.approx(100.0 * 2 * bound / 100e-6)
    readings["profile"] = Profile(window_s=1e-3, ops=ops[1:], host=[])
    assert reader("flash_roofline.xlmr").read(readings) is None  # no flash kernel ran


@pytest.mark.parametrize("regions,want", [
    (["index/encode", "encoder/route_flash"] * 3, 0.0),
    (["index/encode", "encoder/route_plain"] * 3, 1.0),
    (["index/encode", "encoder/route_flash", "encoder/route_plain", "index/encode", "encoder/route_flash"], 0.5),
    (["index/encode"] * 3, None),  # a program with no route regions
    (["encoder/route_flash"], None),  # no batch
])
def test_plain_forwards_reads_zero_not_none(regions, want):
    host = [(float(i), float(i) + 0.5, name) for i, name in enumerate(regions)]
    got = reader("plain_forwards.xlmr").read({"profile": Profile(window_s=1.0, ops=[], host=host)})
    assert got == want


def tiny_cell(tmp_path, trace, seed=SEED):
    workload = copy.deepcopy(common.load_json(common.BENCH / "workloads" / f"{CELL}.json"))
    workload["traffic"].update({"max_rate": 20, "rows": 8, "warm_docs": 8, "trace_docs": 24, "median_words": 300})
    workload["check"]["sample_every"] = 1
    return common.Cell(name=CELL, seed=seed, seconds=2.0, trace=trace, device="cpu", workload=workload,
                       config=TINY_XLMR, tmpdir=tmp_path, started=time.monotonic())


def tiny_run(tmp_path, trace=False):
    cell = tiny_cell(tmp_path, trace)
    driver = common.load_module(common.BENCH / "drivers" / "encode_xlmr.py", "portbench.drivers.encode_xlmr")
    line, _ = run.measure(cell, driver, BENCH, 1)
    json.dumps(line)
    return line


@pytest.mark.parametrize("trace", [False, True])
def test_sound_run_is_correct(trace, tmp_path):
    """At S=512 on the CPU the program's flash route runs its twin."""
    line = tiny_run(tmp_path, trace)
    assert line["correct"], line["checks"]
    want = {m["name"] for m in run.cell_metrics(BENCH, CELL, trace)}
    if not trace:
        assert set(line["metrics"]) == want
    else:
        assert set(line["metrics"]) <= want and "busy_s" in line["device"]
        assert line["metrics"]["plain_forwards.xlmr"]["value"] == 0.0


def test_broken_run_is_not_correct(tmp_path, monkeypatch):
    """Impacts altered where the model produces them."""
    from improving_learned_index_tpu_torch.models.deep_impact import DeepImpact

    inner = DeepImpact.encode_packed

    def encode_packed(self, batch, materialize=True):
        out = np.array(inner(self, batch, materialize=True))
        out[::7] *= 1.5
        return out

    monkeypatch.setattr(DeepImpact, "encode_packed", encode_packed)
    assert not tiny_run(tmp_path)["correct"]


def test_controls_are_not_correct(capsys):
    """The half-batch and unchanged-state (the head's calibration lost)
    faults fail the cell's limits at the test's size.  A 2-layer 64-wide
    trunk drifts less in float8 than the cell's 12 layers of 768, so at
    this size fp8 is only required to read a gap; the chip reads it at the
    cell's size."""
    controls_xlmr.main(["--workload", CELL, "--seeds", str(SEED), "--seconds", "2", "--rate", "20"],
                       device="cpu", overrides={"config": TINY_XLMR, "check": {"sample_every": 1},
                                                "traffic": {"median_words": 300}})
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["control"]
    assert set(got) == {"fp8", "half_batch", "unchanged_state"}
    assert not got["half_batch"]["correct"] and not got["unchanged_state"]["correct"], got
    assert got["fp8"]["checks"]["impact_gap_max"]["value"] > 0
