"""Where the port chooses between a hand-written kernel and its plain
PyTorch version (its twin): ``ops._kernels.launches`` and the one switch
``ops.plain_versions()``.  CPU only, no JAX.

- The switch's contract: ``launches`` answers True for CUDA and False for
  the CPU, False for both inside ``plain_versions()``; blocks nest and
  restore on exit and on an exception; the switch is process-wide, so a
  thread that autograd or ``torch.utils.checkpoint`` runs sees it.
- Every op entry that dispatches refuses a ``meta`` tensor through
  ``launches``.
- By ``ast``: no function in the package takes a ``use_kernel`` or
  ``use_kernels`` flag, and only ``ops/_kernels.py`` holds the switch's
  state.
"""

import ast
import threading
from pathlib import Path

import pytest
import torch

from improving_learned_index_tpu_torch.ops import (
    count_ge,
    encoder_epilogue,
    flash_attention,
    gather_rows,
    linear_gelu,
    plain_versions,
    scatter_scores,
    short_attention,
    topk_select,
)
from improving_learned_index_tpu_torch.ops._kernels import launches
from improving_learned_index_tpu_torch.ops.exact_topk import exact_topk_integer
from improving_learned_index_tpu_torch.ops.pallas_scoring import QG, blocked_scores

PACKAGE = Path(__file__).resolve().parent.parent / "improving_learned_index_tpu_torch"
CUDA, CPU = torch.device("cuda"), torch.device("cpu")


def test_plain_versions_nests_restores_and_reaches_other_threads():
    assert launches(CUDA) and not launches(CPU)
    assert not launches(torch.zeros(2))
    with plain_versions():
        assert not launches(CUDA) and not launches(CPU)
        with plain_versions():
            assert not launches(CUDA)
        assert not launches(CUDA)  # the outer block still holds
        seen = []
        thread = threading.Thread(target=lambda: seen.append(launches(CUDA)))
        thread.start()
        thread.join()
        assert seen == [False]
    assert launches(CUDA)
    with pytest.raises(RuntimeError, match="inside the block"):
        with plain_versions():
            raise RuntimeError("inside the block")
    assert launches(CUDA)


def _meta(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype, device="meta")


def _i32(*shape):
    return _meta(*shape, dtype=torch.int32)


def _bf16(*shape):
    return _meta(*shape, dtype=torch.bfloat16)


def _qkv():
    return _bf16(1, 2, 128, 64), _bf16(1, 2, 128, 64), _bf16(1, 2, 128, 64)


ENTRIES = {
    "gather_rows.accumulate_grouped": lambda: gather_rows.accumulate_grouped(_bf16(4, 64), _i32(8), 2),
    "gather_rows.accumulate_rows": lambda: gather_rows.accumulate_rows(_bf16(4, 64), _i32(3), _i32(5, 2),
                                                                       _i32(2), 2),
    "scatter_scores.apply_tail_chunks": lambda: scatter_scores.apply_tail_chunks(
        _meta(2, 64), _i32(32), _meta(32), _i32(3), _i32(3), _i32(3), 8),
    "scatter_scores.apply_tail_updates": lambda: scatter_scores.apply_tail_updates(_meta(2, 64), _i32(5),
                                                                                   _meta(5), _i32(5)),
    "count_ge": lambda: count_ge(_meta(2, 64), _meta(2, 7)),
    "topk_select.value_histogram": lambda: topk_select.value_histogram(_meta(2, 300)),
    "topk_select.kth_scores": lambda: topk_select.kth_scores(_i32(2, topk_select.BINS), 5),
    "topk_select.block_counts": lambda: topk_select.block_counts(_meta(2, 300), _meta(2, 1)),
    "blocked_scores": lambda: blocked_scores(_i32(2), _i32(1), _i32(1), _i32(1, 2048), _meta(1, 2048), QG, 1),
    "short_attention": lambda: short_attention.short_attention(*_qkv(), _i32(1, 128), 0.125),
    "flash_attention": lambda: flash_attention.flash_attention(*_qkv(), sm_scale=0.125),
    "flash_attention_forward": lambda: flash_attention.flash_attention_forward(*_qkv(), sm_scale=0.125),
    "flash_attention_backward": lambda: flash_attention.flash_attention_backward(
        *_qkv(), None, None, _bf16(1, 2, 128, 64), _meta(1, 2, 128), _bf16(1, 2, 128, 64)),
    "encoder_epilogue.bias_add": lambda: encoder_epilogue.bias_add(_bf16(4, 8), _bf16(4, 8), _bf16(4, 8),
                                                                   _meta(8), _meta(8), _meta(8)),
    "encoder_epilogue.bias_gelu": lambda: encoder_epilogue.bias_gelu(_bf16(4, 8), _meta(8)),
    "encoder_epilogue.bias_residual_layernorm": lambda: encoder_epilogue.bias_residual_layernorm(
        _bf16(4, 8), _meta(8), _bf16(4, 8), _meta(8), _meta(8), 1e-5),
    "exact_topk_integer": lambda: exact_topk_integer(_meta(2, 300), 5, max_score=100),
    "linear_gelu": lambda: linear_gelu.linear_gelu(_bf16(4, 64), _bf16(192, 64), _meta(192)),
}


@pytest.mark.parametrize("name", list(ENTRIES))
def test_op_entries_refuse_other_devices_through_launches(name):
    with pytest.raises(ValueError, match="no kernel and no plain version for device meta"):
        ENTRIES[name]()


def _functions_and_stores(tree):
    """(node, name) of every parameter, attribute and keyword argument."""
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            a = node.args
            for arg in a.posonlyargs + a.args + a.kwonlyargs:
                yield node, arg.arg
        elif isinstance(node, ast.Attribute):
            yield node, node.attr
        elif isinstance(node, ast.keyword) and node.arg:
            yield node, node.arg


def test_no_kernel_flag_in_any_signature_and_one_module_holds_the_switch():
    flags, holders = [], set()
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(PACKAGE).as_posix()
        tree = ast.parse(path.read_text(), filename=rel)
        flags += [f"{rel}:{node.lineno}" for node, name in _functions_and_stores(tree)
                  if name in ("use_kernel", "use_kernels")]
        for node in ast.walk(tree):
            if (isinstance(node, ast.FunctionDef) and node.name in ("launches", "plain_versions")
                    or isinstance(node, ast.Name) and node.id == "_plain_depth"):
                holders.add(rel)
    assert flags == []
    assert holders == {"ops/_kernels.py"}
