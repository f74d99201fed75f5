"""The port's public names against the JAX package's, by ``ast`` only (no
import of either package, well under a second).

For every module under ``improving_learned_index_tpu/``: its public
top-level functions and classes, the public methods of its public classes,
and its module-level public assignments (``quantize_params_int8 =
_quantizer(...)`` among them).  Each must be defined in the port file of the
same relative path, or appear in ``COUNTERPARTS`` as ``"module:name"``
with one line: the port's counterpart (``"path.py:Name"``, checked to
exist) or the reason the name has no torch meaning.  Every name in a JAX
subpackage ``__init__``'s ``__all__`` must be bound in the port
subpackage's ``__init__`` (and listed in its ``__all__``), or be mapped.
The kernel bodies are private names (``_gather_kernel`` ...), so they are
not listed; PERF.md maps each to its ``csrc/`` file.
"""

import ast
import re
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
JAX = REPO / "improving_learned_index_tpu"
PORT = REPO / "improving_learned_index_tpu_torch"
SUBPACKAGES = ("", "analysis", "cli", "core", "data", "evaluation", "expand", "index", "models", "native",
               "ops", "parallel", "scripts", "search", "serve", "text", "train", "utils")
_COUNTERPART = re.compile(r"^[\w/]+\.py:[\w.]+$")

FLAX_SETUP = "flax module plumbing: torch modules build their layers in __init__"
ORBAX = "core/async_checkpoint.py:AsyncCheckpointManager"
MESH = "jax.sharding meshes: the port trains data-parallel, one process a card (parallel/distributed.py)"
PALLAS_TILES = "Pallas tile geometry for TPU VMEM; the CUDA kernel sets its own tiles in csrc/"
COUNTERPARTS = {
    # flax-only plumbing
    "cli/common.py:enable_compilation_cache": "JAX's persistent XLA compile cache; torch has no such cache",
    "models/encoder.py:init_params": "models/encoder.py:init_weights",
    "models/encoder.py:HeadProjection": "models/encoder.py:SelfAttention",
    "models/encoder.py:HeadOutputProjection": "models/encoder.py:SelfAttention",
    "models/t5.py:T5Attention.setup": FLAX_SETUP,
    "models/t5.py:T5Attention.compute_kv": "models/t5.py:T5Model.compute_cross_kvs",
    "models/t5.py:T5EncoderLayer.setup": FLAX_SETUP,
    "models/t5.py:T5DecoderLayer.setup": FLAX_SETUP,
    "models/t5.py:T5Model.setup": FLAX_SETUP,
    "models/hf_import.py:jax_to_np": "fetches a JAX device tree to numpy; torch tensors convert in place",
    "models/hf_import.py:flax_deep_impact_to_hf": "models/hf_import.py:port_deep_impact_to_hf",
    "models/hf_import.py:hf_encoder_to_flax": "models/hf_import.py:hf_deep_impact_to_port",
    "models/hf_import.py:hf_deep_impact_to_flax": "models/hf_import.py:hf_deep_impact_to_port",
    "models/llama.py:hf_llama_to_flax": "models/llama.py:hf_llama_to_port",
    "models/t5.py:hf_t5_to_flax": "models/t5.py:hf_t5_to_port",
    # Orbax's manager; the port's asynchronous manager has the synchronous one's interface
    "core/orbax_checkpoint.py:OrbaxCheckpointManager": ORBAX,
    "core/orbax_checkpoint.py:OrbaxCheckpointManager.exists": "core/checkpoint.py:CheckpointManager.exists",
    "core/orbax_checkpoint.py:OrbaxCheckpointManager.load": "core/async_checkpoint.py:AsyncCheckpointManager.load",
    "core/orbax_checkpoint.py:OrbaxCheckpointManager.on_step": "core/async_checkpoint.py:AsyncCheckpointManager.on_step",
    "core/orbax_checkpoint.py:OrbaxCheckpointManager.rescale_step_for_batch":
        "core/checkpoint.py:CheckpointManager.rescale_step_for_batch",
    "core/orbax_checkpoint.py:OrbaxCheckpointManager.save": "core/async_checkpoint.py:AsyncCheckpointManager.save",
    "core/orbax_checkpoint.py:OrbaxCheckpointManager.wait": "core/async_checkpoint.py:AsyncCheckpointManager.wait",
    "core/orbax_checkpoint.py:LATEST": "core/checkpoint.py:LATEST_SNAPSHOT_SUFFIX",
    "core/orbax_checkpoint.py:logger": "core/async_checkpoint.py:logger",
    "parallel/mesh.py:make_mesh": MESH,
    "parallel/mesh.py:single_device_mesh": MESH,
    "parallel/mesh.py:data_sharding": MESH,
    "parallel/mesh.py:replicated": MESH,
    "parallel/mesh.py:shard_batch": MESH,
    "parallel/mesh.py:pad_to_multiple": MESH,
    "parallel/mesh.py:initialize_distributed": "parallel/distributed.py:initialize_distributed",
    # the subpackage exports of the names above
    "models/__init__.py:init_params": "models/__init__.py:init_weights",
    "parallel/__init__.py:make_mesh": MESH,
    "parallel/__init__.py:single_device_mesh": MESH,
    "parallel/__init__.py:data_sharding": MESH,
    "parallel/__init__.py:replicated": MESH,
    "parallel/__init__.py:shard_batch": MESH,
    "parallel/__init__.py:pad_to_multiple": MESH,
    # Pallas shape gates: the port dispatches by device and its kernels take every shape
    "ops/gather_rows.py:can_use_pallas_gather": "Pallas tiling gate; the CUDA kernel takes every shape",
    "ops/scatter_scores.py:can_use_pallas_tail": "Pallas tiling gate; the CUDA kernel takes every shape",
    "ops/gather_rows.py:STRIP": PALLAS_TILES,
    "ops/gather_rows.py:SUB": PALLAS_TILES,
    "ops/gather_rows.py:LANES": PALLAS_TILES,
    "ops/scatter_scores.py:TILE": PALLAS_TILES,
    "ops/scatter_scores.py:SEG": PALLAS_TILES,
    "ops/scatter_scores.py:PAGE": PALLAS_TILES,
    "ops/pallas_scoring.py:SUB": PALLAS_TILES,
    "ops/short_attention.py:interpret": "Pallas interpret mode; the port runs the plain version on CPU tensors",
    "search/sharded_engine.py:TAIL_CHUNK": "search/hybrid_engine.py:TAIL_CHUNK",
    # deviations ROADMAP documents
    "models/llama.py:llama_param_specs": "tensor-parallel specs; the port runs the decoder on one device",
    "search/hybrid_engine.py:partition_tail_csr": "the opt-in tail_partitioned route, which lost its own A/B",
    "search/hybrid_engine.py:partitioned_chunk_table": "the opt-in tail_partitioned route, which lost its own A/B",
    "search/hybrid_engine.py:HybridSearchEngine.recommend_tail_partitioned":
        "the opt-in tail_partitioned route, which lost its own A/B",
}


def _bound_names(body):
    """Names a module or class body binds at its own level (``if``/``try``
    blocks included): defs, classes, assignments and imports."""
    for node in body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            yield node.name, node
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                for name in ast.walk(target):
                    if isinstance(name, ast.Name):
                        yield name.id, node
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            yield node.target.id, node
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                yield (alias.asname or alias.name).split(".")[0], node
        elif isinstance(node, ast.If):
            yield from _bound_names(node.body)
            yield from _bound_names(node.orelse)
        elif isinstance(node, ast.Try):
            for part in (node.body, node.orelse, node.finalbody, *(h.body for h in node.handlers)):
                yield from _bound_names(part)


def _public(name):
    return not name.startswith("_")


def module_names(path):
    """The public surface of one file: top-level functions, classes and
    assignments, and ``Class.method`` for the public methods of public
    classes (imports are not the module's own names)."""
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    names = set()
    for name, node in _bound_names(tree.body):
        if not _public(name) or isinstance(node, (ast.Import, ast.ImportFrom)):
            continue
        names.add(name)
        if isinstance(node, ast.ClassDef):
            names.update(f"{name}.{m}" for m, n in _bound_names(node.body)
                         if _public(m) and isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)))
    return names


def defined(path, name):
    """Whether ``path`` binds ``name`` (``Class.member``: in the class body)."""
    if not path.is_file():
        return False
    tree = ast.parse(path.read_text(encoding="utf-8"), str(path))
    top = dict(_bound_names(tree.body))
    head, _, member = name.partition(".")
    if head not in top:
        return False
    if not member:
        return True
    node = top[head]
    return isinstance(node, ast.ClassDef) and member in dict(_bound_names(node.body))


def missing_names(jax_root, port_root, subpackage, counterparts=COUNTERPARTS):
    """``module:name`` for each public JAX name in ``subpackage`` that the
    port file of the same path does not define and the map does not hold."""
    base = jax_root / subpackage if subpackage else jax_root
    files = sorted(base.rglob("*.py")) if subpackage else sorted(base.glob("*.py"))
    out = []
    for path in files:
        rel = path.relative_to(jax_root).as_posix()
        for name in sorted(module_names(path)):
            key = f"{rel}:{name}"
            if key not in counterparts and not defined(port_root / rel, name):
                out.append(key)
    return out


def _all_list(path):
    for node in ast.parse(path.read_text(encoding="utf-8"), str(path)).body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "__all__" for t in node.targets):
            return list(ast.literal_eval(node.value))
    return None


@pytest.mark.parametrize("subpackage", SUBPACKAGES, ids=[s or "root" for s in SUBPACKAGES])
def test_every_public_name_has_a_port_counterpart(subpackage):
    assert not missing_names(JAX, PORT, subpackage)


def test_subpackage_exports_match():
    """Each JAX subpackage ``__all__`` name is bound in the port's
    ``__init__`` and listed in its ``__all__``, or mapped."""
    missing = []
    for init in sorted(JAX.glob("*/__init__.py")):
        rel = init.relative_to(JAX).as_posix()
        port_init = PORT / rel
        port_all = _all_list(port_init) if port_init.is_file() else None
        for name in _all_list(init) or []:
            ok = defined(port_init, name) and (port_all is None or name in port_all)
            if not ok and f"{rel}:{name}" not in COUNTERPARTS:
                missing.append(f"{rel}:{name}")
    assert not missing


def test_counterparts_exist_and_every_entry_is_needed():
    """Each named counterpart is defined where the map says; each key is a
    JAX name the port does not define under the same path (no stale entry)."""
    for key, value in COUNTERPARTS.items():
        rel, name = key.split(":")
        jax_file = JAX / rel
        assert jax_file.is_file() and (name in module_names(jax_file) or name in (_all_list(jax_file) or [])), key
        assert not defined(PORT / rel, name), f"{key} is defined in the port: drop it from the map"
        if _COUNTERPART.match(value):
            target, target_name = value.split(":")
            assert defined(PORT / target, target_name), (key, value)
        else:
            assert len(value) > 20 and "\n" not in value, key


def test_checker_reports_an_added_public_function(tmp_path):
    """The checker sees a new public function in a copy of a small JAX
    module (and only that one)."""
    jax_copy, port_copy = tmp_path / "jax", tmp_path / "port"
    for root, src in ((jax_copy, JAX), (port_copy, PORT)):
        (root / "utils").mkdir(parents=True)
        shutil.copy(src / "utils" / "text_utils.py", root / "utils" / "text_utils.py")
    assert missing_names(jax_copy, port_copy, "utils") == []
    with open(jax_copy / "utils" / "text_utils.py", "a", encoding="utf-8") as f:
        f.write("\n\ndef brand_new_helper(x):\n    return x\n\n\nclass _Private:\n    pass\n")
    assert missing_names(jax_copy, port_copy, "utils") == ["utils/text_utils.py:brand_new_helper"]
