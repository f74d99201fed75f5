"""Offline data-prep utilities (reference: src/deep_impact/scripts/ +
src/llama2/prepare_dataset.py), the port's copies of
``improving_learned_index_tpu/scripts/``.  Each module is a library
function plus a ``python -m`` CLI; all run on the host (no device)."""
