"""CLI: quantize a forward index to 8-bit impacts
(reference: python -m src.deep_impact.indexing.quantize, indexing/quantize.py:50-58).

Accepts either the reference text format (file -> file, byte parity with the
reference) or a binary impact store (directory -> directory, array speed:
index/impact_store.py).  ``--text_out`` also writes the reference-format
quantized text from a store run."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index.forward_index import quantize_file
from ..index.impact_store import is_impact_store, quantize_store, store_to_forward_text


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_file_path", type=Path, required=True)
    parser.add_argument("-o", "--output_file_path", type=Path, required=True)
    parser.add_argument("-m", "--max_val", type=float, default=None)
    parser.add_argument("-b", "--bits", type=int, default=8)
    parser.add_argument("--text_out", type=Path, default=None,
                        help="with a store input: also write the quantized "
                        "reference-format text here")
    args = parser.parse_args(argv)
    if is_impact_store(args.input_file_path):
        max_val = quantize_store(args.input_file_path, args.output_file_path, args.max_val, args.bits)
        if args.text_out is not None:
            store_to_forward_text(args.output_file_path, args.text_out)
    else:
        max_val = quantize_file(args.input_file_path, args.output_file_path, args.max_val, args.bits)
    print(f"quantized with max value {max_val}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
