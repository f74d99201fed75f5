"""CLI: quantize a text forward index to 8-bit impacts, file to file, with
byte parity to the reference (python -m src.deep_impact.indexing.quantize,
indexing/quantize.py:50-58).  The binary impact-store route of the JAX CLI
is not ported yet."""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index.forward_index import quantize_file


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_file_path", type=Path, required=True)
    parser.add_argument("-o", "--output_file_path", type=Path, required=True)
    parser.add_argument("-m", "--max_val", type=float, default=None)
    parser.add_argument("-b", "--bits", type=int, default=8)
    args = parser.parse_args(argv)
    if args.input_file_path.is_dir():
        raise NotImplementedError("impact-store input (a directory) is not ported yet")
    max_val = quantize_file(args.input_file_path, args.output_file_path, args.max_val, args.bits)
    print(f"quantized with max value {max_val}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
