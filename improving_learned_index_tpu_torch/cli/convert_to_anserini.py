"""CLI: export a forward index (text or binary impact store) as an Anserini
JsonVectorCollection (reference: python -m
src.deep_impact.indexing.convert_to_anserini).  Host only: it takes no
device.

    python -m improving_learned_index_tpu_torch.cli.convert_to_anserini \\
        -i forward.txt -o anserini.jsonl
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..index.anserini import convert_to_anserini


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--input_file_path", type=Path, required=True)
    parser.add_argument("-o", "--output_file_path", type=Path, required=True)
    args = parser.parse_args(argv)
    n = convert_to_anserini(args.input_file_path, args.output_file_path)
    print(f"exported {n} documents -> {args.output_file_path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
