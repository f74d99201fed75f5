"""CLI: split an inverted index into consecutive doc-range shards — the
deployment step for doc-sharded serving (one ``cli.serve`` daemon per
shard behind a ``cli.serve --shards`` router, serve/router.py).  Inverse of cli.merge_indexes;
merging the shards back is byte-identical to the input.

    python -m improving_learned_index_tpu_torch.cli.split_index \
        -i inverted/ -o shards/ --n_shards 4 --num_docs 1000000

Writes shards/shard0 .. shardN-1 plus shards/shards.json with each shard's
doc count and router offset."""

from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..index.inverted import InvertedIndexData


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-i", "--index_path", type=Path, required=True)
    parser.add_argument("-o", "--output_dir", type=Path, required=True)
    parser.add_argument("--n_shards", type=int, required=True)
    parser.add_argument("--num_docs", type=int, default=0,
                        help="documents in the index (defaults to max doc "
                        "id + 1)")
    args = parser.parse_args(argv)
    index = InvertedIndexData.load(args.index_path, num_docs=args.num_docs)
    shards = index.split_docs(args.n_shards)
    args.output_dir.mkdir(parents=True, exist_ok=True)
    manifest = []
    offset = 0
    for i, shard in enumerate(shards):
        shard.save(args.output_dir / f"shard{i}")
        manifest.append({"path": f"shard{i}", "num_docs": shard.num_docs,
                         "doc_offset": offset})
        offset += shard.num_docs
    with open(args.output_dir / "shards.json", "w") as f:
        json.dump(manifest, f, indent=2)
    print(f"split {index.num_docs} docs into {len(shards)} shards -> {args.output_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
