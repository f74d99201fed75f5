"""doc2query generation: prompt -> N sampled queries per document -> JSONL.

Counterpart of ``improving_learned_index_tpu/expand/generate.py`` (the
reference generate CLI, src/llama2/generate.py:27-117,120-206): the prompt
template around each document (the document, not the template's tail, is
cut to the token budget), left-padded prompt batches bucketed to 64 tokens,
``Sampler`` decoding, output JSONL ``{"doc_id", "queries"}``, resume by
counting output lines (blank input lines are skipped and never counted), an
optional document quota.

``WordTokenizer`` and ``save_local_generator``/``load_local_generator``
keep the JAX layout of a locally fine-tuned generator: ``config.json``
(``LlamaConfig``'s fields), ``params.msgpack`` (the flax msgpack of the
parameter tree, through ``core.flax_msgpack``) and ``word_vocab.txt``; a
directory either package writes, the other loads.
"""

from __future__ import annotations

import dataclasses
import json
import re
from pathlib import Path
from typing import Iterable, List, Optional, Tuple, Union

import numpy as np

from ..core.config import GenerationConfig
from ..core.device import resolve_device
from ..core.logging import get_logger
from ..data.datasets import CollectionParser
from ..models.llama import LlamaConfig, llama_flax_params_to_port, llama_port_params_to_flax, tree_to
from .sampling import Sampler

logger = get_logger("generate")

PROMPT_VI = "Dự đoán các truy vấn tìm kiếm có thể có cho tài liệu sau đây:\n{doc}\n---\n"
PROMPT_EN = "Predict possible search queries for the following document:\n{doc}\n---\n"
PROMPT_SEP = "\n---\n"


class QueryGenerator:
    """Batch query generation over a Llama decoder.  ``params`` (a full
    precision or quantized tree) is moved to ``device`` once; ``device``
    defaults to ``cuda`` and raises without one."""

    def __init__(
        self,
        params,
        config: LlamaConfig,
        tokenizer,  # encode(text)->List[int]; decode(ids)->str
        gen: GenerationConfig = GenerationConfig(),
        prompt_template: str = PROMPT_EN,
        pad_token_id: int = 0,  # the reference sets pad=0 != eos (generate.py:32)
        eos_token_id: int = 2,
        device=None,
    ):
        self.device = resolve_device(device)
        self.params = tree_to(params, self.device)
        self.config = config
        self.tokenizer = tokenizer
        self.gen = gen
        self.prompt_template = prompt_template
        self.pad_token_id = pad_token_id
        self.sampler = Sampler(config, gen, eos_token_id=eos_token_id)
        self.eos_token_id = eos_token_id

    def _encode_prompt(self, document: str) -> List[int]:
        """One prompt's ids, the DOCUMENT cut when over budget (cutting the
        formatted prompt's tail would drop the separator that cues the
        queries)."""
        ids = self.tokenizer.encode(self.prompt_template.format(doc=document))
        doc_ids = None
        while len(ids) > self.gen.max_tokens:
            if doc_ids is None:
                doc_ids = self.tokenizer.encode(document)
            if not doc_ids:
                return ids[-self.gen.max_tokens:]
            overflow = len(ids) - self.gen.max_tokens
            doc_ids = doc_ids[: max(len(doc_ids) - overflow, 0)]
            document = self.tokenizer.decode([int(t) for t in doc_ids])
            ids = self.tokenizer.encode(self.prompt_template.format(doc=document))
        return ids

    def prompt_and_tokenize(self, documents: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        """Left-padded prompt batch, rows padded to a 64-token bucket."""
        encoded = [self._encode_prompt(d) for d in documents]
        max_len = max(len(e) for e in encoded)
        max_len = min(-(-max_len // 64) * 64, max(self.gen.max_tokens, max_len))
        ids = np.full((len(encoded), max_len), self.pad_token_id, dtype=np.int32)
        mask = np.zeros((len(encoded), max_len), dtype=np.int32)
        for i, e in enumerate(encoded):
            ids[i, max_len - len(e):] = e
            mask[i, max_len - len(e):] = 1
        return ids, mask

    def generate(self, documents: List[str], seed: int = 0) -> List[List[str]]:
        """num_return_sequences decoded queries per document, whitespace
        collapsed; a sampled separator keeps only its tail."""
        ids, mask = self.prompt_and_tokenize(documents)
        out = self.sampler.generate(self.params, ids, mask, num_return_sequences=self.gen.num_return_sequences,
                                    seed=seed)
        n = self.gen.num_return_sequences
        queries: List[List[str]] = []
        for i in range(len(documents)):
            decoded = []
            for j in range(n):
                toks = out[i * n + j]
                toks = toks[toks != self.eos_token_id]
                text = self.tokenizer.decode([int(t) for t in toks])
                text = text.rsplit(PROMPT_SEP, 1)[-1]
                decoded.append(re.sub(r"\s{2,}", " ", text).strip())
            queries.append(decoded)
        return queries


class WordTokenizer:
    """Whitespace word-level tokenizer for locally fine-tuned generators: ids
    0..3 are pad/bos/eos/unk, then one id per vocabulary word."""

    PAD, BOS, EOS, UNK = 0, 1, 2, 3

    def __init__(self, words: List[str]):
        self.words = list(words)
        self._w2i = {w: i + 4 for i, w in enumerate(self.words)}
        if len(self._w2i) != len(self.words):
            raise ValueError("duplicate words in generator vocabulary")

    @property
    def vocab_size(self) -> int:
        return len(self.words) + 4

    def encode(self, text: str) -> List[int]:
        return [self.BOS] + [self._w2i.get(w, self.UNK) for w in text.split()]

    def decode(self, ids) -> str:
        return " ".join(self.words[int(i) - 4] for i in ids if int(i) >= 4)

    @classmethod
    def build(cls, texts: Iterable[str]) -> "WordTokenizer":
        words = sorted({w for t in texts for w in t.split()})
        return cls(words)

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_text("".join(f"{w}\n" for w in self.words), encoding="utf-8")

    @classmethod
    def load(cls, path: Union[str, Path]) -> "WordTokenizer":
        text = Path(path).read_text(encoding="utf-8")
        return cls([w for w in text.splitlines() if w])


def save_local_generator(path: Union[str, Path], params, config: LlamaConfig, tokenizer: WordTokenizer) -> None:
    """A fine-tuned generator (merged params + config + word vocabulary) in
    the layout ``cli.expand --local_path`` loads, the JAX package's bytes for
    the same fp32 tree."""
    from ..core.flax_msgpack import write

    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "config.json").write_text(json.dumps(dataclasses.asdict(config)))
    write(path / "params.msgpack", llama_port_params_to_flax(params))
    tokenizer.save(path / "word_vocab.txt")


def load_local_generator(path: Union[str, Path]):
    """Inverse of ``save_local_generator`` -> (params on the CPU, config,
    tokenizer)."""
    from ..core.flax_msgpack import read

    path = Path(path)
    config = LlamaConfig(**json.loads((path / "config.json").read_text()))
    params = llama_flax_params_to_port(read(path / "params.msgpack"), config)
    return params, config, WordTokenizer.load(path / "word_vocab.txt")


def count_lines(path: Union[str, Path]) -> int:
    if not Path(path).exists():
        return 0
    with open(path, encoding="utf-8") as f:
        return sum(1 for _ in f)


def generate_expansions(
    generator: QueryGenerator,
    collection_path: Union[str, Path],
    output_path: Union[str, Path],
    collection_type: str = "msmarco",
    batch_size: int = 4,
    num_docs: Optional[int] = None,
    seed: int = 0,
) -> int:
    """Stream the collection and append JSONL expansions; resumes by skipping
    as many non-blank input lines as output lines exist, stops at
    ``num_docs``.  Batch ``i`` of a run draws with ``seed + skip + written``."""
    skip = count_lines(output_path)
    if skip:
        logger.info(f"resuming: {skip} documents already expanded")
    written = 0
    batch_docs: List[str] = []
    batch_ids: List[str] = []

    def flush():
        nonlocal written
        if not batch_docs:
            return
        queries = generator.generate(batch_docs, seed=seed + skip + written)
        with open(output_path, "a", encoding="utf-8") as out:
            for doc_id, qs in zip(batch_ids, queries):
                json.dump({"doc_id": doc_id, "queries": qs}, out)
                out.write("\n")
        written += len(batch_docs)
        batch_docs.clear()
        batch_ids.clear()

    with open(collection_path, encoding="utf-8") as f:
        seen = 0
        for line in f:
            if not line.strip():
                continue
            if seen < skip:
                seen += 1
                continue
            if num_docs is not None and skip + written + len(batch_docs) >= num_docs:
                break
            doc_id, doc = CollectionParser.parse(line, collection_type)
            batch_ids.append(doc_id)
            batch_docs.append(doc)
            if len(batch_docs) == batch_size:
                flush()
                logger.info(f"expanded {skip + written} documents")
    flush()
    return written
