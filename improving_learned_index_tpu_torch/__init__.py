"""PyTorch/CUDA port of ``improving_learned_index_tpu`` for NVIDIA Hopper.

Mirrors the JAX package's subpackages (``core``, ``index``, ``models``,
``ops``, ``search``, ``serve``, ``text``, ``data``, ``evaluation``,
``train``, ``parallel``, ``cli``) module for module.
The port imports torch and numpy only: never JAX, and nothing of the JAX
package.  Every Pallas kernel of the JAX package on a ported path is a CUDA
kernel under ``csrc/``, built with ``nvcc`` at first use and bound with
``ctypes``; each sits beside a plain PyTorch version of the same function.

Entry points run on the card (``device=None`` means ``cuda``) unless the
caller passes ``device="cpu"``; without a CUDA device they raise.

Ported so far: the query path (load index -> hybrid engine -> exact top-k ->
run file -> MRR/Recall) with the other query engines (device, host,
native, dense, the blocked ``PallasBlockedEngine``); the encode path (text
-> BERT-family encoder with the ``short_attention`` kernel -> forward index
or binary impact store -> quantize -> invert); the index algebra (merge,
filter, split); the serving daemon with its shard router and hot swap;
training, the in-memory eval and the rerankers.  Every Pallas kernel of the
JAX package has its CUDA counterpart.
"""

__version__ = "0.1.0"
