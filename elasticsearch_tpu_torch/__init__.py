"""elasticsearch_tpu_torch: the search engine's port to PyTorch and CUDA.

A package beside `elasticsearch_tpu` (the JAX reference), with the same
module paths and names so each counterpart is easy to find. It imports
torch and numpy, never jax, and nothing of the reference package.

Device rule: entry points take a `device`; `None` means CUDA, and they
raise when no CUDA device is present instead of carrying on on the CPU.
Pass `device="cpu"` to run on the CPU (the tests do).

The front door is the reference's: a `Node` (`node.py`) behind the REST
handlers (`rest/server.py`, `python -m elasticsearch_tpu_torch.rest.
server`), writing through `_bulk` / index, publishing through refresh
(segments or a base + delta pack with compaction, `index/engine.py`) and
reading through `_search` / `_msearch` on `search/shard_searcher.
ShardReader` and the hand-written kernels of `ops/`.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
    """`None` -> CUDA; raises when a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
