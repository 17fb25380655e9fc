"""Broadcast facade, as the reference's ``core/bcast.py``: ``pbcast`` and
``pbcast_tree`` route through the tuned plan layer (:mod:`repro_torch.comm`),
and ``preduce_sum`` is the mirror-image reduce-to-root over the reversed
binomial tree that the paper's CA-CNTK step runs before its broadcast."""
from __future__ import annotations

import torch

from ..comm import api as _api

__all__ = ["pbcast", "pbcast_tree", "preduce_sum"]

pbcast = _api.pbcast
pbcast_tree = _api.pbcast_tree


def preduce_sum(x: torch.Tensor, *, root: int = 0) -> torch.Tensor:
    """Reduce-to-root (sum) of the rank-stacked ``x`` via the reversed
    binomial tree. Only row ``root`` of the result is meaningful (MPI_Reduce
    semantics)."""
    return _api.preduce(x, root=root, algo="binomial_reduce")
