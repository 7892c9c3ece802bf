"""Plain reference of a row of index slices (Rosset et al., SIGIR 2018,
§3: each index machine runs its match plan over its own slice, and the
aggregator merges their candidates by static rank), written from the
configuration file alone: no part of the program is imported or called.

Each slice's answers are the one-slice reference's (``websearch_rl.serve``
over that slice's blocks).  The row's: each slice's doc ids offset by the
slice's number times its documents, concatenated in slice order, the -1
pads dropped, the ``keep`` smallest ids kept in ascending order (the
documents lie in static-rank order) and padded with -1; u and the
candidate counts summed over the slices."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from perfbench.reference.websearch_rl import serve

__all__ = ["serve", "merge"]

Answers = Tuple[np.ndarray, np.ndarray, np.ndarray]   # cand (B, K), u, cnt


def merge(slices: Sequence[Answers], slice_docs: int, keep: int) -> Answers:
    """The row's (cand, u, cnt) from its slices' answers, in slice order."""
    rows = slices[0][0].shape[0]
    ids = [np.where(c >= 0, c.astype(np.int64) + i * slice_docs, -1)
           for i, (c, _, _) in enumerate(slices)]
    cand = np.full((rows, keep), -1, dtype=np.int64)
    for r in range(rows):
        found = np.sort(np.concatenate([x[r][x[r] >= 0] for x in ids]))[:keep]
        cand[r, :len(found)] = found
    u = np.sum([s[1].astype(np.int64) for s in slices], axis=0)
    cnt = np.sum([s[2].astype(np.int64) for s in slices], axis=0)
    return cand, u, cnt
