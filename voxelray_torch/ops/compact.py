"""Active-set compaction, the idiom the traversal loops share.

Counterpart of voxelray_tpu/ops/compact.py: rank the active lanes with a
cumsum, scatter their source indices into a fixed `cap`-sized domain, and
derive a live-slot mask plus a clamped gather index.  Empty slots hold
the out-of-range index `n`, so a write-back through `sel` into an
(n + 1)-long buffer lands in its spare last slot instead of racing on a
clamped duplicate.
"""
from __future__ import annotations

import torch

__all__ = ["compact_mask"]


def compact_mask(mask, cap: int, n: int):
    """Compact the True (or nonzero) lanes of `mask` (shape (n,)) into a
    `cap`-sized index domain.

    Returns (sel, live, sel_c, pos):
      sel   int64[cap] - source index of each compacted slot, `n` where
            the slot is empty
      live  bool[cap]  - the slot holds a real lane
      sel_c int64[cap] - sel clamped to n-1 (a safe gather index; the
            caller masks the lanes where ~live)
      pos   int64[n]   - each source lane's rank among the actives; lanes
            with pos >= cap did not fit (the caller's overflow set)
    """
    dev = mask.device
    active = mask.reshape(-1) != 0
    pos = torch.cumsum(active.to(torch.int64), 0) - 1
    slot = torch.where(active & (pos < cap), pos,
                       torch.full_like(pos, cap))
    # slot `cap` is the drop bin: every lane that does not fit lands there
    sel = torch.full((cap + 1,), n, dtype=torch.int64, device=dev)
    sel[slot] = torch.arange(n, dtype=torch.int64, device=dev)
    sel = sel[:cap]
    live = sel < n
    sel_c = torch.clamp(sel, max=max(n - 1, 0))
    return sel, live, sel_c, pos
