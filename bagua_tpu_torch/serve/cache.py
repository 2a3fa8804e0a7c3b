"""Paged KV-cache bookkeeping: the host half of the serving plane's memory.

Port of ``bagua_tpu/serve/cache.py``.  The device half lives in
:mod:`bagua_tpu_torch.models.transformer`: a paged decode config
(``TransformerConfig(decode=True, page_size=P, num_pages=N)``) keeps one
page pool ``[num_pages, page_size, heads, head_dim]`` a layer
(``PagedKVCache``) instead of a dense ``[b, max_seq_len, ...]`` cache.
Requests of different lengths share the pool through per-slot **block
tables**; the decode tick never changes shape.

* :class:`PagePool` — the free-page allocator over ``num_pages`` (pages
  ``ZERO_PAGE`` and ``TRASH_PAGE`` are reserved).  Exhaustion returns
  ``None`` — the scheduler's cue to queue or preempt, never to crash.
* :class:`SlotTable` — the per-slot block tables / lengths / active mask,
  kept as numpy on the host (the scheduler mutates them between ticks) and
  copied into the device ``slots`` argument of each tick.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..models.transformer import RESERVED_PAGES, TRASH_PAGE, ZERO_PAGE

__all__ = ["PagePool", "SlotTable", "ZERO_PAGE", "TRASH_PAGE",
           "RESERVED_PAGES"]


class PagePool:
    """Free-list allocator over the paged KV-cache's page ids.

    Pure host bookkeeping — the pages' storage is the per-layer pools of
    the engine's ``PagedKVCache``; one allocation here stands for
    the same page id in EVERY layer's pool (the block table is shared
    across layers, so a single id allocates ``2 * n_layers`` physical
    pages' worth of KV).
    """

    def __init__(self, num_pages: int):
        if num_pages <= RESERVED_PAGES:
            raise ValueError(
                f"num_pages must exceed the {RESERVED_PAGES} reserved "
                f"pages, got {num_pages}"
            )
        self.num_pages = int(num_pages)
        # LIFO free list: recently freed pages are re-used first (their
        # pool rows are hot, and reuse exercises the stale-page masking)
        self._free: List[int] = list(
            range(self.num_pages - 1, RESERVED_PAGES - 1, -1)
        )

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return (self.num_pages - RESERVED_PAGES) - len(self._free)

    def alloc(self) -> Optional[int]:
        """One free page id, or None when the pool is exhausted (the
        scheduler then queues the request or preempts a slot)."""
        if not self._free:
            return None
        return self._free.pop()

    def free(self, pages) -> None:
        for p in pages:
            p = int(p)
            assert RESERVED_PAGES <= p < self.num_pages, p
            assert p not in self._free, f"double free of page {p}"
            self._free.append(p)


class SlotTable:
    """Per-slot block tables / lengths / active flags (host numpy).

    ``block_table[slot]`` maps the slot's logical pages (position //
    page_size) to pool page ids; unallocated entries stay at the ZERO page
    so the device gather reads zeros there — exactly the dense cache's
    untouched rows, which is what keeps paged decode bit-identical.
    """

    def __init__(self, max_slots: int, max_seq_len: int, page_size: int):
        assert max_seq_len % page_size == 0, (max_seq_len, page_size)
        self.max_slots = int(max_slots)
        self.page_size = int(page_size)
        self.pages_per_slot = max_seq_len // page_size
        self.block_table = np.full(
            (self.max_slots, self.pages_per_slot), ZERO_PAGE, np.int32
        )
        self.lengths = np.zeros((self.max_slots,), np.int32)
        self.active = np.zeros((self.max_slots,), bool)
        #: page ids held per slot, in allocation (position) order
        self.pages: Dict[int, List[int]] = {i: [] for i in range(max_slots)}

    def needs_page(self, slot: int, n_tokens: int = 1) -> int:
        """Pages the slot must still allocate before caching ``n_tokens``
        more tokens at its current length."""
        have = len(self.pages[slot])
        need = -(-(int(self.lengths[slot]) + n_tokens) // self.page_size)
        return max(0, need - have)

    def map_page(self, slot: int, page: int) -> None:
        idx = len(self.pages[slot])
        assert idx < self.pages_per_slot, (slot, idx)
        self.pages[slot].append(int(page))
        self.block_table[slot, idx] = int(page)

    def release(self, slot: int) -> List[int]:
        """Clear a slot (eviction / preemption); returns its pages for the
        pool to reclaim."""
        pages, self.pages[slot] = self.pages[slot], []
        self.block_table[slot, :] = ZERO_PAGE
        self.lengths[slot] = 0
        self.active[slot] = False
        return pages

    def device_slots(self) -> Dict[str, np.ndarray]:
        """The host copies of one tick's ``slots`` argument — snapshots, so
        the tick never aliases arrays the scheduler mutates next."""
        return {
            "block_table": self.block_table.copy(),
            "lengths": self.lengths.copy(),
            "active": self.active.copy(),
        }
