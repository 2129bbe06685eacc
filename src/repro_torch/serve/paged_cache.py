"""Block-based paged KV cache — refcounting allocator + prefix index
(counterpart of `repro.serve.paged_cache`).

KV storage is a pool of fixed-size pages shared by all in-flight
requests:

  k/v pool : (L, n_pages, page_size, KV, Dh)   device tensors
  allocator: host-side refcounting free list handing out page ids
  per-request page table: ordered page ids; the j-th page of a request
             holds its token positions [j*page_size, (j+1)*page_size).

Page 0 is RESERVED as the trash page: steps run at a fixed max-batch
shape, and inactive batch lanes scatter their (garbage) K/V into page
0 / read from it behind the length mask.

`PageAllocator` and `PrefixIndex` are host logic, copied verbatim from
the reference. The pool differs in one way: the reference's steps
return a new pool (JAX donates the old buffer), while here the pool is
owned and every write updates it in place — the chunk scatter, and
`cow_copy_page` for copy-on-write forks.
"""
from __future__ import annotations

import dataclasses
import hashlib

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

TRASH_PAGE = 0


class PageAllocator:
    """Refcounting free-list allocator over `n_pages` fixed-size pages.

    Page ids are ints in [1, n_pages); page 0 (TRASH_PAGE) is never
    handed out. A page may have MULTIPLE owners (prefix sharing):
    `alloc` creates it at refcount 1, `share` adds owners, `free`
    removes one owner per call and returns the page to the pool only
    when the refcount hits zero. Allocation is LIFO on the free list so
    tests can pin down exact page reuse; within one `free` call the
    released pages re-enter the free list in sorted-DESCENDING order
    (so the next pops return the lowest id first) — reuse order must
    not depend on each call site's incidental list ordering.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is reserved)")
        self.n_pages = n_pages
        self.page_size = page_size
        # LIFO: low page ids come back first (deterministic)
        self._free = list(range(n_pages - 1, 0, -1))
        self._owners: dict[int, set[int]] = {}   # page id -> owner rids
        self.total_allocated = 0   # monotone count of pages handed out

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_used(self) -> int:
        """PHYSICAL pages currently live (shared pages count once)."""
        return len(self._owners)

    @property
    def n_logical(self) -> int:
        """Sum of refcounts — what n_used would be without sharing."""
        return sum(len(o) for o in self._owners.values())

    def pages_for(self, n_tokens: int) -> int:
        """Pages needed to hold n_tokens."""
        return max(1, -(-n_tokens // self.page_size))

    def can_alloc(self, n: int) -> bool:
        return n <= len(self._free)

    def alloc(self, n: int, owner: int) -> list[int]:
        """Take n pages for request `owner`; raises if the pool is dry."""
        if n > len(self._free):
            raise MemoryError(
                f"paged cache exhausted: want {n}, free {len(self._free)}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owners[p] = {owner}
        self.total_allocated += n
        return pages

    def share(self, pages: list[int], owner: int) -> None:
        """Add `owner` as a co-owner of already-resident pages
        (refcount + 1 each). Sharing a free page or double-sharing the
        same page for one owner is a bug, not a no-op."""
        for p in pages:
            owners = self._owners.get(p)
            if owners is None:
                raise ValueError(f"cannot share free page {p}")
            if owner in owners:
                raise ValueError(
                    f"request {owner} already owns page {p}")
        for p in pages:
            self._owners[p].add(owner)

    def free(self, pages: list[int], owner: int | None = None) -> list[int]:
        """Release one ownership of each page. Pages whose refcount hits
        zero return to the free list (sorted descending within this
        call, see class docstring) and are returned to the caller so a
        prefix index can forget them. `owner=None` is accepted only for
        unshared pages (the single owner is implied)."""
        drop: list[tuple[int, int]] = []
        seen: dict[int, int] = {}
        for p in pages:
            owners = self._owners.get(p)
            if owners is None or seen.get(p, 0) >= len(owners):
                raise ValueError(f"double free of page {p}")
            if owner is not None:
                if seen.get(p):
                    raise ValueError(f"double free of page {p}")
                if owner not in owners:
                    raise ValueError(
                        f"request {owner} does not own page {p}")
                drop.append((p, owner))
            else:
                if len(owners) > 1:
                    raise ValueError(
                        f"page {p} is shared ({len(owners)} owners): "
                        f"free needs an explicit owner")
                drop.append((p, next(iter(owners))))
            seen[p] = seen.get(p, 0) + 1
        released = []
        for p, o in drop:
            owners = self._owners[p]
            owners.discard(o)
            if not owners:
                del self._owners[p]
                released.append(p)
        self._free.extend(sorted(released, reverse=True))
        return released

    def refcount(self, page: int) -> int:
        return len(self._owners.get(page, ()))

    def owners_of(self, page: int) -> frozenset[int]:
        return frozenset(self._owners.get(page, ()))

    def check_invariants(self) -> None:
        """No aliasing, no leaks: free + used partition [1, n_pages);
        every live page has refcount >= 1 (owner sets are non-empty and
        shared pages are counted once physically)."""
        free = set(self._free)
        used = set(self._owners)
        assert len(free) == len(self._free), "duplicate pages on free list"
        assert not (free & used), f"aliased pages {free & used}"
        assert free | used == set(range(1, self.n_pages)), "leaked pages"
        assert TRASH_PAGE not in free and TRASH_PAGE not in used
        for p, owners in self._owners.items():
            assert owners, f"live page {p} with refcount 0"
        assert self.n_logical >= self.n_used, "refcount accounting broken"


class PrefixIndex:
    """Token-run -> resident-page index for prefix sharing.

    A page holding positions [j*page, (j+1)*page) is keyed by the hash
    of the WHOLE token prefix [0, (j+1)*page) — K/V content depends on
    everything before it, so the chain key, not the page's own tokens,
    identifies shareable content. Matching walks the chain page by
    page; the stored per-page tokens are compared on every hit so a
    hash collision can never corrupt outputs. A final PARTIAL match is
    allowed when the prompt ends mid-page: a resident page whose token
    run starts with the prompt's remainder covers it (the sharer masks
    the tail by seq_len, and its first divergent write COW-forks the
    page).

    First writer wins: registering content that is already indexed is a
    no-op, and a page is never indexed twice. `forget` must be called
    with pages the allocator actually released.
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = page_size
        self._chain: dict[bytes, int] = {}      # prefix digest -> page
        # page -> (own key, parent key, this page's tokens)
        self._entries: dict[int, tuple[bytes, bytes, np.ndarray]] = {}
        self._children: dict[bytes, list[int]] = {}  # parent key -> pages
        # bumped on every mutation so callers can memoize match results
        self.generation = 0

    def __len__(self) -> int:
        return len(self._entries)

    def pages(self) -> list[int]:
        """Currently-indexed page ids (for invariant checks: every
        indexed page must still be resident in the allocator)."""
        return list(self._entries)

    @staticmethod
    def _digest(tokens: np.ndarray) -> bytes:
        buf = np.ascontiguousarray(tokens, dtype=np.int32).tobytes()
        return hashlib.sha1(buf).digest()

    def register(self, prefix: np.ndarray, page: int) -> bool:
        """Index `page` as holding the last `page_size` tokens of
        `prefix` (whose length must be a positive page multiple).
        Returns False when the content is already indexed (first
        writer wins) or the page already has an entry."""
        prefix = np.asarray(prefix, np.int32).reshape(-1)
        ps = self.page_size
        if len(prefix) < ps or len(prefix) % ps:
            raise ValueError(
                f"prefix length {len(prefix)} is not a positive multiple "
                f"of page_size {ps}")
        if page in self._entries:
            return False
        key = self._digest(prefix)
        if key in self._chain:
            return False
        parent = self._digest(prefix[:-ps])
        self._chain[key] = page
        self._entries[page] = (key, parent, prefix[-ps:].copy())
        self._children.setdefault(parent, []).append(page)
        self.generation += 1
        return True

    def forget(self, pages: list[int]) -> None:
        """Drop released pages from the index (pages never indexed are
        ignored — private/partial pages are a normal case)."""
        for p in pages:
            entry = self._entries.pop(p, None)
            if entry is None:
                continue
            key, parent, _ = entry
            if self._chain.get(key) == p:
                del self._chain[key]
            kids = self._children.get(parent)
            if kids is not None:
                kids.remove(p)
                if not kids:
                    del self._children[parent]
            self.generation += 1

    def match(self, prompt: np.ndarray) -> tuple[int, list[int]]:
        """Longest resident prefix of `prompt`: returns (matched_len,
        pages). Full pages match by chain key (token-verified); if the
        prompt then ends mid-page, a resident sibling page whose run
        starts with the remainder extends the match to the whole
        prompt (registration order breaks ties deterministically)."""
        prompt = np.ascontiguousarray(prompt, np.int32).reshape(-1)
        ps = self.page_size
        pages: list[int] = []
        j = 0
        # ONE incremental hash walks the chain (digest() does not
        # finalize, so each level costs one page of hashing, not a
        # re-hash of the whole prefix)
        h = hashlib.sha1()
        matched_key = h.digest()
        while (j + 1) * ps <= len(prompt):
            h.update(prompt[j * ps:(j + 1) * ps].tobytes())
            key = h.digest()
            page = self._chain.get(key)
            if page is None:
                break
            if not np.array_equal(self._entries[page][2],
                                  prompt[j * ps:(j + 1) * ps]):
                break   # hash collision: treat as a miss
            pages.append(page)
            matched_key = key
            j += 1
        matched = j * ps
        rem = len(prompt) - matched
        if 0 < rem < ps:
            for page in self._children.get(matched_key, ()):
                if np.array_equal(self._entries[page][2][:rem],
                                  prompt[matched:]):
                    pages.append(page)
                    matched = len(prompt)
                    break
        return matched, pages


def cow_copy_page(kv, src: int, dst: int):
    """Copy page `src` -> `dst` across all layers, in place (the
    copy-on-write fork); returns the same pool."""
    kv["k"][:, dst] = kv["k"][:, src]
    kv["v"][:, dst] = kv["v"][:, src]
    return kv


@dataclasses.dataclass
class PagedKVCache:
    """Device page pool + its host-side allocator."""
    kv: dict                 # {"k","v"}: (L, n_pages, page, KV, Dh)
    allocator: PageAllocator

    @property
    def page_size(self) -> int:
        return self.kv["k"].shape[2]

    @property
    def n_pages(self) -> int:
        return self.kv["k"].shape[1]

    def utilization(self) -> float:
        """Fraction of allocatable pages PHYSICALLY live (shared pages
        count once — this is what bounds admission)."""
        return self.allocator.n_used / max(self.allocator.n_pages - 1, 1)

    def logical_utilization(self) -> float:
        """Per-request page-table footprint over the pool size: what
        utilization would be WITHOUT sharing. logical - physical is the
        capacity the prefix sharing bought."""
        return (self.allocator.n_logical
                / max(self.allocator.n_pages - 1, 1))


def init_paged_cache(cfg: ModelConfig, n_pages: int, page_size: int,
                     dtype=torch.float32, device="cuda") -> PagedKVCache:
    """Build the device page pool: two zeroed (L, n_pages, page, KV, Dh)
    tensors on `device`."""
    if cfg.family not in ("dense", "moe"):
        raise ValueError(
            f"paged KV cache needs an attention family, got {cfg.family!r}")
    device = resolve_device(device)
    kv_heads, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, n_pages, page_size, kv_heads, hd)
    kv = {"k": torch.zeros(shape, dtype=dtype, device=device),
          "v": torch.zeros(shape, dtype=dtype, device=device)}
    return PagedKVCache(kv=kv, allocator=PageAllocator(n_pages, page_size))
