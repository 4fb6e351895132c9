"""Radix prefix cache over the paged KV pool (the port's own copy of
``ray_tpu/serve/prefix_cache.py``, unchanged in behaviour: pure Python
over the refcounted ``PageAllocator``).

Role-equivalent to vLLM-style automatic prefix caching / SGLang
RadixAttention as deployed behind Ray Serve LLM (reference: fleets
sharing a system prompt pay one prefill).  Page-aligned prompt prefixes
live in a radix tree: each node owns ONE KV page keyed by that page's
``page_size`` token ids, so walking full-page chunks of a new prompt
yields the longest cached prefix.  The tree holds one allocator ref per
cached page and every sequence that matches takes its own ref
(:meth:`PageAllocator.share`), so a page outlives whichever of
tree/sequences releases it last.

Copy-on-write: when a prompt diverges MID-page from a cached child, the
engine copies that child's page into a fresh private page
(``models/paged.copy_page``) and suffix-prefills from the divergence
point — the cached page is never written after insertion (decode always
appends past the frozen prompt prefix; only fully-frozen pages are
inserted).

Trees are keyed PER ADAPTER: cached V depends on the adapter's wv delta,
so sharing a prefix across adapters would be silently wrong.

Owned by the engine's loop thread like the allocator — no locking here.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

_Key = Tuple[int, ...]


class _Node:
    __slots__ = ("key", "page", "children", "parent", "last_used")

    def __init__(self, key: _Key, page: int, parent: "_Node",
                 last_used: int):
        self.key = key
        self.page = page
        self.children: Dict[_Key, "_Node"] = {}
        self.parent = parent
        self.last_used = last_used


@dataclasses.dataclass
class PrefixMatch:
    """Result of a lookup.  ``pages`` are fully-matched cached pages
    (tokens ``[0, matched_len)``); ``cow_src``/``cow_overlap`` describe a
    mid-page divergence: copy ``cow_src`` and keep its first
    ``cow_overlap`` token positions.  ``prefix_len`` is what the suffix
    prefill skips.  Take refs via :meth:`RadixPrefixCache.claim` before
    touching any of these pages."""

    pages: List[int]
    matched_len: int
    cow_src: Optional[int] = None
    cow_overlap: int = 0
    _nodes: List[_Node] = dataclasses.field(default_factory=list)

    @property
    def prefix_len(self) -> int:
        return self.matched_len + self.cow_overlap

    @property
    def hit(self) -> bool:
        return self.prefix_len > 0


class RadixPrefixCache:
    def __init__(self, page_size: int):
        self.page_size = page_size
        self._roots: Dict[Optional[str], _Node] = {}
        self._clock = 0
        self.pages = 0          # pages the tree currently holds refs on
        self.hits = 0           # lookups that matched >= 1 token
        self.lookups = 0
        self.inserts = 0        # pages inserted
        self.evicted = 0        # pages released by leaf eviction

    def _root(self, adapter: Optional[str]) -> _Node:
        r = self._roots.get(adapter)
        if r is None:
            r = self._roots[adapter] = _Node((), -1, None, 0)  # type: ignore[arg-type]
        return r

    # -------------------------------------------------------------- lookup

    def lookup(self, adapter: Optional[str], tokens) -> PrefixMatch:
        """Longest cached prefix of ``tokens`` under ``adapter``'s tree.
        Pure (no refcount changes).  At least one suffix token is always
        left unmatched — the first sampled token needs real logits, so a
        full-prompt hit is capped one position short."""
        toks: _Key = tuple(int(t) for t in tokens)
        ps = self.page_size
        self.lookups += 1
        node = self._root(adapter)
        pages: List[int] = []
        nodes: List[_Node] = []
        matched = 0
        while matched + ps < len(toks):
            child = node.children.get(toks[matched:matched + ps])
            if child is None:
                break
            pages.append(child.page)
            nodes.append(child)
            node = child
            matched += ps
        # Mid-page divergence: the child sharing the longest proper
        # token-prefix with the remainder is the COW source.
        rem = toks[matched:]
        cow_src, cow_overlap, cow_node = None, 0, None
        cap = min(ps, len(rem) - 1)  # keep >= 1 suffix token
        if cap > 0:
            for key, child in node.children.items():
                ov = 0
                for a, b in zip(key, rem):
                    if a != b:
                        break
                    ov += 1
                ov = min(ov, cap)
                if ov > cow_overlap:
                    cow_overlap, cow_src, cow_node = ov, child.page, child
        m = PrefixMatch(pages, matched, cow_src, cow_overlap,
                        _nodes=nodes + ([cow_node] if cow_node else []))
        if m.hit:
            self.hits += 1
        return m

    def claim(self, match: PrefixMatch, allocator) -> None:
        """Take one sequence ref per matched page (including the COW
        source — it must survive until the engine copies it) and bump
        recency on the matched path."""
        held = list(match.pages)
        if match.cow_src is not None:
            held.append(match.cow_src)
        allocator.share(held)
        self._clock += 1
        for n in match._nodes:
            n.last_used = self._clock

    # -------------------------------------------------------------- insert

    def insert(self, adapter: Optional[str], tokens, pages: List[int],
               allocator) -> int:
        """Insert a freshly-prefilled prompt's FULL pages (``pages[i]``
        holds tokens ``[i*ps, (i+1)*ps)``).  Existing nodes dedupe — the
        tree keeps its first copy and takes no ref on the newcomer's
        page.  The trailing partial page is never inserted: decode still
        appends to it.  Returns pages newly cached."""
        toks: _Key = tuple(int(t) for t in tokens)
        ps = self.page_size
        node = self._root(adapter)
        self._clock += 1
        added = 0
        for i in range(len(toks) // ps):
            key = toks[i * ps:(i + 1) * ps]
            child = node.children.get(key)
            if child is None:
                child = _Node(key, pages[i], node, self._clock)
                node.children[key] = child
                allocator.share([pages[i]])
                self.pages += 1
                self.inserts += 1
                added += 1
            child.last_used = self._clock
            node = child
        return added

    # ------------------------------------------------------------- eviction

    def evict_leaves(self, want: int, allocator) -> int:
        """Release up to ``want`` tree-held pages, LRU leaves first.
        Only leaves whose page the tree holds the LAST ref on count —
        freeing a page a live sequence still reads returns nothing to
        the free list (and discards reusable cache for no gain), so
        those leaves are left alone.  Interior nodes are positional:
        a child's page is meaningless without its parent, so eviction
        never orphans a subtree."""
        freed = 0
        while freed < want:
            leaves = [n for n in self._walk()
                      if not n.children and allocator.refs(n.page) == 1]
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for n in leaves:
                if freed >= want:
                    break
                del n.parent.children[n.key]
                allocator.free([n.page])
                self.pages -= 1
                self.evicted += 1
                freed += 1
        return freed

    def drop_adapter(self, adapter: Optional[str], allocator) -> int:
        """Release every page under one adapter's tree (the adapter's
        weights changed — its cached V deltas are stale)."""
        root = self._roots.pop(adapter, None)
        n = 0
        if root is not None:
            for node in self._walk_from(root):
                allocator.free([node.page])
                self.pages -= 1
                n += 1
        return n

    def clear(self, allocator) -> int:
        """Release every tree-held ref (pool rebuild, drain-to-balance
        in tests/bench)."""
        n = 0
        for adapter in list(self._roots):
            n += self.drop_adapter(adapter, allocator)
        return n

    # ---------------------------------------------------------------- misc

    def _walk(self):
        for root in self._roots.values():
            yield from self._walk_from(root)

    def _walk_from(self, root: _Node):
        stack = list(root.children.values())
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            yield n

    def stats(self) -> Dict[str, Any]:
        return {
            "pages": self.pages,
            "hits": self.hits,
            "lookups": self.lookups,
            "inserts": self.inserts,
            "evicted": self.evicted,
            "trees": len(self._roots),
        }
