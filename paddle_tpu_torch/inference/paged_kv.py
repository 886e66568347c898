"""Host-side bookkeeping for the serving paged KV cache.

The port's own copy of `paddle_tpu/inference/paged_kv.py` (`_Node` :96,
`AdmitPlan` :111, `PageAllocator` :132 through `mark_progress` :410),
pure Python and unchanged in behaviour.  The fleet-tier pieces
(`export_chain`, `graft`, `trie_digest`, `probe_digest`) belong to
disaggregated serving and are not ported yet.

The device side (ops.paged_attention / ops.paged_kv_update +
models.llama.init_paged_cache) is pure data plane: a page pool, page
tables, position-masked reads.  Everything stateful lives here, on the
host, at chunk boundaries:

  PageAllocator   free-list allocator over the pool (page 0 reserved
                  as the null page), per-page refcounts (number of
                  slots currently mapping the page), and a token-exact
                  prefix TRIE over page-sized prompt chunks.

Prefix sharing: a prompt's full pages are registered in the trie as it
prefills; a later admission whose prompt starts with the same chunks
maps those pages directly (refcount++) and SKIPS their prefill chunks
entirely — pos starts at the shared depth.

Copy-on-write at the divergence boundary: when the next chunk matches a
cached page only PARTIALLY (common prefix of m < page_size tokens), the
batcher copies the cached page into a freshly allocated private page
and the request prefills only from row m.

Lifecycle: pages mapped by live slots have refcount > 0 and are never
reclaimed.  When a request finishes, its trie-registered pages stay
RESIDENT as refcount-0 "cached" pages (the prefix cache); its
decode-area pages free immediately.  Allocation under pressure evicts
cached pages LRU-first (leaf-first, so the trie never dangles) and
counts each reclaimed page in `evictions`; if pressure persists after
the cache is empty, alloc() fails and the batcher defers the admission.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

__all__ = ["PageAllocator", "AdmitPlan"]


class _Node:
    """One page-sized prompt chunk in the prefix trie."""
    __slots__ = ("tokens", "page", "children", "parent", "complete", "lru")

    def __init__(self, tokens, page, parent):
        self.tokens = tokens          # tuple of page_size ints
        self.page = page
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent          # _Node or None (root child)
        self.complete = False         # all rows written on device
        self.lru = 0


class AdmitPlan:
    """What one admission decided: the covered page ids (shared prefix
    first, then privates), how many prompt tokens were skipped, an
    optional page copy for a mid-page divergence, and the trie nodes
    registered for the prompt's own chunks (completed as prefill
    advances, removed if the request dies before finishing them).
    `cow`'s SOURCE page arrives pinned (refcounted by admit) so
    pressure cannot reclaim it first — the caller must
    release_page(src) once the device copy is done."""
    __slots__ = ("pages", "shared_tokens", "cow", "nodes",
                 "n_shared_pages")

    def __init__(self, pages, shared_tokens, cow, nodes, n_shared_pages):
        self.pages: List[int] = pages
        self.shared_tokens = shared_tokens
        self.cow: Optional[Tuple[int, int]] = cow   # (src, dst) pages
        self.nodes: List[_Node] = nodes
        self.n_shared_pages = n_shared_pages


class PageAllocator:
    def __init__(self, num_pages: int, page_size: int):
        if num_pages < 2:
            raise ValueError("pool needs >= 2 pages (page 0 is the "
                             "reserved null page)")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.NULL = 0
        self._free = list(range(self.num_pages - 1, 0, -1))
        self._ref: Dict[int, int] = {}
        self._node_of: Dict[int, _Node] = {}   # page -> trie node
        self._root: Dict[tuple, _Node] = {}
        self._clock = 0
        self.evictions = 0
        self.prefix_hit_tokens = 0
        self.cow_copies = 0

    # -- introspection -----------------------------------------------------
    @property
    def pages_free(self) -> int:
        return len(self._free)

    @property
    def pages_used(self) -> int:
        return self.num_pages - 1 - len(self._free)

    @property
    def pages_cached(self) -> int:
        """Refcount-0 pages held resident only by the prefix cache."""
        return sum(1 for p, n in self._node_of.items()
                   if n.complete and self._ref.get(p, 0) == 0)

    # -- allocation --------------------------------------------------------
    def _touch(self, node: _Node):
        self._clock += 1
        node.lru = self._clock

    def _reclaimable(self) -> List[_Node]:
        """Cached LEAF pages, LRU order — leaf-first keeps every
        resident node reachable from the root."""
        out = [n for n in self._node_of.values()
               if n.complete and not n.children
               and self._ref.get(n.page, 0) == 0]
        out.sort(key=lambda n: n.lru)
        return out

    def alloc(self, n: int) -> Optional[List[int]]:
        """n fresh pages (refcount 1 each), evicting cached prefix
        pages LRU-leaf-first under pressure; None if the pool cannot
        serve n even with an empty prefix cache (caller defers).  Pages
        the caller has already refcounted are never reclaimable.  The
        victim list is computed once and refreshed only when it runs
        dry (dropping a leaf can turn its parent into the next leaf)."""
        victims: List[_Node] = []
        vi = 0
        while len(self._free) < n:
            if vi >= len(victims):
                victims, vi = self._reclaimable(), 0
                if not victims:
                    return None
            node = victims[vi]
            vi += 1
            # skip entries invalidated by our own earlier drops
            if self._node_of.get(node.page) is not node \
                    or node.children or self._ref.get(node.page, 0):
                continue
            self._drop_node(node)
            self._free.append(node.page)
            self.evictions += 1
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        return out

    def _drop_node(self, node: _Node):
        parent_children = node.parent.children if node.parent \
            else self._root
        for key, ch in list(parent_children.items()):
            if ch is node:
                del parent_children[key]
        self._node_of.pop(node.page, None)

    def ref_inc(self, page: int):
        self._ref[page] = self._ref.get(page, 0) + 1

    def release_page(self, page: int):
        """One slot unmaps `page`.  At refcount 0 the page either stays
        resident as a cached prefix page (complete trie node) or goes
        straight back to the free list."""
        r = self._ref.get(page, 0) - 1
        if r > 0:
            self._ref[page] = r
            return
        self._ref.pop(page, None)
        node = self._node_of.get(page)
        if node is None:
            self._free.append(page)
        elif not node.complete:
            # the owning request died before the page filled — the
            # chunk content is not trustworthy, drop it
            self._drop_node(node)
            self._free.append(page)
        else:
            self._touch(node)       # newly cached: most-recent end

    # -- prefix trie -------------------------------------------------------
    def prefix_match_len(self, tokens) -> int:
        """READ-ONLY probe: how many leading tokens of `tokens` are
        already resident as shareable prefix pages, capped at
        len(tokens)-1 exactly like admit().  No refcount change, no LRU
        touch, no allocation."""
        plen = len(tokens)
        if plen <= 1:
            return 0
        full, partial = self.match_prefix(tokens, max_share=plen - 1)
        return len(full) * self.page_size \
            + (partial[1] if partial is not None else 0)

    def match_prefix(self, tokens, max_share: int):
        """(full_nodes, partial) for `tokens`: full_nodes are complete
        trie nodes matching whole page_size chunks (walk stops at the
        first miss or incomplete node, and at max_share tokens);
        partial is (node, m) for the best mid-page divergence match
        among the next level's children (m < page_size common-prefix
        tokens), or None."""
        ps = self.page_size
        children = self._root
        full: List[_Node] = []
        i = 0
        while i + ps <= len(tokens) and (i + ps) <= max_share:
            child = children.get(tuple(int(t) for t in tokens[i:i + ps]))
            if child is None or not child.complete:
                break
            full.append(child)
            i += ps
            children = child.children
        partial = None
        best = 0
        rest = [int(t) for t in tokens[i:]]
        for chunk, child in children.items():
            if not child.complete:
                continue
            m = 0
            for a, b in zip(rest, chunk):
                if a != b:
                    break
                m += 1
            m = min(m, max_share - i)
            if m > best:
                best, partial = m, (child, m)
        return full, partial

    def register_chunk(self, parent: Optional[_Node], tokens,
                       page: int) -> Optional[_Node]:
        """Register `page` as the (pending) trie node for one full
        prompt chunk under `parent`; returns the node, or None when the
        chunk is already registered (a concurrent admission got there
        first — the duplicate page simply stays trie-less)."""
        children = parent.children if parent is not None else self._root
        key = tuple(int(t) for t in tokens)
        if key in children:
            return None
        node = _Node(key, page, parent)
        children[key] = node
        self._node_of[page] = node
        self._touch(node)
        return node

    def complete_node(self, node: _Node):
        node.complete = True
        self._touch(node)

    def remove_node(self, node: _Node):
        """Un-register a pending node (request died mid-prefill)."""
        if self._node_of.get(node.page) is node:
            self._drop_node(node)

    # -- admission ---------------------------------------------------------
    def admit(self, prompt, covered_pages: int) -> Optional[AdmitPlan]:
        """Plan one admission: match the prompt against the prefix
        cache (capped at len(prompt)-1 so the final prompt token always
        prefills — its logit seeds the first sampled token), allocate
        the private pages, and register pending trie nodes for the
        prompt's own full chunks.  Returns None (nothing allocated or
        registered) when the pool cannot back the request."""
        ps = self.page_size
        plen = len(prompt)
        full, partial = self.match_prefix(prompt, max_share=plen - 1)
        n_shared = len(full)
        shared_tokens = n_shared * ps
        cow_src = None
        if partial is not None and partial[1] > 0:
            cow_src = partial[0]
        n_priv = covered_pages - n_shared
        if n_priv <= 0 and cow_src is not None:
            cow_src = None          # no private page to copy into
        if n_priv < 0:
            # degenerate tiny-prompt corner: more shared pages than
            # coverage — trim the match instead of over-mapping
            full = full[:covered_pages]
            n_shared = len(full)
            shared_tokens = n_shared * ps
            cow_src = None
            n_priv = 0
        # pin the matched pages BEFORE allocating: under pressure the
        # eviction loop must never reclaim the very pages this plan is
        # about to map as shared (or copy from)
        for node in full:
            self.ref_inc(node.page)
            self._touch(node)
        if cow_src is not None:
            self.ref_inc(cow_src.page)
            self._touch(cow_src)
        priv = self.alloc(n_priv)
        if priv is None:
            for node in full:
                self.release_page(node.page)
            if cow_src is not None:
                self.release_page(cow_src.page)
            return None
        if cow_src is not None:
            shared_tokens += partial[1]
        self.prefix_hit_tokens += shared_tokens
        pages = [n.page for n in full] + priv
        # pending nodes for the prompt's own full chunks; chunks already
        # shared are existing nodes — the walk continues under the LAST
        # matched node
        nodes: List[_Node] = []
        parent = full[-1] if full else None
        for ci in range(n_shared, plen // ps):
            chunk = prompt[ci * ps:(ci + 1) * ps]
            node = self.register_chunk(parent, chunk, pages[ci])
            if node is None:
                break   # a concurrent admission owns this subtree
            nodes.append(node)
            parent = node
        cow = (cow_src.page, priv[0]) if cow_src is not None else None
        if cow is not None:
            self.cow_copies += 1
        return AdmitPlan(pages, shared_tokens, cow, nodes, n_shared)

    def release_plan(self, plan: AdmitPlan):
        """Request finished (or was aborted): drop its pending nodes
        that never completed, then unmap every covered page."""
        for node in plan.nodes:
            if not node.complete:
                self.remove_node(node)
        for page in plan.pages:
            self.release_page(page)

    def mark_progress(self, plan: AdmitPlan, pos: int):
        """Prefill advanced to `pos` rows: pending nodes whose page is
        now fully written become shareable."""
        ps = self.page_size
        for node in plan.nodes:
            if node.complete:
                continue
            idx = plan.pages.index(node.page)
            if pos >= (idx + 1) * ps:
                self.complete_node(node)
