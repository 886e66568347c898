"""Host-side bookkeeping for the serving paged KV cache.

The port's own copy of `paddle_tpu/inference/paged_kv.py` (`_fnv` and
`probe_digest` :55-94, `_Node` :96, `AdmitPlan` :111, `PageAllocator`
:132 through `trie_digest` :507), pure Python and unchanged in
behaviour, the fleet tier included: `admit(..., imported=)` and
`register_chunk(..., imported=)` mark chunks whose KV arrived from
another replica (counted in `import_hit_tokens` when an admission
reuses them), `export_chain` names the resident pages a holder ships,
`graft` registers a replicated chain slot-less (`grafted_pages`), and
`trie_digest` / `probe_digest` publish and score a bounded hash-chain
view of the trie for cross-replica routing.

The device side (ops.paged_attention + models.llama.init_paged_cache) is
pure data plane: a page pool, page tables, position-masked reads.
Everything stateful lives here, on the host, at chunk boundaries:

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

__all__ = ["PageAllocator", "AdmitPlan", "probe_digest"]

# FNV-1a over token streams — the cross-replica digest hash.  Chosen
# because it is deterministic across processes (unlike salted hash()),
# dependency-free, and cheap on the short page-sized chunks it sees.
_FNV_SEED = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_FNV_MASK = 0xFFFFFFFFFFFFFFFF


def _fnv(h: int, tokens) -> int:
    for t in tokens:
        v = int(t) & _FNV_MASK
        for _ in range(8):          # 8 LE bytes per token id
            h = ((h ^ (v & 0xFF)) * _FNV_PRIME) & _FNV_MASK
            v >>= 8
    return h


def probe_digest(digest, tokens, page_size: int) -> int:
    """Estimated resident-prefix depth (in tokens) of `tokens` against
    a replica's published trie digest — the advisory cross-replica twin
    of `prefix_match_len`.  A digest entry is ``[depth, chain_hash]``
    where chain_hash is the cumulative FNV-1a of the root→node chunk
    chain; the probe hashes the prompt's own chunk chain and returns
    the deepest published depth it reproduces.  Advisory only: a hash
    collision over-estimates and a bounded digest under-estimates, and
    either way the router just scores the replica slightly wrong —
    admission re-matches token-exactly on arrival."""
    if not digest:
        return 0
    have: Dict[int, set] = {}
    for ent in digest:
        try:
            d, h = int(ent[0]), str(ent[1])
        except (TypeError, ValueError, IndexError):
            continue
        have.setdefault(d, set()).add(h)
    ps = int(page_size)
    cap = len(tokens) - 1        # last prompt token always prefills
    h = _FNV_SEED
    best = 0
    i = 0
    while i + ps <= len(tokens) and i + ps <= cap:
        h = _fnv(h, tokens[i:i + ps])
        i += ps
        if "%016x" % h in have.get(i, ()):
            best = i
    return best


class _Node:
    """One page-sized prompt chunk in the prefix trie."""
    __slots__ = ("tokens", "page", "children", "parent", "complete",
                 "lru", "imported")

    def __init__(self, tokens, page, parent):
        self.tokens = tokens          # tuple of page_size ints
        self.page = page
        self.children: Dict[tuple, "_Node"] = {}
        self.parent = parent          # _Node or None (root child)
        self.complete = False         # all rows written on device
        self.lru = 0
        self.imported = False         # KV arrived from another replica


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

    def __init__(self, pages, shared_tokens, cow, nodes,
                 n_shared_pages):
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
        # fleet-tier prefix cache: tokens matched against chunks whose
        # KV was imported from another replica (hand-off graft or hot-
        # prefix replication) — the cross-replica hit counter
        self.import_hit_tokens = 0
        self.grafted_pages = 0

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
        serve n even with an empty prefix cache (caller defers).
        Pages the caller has already refcounted (an in-flight
        admission's matched prefix) are never reclaimable.  The victim
        list is computed once and refreshed only when it runs dry
        (dropping a leaf can turn its parent into the next leaf) —
        not re-scanned per evicted page."""
        victims: List[_Node] = []
        vi = 0
        while len(self._free) < n:
            if vi >= len(victims):
                victims, vi = self._reclaimable(), 0
                if not victims:
                    return None
            node = victims[vi]
            vi += 1
            # defensive staleness guard: skip entries invalidated by
            # our own earlier drops this call
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
        already resident as shareable prefix pages (complete full-page
        chunks plus the best mid-page partial match), capped at
        len(tokens)-1 exactly like admit() — the answer is the prefill
        work an admission here would SKIP.

        Pure trie walk: no refcount change, no LRU touch, no CoW, no
        allocation — the serve-fleet router calls this against every
        replica per routed request, so probing must never pin a page
        or perturb the eviction order (regression-pinned)."""
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
                       page: int, imported: bool = False) \
            -> Optional[_Node]:
        """Register `page` as the (pending) trie node for one full
        prompt chunk under `parent`; returns the node, or None when the
        chunk is already registered (a concurrent admission got there
        first — the duplicate page simply stays trie-less)."""
        children = parent.children if parent is not None else self._root
        key = tuple(int(t) for t in tokens)
        if key in children:
            return None
        node = _Node(key, page, parent)
        node.imported = imported
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
    def admit(self, prompt, covered_pages: int,
              imported: bool = False) -> Optional[AdmitPlan]:
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
        # about to map as shared (or copy from) and recycle them as
        # its own privates — a silent shared/private alias
        for node in full:
            self.ref_inc(node.page)
            self._touch(node)
        if cow_src is not None:
            self.ref_inc(cow_src.page)
            self._touch(cow_src)
        priv = self.alloc(n_priv)
        if priv is None:
            # roll the pins back: complete nodes return to the cached
            # state (release_page re-touches them to the recent end)
            for node in full:
                self.release_page(node.page)
            if cow_src is not None:
                self.release_page(cow_src.page)
            return None
        if cow_src is not None:
            shared_tokens += partial[1]
        self.prefix_hit_tokens += shared_tokens
        # attribute hits on grafted chunks: KV computed on ANOTHER
        # replica, reused here — the fleet-tier cache working
        imp = sum(ps for node in full if node.imported)
        if cow_src is not None and cow_src.imported:
            imp += partial[1]
        self.import_hit_tokens += imp
        pages = [n.page for n in full] + priv
        # pending nodes for the prompt's own full chunks (content is
        # prompt-determined, so future admissions can share them);
        # chunks already shared are existing nodes — walk continues
        # under the LAST matched node
        nodes: List[_Node] = []
        parent = full[-1] if full else None
        for ci in range(n_shared, plen // ps):
            chunk = prompt[ci * ps:(ci + 1) * ps]
            node = self.register_chunk(parent, chunk, pages[ci],
                                       imported=imported)
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
            # node i covers logical rows [i*ps, (i+1)*ps) — find its
            # index from the plan's page list
            idx = plan.pages.index(node.page)
            if pos >= (idx + 1) * ps:
                self.complete_node(node)

    # -- fleet-tier prefix cache --------------------------------
    def export_chain(self, tokens) -> Tuple[int, List[int]]:
        """Resident complete full-chunk chain for `tokens`: the page
        list a holder replica would ship when replicating this prefix.
        Read-only (no pins, no LRU touch) — the caller gathers the page
        data synchronously at the same chunk boundary, before any
        allocation can evict."""
        ps = self.page_size
        children = self._root
        pages: List[int] = []
        i = 0
        while i + ps <= len(tokens):
            child = children.get(tuple(int(t) for t in tokens[i:i + ps]))
            if child is None or not child.complete:
                break
            pages.append(child.page)
            i += ps
            children = child.children
        return i, pages

    def graft(self, tokens, max_pages: int) \
            -> Optional[List[Tuple[int, int]]]:
        """Slot-less trie graft for hot-prefix replication: register
        the leading full chunks of `tokens` (up to `max_pages` pages)
        as COMPLETE cached nodes, allocating pages for chunks not
        already resident.  Returns [(chunk_idx, page)] the caller must
        fill with the holder's exported page data before the next
        admission can match them — complete-on-register is safe because
        the device write happens at this same chunk boundary.  Chunks
        already resident are skipped (dedup).  None under pool
        pressure (nothing registered — placement is best-effort and
        must never starve serving)."""
        ps = self.page_size
        n_chunks = min(len(tokens) // ps, max_pages)
        if n_chunks <= 0:
            return []
        # walk the existing chain; count the missing tail
        children = self._root
        parent: Optional[_Node] = None
        i = 0
        while i < n_chunks:
            child = children.get(
                tuple(int(t) for t in tokens[i * ps:(i + 1) * ps]))
            if child is None or not child.complete:
                break
            parent = child
            children = child.children
            i += 1
        missing = n_chunks - i
        if missing <= 0:
            return []
        # pin the deepest matched node: it is a cached LEAF until the
        # new children are registered, and alloc()'s eviction loop must
        # not reclaim the very chain we are extending
        pin = parent
        if pin is not None:
            self.ref_inc(pin.page)
        pages = self.alloc(missing)
        if pages is None:
            if pin is not None:
                self.release_page(pin.page)
            return None
        out: List[Tuple[int, int]] = []
        for k in range(missing):
            ci = i + k
            chunk = tokens[ci * ps:(ci + 1) * ps]
            node = self.register_chunk(parent, chunk, pages[k],
                                       imported=True)
            if node is None:        # raced: subtree already owned
                for page in pages[k:]:
                    self.release_page(page)
                break
            self.complete_node(node)
            out.append((ci, pages[k]))
            parent = node
        # grafted pages are cache-resident, not slot-mapped: drop the
        # alloc refcount so they live as refcount-0 cached pages
        for _, page in out:
            self.release_page(page)
        if pin is not None:
            self.release_page(pin.page)
        self.grafted_pages += len(out)
        return out

    def trie_digest(self, max_entries: int = 32) -> List[list]:
        """Bounded published view of the prefix cache: up to
        `max_entries` ``[depth_tokens, chain_hash]`` entries for
        complete trie nodes, most-recently-used first — what a replica
        ships in its `router_view` so peers can score cross-replica
        prefix affinity with `probe_digest` without a token-level RPC.
        Pure walk: no pins, no LRU touch."""
        if max_entries <= 0:
            return []
        ps = self.page_size
        entries: List[Tuple[int, int, int]] = []   # (lru, depth, hash)
        stack = [(node, _fnv(_FNV_SEED, node.tokens), ps)
                 for node in self._root.values()]
        while stack:
            node, h, depth = stack.pop()
            if node.complete:
                entries.append((node.lru, depth, h))
            for child in node.children.values():
                stack.append((child, _fnv(h, child.tokens), depth + ps))
        entries.sort(key=lambda e: -e[0])
        return [[depth, "%016x" % h]
                for _, depth, h in entries[:max_entries]]
