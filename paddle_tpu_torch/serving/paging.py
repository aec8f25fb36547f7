"""Paged KV-cache subsystem for the serving pool (the JAX package's
`serving/paging.py`, on torch tensors).

The dense serving pool preallocates one contiguous [S, H, max_len, D]
K/V region per layer, so every slot pays for the worst-case `max_len`,
and identical system prompts are re-prefilled for every request. This
module replaces the per-slot rows with a **global pool of fixed-size
pages** plus an int32 indirection:

  * pages live in [n_pages + 1, H, page_size, D] tensors per layer (row
    `n_pages` is the TRASH page: inactive slots' masked decode writes
    land there, never on live data);
  * each slot owns a `page_table[S, max_pages]` row mapping its logical
    block i to a physical page (host-side -1 = unmapped, clipped to the
    trash row before it reaches the device);
  * `PageAllocator` hands pages out of a free list with refcounts, so
    several slots can map the SAME physical page read-only (shared
    prompt prefixes), and a page returns to the free list exactly when
    its last reference drops;
  * `PrefixCache` (whole prompts) and `RadixPrefixCache` (a page-granular
    token trie: whole and partial hits) key prefilled prompt pages on the
    prompt tokens plus the cross-attention memory digest, so a request
    repeating a known prompt maps the cached pages with zero prefill,
    and one sharing a preamble prefills only its tail;
  * pages store K/V in fp32 / bf16 / int8 behind the engine's
    `kv_dtype=` knob; int8 pages carry a per-(page, head) f32 scale
    (symmetric, amax/127) that only grows: a decode write whose token
    outranges the page rescales the page's int8 payload in place.

The host side (allocator, prefix caches) is the JAX package's, line for
line. The device side writes the pages IN PLACE (the JAX functions
returned updated copies), on whatever device the pages live.
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np
import torch

__all__ = ["OutOfPages", "PageAllocator", "PrefixCache",
           "RadixPrefixCache", "PagedKVCache",
           "pages_for", "resolve_kv_dtype", "quantize_chunks",
           "chunk_prompt", "write_prompt_pages", "write_token",
           "write_tokens", "copy_page", "gather_pages"]

_QMAX = 127.0


def _host(memory):
    """A memory (torch tensor on any device, or array) as a contiguous
    numpy array for digests."""
    if isinstance(memory, torch.Tensor):
        memory = memory.detach().cpu().numpy()
    return np.ascontiguousarray(memory)


class OutOfPages(RuntimeError):
    """The page pool cannot serve an allocation: backpressure (the
    scheduler keeps the request queued until pages free up) or, when it
    strikes mid-decode under oversubscription, a victim eviction."""


#: the paged cache of one decoder layer: K/V page tensors, the int8
#: scales (None unless the pages are int8), the [S, max_pages] int32 page
#: table (trash-clipped) and the per-slot written-token counts [S] int32.
#: Page writes go into `k`, `v` and the scales in place.
PagedKVCache = collections.namedtuple(
    "PagedKVCache", ["k", "v", "k_scale", "v_scale", "table", "index"])


def pages_for(n_tokens, page_size):
    """Pages needed to hold `n_tokens` cache positions."""
    return -(-int(n_tokens) // int(page_size))


def resolve_kv_dtype(kv_dtype, compute_dtype):
    """The engine's `kv_dtype=` knob -> (storage torch dtype, quantized?).
    None keeps the compute dtype (bit-exact paging); "bf16" stores
    bfloat16; "int8" stores symmetric int8 with per-(page, head)
    scales."""
    if kv_dtype is None:
        return compute_dtype, False
    if isinstance(kv_dtype, torch.dtype):
        return kv_dtype, kv_dtype == torch.int8
    name = str(kv_dtype).lower()
    if name in ("int8", "i1"):
        return torch.int8, True
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16, False
    if name in ("f4", "f32", "float32"):
        return torch.float32, False
    raise ValueError(f"kv_dtype={kv_dtype!r}: expected None, 'float32', "
                     f"'bf16' or 'int8'")


# --------------------------------------------------------------------------
# host side: allocator + prefix cache
# --------------------------------------------------------------------------

class PageAllocator:
    """Free-list + refcount bookkeeping over `n_pages` physical pages.
    Host-side only — it never touches device arrays; the engine turns
    its decisions into page-table entries. `alloc` raises `OutOfPages`
    without partial effects; refcounts let shared prompt pages outlive
    any single slot."""

    def __init__(self, n_pages, page_size):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = int(n_pages)
        self.page_size = int(page_size)
        # pop() takes from the end: keep ids ascending for readability
        self._free = list(range(self.n_pages - 1, -1, -1))
        self.refcount = np.zeros(self.n_pages, np.int32)

    @property
    def pages_free(self):
        return len(self._free)

    @property
    def pages_in_use(self):
        return self.n_pages - len(self._free)

    def alloc(self, n):
        """Allocate `n` pages (refcount 1 each) or raise OutOfPages
        with NO pages taken."""
        n = int(n)
        if n > len(self._free):
            raise OutOfPages(
                f"need {n} pages, {len(self._free)} free of "
                f"{self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        self.refcount[pages] = 1
        return pages

    def incref(self, pages):
        for p in pages:
            if self.refcount[p] <= 0:
                raise RuntimeError(f"incref on free page {p}")
            self.refcount[p] += 1

    def decref(self, pages):
        """Drop one reference per page; pages reaching zero return to
        the free list (double-free raises — the invariant tests lean on
        this)."""
        for p in pages:
            p = int(p)
            if self.refcount[p] <= 0:
                raise RuntimeError(f"decref on free page {p}")
            self.refcount[p] -= 1
            if self.refcount[p] == 0:
                self._free.append(p)

    def check(self):
        """Invariants: free + referenced partitions the pool exactly;
        raises on any violation (used by the soak test and the chaos
        leak check)."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate pages on the free list")
        held = {p for p in range(self.n_pages) if self.refcount[p] > 0}
        if free & held:
            raise AssertionError(f"pages both free and held: "
                                 f"{sorted(free & held)}")
        if free | held != set(range(self.n_pages)):
            raise AssertionError("leaked pages: neither free nor held: "
                                 f"{sorted(set(range(self.n_pages)) - free - held)}")
        if (self.refcount < 0).any():
            raise AssertionError("negative refcount")
        return True


class PrefixCache:
    """Host-side map from (prompt tokens, memory digest) to the
    immutable pages a previous join prefilled for that prompt, plus the
    prefill's first greedy token. Whole-prompt granularity: a hit means
    the ENTIRE padded prompt block [0, Pb) is served by shared pages
    and the join runs zero prefill FLOPs. LRU-bounded: inserting past
    `capacity` (or an explicit `reclaim`) drops the oldest entries,
    releasing the cache's page references."""

    def __init__(self, allocator, capacity=64):
        self.allocator = allocator
        self.capacity = int(capacity)
        self._entries = collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key_of(prompt, memory):
        prompt = np.asarray(prompt)
        mem = b"" if memory is None else _host(memory)
        digest = hashlib.sha1()
        digest.update(np.ascontiguousarray(prompt.astype(np.int64)))
        if memory is not None:
            digest.update(str(mem.dtype).encode())
            digest.update(str(mem.shape).encode())
            digest.update(mem)
        # the digest alone would admit hash collisions across prompts;
        # carrying the token tuple keeps lookups exact
        return (tuple(int(t) for t in prompt.ravel()),
                digest.hexdigest())

    def __len__(self):
        return len(self._entries)

    def peek(self, key):
        """Like lookup, but no hit/miss accounting and no MRU move —
        the admission gate's headroom estimate uses it."""
        return self._entries.get(key)

    def lookup(self, key):
        """Entry dict {pages, tok0, n_prompt, Pb} or None. A hit moves
        the entry to MRU; the CALLER increfs the pages it maps."""
        e = self._entries.get(key)
        if e is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        if not isinstance(e["tok0"], int):
            # inserted as the producing join's TRACED scalar (the
            # submit path never blocks on it); the first hit — always
            # long after that dispatch retired — canonicalizes it
            e["tok0"] = int(e["tok0"])
        return e

    def insert(self, key, pages, tok0, n_prompt, Pb):
        """Adopt `pages` (already refcounted by their owner): the cache
        takes its own reference so they survive the owner's eviction.
        `tok0` may be a still-traced device scalar — stored raw and
        resolved lazily at the first hit, keeping the producing join's
        submit path sync-free."""
        if key in self._entries:
            # a re-inserted prefix is HOT: refresh its LRU position so
            # it isn't evicted ahead of genuinely colder entries
            self._entries.move_to_end(key)
            return
        self.allocator.incref(pages)
        self._entries[key] = {"pages": list(pages), "tok0": tok0,
                              "n_prompt": int(n_prompt), "Pb": int(Pb)}
        while len(self._entries) > self.capacity:
            self._drop_lru()

    def _drop_lru(self):
        _, e = self._entries.popitem(last=False)
        self.allocator.decref(e["pages"])

    def reclaim(self, n_needed):
        """Drop LRU entries until the allocator has `n_needed` free
        pages or the cache is empty. Returns True on success. (Entries
        whose pages are still mapped by live slots free nothing yet —
        the refcount keeps them alive — so keep dropping.)"""
        while self.allocator.pages_free < n_needed and self._entries:
            self._drop_lru()
        return self.allocator.pages_free >= n_needed

    def flush(self):
        while self._entries:
            self._drop_lru()

    @property
    def hit_rate(self):
        n = self.hits + self.misses
        return (self.hits / n) if n else 0.0


class _RadixNode:
    """One FULL page of prompt tokens in the radix trie. The edge from
    the parent is the page's `page_size`-token run; `page` is the
    physical page holding its K/V (the trie owns one reference).
    `terminals` hang completed prompts off the node: the sub-page tail
    tokens + prompt length key the pages past the last full page (the
    partial last page and any hole pages up to the prompt bucket)."""

    __slots__ = ("tokens", "page", "parent", "children", "terminals",
                 "tick")

    def __init__(self, tokens, page, parent):
        self.tokens = tokens          # page_size-tuple (None at roots)
        self.page = page              # physical page id (None at roots)
        self.parent = parent
        self.children = {}            # {page-token-tuple: _RadixNode}
        self.terminals = {}           # {(tail-tuple, P0): entry dict}
        self.tick = 0


class RadixPrefixCache:
    """Host-side token trie over prefilled prompt pages: edges are
    page-granular token runs, so two prompts sharing a long preamble
    share the preamble's PHYSICAL pages even when their tails differ.

    `lookup` returns the longest-prefix match:

      * a WHOLE hit (full pages + a terminal whose tail tokens and
        prompt length match exactly) maps every cached page with zero
        prefill FLOPs — same contract as the flat `PrefixCache`;
      * a PARTIAL hit returns the matched full pages plus, when the
        divergence falls mid-page, a copy-on-write source page and the
        in-page match length `j` — the engine copies that page and
        prefills ONLY the divergent tail (the `pattach` program
        family), seeded by the matched K/V.

    Tenancy: trees are scoped by (memory digest, tenant key). Requests
    with no adapter share one base subtree ACROSS logical tenants —
    LoRA perturbs K/V from token 0, so only base-model traffic is
    safely shareable — while adapter traffic is keyed by
    (adapter name, generation); a generation bump (adapter
    re-register) orphans the stale subtree lazily on next touch, or
    eagerly via `drop_tenant`.

    Eviction is leaf-first LRU over terminals and BARE leaf nodes (no
    children, no terminals): interior nodes keep serving partial
    matches until everything under them has aged out, and every drop
    releases exactly the references the trie took, so
    `PageAllocator.check()` stays clean under chaos."""

    def __init__(self, allocator, capacity=64, page_size=None,
                 mid_page="round_down"):
        if mid_page not in ("round_down", "cow"):
            raise ValueError(f"mid_page={mid_page!r}: expected "
                             f"'round_down' or 'cow'")
        self.allocator = allocator
        self.capacity = int(capacity)
        self.page_size = int(page_size if page_size is not None
                             else allocator.page_size)
        # mid-page match policy: a match ending INSIDE a page can be
        # served by COW-copying the partially-matching page ("cow") or
        # by rounding the match DOWN to the page boundary and
        # re-prefilling the whole partial page with the divergent tail
        # ("round_down"). The copy costs a page write + an extra
        # dispatch and saves < page_size prefill tokens — on CPU it
        # measurably LOSES (~0.7x TTFT at depth 40/psz 16), so
        # round_down is the default; `rounded_down` counts the
        # decisions so the policy stays measurable.
        self.mid_page = mid_page
        self._roots = {}              # {(mem digest, tenant): _RadixNode}
        self._tenant_gen = {}         # {adapter name: last-seen gen}
        self._tick = 0
        self._n_nodes = 0
        self._n_terminals = 0
        self._n_pages = 0             # pages referenced by the trie
        self.whole_hits = 0
        self.partial_hits = 0
        self.misses = 0
        self.rounded_down = 0         # mid-page matches truncated

    # -- keys ------------------------------------------------------------

    @staticmethod
    def mem_digest(memory):
        """Cross-attention memory digest: decoder self-attn K/V depend
        on the memory through the cross-attn residual stream, so pages
        are only shareable within one memory scope."""
        if memory is None:
            return ""
        mem = _host(memory)
        digest = hashlib.sha1()
        digest.update(str(mem.dtype).encode())
        digest.update(str(mem.shape).encode())
        digest.update(mem)
        return digest.hexdigest()

    def _touch(self):
        self._tick += 1
        return self._tick

    def _root_for(self, memory, tenant, create):
        """Scope root, handling tenant-generation invalidation: a
        stale-generation subtree is dropped before the fresh one is
        touched (tenant = None for base traffic, (name, gen) for
        adapter traffic)."""
        if tenant is not None:
            name, gen = tenant
            old = self._tenant_gen.get(name)
            if old is not None and old != gen:
                self.drop_tenant(name)
            self._tenant_gen[name] = gen
        key = (self.mem_digest(memory), tenant)
        root = self._roots.get(key)
        if root is None and create:
            root = _RadixNode(None, None, None)
            self._roots[key] = root
        return root

    # -- lookup ----------------------------------------------------------

    def _walk(self, root, tokens, P0):
        """Longest run of full-page children matching `tokens[:P0]`.
        Returns (node, path) where path is the list of matched nodes
        (so pages AND parents are recoverable)."""
        psz = self.page_size
        node, path = root, []
        n_full = int(P0) // psz
        for i in range(n_full):
            child = node.children.get(tuple(tokens[i * psz:(i + 1) * psz]))
            if child is None:
                break
            node = child
            path.append(child)
        return node, path

    def _best_partial(self, node, tokens, P0, m):
        """Best mid-page extension below `node` (which matched `m` full
        pages): the longest common prefix between the remaining tokens
        and any child edge or terminal tail hanging here, capped so at
        least one divergent tail token remains for the partial attach.
        Returns (j, cow_src_page)."""
        psz = self.page_size
        rem = tuple(tokens[m * psz:P0])
        limit = min(psz - 1, len(rem) - 1)
        best_j, best_src = 0, None
        if limit <= 0:
            return best_j, best_src

        def common(a, b):
            n = 0
            for x, y in zip(a, b):
                if x != y:
                    break
                n += 1
            return n

        for et, child in node.children.items():
            j = min(common(rem, et), limit)
            if j > best_j:
                best_j, best_src = j, child.page
        for (tail, _p0), ent in node.terminals.items():
            if ent["pages"]:
                j = min(common(rem, tail), limit)
                if j > best_j:
                    best_j, best_src = j, ent["pages"][0]
        return best_j, best_src

    def _match(self, memory, tenant, tokens, P0, Pb, allow_partial,
               mutate):
        psz = self.page_size
        tokens = tuple(int(t) for t in tokens)[:int(P0)]
        if mutate:
            root = self._root_for(memory, tenant, create=False)
        else:
            # peek: read-only, even for generation bookkeeping
            if tenant is not None:
                name, gen = tenant
                old = self._tenant_gen.get(name)
                if old is not None and old != gen:
                    return None
            root = self._roots.get((self.mem_digest(memory), tenant))
        if root is None:
            return None
        node, path = self._walk(root, tokens, P0)
        m = len(path)
        n_full = P0 // psz
        if m == n_full:
            ent = node.terminals.get((tokens[n_full * psz:P0], P0))
            if ent is not None and ent["Pb"] == int(Pb):
                if mutate:
                    t = self._touch()
                    for n in path:
                        n.tick = t
                    ent["tick"] = t
                    if not isinstance(ent["tok0"], int):
                        # stored as the producing join's traced scalar
                        # (deferred sync); the first hit canonicalizes
                        ent["tok0"] = int(ent["tok0"])
                return ("whole", {
                    "pages": [n.page for n in path] + list(ent["pages"]),
                    "tok0": ent["tok0"], "n_prompt": ent["n_prompt"],
                    "Pb": ent["Pb"]})
        if not allow_partial:
            return None
        if m and m * psz == P0:
            # every real token sits in matched full pages but no
            # terminal completes the prompt: back off one page so the
            # attach has a tail to prefill (the dropped page re-emerges
            # as the COW source with j = page_size - 1)
            node = path.pop().parent
            m -= 1
        j, cow_src = self._best_partial(node, tokens, P0, m)
        if j and self.mid_page == "round_down":
            # mid-page policy: drop the sub-page extension and attach
            # from the page boundary — the pattach tail re-prefills
            # the j matched tokens along with the divergent remainder,
            # which beats paying a COW page copy + extra dispatch for
            # them (see __init__; "cow" preserves the old behavior)
            if mutate:
                self.rounded_down += 1
            j, cow_src = 0, None
        if m == 0 and j == 0:
            return None
        if mutate:
            t = self._touch()
            for n in path:
                n.tick = t
        return ("partial", {
            "pages": [n.page for n in path], "j": int(j),
            "cow_src": cow_src, "seed_len": m * psz + int(j)})

    def lookup(self, tokens, P0, Pb, memory=None, tenant=None,
               allow_partial=True):
        """Longest-prefix match for `tokens[:P0]` in the (memory,
        tenant) scope. Returns None, ("whole", entry) or ("partial",
        {pages, j, cow_src, seed_len}). The CALLER increfs any pages
        it maps; matched nodes move to MRU."""
        res = self._match(memory, tenant, tokens, P0, Pb, allow_partial,
                          mutate=True)
        if res is None:
            self.misses += 1
        elif res[0] == "whole":
            self.whole_hits += 1
        else:
            self.partial_hits += 1
        return res

    def peek(self, tokens, P0, Pb, memory=None, tenant=None,
             allow_partial=True):
        """Like lookup, but side-effect free (no accounting, no MRU
        move, no generation invalidation) — the admission gate's
        headroom estimate uses it."""
        return self._match(memory, tenant, tokens, P0, Pb,
                           allow_partial, mutate=False)

    # -- insert ----------------------------------------------------------

    def insert(self, tokens, P0, Pb, memory, tenant, pages, tok0):
        """Extend the trie with a completed prompt's pages (already
        refcounted by their slot; the trie takes its own references).
        Full pages become (or refresh) trie nodes one by one — a
        partial-hit join re-walks its matched prefix and only adopts
        the pages it actually created — and the sub-page tail plus any
        hole pages up to the prompt bucket land in a terminal."""
        psz = self.page_size
        tokens = tuple(int(t) for t in tokens)[:int(P0)]
        P0, Pb = int(P0), int(Pb)
        root = self._root_for(memory, tenant, create=True)
        n_full = P0 // psz
        t = self._touch()
        node = root
        for i in range(n_full):
            et = tokens[i * psz:(i + 1) * psz]
            child = node.children.get(et)
            if child is None:
                page = int(pages[i])
                self.allocator.incref([page])
                child = _RadixNode(et, page, node)
                node.children[et] = child
                self._n_nodes += 1
                self._n_pages += 1
            child.tick = t
            node = child
        tkey = (tokens[n_full * psz:P0], P0)
        ent = node.terminals.get(tkey)
        if ent is not None:
            ent["tick"] = t               # hot terminal: refresh LRU
            return
        tail = [int(p) for p in pages[n_full:]]
        self.allocator.incref(tail)
        # tok0 may still be the producing join's traced scalar: store
        # it raw (the submit path never blocks on it) — the first
        # whole hit canonicalizes it to a host int
        node.terminals[tkey] = {"pages": tail, "tok0": tok0,
                                "n_prompt": P0, "Pb": Pb, "tick": t}
        self._n_terminals += 1
        self._n_pages += len(tail)
        while self._n_terminals > self.capacity:
            if not self._evict_one():
                break

    def insert_prefix(self, tokens, memory, tenant, pages):
        """Extend the trie with FULL PAGES only — no terminal: the
        chunked-prefill path calls this after every completed chunk,
        so the pages a long prompt has prefilled SO FAR are already
        partial-matchable (and survive the slot's failure) before the
        final chunk lands the terminal via `insert`. `tokens` must be
        a page-multiple prefix; extra tokens past `len(pages) *
        page_size` are ignored. Existing nodes are refreshed, new ones
        take their own page reference — identical adoption semantics
        to `insert`'s full-page walk."""
        psz = self.page_size
        n_full = min(len(tokens) // psz, len(pages))
        if n_full == 0:
            return
        tokens = tuple(int(t) for t in tokens)[:n_full * psz]
        root = self._root_for(memory, tenant, create=True)
        t = self._touch()
        node = root
        for i in range(n_full):
            et = tokens[i * psz:(i + 1) * psz]
            child = node.children.get(et)
            if child is None:
                page = int(pages[i])
                self.allocator.incref([page])
                child = _RadixNode(et, page, node)
                node.children[et] = child
                self._n_nodes += 1
                self._n_pages += 1
            child.tick = t
            node = child

    # -- eviction --------------------------------------------------------

    def _iter_nodes(self):
        stack = [(key, root) for key, root in self._roots.items()]
        while stack:
            key, node = stack.pop()
            yield key, node
            for child in node.children.values():
                stack.append((key, child))

    def _evict_one(self):
        """Drop the least-recently-used evictable item: a terminal, or
        a BARE leaf node (no children, no terminals). Interior nodes
        are never dropped while anything hangs below them — they still
        serve partial matches — but become bare (and evictable) as
        their subtrees age out. Returns False when nothing is left."""
        best = None                   # (tick, kind, ...)
        for key, node in self._iter_nodes():
            for tkey, ent in node.terminals.items():
                if best is None or ent["tick"] < best[0]:
                    best = (ent["tick"], "terminal", node, tkey)
            if (node.parent is not None and not node.children
                    and not node.terminals):
                if best is None or node.tick < best[0]:
                    best = (node.tick, "node", node, key)
        if best is None:
            return False
        if best[1] == "terminal":
            _, _, node, tkey = best
            ent = node.terminals.pop(tkey)
            self.allocator.decref(ent["pages"])
            self._n_terminals -= 1
            self._n_pages -= len(ent["pages"])
        else:
            _, _, node, key = best
            del node.parent.children[node.tokens]
            self.allocator.decref([node.page])
            self._n_nodes -= 1
            self._n_pages -= 1
            parent = node.parent
            if (parent.parent is None and not parent.children
                    and not parent.terminals):
                self._roots.pop(key, None)
        return True

    def reclaim(self, n_needed):
        """Evict leaf-first LRU until the allocator has `n_needed`
        free pages or the trie is exhausted. Returns True on success.
        (Items whose pages are still mapped by live slots free nothing
        yet — the refcount keeps them alive — so keep evicting.)"""
        while self.allocator.pages_free < n_needed:
            if not self._evict_one():
                break
        return self.allocator.pages_free >= n_needed

    def _drop_subtree(self, node):
        for child in list(node.children.values()):
            self._drop_subtree(child)
        for ent in node.terminals.values():
            self.allocator.decref(ent["pages"])
            self._n_terminals -= 1
            self._n_pages -= len(ent["pages"])
        node.terminals.clear()
        node.children.clear()
        if node.page is not None:
            self.allocator.decref([node.page])
            self._n_nodes -= 1
            self._n_pages -= 1

    def drop_tenant(self, name):
        """Release every subtree keyed to adapter `name` (any
        generation) — the eager path of generation invalidation."""
        for key in [k for k in self._roots
                    if k[1] is not None and k[1][0] == name]:
            self._drop_subtree(self._roots.pop(key))
        self._tenant_gen.pop(name, None)

    def flush(self):
        for key in list(self._roots):
            self._drop_subtree(self._roots.pop(key))

    # -- introspection ---------------------------------------------------

    def stats(self):
        """Gauges for the metrics snapshot: trie size in nodes (full
        prompt pages on edges), terminals, and total pages referenced
        (node pages + terminal tails)."""
        return {"nodes": self._n_nodes, "terminals": self._n_terminals,
                "pages": self._n_pages, "scopes": len(self._roots),
                "rounded_down": self.rounded_down}

    def __len__(self):
        return self._n_terminals

    # flat-cache-compatible accounting, so dashboards keyed on the old
    # PrefixCache surface keep working
    @property
    def hits(self):
        return self.whole_hits + self.partial_hits

    @property
    def hit_rate(self):
        n = self.hits + self.misses
        return (self.hits / n) if n else 0.0


# --------------------------------------------------------------------------
# device side: page math on torch tensors (writes in place)
# --------------------------------------------------------------------------

def quantize_chunks(chunks, storage_dtype, quantized):
    """[N, H, page_size, D] compute-dtype chunks -> (stored, scale).
    int8: symmetric per-(page, head) amax/127 scale (1.0 for all-zero
    pages, so dequant never divides by zero); other dtypes: a plain
    cast, scale None."""
    if not quantized:
        return chunks.to(storage_dtype), None
    x = chunks.float()
    amax = x.abs().amax(dim=(2, 3), keepdim=True)            # [N, H, 1, 1]
    scale = torch.where(amax > 0, amax / _QMAX, 1.0).float()
    q = torch.clamp(torch.round(x / scale), -_QMAX, _QMAX).to(torch.int8)
    return q, scale


def chunk_prompt(kv, page_size):
    """A prefilled [1, H, P, D] K or V block -> [n_pages, H, page_size,
    D] page chunks (tail zero-padded to the page boundary)."""
    _, H, P, D = kv.shape
    n_pp = pages_for(P, page_size)
    pad = n_pp * page_size - P
    x = kv[0]
    if pad:
        x = torch.cat([x, x.new_zeros((H, pad, D))], dim=1)
    return x.reshape(H, n_pp, page_size, D).transpose(0, 1)


def write_prompt_pages(pages, scales, page_ids, kv, quantized):
    """Scatter a prefilled [1, H, P, D] block into `pages` at `page_ids`
    ([n_pages] int), quantizing per page, in place. Returns (pages,
    scales)."""
    chunks = chunk_prompt(kv, pages.shape[2])
    stored, sc = quantize_chunks(chunks, pages.dtype, quantized)
    ids = torch.as_tensor(page_ids, device=pages.device).long()
    pages[ids] = stored
    if quantized:
        scales[ids] = sc
    return pages, scales


def _write_ids(pages, table, pos):
    """(physical page [S, n], in-page offset [S, n]) of logical positions
    pos [S, n] through the table. A position past the table's width (the
    tail lanes of a pattach bucket that overhang a clipped table row)
    writes to the trash page, as the JAX scatter drops it."""
    psz, width = pages.shape[2], table.shape[1]
    col = pos // psz
    pid = table.long().gather(1, torch.clamp(col, max=width - 1))
    return torch.where(col < width, pid, pages.shape[0] - 1), pos % psz


def write_token(pages, scales, table, index, tok):
    """The decode write, in place: slot s's token K or V ([S, H, D])
    lands at logical position index[s], physical page table[s,
    index[s] // page_size], offset index[s] % page_size. Slots whose
    entry points at the trash row write garbage there harmlessly. int8
    pages whose scale the new token outranges are rescaled (the
    per-page scale only ever grows)."""
    S = tok.shape[0]
    pid, off = _write_ids(pages, table, index.long()[:, None])
    pid, off = pid[:, 0], off[:, 0]
    if scales is None:
        pages[pid, :, off, :] = tok.to(pages.dtype)
        return pages, None
    # gather the S target pages, grow their scales to cover the new
    # token, rescale the existing int8 payload, write, scatter back
    pg = pages[pid].float()                          # [S, H, psz, D]
    s_old = scales[pid]                              # [S, H, 1, 1]
    t32 = tok.float()
    amax = t32.abs().amax(-1, keepdim=True)[..., None]   # [S, H, 1, 1]
    s_new = torch.maximum(s_old, amax / _QMAX)
    s_new = torch.where(s_new > 0, s_new, 1.0)
    factor = s_old / s_new               # <= 1; exactly 1.0 without growth
    pg = torch.clamp(torch.round(pg * factor), -_QMAX, _QMAX)
    qt = torch.clamp(torch.round(t32 / s_new[..., 0]), -_QMAX, _QMAX)
    pg[torch.arange(S, device=pg.device), :, off, :] = qt
    pages[pid] = pg.to(torch.int8)
    scales[pid] = s_new
    return pages, scales


def write_tokens(pages, scales, table, index, toks):
    """The T-wide write of a verify block, in place: slot s's T tokens
    ([S, H, T, D]) land at logical positions index[s] .. index[s] + T - 1,
    each position through its OWN table entry, so a block straddling
    pages scatters into each. int8 pages take `write_token`'s rescale
    position by position (a later token that outranges the page
    rescales what the earlier ones just wrote); other pages take one
    scatter. Rejected speculative tokens need no undo: the caller rolls
    the index back, and the masked positions are rewritten by the next
    round's fixed-T write before any query can see them."""
    T = toks.shape[2]
    index = index.long()
    if scales is not None:
        for j in range(T):
            write_token(pages, scales, table, index + j, toks[:, :, j, :])
        return pages, scales
    pos = index[:, None] + torch.arange(T, device=index.device)[None]
    pid, off = _write_ids(pages, table, pos)
    pages[pid, :, off, :] = toks.transpose(1, 2).to(pages.dtype)
    return pages, None


def copy_page(pages, scales, src, dst):
    """Copy-on-write, in place: physical page `src` into `dst`, so a
    joiner can decode-write without touching the shared original."""
    pages[dst] = pages[src]
    if scales is not None:
        scales[dst] = scales[src]
    return pages, scales


def gather_pages(pages, scales, table, compute_dtype):
    """Dense [S, H, max_pages * page_size, D] logical view of each slot's
    cache, dequantized (the CPU read path; the kernels read the pages in
    place through the table)."""
    from ..ops.attention import paged_gather_kv

    return paged_gather_kv(pages, scales, table, compute_dtype)
