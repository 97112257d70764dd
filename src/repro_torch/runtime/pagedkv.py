"""Block-paged KV memory: the page pool, prefix sharing, and CoW forks.

The ring cache (``models/attention.py::attn_cache_init``) reserves one
``max_seq`` region per serving slot. The paged layout replaces that
reservation with a global pool of fixed-size pages plus a per-slot int32
*page table*: slot ``b``'s KV for absolute position ``t`` lives at
``(table[b, t // page_size], t % page_size)``. One table serves every
layer: each layer's pool slice is indexed with the same page ids.

* **host side (this module)** — free lists, refcounts, the prefix-hash
  registry and preemption accounting. Pure Python, no tensors.
* **device side** — the page table is a ``(B, pages_per_slot)`` int32
  tensor built from the host's numpy mirror every step, so any allocation
  pattern runs the same shapes; pool writes go in place.

Pages are refcounted so requests with a common prompt prefix share
physical KV: a *full* prompt page is registered under a chained hash of
its token blocks (namespaced by routing mode, budget, theta and KV dtype,
since the ElastiFormer token gate decides which positions hold valid KV),
and a later request with the same prefix increfs the page instead of
recomputing it. Shared pages are immutable; the only mutation of an
incref'd page's content is ``fork``'s copy-on-write of the *partial* tail
page into a fresh exclusively-owned page (``copy_page_in_tree``).

The last page of each replica's id range is reserved as a *trash* page:
the decode writes of inactive slots (table entry ``-1``) land there
instead of branching, so the decode step keeps its shapes.

This is the JAX package's ``runtime/pagedkv.py`` (same ids, refcounts and
keys for the same calls), copied so that the port depends on nothing of
that package; ``copy_page_in_tree`` copies in place over the port's
``{"layers": [...]}`` pool list.
"""
from __future__ import annotations

import numpy as np
import torch


def n_pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` positions (ceil division)."""
    return -(-int(n_tokens) // int(page_size))


def prefix_keys(tokens, page_size: int, namespace=()) -> list:
    """Chained hash keys for every FULL page of a token prefix.

    ``key[i]`` commits to tokens ``[0, (i+1) * page_size)`` — a chain, so
    a lookup hit at page ``i`` implies hits at every earlier page. The
    namespace (routing mode, solved budget, gate threshold, KV dtype) is
    folded into the chain seed because the token gate's keep decisions —
    and therefore the KV bytes on the page — depend on it.
    """
    toks = np.asarray(tokens).reshape(-1)
    keys, h = [], hash(("pagedkv", tuple(namespace)))
    for i in range(len(toks) // page_size):
        blk = tuple(int(x) for x in toks[i * page_size:(i + 1) * page_size])
        h = hash((h, blk))
        keys.append(h)
    return keys


class PagePool:
    """Host-side allocator for the global KV page pool.

    ``n_pages`` counts TOTAL physical pages; each of the ``n_replicas``
    contiguous ranges donates its last id as the replica's trash page, so
    ``pages_per_replica - 1`` ids per replica are allocatable.
    """

    def __init__(self, n_pages: int, page_size: int, n_replicas: int = 1):
        if n_pages % n_replicas:
            raise ValueError(f"n_pages={n_pages} must be a multiple of "
                             f"n_replicas={n_replicas}")
        ppr = n_pages // n_replicas
        if ppr < 2:
            raise ValueError("need at least 2 pages per replica "
                             "(one allocatable + one trash)")
        self.n_pages, self.page_size = n_pages, page_size
        self.n_replicas, self.pages_per_replica = n_replicas, ppr
        # freelists are LIFO per replica; trash id excluded
        self._free = [list(range(r * ppr, (r + 1) * ppr - 1))[::-1]
                      for r in range(n_replicas)]
        self._ref = {}                      # page id -> refcount
        self._registry = {}                 # prefix key -> page id
        self._page_keys = {}                # page id -> set of prefix keys
        self.peak_allocated = 0

    # ------------------------------ placement ------------------------------

    def trash_page(self, replica: int) -> int:
        return (replica + 1) * self.pages_per_replica - 1

    def replica_of(self, page: int) -> int:
        return page // self.pages_per_replica

    @property
    def usable_per_replica(self) -> int:
        return self.pages_per_replica - 1

    def n_free(self, replica: int) -> int:
        return len(self._free[replica])

    def can_alloc(self, replica: int, n: int) -> bool:
        return self.n_free(replica) >= n

    # ----------------------------- alloc / free ----------------------------

    def alloc(self, replica: int, n: int):
        """-> list of ``n`` fresh page ids (refcount 1), or None if the
        replica's freelist cannot cover the request (caller preempts)."""
        if n < 0:
            raise ValueError("n < 0")
        if len(self._free[replica]) < n:
            return None
        ids = [self._free[replica].pop() for _ in range(n)]
        for p in ids:
            self._ref[p] = 1
        self.peak_allocated = max(self.peak_allocated, self.allocated)
        return ids

    def incref(self, page: int):
        self._ref[page] += 1

    def free(self, pages):
        """Decref every id; pages hitting zero return to their replica's
        freelist and are purged from the prefix registry."""
        for p in pages:
            p = int(p)
            if p < 0:
                continue
            if p not in self._ref:
                raise RuntimeError(f"double free of page {p}")
            self._ref[p] -= 1
            if self._ref[p] == 0:
                del self._ref[p]
                for k in self._page_keys.pop(p, ()):
                    self._registry.pop(k, None)
                self._free[self.replica_of(p)].append(p)

    # ---------------------------- prefix sharing ---------------------------

    def register_prefix(self, key, page: int):
        """Publish a fully-written prompt page under its chain key."""
        self._registry[key] = page
        self._page_keys.setdefault(page, set()).add(key)

    def lookup_prefix(self, key, replica: int):
        """-> page id of a live page holding this prefix block on the
        given replica, else None (pages never cross replicas)."""
        p = self._registry.get(key)
        if p is None or self.replica_of(p) != replica:
            return None
        return p

    # -------------------------------- stats --------------------------------

    @property
    def allocated(self) -> int:
        return len(self._ref)

    @property
    def shared(self) -> int:
        return sum(1 for c in self._ref.values() if c > 1)

    def stats(self) -> dict:
        return {"allocated": self.allocated,
                "free": sum(len(f) for f in self._free),
                "shared": self.shared,
                "registered_prefixes": len(self._registry),
                "peak_allocated": self.peak_allocated,
                "page_size": self.page_size,
                "usable": self.usable_per_replica * self.n_replicas}


# ------------------------------ pool copy ------------------------------------

def copy_page_in_tree(caches, src: int, dst: int, n_keep: int) -> None:
    """Copy page ``src`` -> ``dst`` in every layer's pool, in place,
    keeping only the first ``n_keep`` positions valid — the copy-on-write
    step of ``ServingEngine.fork`` for the parent's partial tail page.
    ``kp``/``vp`` and an int8 pool's ``kscale``/``vscale`` are copied
    verbatim (re-quantizing a dequantized tail would drift from the
    parent's bytes); positions ``>= n_keep`` are masked through ``pvalid``
    only."""
    for layer in caches["layers"]:
        pool = layer["attn"]
        ps = pool["pvalid"].shape[1]
        keep = torch.arange(ps, device=pool["pvalid"].device) < n_keep
        for name in ("kp", "vp", "kscale", "vscale"):
            if name in pool:
                pool[name][dst] = pool[name][src].clone()
        pool["pvalid"][dst] = pool["pvalid"][src] & keep
