"""Cross-request radix prefix cache + compressed KV hops (paper §VI).

The JAX package's ``repro/serving/prefix_cache.py`` on PyTorch.  Shared
prompt prefixes (system prompts, few-shot templates) prefill once; later
requests reuse the cached K/V and prefill only their tail.

**PrefixCache** -- a radix (token-trie) cache over fixed-size KV blocks:

* Dense stacks store one trie node per ``block_size`` tokens; its payload
  is that block's post-RoPE K/V rows, copied out of a finished B=1 prefill
  cache (``[L, 1, T, Hkv, dh]`` leaves).  Causal prefill masks future
  positions with an exact ``-inf``, so row *i* of every K/V buffer depends
  only on tokens ``[0, i]``: a block cached from one request holds what any
  request sharing that prefix would compute.
* A matched request resumes prefill from the block-aligned span (``batch
  ["prefix"]`` through ``models/model.forward``); an exact full-prompt match
  (every block and the terminal remainder node) skips prefill, and on the
  disaggregated path the KV hop too.
* Payloads are immutable copies: ``insert`` copies the rows out before
  the engine splices the prefill cache, and ``match`` hands out fresh
  concatenations.  The engine writes its big cache, decode state and slot
  rows in place; no tensor of the trie is ever one of those or a view of
  one.
* Reference counts pin a partial hit's nodes until ``release``; eviction
  removes childless, unpinned nodes, least recently used first, until the
  block budget holds.
* SSM and hybrid stacks fold the whole prefix into their states, and the
  audio decoder's cross K/V depend on the whole frame input: they get exact
  full-prompt terminals only, under the same budget.
* The vlm's cache starts with its F patch rows (the prologue).  Roots are
  keyed by the prompt length and the frontend's digest; a vlm root holds
  rows ``[0, F)`` as its payload, every block node the F-shifted rows of its
  tokens, and a match without the prologue misses (a resume needs a span
  contiguous from row 0).

**KV-hop compaction** (``compact_kv_hop`` / ``restore_kv_hop``): the sender
ships only the tail rows the receiver does not hold, packed to the front of
the buffer by the ``masked_compact`` kernel; wire bytes are the packed rows
plus their int32 indices (``core/masking.compression_report``).  The
keep-all mask is lossless; ``keep_rate < 1`` drops low-salience tail rows
(K-norm scores) and is lossy.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import is_mla
from repro_torch.core import masking
from repro_torch.core.offload import tree_leaves, tree_map
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import ops
from repro_torch.models import model as M


# ---------------------------------------------------------------------------
# Analytic prefill-FLOPs accounting (what the cache saves)
# ---------------------------------------------------------------------------
def prefill_flops(cfg, rows: int, cached: int = 0) -> float:
    """Analytic FLOPs to prefill ``rows`` rows when the first ``cached``
    rows' K/V are resident: 2·N_active per tail row for the parameter
    matmuls plus the causal-attention term (4·L·H·dh·Σ keys per query row)
    for the tail rows only."""
    n_active = M.count_params_analytic(cfg, active_only=True)
    lin = 2.0 * n_active * (rows - cached)

    def tri(n: int) -> float:
        return n * (n + 1) / 2.0

    quad = 4.0 * cfg.num_layers * (cfg.num_heads or 0) * cfg.head_dim \
        * (tri(rows) - tri(cached))
    return lin + quad


# ---------------------------------------------------------------------------
# Trie nodes
# ---------------------------------------------------------------------------
class _Node:
    """One radix node.  ``kv`` is the immutable block payload (a prefill
    cache tree cut to this block's rows) or None for payload-less roots;
    terminals also carry the last-token ``logits``."""
    __slots__ = ("key", "kv", "logits", "children", "refs", "tick", "parent")

    def __init__(self, key, kv=None, logits=None, parent=None):
        self.key = key
        self.kv = kv
        self.logits = logits
        self.children: Dict[Any, "_Node"] = {}
        self.refs = 0
        self.tick = 0
        self.parent = parent


@dataclass
class PrefixHit:
    """Result of one trie lookup (misses included, so the caller's FLOPs
    accounting sees every request)."""
    q_rows: int = 0                    # cache rows covered by the match
    rows_total: int = 0                # full prefill rows for this request
    blocks: int = 0                    # payload nodes reused
    prefix: Any = None                 # L-stacked KV tree [L,1,q,...] or None
    full: Any = None                   # (logits, cache) for exact full hits
    pins: Tuple[_Node, ...] = ()       # nodes pinned until release()
    flops_avoided: float = 0.0
    flops_total: float = 0.0

    @property
    def hit(self) -> bool:
        return self.q_rows > 0


def _digest(frontend) -> Optional[str]:
    if frontend is None:
        return None
    arr = np.asarray(frontend)
    return hashlib.blake2b(arr.tobytes(), digest_size=8).hexdigest()


def _concat_blocks(parts):
    """Node payloads as one fresh tree along the position axis (a copy even
    for one part: hits are spliced into caches written in place).  On the
    card every block read is recorded on the current stream, so an
    eviction cannot free its memory under a copy still queued there."""
    for t in tree_leaves(parts):
        if t.is_cuda:
            t.record_stream(torch.cuda.current_stream(t.device))
    if len(parts) == 1:
        return tree_map(torch.clone, parts[0])
    return tree_map(lambda *xs: torch.cat(xs, dim=2), *parts)


class PrefixCache:
    """Hub-side cross-request radix prefix cache (one per served task,
    shared by every decode-group engine and consulted before every prefill
    dispatch, local or remote).  Its blocks live on ``device``: the card
    unless the caller says otherwise."""

    def __init__(self, cfg, *, block_size: int = 8, budget_blocks: int = 512,
                 device: DeviceLike = None):
        if block_size < 1 or budget_blocks < 1:
            raise ValueError("block_size and budget_blocks must be >= 1")
        if is_mla(cfg):
            raise ValueError(f"{cfg.name}: the prefix cache does not hold "
                             "latent-cache blocks (multi-head latent "
                             "attention)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.block_size = int(block_size)
        self.budget_blocks = int(budget_blocks)
        self.kind = M._kind(cfg)
        self._offset = M.frontend_offset(cfg)
        self._roots: Dict[Any, _Node] = {}
        self._payload_nodes: list = []   # every node holding kv/logits
        self._tick = 0
        # the cache's lifetime counters (the engine folds per-request
        # numbers from PrefixHit into ContinuousStats)
        self.hits = 0
        self.full_hits = 0
        self.misses = 0
        self.blocks_reused = 0
        self.flops_avoided = 0.0
        self.flops_total = 0.0
        self.inserts = 0
        self.evictions = 0

    def _copy(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, copy=True, memory_format=torch.contiguous_format)

    # -- bookkeeping ----------------------------------------------------
    def _touch(self, node: _Node) -> None:
        self._tick += 1
        node.tick = self._tick

    @property
    def n_blocks(self) -> int:
        return len(self._payload_nodes)

    def _evict(self) -> None:
        """LRU-evict childless, unpinned payload nodes until the budget
        holds.  Pinned or interior nodes are never evicted; the budget may
        overflow while everything over it is pinned."""
        while len(self._payload_nodes) > self.budget_blocks:
            victims = [n for n in self._payload_nodes
                       if not n.children and n.refs == 0]
            if not victims:
                return
            victim = min(victims, key=lambda n: n.tick)
            if victim.parent is not None:
                victim.parent.children.pop(victim.key, None)
            else:   # a childless vlm prologue root
                self._roots = {k: v for k, v in self._roots.items()
                               if v is not victim}
            self._payload_nodes.remove(victim)
            self.evictions += 1

    def release(self, hit: Optional[PrefixHit]) -> None:
        """Unpin a partial hit's matched nodes (after its resumed prefill
        has run and been re-inserted).  A second release is a no-op."""
        if hit is None:
            return
        for node in hit.pins:
            if node.refs <= 0:
                raise RuntimeError("release without a matching pin")
            node.refs -= 1
        hit.pins = ()
        self._evict()   # pins may have been all that held the budget over

    # -- lookup ---------------------------------------------------------
    def _root_key(self, n_tokens: int, frontend) -> Any:
        # keyed by padded prompt length (prefixes transfer only between
        # same-shape requests) and by the frontend's digest (the vlm's
        # prologue rows depend on the image, not only on the tokens)
        return (n_tokens, _digest(frontend))

    def match(self, tokens, *, frontend=None) -> PrefixHit:
        toks = tuple(int(t) for t in np.asarray(tokens).ravel())
        rows = len(toks) + self._offset
        total = prefill_flops(self.cfg, rows)
        self.flops_total += total
        hit = PrefixHit(rows_total=rows, flops_total=total)
        root = self._roots.get(self._root_key(len(toks), frontend))
        if root is None:
            self.misses += 1
            return hit
        if self.kind != "dense":
            return self._match_exact(root, toks, hit)

        T = self.block_size
        node, matched = root, []
        for i in range(len(toks) // T):
            child = node.children.get(toks[i * T:(i + 1) * T])
            if child is None:
                break
            matched.append(child)
            node = child
        term = node.children.get(("end", toks[len(matched) * T:]))
        prologue = [root.kv] if root.kv is not None else []
        if self._offset and not prologue:
            # a vlm trie without its prologue rows cannot resume
            self.misses += 1
            return hit
        if term is not None:
            # exact full-prompt hit: the complete cache from the chain and
            # the remainder; prefill and the KV hop are skipped
            parts = prologue + [n.kv for n in matched]
            if term.kv is not None:
                parts.append(term.kv)
            for n in [root] + matched + [term]:
                self._touch(n)
            hit.q_rows = rows
            hit.blocks = len(parts)
            hit.full = (term.logits, _concat_blocks(parts))
            hit.flops_avoided = total
            self.hits += 1
            self.full_hits += 1
            self.blocks_reused += hit.blocks
            self.flops_avoided += hit.flops_avoided
            return hit

        # partial hit: a resume needs >= 1 tail row; a vlm resumes from its
        # prologue alone too
        while matched and self._offset + len(matched) * T >= rows:
            matched.pop()
        if not matched and not prologue:
            self.misses += 1
            return hit
        parts = prologue + [n.kv for n in matched]
        pins = tuple([root] + matched) if prologue else tuple(matched)
        for n in pins:
            n.refs += 1
            self._touch(n)
        hit.q_rows = self._offset + len(matched) * T
        hit.blocks = len(parts)
        hit.prefix = _concat_blocks(parts)
        hit.pins = pins
        hit.flops_avoided = total - prefill_flops(self.cfg, rows, hit.q_rows)
        self.hits += 1
        self.blocks_reused += hit.blocks
        self.flops_avoided += hit.flops_avoided
        return hit

    def _match_exact(self, root: _Node, toks, hit: PrefixHit) -> PrefixHit:
        term = root.children.get(("end", toks))
        if term is None:
            self.misses += 1
            return hit
        self._touch(term)
        hit.q_rows = hit.rows_total
        hit.blocks = 1
        hit.full = (term.logits, _concat_blocks([term.kv]))
        hit.flops_avoided = hit.flops_total
        self.hits += 1
        self.full_hits += 1
        self.blocks_reused += 1
        self.flops_avoided += hit.flops_avoided
        return hit

    # -- insert ---------------------------------------------------------
    def _add_payload(self, node: _Node) -> None:
        self._payload_nodes.append(node)
        self._touch(node)

    def insert(self, tokens, logits, cache, *, frontend=None) -> None:
        """Index a finished B=1 prefill cache.  Every payload (the logits
        too) is a copy taken here, before the engine splices the prefill
        cache; existing nodes stay as they are (a reinsert of known content
        only refreshes recency)."""
        if cache is None:
            return
        toks = tuple(int(t) for t in np.asarray(tokens).ravel())
        key = self._root_key(len(toks), frontend)
        self.inserts += 1
        root = self._roots.get(key)
        if root is None:
            root = self._roots[key] = _Node(key)
        if self.kind != "dense":
            if ("end", toks) not in root.children:
                term = _Node(("end", toks), kv=tree_map(self._copy, cache),
                             logits=self._copy(logits), parent=root)
                root.children[term.key] = term
                self._add_payload(term)
            else:
                self._touch(root.children[("end", toks)])
            self._evict()
            return

        T, F = self.block_size, self._offset
        rows = len(toks) + F
        if tree_leaves(cache)[0].shape[2] != rows:
            raise ValueError("prefill cache rows must cover the frontend "
                             "prologue and the prompt tokens")

        def rows_of(lo, hi):
            return tree_map(lambda a: self._copy(a[:, :, lo:hi]), cache)

        if F and root.kv is None:
            root.kv = rows_of(0, F)
            self._add_payload(root)
        node = root
        nb = len(toks) // T
        for i in range(nb):
            blk = toks[i * T:(i + 1) * T]
            child = node.children.get(blk)
            if child is None:
                child = _Node(blk, kv=rows_of(F + i * T, F + (i + 1) * T),
                              parent=node)
                node.children[blk] = child
                self._add_payload(child)
            else:
                self._touch(child)
            node = child
        rem = toks[nb * T:]
        tkey = ("end", rem)
        if tkey not in node.children:
            term = _Node(tkey, kv=rows_of(F + nb * T, rows) if rem else None,
                         logits=self._copy(logits), parent=node)
            node.children[tkey] = term
            self._add_payload(term)
        else:
            self._touch(node.children[tkey])
        self._evict()

    # -- introspection ---------------------------------------------------
    def stats(self) -> Dict[str, float]:
        return {
            "hits": self.hits, "full_hits": self.full_hits,
            "misses": self.misses, "blocks_reused": self.blocks_reused,
            "flops_avoided": self.flops_avoided,
            "flops_total": self.flops_total,
            "inserts": self.inserts, "evictions": self.evictions,
            "n_blocks": self.n_blocks,
        }

    def check_invariants(self) -> None:
        """Structural invariants: every payload node is reachable and
        registered once; refcounts are non-negative; siblings never share a
        key; the budget holds unless every node over it is pinned or
        interior.  Raises AssertionError on a breach."""
        seen = set()
        for root in self._roots.values():
            stack = [root]
            while stack:
                n = stack.pop()
                _check(n.refs >= 0, "negative refcount")
                _check(id(n) not in seen, "node reachable twice")
                seen.add(id(n))
                _check(len(set(map(id, n.children.values())))
                       == len(n.children), "siblings share a node")
                stack.extend(n.children.values())
        for n in self._payload_nodes:
            _check(id(n) in seen, "payload node unreachable from any root")
            _check(n.kv is not None or n.logits is not None,
                   "payload node without a payload")
        if len(self._payload_nodes) > self.budget_blocks:
            # insert() and release() both evict, so an over-budget cache
            # means every payload node is interior or pinned
            _check(all(n.children or n.refs > 0 for n in self._payload_nodes),
                   "over budget with evictable nodes remaining")


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


# ---------------------------------------------------------------------------
# KV-hop compaction (sender side of the prefill->decode transfer)
# ---------------------------------------------------------------------------
def compact_kv_hop(cache, q_rows: int, *, keep_rate: Optional[float] = None):
    """Sender-side compaction of a full-length resumed-prefill cache: only
    the tail rows ``[q_rows:]`` cross the link, packed to the front by the
    ``masked_compact`` kernel (on the card; its plain version on the CPU).
    The tail ``[L, Rt, Hkv·dh]`` is a strided view of the cache, copied
    contiguous for the kernel.  Returns ``(packed, wire_bytes)``: the
    packed rows plus the int32 index map, as ``compression_report`` counts
    them over the unpadded mask.

    ``keep_rate=None`` is lossless (the keep-all mask packs every tail row
    in order; :func:`restore_kv_hop` inverts it exactly); ``keep_rate < 1``
    keeps the top rows by K norm and is lossy."""
    kv = cache["self"]
    lossy = keep_rate is not None and keep_rate < 1.0
    L, _, S = kv["k"].shape[:3]
    Rt = S - q_rows
    if Rt < 1 or q_rows < 0:
        raise ValueError(f"no tail to ship: q_rows={q_rows} of {S} rows")
    if lossy:
        ktail = kv["k"][:, 0, q_rows:]
        mask = masking.make_mask(masking.norm_scores(ktail.reshape(L, Rt, -1)),
                                 float(keep_rate))
        cap = max(1, int(round(float(keep_rate) * Rt)))
        kept = mask                       # read back for the byte count
    else:
        mask = torch.ones((L, Rt), dtype=torch.bool, device=kv["k"].device)
        cap = Rt
        kept = torch.ones((L, Rt), dtype=torch.bool)   # host-side: no read
    packed: Dict[str, Any] = {"lossless": not lossy}
    wire = 0.0
    for name in ("k", "v"):
        leaf = kv[name]
        Hkv, dh = leaf.shape[3:]
        D = Hkv * dh
        tail = leaf[:, 0, q_rows:].reshape(L, Rt, D).contiguous()
        out, idx, _ = ops.masked_compact(tail, mask, cap)
        rep = masking.compression_report(kept, cap, D,
                                         bytes_per_el=leaf.element_size())
        wire += rep.bytes_after
        packed[name] = (out, idx, (L, Rt, Hkv, dh))
    return packed, float(wire)


def restore_kv_hop(packed, prefix):
    """Receiver-side restore: unpack the compacted tail behind the
    hub-resident ``prefix`` rows into a full-length prefill cache tree.
    Lossless payloads restore bit for bit (the unpack is a slice); lossy
    ones scatter by the index map and leave dropped rows zero."""
    kv = {}
    for name in ("k", "v"):
        out, idx, (L, Rt, Hkv, dh) = packed[name]
        if packed["lossless"]:
            tail = out[:, :Rt]
        else:
            valid = idx >= 0
            src = torch.where(valid[..., None], out, torch.zeros_like(out))
            tail = torch.zeros((L, Rt, out.shape[-1]), dtype=out.dtype,
                               device=out.device)
            rows = torch.arange(L, device=out.device)[:, None].expand_as(idx)
            tail.index_put_((rows, torch.where(valid, idx, 0).long()), src,
                            accumulate=True)
        tail = tail.reshape(L, 1, Rt, Hkv, dh)
        kv[name] = torch.cat([prefix["self"][name].to(tail.dtype), tail], dim=2)
    return {"self": kv}
