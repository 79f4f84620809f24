"""Request-path economics: response cache, collapse pricing, cost model.

Heavy real traffic is redundant — the same image batch arrives again and
again — and the serve stack (PRs 3–16) priced every request identically
and recomputed every duplicate. This module is the shared economics
layer in front of the batcher (server) and in front of the fleet
(router):

- :class:`ResponseCache` — exact-match response memoization. The key is
  a hash over the RAW request bytes plus the serving identity (model,
  serve mode, precision): two byte-identical requests against the same
  plane are the same answer, and nothing less than byte identity is
  assumed (no canonicalization — a reordered JSON object is a different
  key and merely misses). Every entry is stamped with the serving epoch
  it was computed under and the cache GENERATION current at insert
  time. Invalidation is one integer increment (``bump_generation``,
  registered as a swap hook under the engine/pool/canary params lock):
  a hot reload, precision swap, or canary promote makes every prior
  entry unreachable atomically — no per-entry scan, stale entries are
  lazily dropped on next touch or evicted by LRU pressure.
- :class:`CostModel` — per-bucket measured step cost. Seeded from the
  bucket geometry (the bench's per-bucket timings establish the same
  shape — see DESIGN.md §7n for provenance), refreshed at serve time by
  a cheap online EWMA over the batcher's measured batch walls. Prices
  are normalized so the smallest bucket costs ~1.0; a cache hit prices
  at :data:`HIT_COST` (~0) so duplicate-heavy clients stop starving
  compute-heavy ones under cost-accounted quotas.

Pure stdlib ON PURPOSE (no torch, no numpy): a fleet router with no
accelerator stack can import this module for its own keyed cache,
sharing one implementation and one invalidation rule with the backends.

Lock discipline: the cache lock guards dict/counter arithmetic only.
Payloads are built (serialized, device-fetched) OUTSIDE the lock and
handed in; ``put`` re-checks the generation captured at probe time
under the lock and drops the insert if a swap landed in between
(snapshot-then-insert — the engine ``swap_params`` idiom one layer up).
"""

from __future__ import annotations

import collections
import hashlib
import threading
from typing import Dict, Optional, Sequence, Tuple

#: Admission price of a response served from cache: not exactly zero
#: (a flood of even-free requests still spends sockets and handler
#: threads) but ~0 relative to the smallest compute bucket's 1.0.
HIT_COST = 0.01


def request_key(raw: bytes, model: Optional[str], serve_mode: str,
                precision: str) -> str:
    """Exact-match cache key: hash(raw request bytes + model +
    serve-mode + precision). Length-framed so field boundaries cannot
    alias (``"ab"+"c"`` vs ``"a"+"bc"``), and the serving identity is
    part of the key — the same bytes against a different plane or a
    differently-quantized program are a different answer."""
    h = hashlib.sha256()
    for part in (raw, (model or "").encode(), serve_mode.encode(),
                 precision.encode()):
        h.update(len(part).to_bytes(8, "big"))
        h.update(part)
    return h.hexdigest()


class _Entry:
    __slots__ = ("value", "nbytes", "epoch", "generation")

    def __init__(self, value, nbytes: int, epoch: Optional[int],
                 generation: int) -> None:
        self.value = value
        self.nbytes = int(nbytes)
        self.epoch = epoch
        self.generation = generation


class ResponseCache:
    """Bounded LRU response cache with epoch/generation stamping.

    ``max_bytes`` bounds the PAYLOAD bytes held (the caller states each
    value's size — serialized reply bytes; the dict overhead is small
    against logit payloads). One lock, arithmetic only under it.

    ``get(key)`` returns ``(value, epoch, generation)`` — value ``None``
    on miss; the returned generation is the one the caller must hand
    back to ``put`` after computing, so an intervening swap turns the
    insert into a counted drop instead of a stale entry.
    """

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        self._lock = threading.Lock()
        self._entries: "collections.OrderedDict[str, _Entry]" = \
            collections.OrderedDict()
        self._bytes = 0
        self._generation = 0
        self.hits = 0
        self.misses = 0
        self.hit_bytes = 0
        self.evictions = 0
        self.inserts = 0
        self.stale_drops = 0

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    @property
    def generation(self) -> int:
        with self._lock:
            return self._generation

    def bump_generation(self, *_args, **_kwargs) -> int:
        """Invalidate EVERYTHING in O(1): one integer increment. Swap
        hooks call this under the engine/pool/canary params lock (with
        whatever epoch arguments the hook carries — ignored), so the
        moment new params are installed no pre-swap entry can hit; the
        entries themselves are dropped lazily on next touch."""
        with self._lock:
            self._generation += 1
            return self._generation

    def get(self, key: str):
        """``(value, epoch, generation)``; value None = miss. A
        generation-mismatched entry is a miss AND is dropped here (the
        lazy half of the O(1) invalidation)."""
        with self._lock:
            entry = self._entries.get(key)
            if entry is not None and entry.generation != self._generation:
                del self._entries[key]
                self._bytes -= entry.nbytes
                entry = None
            if entry is None:
                self.misses += 1
                return None, None, self._generation
            self._entries.move_to_end(key)
            self.hits += 1
            self.hit_bytes += entry.nbytes
            return entry.value, entry.epoch, self._generation

    def put(self, key: str, value, nbytes: int, epoch: Optional[int],
            generation: int) -> bool:
        """Insert a computed response, guarded by the generation the
        caller captured at probe time: if a swap bumped it since, the
        value was computed under dead params — drop it (counted), never
        install it."""
        if not self.enabled:
            return False
        nbytes = int(nbytes)
        with self._lock:
            if generation != self._generation:
                self.stale_drops += 1
                return False
            if nbytes > self.max_bytes:
                return False  # one giant reply must not flush the cache
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            self._entries[key] = _Entry(value, nbytes, epoch, generation)
            self._bytes += nbytes
            self.inserts += 1
            while self._bytes > self.max_bytes and self._entries:
                _, evicted = self._entries.popitem(last=False)
                self._bytes -= evicted.nbytes
                self.evictions += 1
        return True

    def snapshot(self) -> Dict:
        """The ``/stats`` ``cache`` block (schema-ADDITIVE)."""
        with self._lock:
            total = self.hits + self.misses
            return {
                "hits": self.hits,
                "misses": self.misses,
                "hit_rate": round(self.hits / total, 4) if total else 0.0,
                "hit_bytes": self.hit_bytes,
                "evictions": self.evictions,
                "stale_drops": self.stale_drops,
                "generation": self._generation,
                "entries": len(self._entries),
                "bytes": self._bytes,
                "capacity_bytes": self.max_bytes,
            }


class CostModel:
    """Per-bucket step cost in normalized cost units.

    Seeded from the bucket geometry (cost proportional to bucket rows —
    the shape the bench's per-bucket timings measure on every box this
    repo has run on), then refreshed by an online EWMA over the
    batcher's measured batch walls: ``observe(rows, wall_s)`` per
    completed batch, ``price(rows)`` per admission decision. Prices are
    normalized to the smallest bucket (~1.0), so quota rates configured
    in requests/sec keep their meaning for smallest-bucket traffic and
    an 8x-bucket request costs what it measures — not what it claims.
    """

    def __init__(self, buckets: Sequence[int], alpha: float = 0.2,
                 seed_costs: Optional[Dict[int, float]] = None) -> None:
        if not buckets:
            raise ValueError("CostModel needs at least one bucket")
        self.buckets: Tuple[int, ...] = tuple(sorted(set(
            int(b) for b in buckets)))
        if self.buckets[0] < 1:
            raise ValueError(f"buckets must be >= 1, got {self.buckets}")
        self.alpha = float(alpha)
        self._lock = threading.Lock()
        base = float(self.buckets[0])
        # Seed walls in arbitrary units; only RATIOS ever leave price(),
        # and the first real observation rescales every still-seeded
        # bucket onto the measured unit (seconds), so a price never
        # compares a seed unit against a measured one.
        self._wall: Dict[int, float] = {
            b: float(b) / base for b in self.buckets}
        for b, w in (seed_costs or {}).items():
            if int(b) in self._wall and float(w) > 0:
                self._wall[int(b)] = float(w)
        self._observed: Dict[int, int] = {b: 0 for b in self.buckets}
        self._calibrated = False

    def bucket_for(self, rows: int) -> int:
        for b in self.buckets:
            if rows <= b:
                return b
        return self.buckets[-1]

    def observe(self, rows: int, wall_s: float) -> None:
        """EWMA-refresh one bucket's measured wall (the batcher's
        completion stage calls this per successful batch)."""
        if wall_s <= 0:
            return
        b = self.bucket_for(int(rows))
        with self._lock:
            prev = self._wall[b]
            if self._observed[b] == 0:
                # First real measurement replaces the geometric seed —
                # an EWMA from a made-up baseline converges too slowly.
                # The very first observation also rescales every
                # still-seeded bucket onto the measured unit, keeping
                # the seed GEOMETRY (cost ~ rows) while making every
                # cross-bucket ratio unit-consistent from then on.
                if not self._calibrated:
                    scale = float(wall_s) / prev
                    for c in self.buckets:
                        if c != b and self._observed[c] == 0:
                            self._wall[c] *= scale
                    self._calibrated = True
                self._wall[b] = float(wall_s)
            else:
                self._wall[b] = ((1.0 - self.alpha) * prev
                                 + self.alpha * float(wall_s))
            self._observed[b] += 1

    def price(self, rows: int) -> float:
        """Cost units for a ``rows``-row request: its bucket's measured
        wall over the smallest bucket's. Floored at HIT_COST (a
        degenerate measurement must never price compute below a cache
        hit)."""
        b = self.bucket_for(int(rows))
        with self._lock:
            base = self._wall[self.buckets[0]]
            wall = self._wall[b]
        if base <= 0:
            return 1.0
        return max(HIT_COST, round(wall / base, 4))

    def snapshot(self) -> Dict:
        with self._lock:
            base = self._wall[self.buckets[0]] or 1.0
            return {
                "buckets": list(self.buckets),
                "alpha": self.alpha,
                "cost_units": {str(b): round(self._wall[b] / base, 4)
                               for b in self.buckets},
                "observed_batches": {str(b): self._observed[b]
                                     for b in self.buckets},
            }
