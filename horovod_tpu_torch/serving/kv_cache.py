"""Slot-based KV cache with block-granular accounting.

Two halves, deliberately separated:

  * BlockLedger — pure-host bookkeeping: which slot owns how many
    fixed-size blocks of cache capacity, against a global block budget.
    Copied verbatim from ``horovod_tpu/serving/kv_cache.py``.
  * KVCache — the device tensors: dense, preallocated
    [layers, slots, max_len, heads, head_dim] K and V, updated in place
    by prefill and decode. Dense rather than paged because the engine
    decodes every slot every step at one shape; lengths are data. On a
    tensor-parallel mesh each rank holds its shard of the heads
    (``parallel.mesh.kv_cache_spec``: heads over tp when tp divides
    them, else every head).

The ledger accounts in blocks (HVD_SERVE_KV_BLOCK tokens each) so
admission can refuse work that would oversubscribe cache capacity
BEFORE it holds a slot.
"""

import math

import torch

from ..common import config


class BlockLedger:
    """Host-side block accounting for ``num_slots`` cache rows.

    Each slot may grow to ``max_len`` tokens; capacity is claimed in
    blocks of ``block_size`` tokens against ``total_blocks`` (default:
    exactly enough for every slot at full length — a tighter budget
    models cache-constrained admission).
    """

    def __init__(self, num_slots, max_len, block_size=None,
                 total_blocks=None):
        self.block_size = (config.env_int("SERVE_KV_BLOCK", 16)
                           if block_size is None else block_size)
        if self.block_size <= 0:
            raise ValueError(f"block_size must be > 0, got "
                             f"{self.block_size}")
        self.num_slots = num_slots
        self.max_len = max_len
        self.blocks_per_slot_max = math.ceil(max_len / self.block_size)
        self.total_blocks = (num_slots * self.blocks_per_slot_max
                             if total_blocks is None else total_blocks)
        self._free_slots = list(range(num_slots - 1, -1, -1))
        self._blocks = {}  # slot -> blocks held
        self._lengths = {}  # slot -> valid tokens

    @property
    def blocks_in_use(self):
        return sum(self._blocks.values())

    @property
    def free_slots(self):
        return len(self._free_slots)

    def length(self, slot):
        return self._lengths[slot]

    def _blocks_for(self, length):
        return max(1, math.ceil(length / self.block_size))

    def can_alloc(self, length):
        if not self._free_slots or length > self.max_len:
            return False
        return (self.blocks_in_use + self._blocks_for(length)
                <= self.total_blocks)

    def alloc(self, length):
        """Claim a slot sized for ``length`` tokens; None when slots or
        the block budget are exhausted (admission then rejects)."""
        if not self.can_alloc(length):
            return None
        slot = self._free_slots.pop()
        self._blocks[slot] = self._blocks_for(length)
        self._lengths[slot] = length
        return slot

    def alloc_at(self, slot, length, reserve=None):
        """Claim a SPECIFIC free slot — the engine path, where the
        scheduler owns slot assignment and the ledger must account the
        same row. ``reserve`` claims blocks for a longer whole-life
        length up front (the engine reserves prompt + max_new so a
        request, once admitted, can never be starved mid-stream by a
        later joiner). Raises on a taken slot (desync bug) and on an
        over-budget claim (callers gate on can_alloc first)."""
        if slot in self._blocks:
            raise KeyError(f"alloc_at on taken slot {slot}")
        if slot not in self._free_slots:
            raise KeyError(f"alloc_at on unknown slot {slot}")
        reserve = length if reserve is None else max(reserve, length)
        if not self.can_alloc(reserve):
            raise RuntimeError(
                f"alloc_at({slot}, {length}, reserve={reserve}) over "
                f"budget: {self.blocks_in_use}/{self.total_blocks} "
                f"blocks used")
        self._free_slots.remove(slot)
        self._blocks[slot] = self._blocks_for(reserve)
        self._lengths[slot] = length

    def grow(self, slot, new_length):
        """Extend a slot to ``new_length`` tokens, claiming blocks as
        crossed; False when the budget or max_len refuses (the engine
        must then retire the request, never silently truncate)."""
        if slot not in self._blocks:
            raise KeyError(f"grow on unallocated slot {slot}")
        if new_length > self.max_len:
            return False
        need = self._blocks_for(new_length)
        have = self._blocks[slot]
        if need > have:
            if self.blocks_in_use + (need - have) > self.total_blocks:
                return False
            self._blocks[slot] = need
        self._lengths[slot] = new_length
        return True

    def free(self, slot):
        """Return every block the slot holds. Double-free raises — a
        scheduler bug, not a runtime condition to paper over."""
        if slot not in self._blocks:
            raise KeyError(f"free on unallocated slot {slot}")
        del self._blocks[slot]
        del self._lengths[slot]
        self._free_slots.append(slot)

    def predicted_free_blocks(self, queued_tokens):
        """OOM forecast (docs/memory.md): free blocks AFTER the queue
        drains — free minus what ``queued_tokens`` of not-yet-admitted
        work will claim. Active slots already hold their whole-life
        reservation (alloc_at reserves prompt + max_new at admission),
        so the only future claim left is the queue. ≤0 means the next
        admissions will exhaust the cache: the elasticity pressure
        signal and the router's ``kv_forecast`` shed read this."""
        free = self.total_blocks - self.blocks_in_use
        if not queued_tokens or queued_tokens <= 0:
            return free
        return free - math.ceil(queued_tokens / self.block_size)


class KVCache:
    """Dense per-slot K/V device tensors plus their ledger (one per
    engine, written in place by its single-threaded step loop)."""

    def __init__(self, cfg, num_slots, max_len=None, block_size=None,
                 total_blocks=None, device=None, mesh=None):
        max_len = cfg.max_seq_len if max_len is None else max_len
        self.ledger = BlockLedger(num_slots, max_len,
                                  block_size=block_size,
                                  total_blocks=total_blocks)
        shape = (cfg.num_layers, num_slots, max_len, cfg.num_heads,
                 cfg.head_dim)
        if mesh is not None:
            # this rank's shard: heads/tp of them when tp divides the
            # heads, all of them (replicated) otherwise
            from ..parallel import mesh as mesh_lib
            shape = mesh_lib.spec_shard_shape(
                shape, mesh_lib.kv_cache_spec(cfg.num_heads, mesh),
                mesh.shape)
        self.k = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.v = torch.zeros(shape, dtype=cfg.dtype, device=device)
        self.max_len = max_len

    def per_chip_bytes(self):
        """Bytes of K+V cache this rank holds on its card: its shard under
        the cache's sharding, the whole cache when unsharded."""
        return sum(t.numel() * t.element_size() for t in (self.k, self.v))

    @property
    def num_slots(self):
        return self.ledger.num_slots
