"""Slot scheduling: continuous batching vs the drain baseline.

Pure host-side state machine (no jax) mapping requests to device batch
slots. Two policies:

  * continuous — a request may JOIN whenever a slot is free and RETIRE
    the moment it finishes; the device batch never drains. This is the
    serving plane's whole point: short requests stop paying for long
    ones (docs/serving.md).
  * drain — the static-batch baseline the bench compares against: a
    wave of requests is admitted only into an idle batch, decodes to
    completion, and only then may the next wave join. Deliberately kept
    in-tree so the baseline in bench.py is the same engine with one
    flag, not a separate code path that could drift.

Invariants (tests/test_serving.py): a slot is owned by at most one
request; join on a full batch raises; retire frees the slot for
immediate reuse; drain never admits into a started wave.
"""


class SlotScheduler:
    POLICIES = ("continuous", "drain")

    def __init__(self, num_slots, policy="continuous"):
        if policy not in self.POLICIES:
            raise ValueError(f"unknown policy {policy!r}; expected one "
                             f"of {self.POLICIES}")
        if num_slots <= 0:
            raise ValueError(f"num_slots must be > 0, got {num_slots}")
        self.num_slots = num_slots
        self.policy = policy
        self.active = {}  # slot -> request_id
        self._free = list(range(num_slots - 1, -1, -1))
        self._wave_started = False

    def can_join(self):
        if not self._free:
            return False
        if self.policy == "continuous":
            return True
        # drain: admit only while the current wave is still filling
        return not self._wave_started

    def join(self, request_id):
        """Assign a free slot; raises when can_join() is False — the
        engine must gate on it, a blind join is a scheduling bug."""
        if not self.can_join():
            raise RuntimeError(
                f"join({request_id!r}) with no admissible slot "
                f"(policy={self.policy}, active={len(self.active)}/"
                f"{self.num_slots}, wave_started={self._wave_started})")
        slot = self._free.pop()
        self.active[slot] = request_id
        return slot

    def begin_wave(self):
        """Engine marks that decoding started on the current batch; only
        the drain policy cares (it closes admission until idle)."""
        if self.active:
            self._wave_started = True

    def retire(self, slot):
        if slot not in self.active:
            raise KeyError(f"retire of inactive slot {slot}")
        del self.active[slot]
        self._free.append(slot)
        if not self.active:
            self._wave_started = False

    def snapshot(self):
        """Occupancy summary for span attrs / the failover dump: which
        request owns which slot right now (serving/tracing.py stamps
        this onto decode_tick spans so a flight dump shows the batch
        composition at every step)."""
        return {
            "policy": self.policy,
            "occupied": len(self.active),
            "free": len(self._free),
            "wave_started": self._wave_started,
            "slots": {int(s): rid for s, rid in sorted(
                self.active.items())},
        }
