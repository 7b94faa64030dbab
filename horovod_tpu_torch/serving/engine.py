"""The continuous-batching step loop, port of ``horovod_tpu/serving/engine.py``.

One ``step()`` = admit joins, one fused decode over every batch slot,
retire finishers. As in the JAX engine:

  * decode always runs all ``num_slots`` rows — inactive rows park their
    K/V write at ``max_len - 1``, where the length mask hides it, and
    the host ignores their tokens;
  * prefill pads each prompt to a KV-block multiple (causal masking makes
    the pads inert) and runs the model's attention — on the card, the
    flash-attention kernels;
  * admission reserves a request's whole-life cache blocks (prompt plus
    every generated token that is written back) before it holds a slot,
    so a later joiner can never starve it mid-stream;
  * exactly one host readback per prefill (the first token) and one per
    decode step (the sampled ids).

Left for later slices of the port: the fleet's weight hot swap (and so
the per-generation decode cohorts), ``ReplicaGroup`` liveness, the
tensor-parallel mesh, and the metrics, alert, history and memory hooks.
"""

import time

import numpy as np
import torch

from ..common import config
from ..common.device import resolve_device
from .decode import decode_step, prefill_forward
from .kv_cache import KVCache
from .queue import AdmissionQueue, RequestResult
from .sampling import sample_tokens
from .scheduler import SlotScheduler


class _Active:
    """Host-side per-slot decode state."""

    __slots__ = ("request", "generated", "next_token", "next_pos",
                 "ttft_s")

    def __init__(self, request, first_token, prompt_len, now):
        self.request = request
        self.generated = [first_token]
        self.next_token = first_token  # fed to the next decode step
        self.next_pos = prompt_len  # cache position it will occupy
        self.ttft_s = now - request.arrival_ts


class ServeEngine:
    """Continuous-batching engine over one model replica on ``device``
    (CUDA unless told otherwise). ``model`` is a ``TransformerLM`` on
    that device. ``policy="drain"`` is the static-batch baseline;
    everything else about the engine is identical."""

    def __init__(self, cfg, model, num_slots=None, max_len=None,
                 kv_block=None, total_blocks=None, policy="continuous",
                 queue=None, seed=0, clock=time.monotonic, device=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        num_slots = (config.env_int("SERVE_SLOTS", 8)
                     if num_slots is None else num_slots)
        self.kv = KVCache(cfg, num_slots, max_len=max_len,
                          block_size=kv_block, total_blocks=total_blocks,
                          device=self.device)
        self.scheduler = SlotScheduler(num_slots, policy=policy)
        self.queue = queue if queue is not None else AdmissionQueue()
        self._clock = clock
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._draining = False
        self._active = {}  # slot -> _Active
        self._finished = []

    # -- submission -----------------------------------------------------

    def submit(self, request):
        if self._draining:
            return False
        return self.queue.submit(request)

    @property
    def draining(self):
        return self._draining

    def begin_drain(self):
        """Enter drain mode: no new submissions; the queue and in-flight
        work run to completion. Idempotent."""
        self._draining = True

    # -- the step loop --------------------------------------------------

    def step(self):
        """One scheduler iteration. Returns the requests that finished
        during it, as RequestResults."""
        self._admit()
        self.scheduler.begin_wave()
        self._decode()
        done, self._finished = self._finished, []
        return done

    def run_to_completion(self, max_steps=100000):
        """Drive step() until queue and batch are empty."""
        out = []
        for _ in range(max_steps):
            out.extend(self.step())
            if not self._active and not len(self.queue):
                break
        return out

    @property
    def active_count(self):
        return len(self._active)

    # -- internals ------------------------------------------------------

    def _pad_len(self, n):
        block = self.kv.ledger.block_size
        return min(-(-n // block) * block, self.kv.max_len)

    def _admit(self):
        while self.scheduler.can_join():
            req = self.queue.pop()
            if req is None:
                break
            prompt_len = len(req.prompt)
            # cache rows needed over the request's whole life: the final
            # generated token is sampled but never written back
            final_len = prompt_len + max(req.max_new_tokens - 1, 0)
            if (prompt_len == 0 or final_len > self.kv.max_len or
                    self.kv.ledger._blocks_for(final_len) >
                    self.kv.ledger.total_blocks):
                self._finished.append(RequestResult(
                    req.request_id, (), "failed", reason="too_long",
                    finish_ts=self._clock()))
                continue
            if not self.kv.ledger.can_alloc(final_len):
                # cache pressure, not impossibility: wait for
                # retirements, gating on the WHOLE-life need
                self.queue.requeue(req)
                break
            self._prefill(req, prompt_len, final_len)

    def _prefill(self, req, prompt_len, final_len):
        slot = self.scheduler.join(req.request_id)
        self.kv.ledger.alloc_at(slot, prompt_len, reserve=final_len)
        s_pad = self._pad_len(prompt_len)
        tokens = torch.zeros((1, s_pad), dtype=torch.int64)
        tokens[0, :prompt_len] = torch.as_tensor(req.prompt)
        logits, pk, pv = prefill_forward(self.cfg, self.model,
                                         tokens.to(self.device))
        tok = sample_tokens(logits[0, prompt_len - 1][None],
                            [req.temperature], self._generator)
        self.kv.k[:, slot, :s_pad] = pk[:, 0]
        self.kv.v[:, slot, :s_pad] = pv[:, 0]
        first = int(tok[0])  # the one per-prefill readback
        self._active[slot] = _Active(req, first, prompt_len, self._clock())
        if req.max_new_tokens <= 1:
            self._retire(slot, "completed")

    def _decode(self):
        if not self._active:
            return
        S = self.kv.num_slots
        tokens = np.zeros(S, np.int64)
        # rows outside the batch park their K/V write at max_len-1, where
        # the length mask hides it until a real row overwrites it
        positions = np.full(S, self.kv.max_len - 1, np.int64)
        temps = np.zeros(S, np.float32)
        for slot, st in self._active.items():
            tokens[slot] = st.next_token
            positions[slot] = st.next_pos
            temps[slot] = st.request.temperature
        logits, _, _ = decode_step(
            self.cfg, self.model, torch.from_numpy(tokens).to(self.device),
            torch.from_numpy(positions).to(self.device), self.kv.k,
            self.kv.v)
        nxt = sample_tokens(logits, temps, self._generator)
        ids = nxt.cpu().numpy()  # the one per-step readback
        now = self._clock()
        for slot in list(self._active):
            st = self._active[slot]
            # the fed token's K/V landed at next_pos this step
            if not self.kv.ledger.grow(slot, st.next_pos + 1):
                self._retire(slot, "failed", reason="kv_exhausted")
                continue
            tok = int(ids[slot])
            st.generated.append(tok)
            st.next_token = tok
            st.next_pos += 1
            req = st.request
            if len(st.generated) >= req.max_new_tokens:
                self._retire(slot, "completed")
            elif (req.deadline_s is not None and
                    now - req.arrival_ts > req.deadline_s):
                self._retire(slot, "failed", reason="deadline")

    def _retire(self, slot, outcome, reason=""):
        st = self._active.pop(slot)
        self.kv.ledger.free(slot)
        self.scheduler.retire(slot)
        self._finished.append(RequestResult(
            st.request.request_id, tuple(st.generated), outcome,
            ttft_s=st.ttft_s, finish_ts=self._clock(), reason=reason))
