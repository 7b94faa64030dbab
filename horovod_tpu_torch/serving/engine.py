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

Tensor-parallel serving: with a ``mesh`` whose tp axis is above 1 (a
process mesh, or a thread rank's ``ThreadMesh`` where the tp ranks share
one card), ``_place_params`` places the weights by the model's
``param_specs`` once, the KV cache holds this rank's heads, and prefill
and decode run on them with one activation all-reduce after ``out`` and
one after ``down`` per layer and one all-gather of the head's logits
(``serving.decode.ServingWeights``). Every tp rank runs the same engine
on the same requests, and samples the same tokens.

Left for later slices of the port: the fleet's weight hot swap (and so
the per-generation decode cohorts, the generation stays 0),
``ReplicaGroup`` liveness, and the metrics, alert, history and memory
hooks.
"""

import time

import numpy as np
import torch

from ..common import config
from ..common.device import resolve_device
from ..common.exceptions import RanksLostError
from ..utils import memory as hvd_memory
from .decode import ServingWeights, decode_step, prefill_forward
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
    that device, whole on every rank; with a ``mesh`` each rank keeps its
    tensor-parallel shards of it. ``policy="drain"`` is the static-batch
    baseline; everything else about the engine is identical.
    ``replica`` (``serving.replica.ReplicaGroup``) plugs the engine into
    the control plane's liveness ledger: each step heartbeats with the
    engine's load snapshot, and a declared-lost peer calls
    ``on_ranks_lost(lost_ranks)`` instead of hanging."""

    def __init__(self, cfg, model, num_slots=None, max_len=None,
                 kv_block=None, total_blocks=None, policy="continuous",
                 queue=None, seed=0, clock=time.monotonic, device=None,
                 mesh=None, replica=None, on_ranks_lost=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        self.params = self._place_params(model)
        self._generation = 0
        num_slots = (config.env_int("SERVE_SLOTS", 8)
                     if num_slots is None else num_slots)
        self.kv = KVCache(cfg, num_slots, max_len=max_len,
                          block_size=kv_block, total_blocks=total_blocks,
                          device=self.device, mesh=mesh)
        self.scheduler = SlotScheduler(num_slots, policy=policy)
        self.queue = queue if queue is not None else AdmissionQueue()
        self._clock = clock
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)
        self._draining = False
        self._active = {}  # slot -> _Active
        self._finished = []
        self._replica = replica
        self._on_ranks_lost = on_ranks_lost

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
        self._heartbeat()
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

    def _heartbeat(self):
        """One liveness cycle of the replica group; a RanksLostError
        becomes failover: the group is closed and dropped, and the lost
        ranks go to ``on_ranks_lost``."""
        if self._replica is None:
            return
        try:
            self._replica.heartbeat(load=self.load_snapshot())
        except RanksLostError as err:
            lost = tuple(int(r) for r in err.ranks)
            replica, self._replica = self._replica, None
            replica.close()
            if self._on_ranks_lost is not None:
                self._on_ranks_lost(lost)

    @property
    def generation(self):
        """The weight generation newly admitted requests decode on (0
        until the fleet's hot swap is ported)."""
        return self._generation

    def load_snapshot(self):
        """Compact live-load summary, the JAX engine's: queue depth,
        busy/free slots, outstanding decode work in tokens (queued plus
        remaining on active slots), free KV blocks, the OOM forecast and
        the weight generations (the armed one None until the fleet plane
        is ported)."""
        ledger = self.kv.ledger
        work = sum(max(st.request.max_new_tokens - len(st.generated), 0)
                   for st in self._active.values())
        queued_tokens = (self.queue.queued_work_tokens()
                         if hasattr(self.queue, "queued_work_tokens")
                         else 0)
        work += queued_tokens
        snap = {
            "queue_depth": len(self.queue),
            "active_slots": len(self._active),
            "work_tokens": work,
            "free_slots": self.kv.num_slots - len(self._active),
            "free_blocks": ledger.total_blocks - ledger.blocks_in_use,
            "total_blocks": ledger.total_blocks,
            "predicted_free_blocks": ledger.predicted_free_blocks(
                queued_tokens),
            "generation": self._generation,
            "armed_generation": None,
        }
        if self._draining:
            snap["draining"] = True
        return snap

    def resharding_report(self):
        """The resharding sentinel over one decode step at this engine's
        real shapes (every slot, on a scratch copy of the cache): the
        collectives it issues, recorded through the serving forwards'
        own wrappers, held to ``utils.memory.scan_resharding``'s rule.
        Empty on a clean engine and on one with no mesh. Under tp every
        rank of the engine must call it together (it issues the step's
        collectives)."""
        if self.mesh is None:
            return []
        from ..models.transformer import param_specs
        S = self.kv.num_slots
        tokens = torch.zeros(S, dtype=torch.int64, device=self.device)
        positions = torch.zeros_like(tokens)
        with self.params.recording() as records:
            decode_step(self.cfg, self.params, tokens, positions,
                        self.kv.k.clone(), self.kv.v.clone())
        named = dict(self.model.named_parameters())
        return hvd_memory.scan_resharding(
            records, named, param_specs(named), self.mesh.shape,
            site="serve_decode")

    # -- internals ------------------------------------------------------

    def _place_params(self, model):
        """The weights the forwards read: the model's own without a mesh,
        this rank's shards placed by ``param_specs`` with one (the fused
        qkv's heads gathered once, here)."""
        return ServingWeights(self.cfg, model, self.mesh)

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
        logits, pk, pv = prefill_forward(self.cfg, self.params,
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
            self.cfg, self.params, torch.from_numpy(tokens).to(self.device),
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
