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

The observability planes ride the step as in the JAX engine: the
``hvd_serve_*`` families (requests by outcome, tokens by phase, TTFT,
inter-token gaps, goodput and wasted tokens, active slots, KV blocks,
phase seconds), the ``serve_admit`` / ``serve_reject`` /
``serve_retire`` / ``serve_failover`` events, every request's trace
(``serving/tracing.py``: prefill, one ``decode_tick`` span per fused
step credited to every active request, the ``phase_ms`` decomposition on
each result), and ``history.poke`` and ``alerts.tick`` on every
``step`` on the engine's clock.

The fleet plane's zero-drain hot swap rides it too. ``_maybe_swap`` at
the top of ``step()`` polls the engine's ``WeightSubscriber`` (one stat,
rate-limited), asks the ``swap_gate`` (the router's canary), and makes an
armed generation current: on the card it first makes the engine's stream
wait on the loader's CUDA event and ``record_stream``s the new tensors
onto it, then builds a separate module for the generation
(``decode.model_from_tree``, on ``meta`` with ``assign=True``) and its
``ServingWeights`` through ``_place_params``, so on a tp mesh it is
sharded as the old one was. Every request decodes to the end on the
weights that admitted it: during a transition decode runs one fused pass
per live generation over all slots (the other cohorts' rows parked at
``max_len - 1``), one readback per pass, and an old generation is dropped
once no active request decodes on it. Under tp every rank swaps at the
same step: the ranks agree on the armed generation over the tp group.

The memory plane rides it as in the JAX engine: the weights and the KV
cache go into the HBM ledger at build, the weights again on every swap,
and each prefill (keyed by its padded length) and decode step reports
its abstract-shape key to the compile tracker (``serve_prefill``,
``serve_decode``).
"""

import time

import numpy as np
import torch
import torch.distributed as dist

from ..common import config
from ..common.device import resolve_device
from ..common.exceptions import RanksLostError
from ..fleet.subscriber import tree_leaves
from ..utils import alerts as hvd_alerts
from ..utils import history as hvd_history
from ..utils import memory as hvd_memory
from ..utils import metrics as hvd_metrics
from ..utils import tracing as hvd_tracing
from . import tracing as serve_tracing
from .decode import (ServingWeights, decode_step, model_from_tree,
                     prefill_forward)
from .kv_cache import KVCache
from .queue import AdmissionQueue, RequestResult
from .sampling import sample_tokens
from .scheduler import SlotScheduler


class _Active:
    """Host-side per-slot decode state."""

    __slots__ = ("request", "generated", "next_token", "next_pos",
                 "ttft_s", "last_token_ts", "generation")

    def __init__(self, request, first_token, prompt_len, now,
                 generation=0):
        self.request = request
        self.generated = [first_token]
        self.next_token = first_token  # fed to the next decode step
        self.next_pos = prompt_len  # cache position it will occupy
        self.ttft_s = now - request.arrival_ts
        self.last_token_ts = now
        # the weight generation that admitted this request: it decodes on
        # these weights to the end, across any hot swap
        self.generation = generation


class ServeEngine:
    """Continuous-batching engine over one model replica on ``device``
    (CUDA unless told otherwise). ``model`` is a ``TransformerLM`` on
    that device, whole on every rank (``decode.model_from_tree`` builds
    one from the weights ``WeightSubscriber.load_initial`` returns); with
    a ``mesh`` each rank keeps its tensor-parallel shards of it.
    ``policy="drain"`` is the static-batch baseline; everything else
    about the engine is identical. ``replica``
    (``serving.replica.ReplicaGroup``) plugs the engine into the control
    plane's liveness ledger: each step heartbeats with the engine's load
    snapshot, and a declared-lost peer calls ``on_ranks_lost(lost_ranks)``
    instead of hanging.

    ``subscriber`` (``fleet.WeightSubscriber``, else ``replica``'s) feeds
    armed weight generations, swapped in at step boundaries;
    ``generation`` is the one ``model`` holds (the subscriber's current
    one, else 0). ``swap_gate(generation) -> bool`` (the router's
    ``CanaryController.gate``) may hold the engine on its current weights;
    the generation stays armed and is offered again next step."""

    def __init__(self, cfg, model, num_slots=None, max_len=None,
                 kv_block=None, total_blocks=None, policy="continuous",
                 queue=None, seed=0, clock=time.monotonic, device=None,
                 mesh=None, replica=None, on_ranks_lost=None,
                 subscriber=None, generation=None, swap_gate=None):
        self.device = resolve_device(device)
        if model.device.type != self.device.type:
            raise ValueError(f"model is on {model.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.model = model
        self.mesh = mesh
        self.params = self._place_params(model)
        # fleet plane: params is always the CURRENT generation's weights
        # (what prefill uses); _params_by_gen keeps older generations
        # alive exactly as long as a request admitted under them decodes
        if subscriber is None and replica is not None:
            subscriber = getattr(replica, "subscriber", None)
        self._subscriber = subscriber
        if generation is None:
            generation = 0
            if subscriber is not None and \
                    subscriber.current_generation is not None:
                generation = subscriber.current_generation
        self._generation = int(generation)
        self._params_by_gen = {self._generation: self.params}
        self.last_swap = None  # latency phases of the most recent swap
        self._swap_gate = swap_gate
        num_slots = (config.env_int("SERVE_SLOTS", 8)
                     if num_slots is None else num_slots)
        self.kv = KVCache(cfg, num_slots, max_len=max_len,
                          block_size=kv_block, total_blocks=total_blocks,
                          device=self.device, mesh=mesh)
        if hvd_memory.enabled():
            ledger = hvd_memory.get_ledger()
            ledger.account_tree("params", self.model)
            ledger.account_kv(self.kv)
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
        reg = self._metrics = hvd_metrics.get_registry()
        self._m_requests = reg.counter(
            "hvd_serve_requests_total",
            "Serving requests by terminal outcome "
            "(completed/rejected/failed).", labels=("outcome",))
        self._m_tokens = reg.counter(
            "hvd_serve_tokens_total",
            "Tokens processed by the serving engine, by phase.",
            labels=("phase",))
        self._m_ttft = reg.histogram(
            "hvd_serve_ttft_seconds",
            "Time to first token: request arrival to the prefill "
            "sample.")
        self._m_intertoken = reg.histogram(
            "hvd_serve_intertoken_seconds",
            "Gap between consecutive decode tokens of one request.")
        self._m_active = reg.gauge(
            "hvd_serve_active_slots",
            "Batch slots currently decoding a request.")
        self._m_blocks = reg.gauge(
            "hvd_serve_kv_blocks_in_use",
            "KV-cache blocks currently claimed by active slots.")
        # SLO goodput: a token counts as goodput only when its request
        # completed within its deadline; everything else is wasted
        # device work, labeled by why
        self._m_goodput = reg.counter(
            "hvd_serve_goodput_tokens_total",
            "Tokens (prefill + decode) of requests that completed "
            "within their SLO deadline.")
        self._m_wasted = reg.counter(
            "hvd_serve_wasted_tokens_total",
            "Tokens (prefill + decode) whose request ended without "
            "meeting its SLO, by why the work was wasted.",
            labels=("reason",))
        self._m_goodput_ratio = reg.gauge(
            "hvd_serve_goodput_ratio",
            "goodput / (goodput + wasted) tokens over the engine's "
            "life; 1.0 until the first wasted token.")
        self._goodput_tokens = 0
        self._wasted_tokens = 0
        if self._subscriber is not None:
            rep = str(self._subscriber.replica)
            self._m_gen = reg.gauge(
                "hvd_fleet_generation",
                "Weight generation this replica is currently serving.",
                labels=("replica",)).labels(replica=rep)
            self._m_gen.set(self._generation)
            self._m_swaps = reg.counter(
                "hvd_fleet_swaps_total",
                "Zero-drain weight swaps completed by serving engines.")
            self._m_last_swap = reg.gauge(
                "hvd_fleet_last_swap_seconds",
                "Detect->swapped latency of this replica's most recent "
                "weight swap.", labels=("replica",)).labels(replica=rep)
            self._m_swap_s = reg.histogram(
                "hvd_fleet_swap_seconds",
                "Weight-swap latency decomposition "
                "(detect_to_loaded/loaded_to_armed/armed_to_swapped/"
                "total).", labels=("phase",))
        serve_tracing.phase_histogram(reg)
        self._gauge_interval = config.env_float(
            "SERVE_METRICS_INTERVAL_S", 1.0)
        self._last_gauge_ts = -1e30

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
        if self._draining:
            return
        self._draining = True
        self._metrics.event("serve_drain_begin",
                            inflight=len(self._active),
                            queued=len(self.queue))

    # -- the step loop --------------------------------------------------

    def step(self):
        """One scheduler iteration. Returns the requests that finished
        during it, as RequestResults."""
        self._heartbeat()
        self._maybe_swap()
        dirty = self._admit()
        self.scheduler.begin_wave()
        dirty |= self._decode()
        self._refresh_gauges(force=dirty)
        # alerting and the durable history ride the serve tick, on the
        # engine's clock (interval-throttled clock compares)
        now = self._clock()
        hvd_history.poke(now)
        hvd_alerts.tick(now)
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
            # the in-flight requests' spans are still open, so the dump
            # below carries them
            inflight = sorted(st.request.request_id
                              for st in self._active.values())
            self._metrics.event("serve_failover", lost_ranks=list(lost),
                                inflight=inflight)
            hvd_tracing.get_tracer().dump("serve_ranks_lost")
            replica, self._replica = self._replica, None
            replica.close()
            if self._on_ranks_lost is not None:
                self._on_ranks_lost(lost)

    @property
    def generation(self):
        """The weight generation newly admitted requests decode on."""
        return self._generation

    def load_snapshot(self):
        """Compact live-load summary, the JAX engine's and what the router
        scores dispatch on: queue depth, busy/free slots, outstanding
        decode work in tokens (queued plus remaining on active slots),
        free KV blocks, the OOM forecast, and the current and armed
        weight generations (the canary controller reads cohorts off
        these)."""
        ledger = self.kv.ledger
        sub = self._subscriber
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
            "armed_generation": (getattr(sub, "armed_generation", None)
                                 if sub is not None else None),
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
        qkv's heads gathered once, here). Weights enter the engine only
        through here (``__init__`` and hot swaps), so a swapped-in
        generation is sharded as the one it replaces."""
        return ServingWeights(self.cfg, model, self.mesh)

    def _maybe_swap(self):
        """Zero-drain hot swap at the step boundary: poll the subscriber
        and, if a fully loaded and verified generation is armed (and the
        swap gate lets it through), make it current. In-flight requests
        keep their admit-time generation (the cohort decode finishes them
        on the old weights), so nothing drains and no half-loaded tree is
        ever read."""
        sub = self._subscriber
        if sub is None:
            return
        sub.poll()
        rec = sub.armed
        if rec is not None and self._swap_gate is not None and \
                not self._swap_gate(rec.generation):
            rec = None  # held by the canary gate; offered again next step
        if self.params.comm is not None:
            rec = self._agree(rec)
        if rec is None:
            return
        rec = sub.take_armed(rec)
        if rec.event is not None:
            # fence: the engine's stream waits for the loader's copies,
            # and the allocator learns that this stream reads the blocks
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(rec.event)
            for leaf in tree_leaves(rec.params):
                leaf.record_stream(stream)
        old_gen, gen = self._generation, rec.generation
        self.model = model_from_tree(self.cfg, rec.params, self.device)
        # re-state the params component: a swapped-in generation may
        # differ in dtype or shape from the one it replaces
        if hvd_memory.enabled():
            hvd_memory.get_ledger().account_tree("params", self.model)
        new_params = self._place_params(self.model)
        self.params = new_params
        self._params_by_gen[gen] = new_params
        self._generation = gen
        self._prune_params()
        now = sub.clock()  # the subscriber's clock stamped rec
        d2l = max(rec.loaded_ts - rec.detect_ts, 0.0)
        l2a = max(rec.armed_ts - rec.loaded_ts, 0.0)
        a2s = max(now - rec.armed_ts, 0.0)
        total = d2l + l2a + a2s
        for phase, dt in (("detect_to_loaded", d2l),
                          ("loaded_to_armed", l2a),
                          ("armed_to_swapped", a2s), ("total", total)):
            self._m_swap_s.labels(phase=phase).observe(dt)
        self._m_swaps.inc()
        self._m_gen.set(gen)
        self._m_last_swap.set(total)
        self.last_swap = {
            "generation": gen, "from_generation": old_gen,
            "step": rec.step,
            "detect_to_loaded_ms": round(d2l * 1e3, 3),
            "loaded_to_armed_ms": round(l2a * 1e3, 3),
            "armed_to_swapped_ms": round(a2s * 1e3, 3),
            "total_ms": round(total * 1e3, 3),
        }
        self._metrics.event(
            "fleet_swap", replica=sub.replica,
            inflight=len(self._active), **self.last_swap)

    def _agree(self, rec):
        """``rec`` when every tp rank of the engine holds the same armed
        generation ready to swap, else None: the ranks' decode passes
        issue collectives, so they must change weights at the same
        step. One two-element MIN all-reduce over the tp group."""
        g = -1 if rec is None else int(rec.generation)
        both = self.params.comm.all_reduce(
            torch.tensor([g, -g], dtype=torch.int64, device=self.device),
            op=dist.ReduceOp.MIN)
        lo, hi = (int(v) for v in both.cpu())
        return rec if lo >= 0 and lo == -hi else None

    def _prune_params(self):
        """Drop weight generations no active request decodes on; the
        single-generation steady state returns at once."""
        if len(self._params_by_gen) == 1:
            return
        live = {st.generation for st in self._active.values()}
        live.add(self._generation)
        for gen in [g for g in self._params_by_gen if g not in live]:
            del self._params_by_gen[gen]

    def _pad_len(self, n):
        block = self.kv.ledger.block_size
        return min(-(-n // block) * block, self.kv.max_len)

    def _admit(self):
        admitted = False
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
                self._m_requests.labels(outcome="failed").inc()
                trace = serve_tracing.trace_of(req)
                phases = trace.on_reject("too_long")
                self._metrics.event(
                    "serve_reject", request_id=req.request_id,
                    reason="too_long", trace_id=trace.trace_id)
                self._finished.append(RequestResult(
                    req.request_id, (), "failed", reason="too_long",
                    finish_ts=self._clock(), trace_id=trace.trace_id,
                    phase_ms=phases or None,
                    generation=self._generation))
                continue
            if not self.kv.ledger.can_alloc(final_len):
                # cache pressure, not impossibility: wait for
                # retirements, gating on the WHOLE-life need
                self.queue.requeue(req)
                break
            self._prefill(req, prompt_len, final_len)
            admitted = True
        return admitted

    def _prefill(self, req, prompt_len, final_len):
        slot = self.scheduler.join(req.request_id)
        trace = serve_tracing.trace_of(req)
        trace.on_prefill_start(slot, prompt_len)
        self.kv.ledger.alloc_at(slot, prompt_len, reserve=final_len)
        s_pad = self._pad_len(prompt_len)
        tokens = torch.zeros((1, s_pad), dtype=torch.int64)
        tokens[0, :prompt_len] = torch.as_tensor(req.prompt)
        # each distinct padded prompt length is a new shape at this site
        if hvd_memory.enabled():
            hvd_memory.get_tracker().observe("serve_prefill", (tokens,))
        logits, pk, pv = prefill_forward(self.cfg, self.params,
                                         tokens.to(self.device))
        tok = sample_tokens(logits[0, prompt_len - 1][None],
                            [req.temperature], self._generator)
        self.kv.k[:, slot, :s_pad] = pk[:, 0]
        self.kv.v[:, slot, :s_pad] = pv[:, 0]
        first = int(tok[0])  # the one per-prefill readback
        st = self._active[slot] = _Active(req, first, prompt_len,
                                          self._clock(),
                                          generation=self._generation)
        trace.on_prefill_end(ttft_s=st.ttft_s)
        trace.annotate(generation=self._generation)
        self._m_tokens.labels(phase="prefill").inc(prompt_len)
        self._m_tokens.labels(phase="decode").inc()
        self._m_ttft.observe(st.ttft_s)
        self._metrics.event("serve_admit", request_id=req.request_id,
                            slot=slot, prompt_len=prompt_len,
                            trace_id=trace.trace_id,
                            generation=self._generation,
                            ttft_s=round(st.ttft_s, 6))
        if req.max_new_tokens <= 1:
            self._retire(slot, "completed")

    def _decode(self):
        if not self._active:
            return False
        # one span per fused step, its duration credited to every
        # request active during the tick
        tick = serve_tracing.tick_span(**self.scheduler.snapshot())
        in_tick = list(self._active.values())
        S = self.kv.num_slots
        # Cohort-partitioned decode: a request decodes on the weights that
        # admitted it, so each live generation runs its own fused pass
        # over ALL slots. Rows outside the pass's cohort park their K/V
        # write at max_len-1, where the length mask hides it until the
        # row's own pass overwrites it (each pass writes, then attends).
        # Between swaps there is one cohort: the one fused call as ever.
        cohorts = {}
        for slot, st in self._active.items():
            cohorts.setdefault(st.generation, []).append(slot)
        sampled = {}
        for gen in sorted(cohorts):
            tokens = np.zeros(S, np.int64)
            positions = np.full(S, self.kv.max_len - 1, np.int64)
            temps = np.zeros(S, np.float32)
            for slot in cohorts[gen]:
                st = self._active[slot]
                tokens[slot] = st.next_token
                positions[slot] = st.next_pos
                temps[slot] = st.request.temperature
            # decode is shape-static: one miss at the first step, hits
            # after it
            if hvd_memory.enabled():
                hvd_memory.get_tracker().observe(
                    "serve_decode", (tokens, positions, temps))
            logits, _, _ = decode_step(
                self.cfg, self._params_by_gen[gen],
                torch.from_numpy(tokens).to(self.device),
                torch.from_numpy(positions).to(self.device), self.kv.k,
                self.kv.v)
            nxt = sample_tokens(logits, temps, self._generator)
            # the per-step readback (one per cohort during a transition)
            ids = nxt.cpu().numpy()
            for slot in cohorts[gen]:
                sampled[slot] = int(ids[slot])
        tick_us = serve_tracing.finish_tick(tick,
                                            active_slots=len(in_tick))
        for st in in_tick:
            serve_tracing.trace_of(st.request).on_decode_tick(tick_us)
        now = self._clock()
        for slot in list(self._active):
            st = self._active[slot]
            # the fed token's K/V landed at next_pos this step
            if not self.kv.ledger.grow(slot, st.next_pos + 1):
                self._retire(slot, "failed", reason="kv_exhausted")
                continue
            tok = sampled[slot]
            st.generated.append(tok)
            st.next_token = tok
            st.next_pos += 1
            self._m_intertoken.observe(now - st.last_token_ts)
            st.last_token_ts = now
            self._m_tokens.labels(phase="decode").inc()
            req = st.request
            if len(st.generated) >= req.max_new_tokens:
                self._retire(slot, "completed")
            elif (req.deadline_s is not None and
                    now - req.arrival_ts > req.deadline_s):
                self._retire(slot, "failed", reason="deadline")
        return True

    def _retire(self, slot, outcome, reason=""):
        st = self._active.pop(slot)
        self.kv.ledger.free(slot)
        self.scheduler.retire(slot)
        self._m_requests.labels(outcome=outcome).inc()
        now = self._clock()
        req = st.request
        trace = serve_tracing.trace_of(req)
        phases = trace.on_retire(outcome, reason,
                                 tokens=len(st.generated))
        # SLO goodput: every token this request cost the device counts
        # as goodput only if it completed inside its deadline
        tokens = len(req.prompt) + len(st.generated)
        met = (outcome == "completed" and
               (req.deadline_s is None or
                now - req.arrival_ts <= req.deadline_s))
        if met:
            self._goodput_tokens += tokens
            self._m_goodput.inc(tokens)
        else:
            waste = reason or ("deadline_miss" if outcome == "completed"
                               else outcome)
            self._wasted_tokens += tokens
            self._m_wasted.labels(reason=waste).inc(tokens)
        total = self._goodput_tokens + self._wasted_tokens
        if total:
            self._m_goodput_ratio.set(self._goodput_tokens / total)
        self._metrics.event("serve_retire",
                            request_id=req.request_id, slot=slot,
                            outcome=outcome, reason=reason,
                            tokens=len(st.generated),
                            generation=st.generation,
                            trace_id=trace.trace_id,
                            phase_ms=phases or None,
                            ttft_s=st.ttft_s)
        self._finished.append(RequestResult(
            req.request_id, tuple(st.generated), outcome,
            ttft_s=st.ttft_s, finish_ts=now, reason=reason,
            trace_id=trace.trace_id, phase_ms=phases or None,
            generation=st.generation))
        self._prune_params()

    def _refresh_gauges(self, force=False):
        now = self._clock()
        if not force and now - self._last_gauge_ts < self._gauge_interval:
            return
        self._last_gauge_ts = now
        self._m_active.set(len(self._active))
        self._m_blocks.set(self.kv.ledger.blocks_in_use)
