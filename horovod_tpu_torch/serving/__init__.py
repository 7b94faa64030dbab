"""Serving plane of the port: continuous-batching inference for the LM.

  * queue.py     — admission control: bounded queue, deadline tags
  * kv_cache.py  — slot-based KV cache: dense device tensors, host-side
                   block-granular accounting
  * scheduler.py — slot assignment: continuous vs drain (static batch)
  * sampling.py  — greedy / temperature sampling, per row
  * decode.py    — prefill + single-token decode forwards
  * engine.py    — the step loop tying it together
"""

from .engine import ServeEngine
from .kv_cache import BlockLedger, KVCache
from .queue import AdmissionQueue, Request, RequestResult
from .scheduler import SlotScheduler

__all__ = ["AdmissionQueue", "BlockLedger", "KVCache", "Request",
           "RequestResult", "ServeEngine", "SlotScheduler"]
