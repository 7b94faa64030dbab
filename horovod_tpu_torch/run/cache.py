"""Disk-backed memo cache for launcher checks: the port's copy of
``horovod_tpu/run/cache.py`` (reference horovod/run/util/cache.py:
~/.horovod, 60-minute TTL for ssh/NIC results). Only remote hosts'
ssh checks use it.
"""

import os
import pickle
import threading
import time

DEFAULT_CACHE_DIR = os.path.join(os.path.expanduser("~"), ".horovod_tpu_torch")
DEFAULT_TTL_S = 60 * 60


class Cache:
    def __init__(self, cache_dir=DEFAULT_CACHE_DIR, ttl_s=DEFAULT_TTL_S,
                 parameters_hash=""):
        os.makedirs(cache_dir, exist_ok=True)
        self._path = os.path.join(cache_dir,
                                  f"cache_{parameters_hash}.pkl")
        self._ttl = ttl_s
        self._lock = threading.Lock()
        self._store = {}  # guarded_by: _lock
        try:
            with open(self._path, "rb") as f:
                self._store = pickle.load(f)
        except Exception:
            self._store = {}

    def get(self, key):
        with self._lock:
            hit = self._store.get(key)
            if hit is None:
                return None
            value, ts = hit
            if time.time() - ts > self._ttl:
                del self._store[key]
                return None
            return value

    def put(self, key, value):
        with self._lock:
            self._store[key] = (value, time.time())
            tmp = self._path + ".tmp"
            try:
                with open(tmp, "wb") as f:
                    pickle.dump(self._store, f)
                os.replace(tmp, self._path)
            except Exception:
                pass
