"""Online autotuning of fusion_threshold and cycle_time.

The port of ``horovod_tpu/utils/autotune.py``, the same engines and
scoring. Parity with the reference ParameterManager (horovod/common/
parameter_manager.{h,cc}): Bayesian optimization (GP + expected improvement)
over fusion-threshold in [0, 64MB] and cycle-time in [1, 100] ms
(parameter_manager.cc:46-54), scoring bytes/us over windows of cycles
(Update/Tune, parameter_manager.cc:155-210), with an optional CSV log
(HOROVOD_AUTOTUNE_LOG, parameter_manager.cc:96-102). The GP/EI engine is the
native core (``csrc/host/autotune.cc``, the JAX package's source); when the
native core cannot be built (``_native.available()`` False) a pure-Python
random search takes its place, with a warning, as in the JAX package.

Where the reference's coordinator broadcasts tuned values over a custom MPI
struct (parameter_manager.cc:66-81), multi-process runs here have ONLY
rank 0 tune (per-process tuning from local timings would diverge the
fusion plans), and every process adopts the tuned values at the same agreed
point: under negotiation the tuned values ride every CycleResponse
(``params``); without a coordinator, EagerCoordinator's _sync_tuned_params
allgather, scheduled every HOROVOD_AUTOTUNE_SYNC_COLLECTIVES collectives.
"""

import ctypes
import random
import time

from .. import _native

THRESHOLD_BOUNDS = (0.0, 64.0 * 1024 * 1024)
CYCLE_BOUNDS_MS = (1.0, 100.0)
# An adopted cycle_time within this fraction of the TOP of its bound is
# treated as a boundary artifact, not a tuned value (see Autotuner.freeze):
# the passive scorer measures bytes/us between flushes, and once the cycle
# timer is longer than the workload's natural burst spacing every flush is
# demand-driven — the knob stops being observable, the score goes flat in
# cycle_ms, and the GP's argmax parks on the boundary (r5 adopted 99.22 ms
# exactly this way). A near-100 ms cycle is also an actively bad value to
# RUN AT: any tensor that misses a demand flush waits out the full timer.
# The LOW bound has no such failure mode (short cycles are merely eager),
# so only the top is clamped.
CYCLE_BOUNDARY_FRAC = 0.05
# samples per parameter point before scoring (reference: 5 samples of 10
# cycles each, parameter_manager.h)
CYCLES_PER_SAMPLE = 10
SAMPLES_PER_STEP = 5


class _NativeEngine:
    def __init__(self, seed):
        self._lib = _native.load()
        self._ptr = self._lib.hvd_autotune_create(
            THRESHOLD_BOUNDS[0], THRESHOLD_BOUNDS[1],
            CYCLE_BOUNDS_MS[0], CYCLE_BOUNDS_MS[1], seed)

    def record(self, threshold, cycle_ms, score):
        self._lib.hvd_autotune_record(self._ptr, threshold, cycle_ms, score)

    def suggest(self):
        thr, ct = ctypes.c_double(), ctypes.c_double()
        self._lib.hvd_autotune_suggest(self._ptr, ctypes.byref(thr),
                                       ctypes.byref(ct))
        return thr.value, ct.value

    def best(self):
        thr, ct, sc = (ctypes.c_double() for _ in range(3))
        if self._lib.hvd_autotune_best(self._ptr, ctypes.byref(thr),
                                       ctypes.byref(ct), ctypes.byref(sc)):
            return thr.value, ct.value, sc.value
        return None

    def __del__(self):
        try:
            self._lib.hvd_autotune_destroy(self._ptr)
        except Exception:  # noqa: BLE001 — interpreter shutdown
            pass


class _PythonEngine:
    """Random-search fallback (no GP)."""

    def __init__(self, seed):
        self._rng = random.Random(seed)
        self._samples = []

    def record(self, threshold, cycle_ms, score):
        self._samples.append((threshold, cycle_ms, score))

    def suggest(self):
        if len(self._samples) >= 4 and self._rng.random() < 0.5:
            # exploit: jitter around the best point
            thr, ct, _ = max(self._samples, key=lambda s: s[2])
            thr += self._rng.gauss(0, (THRESHOLD_BOUNDS[1] -
                                       THRESHOLD_BOUNDS[0]) * 0.1)
            ct += self._rng.gauss(0, (CYCLE_BOUNDS_MS[1] -
                                      CYCLE_BOUNDS_MS[0]) * 0.1)
            thr = min(max(thr, THRESHOLD_BOUNDS[0]), THRESHOLD_BOUNDS[1])
            ct = min(max(ct, CYCLE_BOUNDS_MS[0]), CYCLE_BOUNDS_MS[1])
            return thr, ct
        return (self._rng.uniform(*THRESHOLD_BOUNDS),
                self._rng.uniform(*CYCLE_BOUNDS_MS))

    def best(self):
        if not self._samples:
            return None
        return max(self._samples, key=lambda s: s[2])


class Autotuner:
    """Drives the tune loop from per-cycle (bytes, duration) measurements.

    Call ``record_cycle(total_bytes, duration_s)`` after each flush cycle;
    the tuner aggregates CYCLES_PER_SAMPLE cycles into one sample,
    SAMPLES_PER_STEP samples into one scored step (median-of-samples like
    the reference), then records the score and moves the knobs to the next
    suggestion. Current knob values are ``threshold`` / ``cycle_time_ms``.
    """

    def __init__(self, config, log_path=None, seed=0):
        self.threshold = float(config.fusion_threshold)
        self.cycle_time_ms = float(config.cycle_time_ms)
        # freeze() falls back to this when the tuned cycle is a boundary
        # artifact (CYCLE_BOUNDARY_FRAC above)
        self._default_cycle_ms = float(config.cycle_time_ms)
        self.cycle_boundary_clamped = False
        self.frozen = False
        if _native.available():
            self._engine = _NativeEngine(seed)
        else:
            # say so out loud: the fallback explores by random search,
            # not GP+EI — users who built without the native core should
            # know their tuning quality silently differs
            from ..common import hvd_logging as log
            log.warning(
                "HOROVOD_AUTOTUNE is on but the native core "
                "(libhvd_core.so) does not build: falling back to "
                "random-search exploration instead of Bayesian GP+EI.")
            self._engine = _PythonEngine(seed)
        self._cycle_bytes = 0
        self._cycle_time = 0.0
        self._cycles = 0
        self._scores = []
        self._log = open(log_path, "w") if log_path else None
        if self._log:
            self._log.write("threshold_bytes,cycle_time_ms,score_bytes_per_us\n")

    def record_cycle(self, total_bytes, duration_s):
        if self.frozen:
            return False
        self._cycle_bytes += int(total_bytes)
        self._cycle_time += float(duration_s)
        self._cycles += 1
        if self._cycles < CYCLES_PER_SAMPLE:
            return False
        score = self._cycle_bytes / max(1e-9, self._cycle_time) / 1e6  # B/us
        self._scores.append(score)
        self._cycle_bytes = 0
        self._cycle_time = 0.0
        self._cycles = 0
        if len(self._scores) < SAMPLES_PER_STEP:
            return False
        self._scores.sort()
        median = self._scores[len(self._scores) // 2]
        self._scores = []
        self._engine.record(self.threshold, self.cycle_time_ms, median)
        if self._log:
            self._log.write(f"{self.threshold:.0f},{self.cycle_time_ms:.2f},"
                            f"{median:.4f}\n")
            self._log.flush()
        self.threshold, self.cycle_time_ms = self._engine.suggest()
        return True

    def best(self):
        return self._engine.best()

    def freeze(self):
        """Stop tuning and adopt the best scored point (the reference
        ParameterManager's end state once Tune() stops improving:
        parameter_manager.cc:155-210 sets active_=false and runs at the
        best values). After this, record_cycle becomes a no-op — the
        coordinator stops paying the per-cycle device sync that exact
        scoring requires. Returns (threshold, cycle_ms, score) or None
        if nothing was ever scored.

        Boundary guard: a best cycle_time within CYCLE_BOUNDARY_FRAC of
        the top bound is NOT adopted — the threshold is kept but the
        cycle falls back to the pre-tune default, and
        ``cycle_boundary_clamped`` is set so callers can
        report the clamp instead of silently running a flat-score
        argmax."""
        self.frozen = True
        b = self._engine.best()
        if b is not None:
            cycle = b[1]
            span = CYCLE_BOUNDS_MS[1] - CYCLE_BOUNDS_MS[0]
            if cycle >= CYCLE_BOUNDS_MS[1] - CYCLE_BOUNDARY_FRAC * span:
                cycle = self._default_cycle_ms
                self.cycle_boundary_clamped = True
            self.threshold, self.cycle_time_ms = b[0], cycle
        return b

    def close(self):
        if self._log:
            self._log.close()
            self._log = None
