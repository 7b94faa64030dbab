// horovod_tpu_torch native host core: the port's copy of
// horovod_tpu/_native/src/hvd_core.h.
//
// Re-implementation of the reference's C++ runtime services
// (horovod/common/): the pieces that remain host-side work when the data
// plane is the process group's collectives. Each component cites the
// reference design it replaces:
//
//   fusion planner <- FuseResponses look-ahead bucketing
//                     (horovod/common/operations.cc:450-573)
//   timeline       <- horovod/common/timeline.{h,cc} (writer thread + queue)
//   autotuner      <- ParameterManager + BayesianOptimization +
//                     GaussianProcessRegressor
//                     (horovod/common/parameter_manager.{h,cc},
//                      horovod/common/optim/*)
//
// The JAX package's core also carries logging, an LRU cache, a tensor
// table and a byte hash; the port's eager core keeps its plan cache,
// tensor table and stall scan in Python (ops/eager.py), as the JAX eager
// core does, so those are not copied.
//
// The API is a flat extern-C surface consumed from Python via ctypes
// (the reference exposed extern-C the same way for horovod_init etc.,
// operations.cc:1595-1650). All functions are thread-safe.

#ifndef HVD_CORE_H_
#define HVD_CORE_H_

#include <cstdint>

#if defined(_WIN32)
#define HVD_EXPORT __declspec(dllexport)
#else
#define HVD_EXPORT __attribute__((visibility("default")))
#endif

extern "C" {

// ---- fusion planner -------------------------------------------------------
// Look-ahead bucketing: same-dtype tensors packed in submission order,
// first-fit across all open buckets of <= threshold bytes — a tensor that
// does not fit opens a new bucket without closing the old, so later small
// tensors still join it (FuseResponses semantics); oversized tensors ride
// alone. Writes bucket id per tensor into bucket_out; returns the count.
HVD_EXPORT int64_t hvd_plan_buckets(int64_t n, const int64_t* nbytes,
                                    const int32_t* dtype_ids,
                                    int64_t threshold, int32_t* bucket_out);

// ---- timeline -------------------------------------------------------------
// base_ns: the monotonic base (ns of CLOCK_MONOTONIC) that ts 0 stands
// for; epoch_us_at_ts0: the wall clock at that base, written as the
// clock_sync event. Both are the shared clock's (utils/metrics.py).
HVD_EXPORT void* hvd_timeline_create(const char* path, int mark_cycles,
                                     int64_t base_ns,
                                     int64_t epoch_us_at_ts0);
HVD_EXPORT void hvd_timeline_destroy(void* timeline);
// phase: 0 = begin span, 1 = end span, 2 = instant event
HVD_EXPORT void hvd_timeline_event(void* timeline, const char* tensor,
                                   const char* activity, int phase);
HVD_EXPORT void hvd_timeline_cycle(void* timeline);
HVD_EXPORT int64_t hvd_timeline_pending(void* timeline);

// ---- autotuner (Gaussian process + expected improvement) -----------------
// Tunes (fusion_threshold_bytes, cycle_time_ms) to maximize a throughput
// score (bytes/us like the reference). Bounds mirror the reference's
// 0..64MB / 1..100ms (parameter_manager.cc:46-54).
HVD_EXPORT void* hvd_autotune_create(double thr_lo, double thr_hi,
                                     double ct_lo, double ct_hi,
                                     uint64_t seed);
HVD_EXPORT void hvd_autotune_destroy(void* tuner);
HVD_EXPORT void hvd_autotune_record(void* tuner, double threshold,
                                    double cycle_ms, double score);
HVD_EXPORT void hvd_autotune_suggest(void* tuner, double* threshold_out,
                                     double* cycle_ms_out);
HVD_EXPORT int64_t hvd_autotune_num_samples(void* tuner);
// Best observed (threshold, cycle_ms, score); returns 0 if no samples.
HVD_EXPORT int hvd_autotune_best(void* tuner, double* threshold_out,
                                 double* cycle_ms_out, double* score_out);

// ---- misc -----------------------------------------------------------------
HVD_EXPORT const char* hvd_core_version();

}  // extern "C"

#endif  // HVD_CORE_H_
