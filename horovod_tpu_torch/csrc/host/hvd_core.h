// horovod_tpu_torch native host core: the port's copy of
// horovod_tpu/_native/src/hvd_core.h without the autotuner (its source,
// autotune.cc, is not ported yet).
//
// Re-implementation of the reference's C++ runtime services
// (horovod/common/): the pieces that remain host-side work when the data
// plane is the process group's collectives. Each component cites the
// reference design it replaces:
//
//   fusion planner <- FuseResponses look-ahead bucketing
//                     (horovod/common/operations.cc:450-573)
//   timeline       <- horovod/common/timeline.{h,cc} (writer thread + queue)
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
HVD_EXPORT void* hvd_timeline_create(const char* path, int mark_cycles);
HVD_EXPORT void hvd_timeline_destroy(void* timeline);
// phase: 0 = begin span, 1 = end span, 2 = instant event
HVD_EXPORT void hvd_timeline_event(void* timeline, const char* tensor,
                                   const char* activity, int phase);
HVD_EXPORT void hvd_timeline_cycle(void* timeline);
HVD_EXPORT int64_t hvd_timeline_pending(void* timeline);

// ---- misc -----------------------------------------------------------------
HVD_EXPORT const char* hvd_core_version();

}  // extern "C"

#endif  // HVD_CORE_H_
