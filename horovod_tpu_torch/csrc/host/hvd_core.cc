// Core services: the fusion planner and the version string.
// See hvd_core.h for the reference-design citations.

#include "hvd_core.h"

#include <unordered_map>
#include <vector>

// ---------------------------------------------------------------------------
// fusion planner — look-ahead bucketing in submission order: first-fit
// across all open same-dtype buckets, non-fitting tensors open new ones
// without closing the old (FuseResponses semantics).
// ---------------------------------------------------------------------------

int64_t hvd_plan_buckets(int64_t n, const int64_t* nbytes,
                         const int32_t* dtype_ids, int64_t threshold,
                         int32_t* bucket_out) {
  if (n <= 0) return 0;
  if (threshold <= 0) {
    for (int64_t i = 0; i < n; ++i) bucket_out[i] = static_cast<int32_t>(i);
    return n;
  }
  struct Open {
    int32_t id;
    int64_t bytes;
  };
  // First-fit across ALL open same-dtype buckets: the reference's
  // look-ahead skips a non-fitting entry but lets LATER entries join the
  // same response (FuseResponses, operations.cc:478-533).
  std::unordered_map<int32_t, std::vector<Open>> open;  // dtype -> buckets
  int32_t next_id = 0;
  for (int64_t i = 0; i < n; ++i) {
    auto& buckets = open[dtype_ids[i]];
    bool placed = false;
    for (auto& b : buckets) {
      if (b.bytes + nbytes[i] <= threshold) {
        bucket_out[i] = b.id;
        b.bytes += nbytes[i];
        placed = true;
        break;
      }
    }
    if (!placed) {
      bucket_out[i] = next_id;
      // full/oversized buckets can never accept another tensor; keeping
      // them open would make planning quadratic in their count
      if (nbytes[i] < threshold) {
        buckets.push_back(Open{next_id, nbytes[i]});
      }
      ++next_id;
    }
  }
  return next_id;
}

// ---------------------------------------------------------------------------
// misc
// ---------------------------------------------------------------------------

const char* hvd_core_version() { return "0.1.0"; }

