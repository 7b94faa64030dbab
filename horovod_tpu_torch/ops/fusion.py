"""Tensor-fusion planning: batch many small tensors into few collectives.

The port of ``horovod_tpu/ops/fusion.py``'s Python plan (the reference's
FuseResponses, horovod/common/operations.cc:450-573): same-dtype tensors
are packed, first fit in submission order, into buckets of at most
``fusion_threshold`` bytes; each bucket is one flat buffer and one
collective. A tensor at or above the threshold goes alone, and a
threshold of 0 or less sends every tensor alone
(``HOROVOD_FUSION_THRESHOLD=0``).
"""

import dataclasses

import torch


@dataclasses.dataclass
class Bucket:
    """One fused collective: indices into the original tensor list."""
    indices: list
    dtype: torch.dtype
    nbytes: int


def plan_buckets(tensors, fusion_threshold):
    """Greedy look-ahead bucketing in submission order: a tensor that does
    not fit an open bucket of its dtype opens a new one, and later small
    tensors may still join the earlier buckets. Returns a list of
    ``Bucket`` in the order each was opened."""
    threshold = int(fusion_threshold or 0)
    buckets = []
    open_by_dtype = {}   # dtype -> open buckets, in creation order
    for i, t in enumerate(tensors):
        nbytes = t.numel() * t.element_size()
        candidates = open_by_dtype.setdefault(t.dtype, [])
        for b in candidates:
            if b.nbytes + nbytes <= threshold:
                b.indices.append(i)
                b.nbytes += nbytes
                break
        else:
            b = Bucket([i], t.dtype, nbytes)
            buckets.append(b)
            if nbytes < threshold:
                # full and oversized buckets never take another tensor
                candidates.append(b)
    return buckets


def fuse(tensors, bucket):
    """The bucket's tensors flattened into one new buffer."""
    return torch.cat([tensors[i].reshape(-1) for i in bucket.indices])


def unfuse(flat, tensors, bucket):
    """Split a fused buffer back into views shaped like the bucket's
    tensors."""
    out, offset = [], 0
    for i in bucket.indices:
        n = tensors[i].numel()
        out.append(flat[offset:offset + n].view(tensors[i].shape))
        offset += n
    return out
