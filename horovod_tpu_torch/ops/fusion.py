"""Tensor-fusion planning: batch many small tensors into few collectives.

The port of ``horovod_tpu/ops/fusion.py`` (the reference's
FuseResponses, horovod/common/operations.cc:450-573): same-dtype tensors
are packed, first fit in submission order, into buckets of at most
``fusion_threshold`` bytes; each bucket is one flat buffer and one
collective. A tensor at or above the threshold goes alone, and a
threshold of 0 or less sends every tensor alone
(``HOROVOD_FUSION_THRESHOLD=0``).

The planning runs in the native host core (``hvd_plan_buckets``, built
at first use by ``_native``); ``_python_plan`` is its plain version, the
same algorithm, which the tests hold it equal to. ``plan_buckets`` takes
tensors or anything with ``shape`` and ``dtype`` (the negotiation's
``EntryMeta``, whose dtype is a name such as "float32").
"""

import dataclasses

import torch

# bytes per element of the dtype names the control plane carries (numpy's
# names, as the JAX package's metas carry them)
_ITEMSIZE = {"float64": 8, "float32": 4, "float16": 2, "bfloat16": 2,
             "int64": 8, "int32": 4, "int16": 2, "int8": 1, "uint8": 1,
             "bool": 1, "complex64": 8, "complex128": 16,
             "float8_e4m3fn": 1, "float8_e5m2": 1}


@dataclasses.dataclass
class Bucket:
    """One fused collective: indices into the original tensor list."""
    indices: list
    dtype: object
    nbytes: int


def dtype_name(dtype):
    """The numpy-style name of a torch dtype ("float32", "bfloat16"), or
    ``str(dtype)`` of anything else (a name already)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rpartition(".")[2]
    return str(dtype)


def _nbytes(leaf):
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    n = 1
    for d in leaf.shape:
        n *= int(d)
    name = dtype_name(leaf.dtype)
    if name not in _ITEMSIZE:
        raise ValueError(f"fusion: no element size for dtype {name!r}")
    return n * _ITEMSIZE[name]


def plan_buckets(tensors, fusion_threshold):
    """Greedy look-ahead bucketing in submission order: a tensor that does
    not fit an open bucket of its dtype opens a new one, and later small
    tensors may still join the earlier buckets. Returns a list of
    ``Bucket`` in the order each was opened."""
    threshold = int(fusion_threshold or 0)
    sizes = [_nbytes(t) for t in tensors]
    dtypes = [t.dtype for t in tensors]
    buckets, by_id = [], {}
    for i, bid in enumerate(_native_plan(sizes, dtypes, threshold)):
        b = by_id.get(bid)
        if b is None:
            b = by_id[bid] = Bucket([], dtypes[i], 0)
            buckets.append(b)
        b.indices.append(i)
        b.nbytes += sizes[i]
    return buckets


def _native_plan(sizes, dtypes, threshold):
    """The bucket id of each tensor from the native planner."""
    import ctypes
    from .. import _native
    lib = _native.load()
    n = len(sizes)
    if not n:
        return []
    dtype_ids = {}
    ids = [dtype_ids.setdefault(dtype_name(d), len(dtype_ids))
           for d in dtypes]
    out = (ctypes.c_int32 * n)()
    lib.hvd_plan_buckets(n, (ctypes.c_int64 * n)(*sizes),
                         (ctypes.c_int32 * n)(*ids), int(threshold), out)
    return list(out)


def _python_plan(sizes, dtypes, threshold):
    """The plain version of ``_native_plan``: first fit across all open
    same-dtype buckets, the reference's look-ahead (FuseResponses,
    operations.cc:478-533)."""
    if threshold <= 0:
        return list(range(len(sizes)))
    assignment = []
    open_buckets = {}  # dtype -> [(bucket id, bytes)...] creation order
    next_id = 0
    for nb, dt in zip(sizes, dtypes):
        buckets = open_buckets.setdefault(dtype_name(dt), [])
        for j, (bid, used) in enumerate(buckets):
            if used + nb <= threshold:
                assignment.append(bid)
                buckets[j] = (bid, used + nb)
                break
        else:
            assignment.append(next_id)
            if nb < threshold:
                # full and oversized buckets never take another tensor
                buckets.append((next_id, nb))
            next_id += 1
    return assignment


def bucket_stats(flat, sizes):
    """Per-slice health stats of an already-materialized fused buffer, in
    one pass over the whole bucket: an ``[n, 5]`` fp32 matrix on the
    buffer's device whose rows follow ``sizes`` (the element count of
    each slice in buffer order) and whose columns are the JAX package's
    ``S_*`` layout (``utils/numerics.py``): L2 norm and largest |x| of
    the finite values, the count of non-finite values, the fraction of
    exact zeros, and the sum of the finite values."""
    f = flat.reshape(-1).float()
    n = len(sizes)
    counts = torch.tensor([float(s) for s in sizes], device=f.device)
    ids = torch.repeat_interleave(
        torch.arange(n, device=f.device),
        torch.tensor([int(s) for s in sizes], device=f.device))
    finite = torch.isfinite(f)
    safe = torch.where(finite, f, torch.zeros_like(f))

    def seg_sum(v):
        return torch.zeros(n, device=f.device).index_add_(0, ids, v)

    max_abs = torch.zeros(n, device=f.device).scatter_reduce_(
        0, ids, safe.abs(), "amax", include_self=True)
    return torch.stack([
        torch.sqrt(seg_sum(safe * safe).clamp_min(0.0)),
        max_abs,
        counts - seg_sum(finite.float()),
        seg_sum((f == 0.0).float()) / counts.clamp_min(1.0),
        seg_sum(safe),
    ], dim=1)


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


def fused_map(fn, tensors, fusion_threshold):
    """Apply ``fn`` (flat buffer -> flat buffer of the same length, e.g. a
    sum across workers) over fused buckets of ``tensors``; returns the
    transformed tensors in order, one ``fn`` call per bucket."""
    out = [None] * len(tensors)
    for b in plan_buckets(tensors, fusion_threshold):
        flat = fn(fuse(tensors, b))
        for idx, piece in zip(b.indices, unfuse(flat, tensors, b)):
            out[idx] = piece
    return out
