"""Sequence/context parallelism: ring attention and Ulysses all-to-all,
port of ``horovod_tpu/parallel/ring.py``.

These shard the *sequence* dimension across the ranks of a ring (the sp
axis of a mesh), so attention over sequences far larger than one card's
memory runs with O(seq/sp) memory:

* ``ring_attention`` — blockwise attention with an online softmax merge,
  passing K/V blocks around the ring; causal in *global* positions.
* ``ring_flash_attention`` — the same ring with the port's flash kernels
  as the per-pair engine, forward and backward (a
  ``torch.autograd.Function``): the forward merges each pair's
  ``(out, lse)``; the backward is a second ring pass that runs the flash
  backward per pair against the MERGED lse, with dK/dV riding the ring
  home.
* ``ulysses_attention`` — all-to-all sequence→head reshard, full
  attention over the whole sequence on this rank's heads, head→sequence
  back; needs num_heads % sp == 0.

Where the JAX package names a mesh axis bound by ``shard_map``, the port
takes a *ring*, the port's group object: an object with ``rank``,
``size`` and the exchanges ``shift`` (send to the next rank, receive from
the previous one), ``all_to_all``, ``all_gather``, ``reduce_scatter`` and
``all_reduce``. ``GroupRing`` wraps a process group (an axis of a mesh:
production); ``ThreadRing`` runs the ranks as threads of one process,
which is how ranks share one card (NCCL refuses two ranks on one
device). The tensor-parallel layers (``parallel.tensor_parallel``), the
ring collectives and the hierarchical allreduce take the same objects.
Every function below also takes an axis name (default 'sp', of
``parallel.mesh.global_mesh()``) or a process group.
"""

import threading

import torch
import torch.distributed as dist

NEG_INF = -1e30

# A future pair's lse in the ring backward: p = exp(s - 1e30) underflows
# to exactly 0 inside the kernel, whatever the pair's logits.
FUTURE_LSE = 1e30


# ---------------------------------------------------------------------------
# rings


class GroupRing:
    """The ring of a process group's ranks, in group-rank order."""

    def __init__(self, group=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)

    def _peer(self, r):
        r %= self.size
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def shift(self, *tensors, reverse=False):
        """Each tensor sent to the next rank (the previous one when
        ``reverse``); returns the tensors received, in order."""
        if self.size == 1:
            return list(tensors)
        step = -1 if reverse else 1
        outs = [torch.empty(t.shape, dtype=t.dtype, device=t.device)
                for t in tensors]
        ops = []
        for t, o in zip(tensors, outs):
            ops.append(dist.P2POp(dist.isend, t.contiguous(),
                                  self._peer(self.rank + step), self.group))
            ops.append(dist.P2POp(dist.irecv, o,
                                  self._peer(self.rank - step), self.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return outs

    def all_to_all(self, t, split_axis, concat_axis):
        from .. import mpi_ops
        if self.size == 1:
            return t
        return mpi_ops.alltoall(t, self.group, split_axis, concat_axis)

    def all_gather(self, t, dim):
        if self.size == 1:
            return t
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((self.size * src.shape[0],) + src.shape[1:])
        from ..mpi_ops import _all_gather_into
        _all_gather_into(out, src, self.group)
        return out.movedim(0, dim)

    def reduce_scatter(self, t, dim):
        if self.size == 1:
            return t
        src = t.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // self.size,) + src.shape[1:])
        from ..mpi_ops import _reduce_scatter_into
        _reduce_scatter_into(out, src, self.group)
        return out.movedim(0, dim)

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """The elementwise sum (or ``op``) of every rank's ``t``, a new
        tensor: the process group's own all-reduce."""
        out = t.contiguous().clone()
        dist.all_reduce(out, op=op, group=self.group)
        return out


class ThreadRing:
    """``size`` ranks as threads of one process: ``rank(r)`` is rank r's
    ring, which that rank's thread uses. Each exchange posts this rank's
    tensors, meets the other ranks at a barrier and reads theirs; tensors
    on one card stay in the stream order of their one device, so no copy
    is needed. A thread's exchanges must run on that thread (not from
    autograd's device threads): drive the ring functions' forward and
    backward halves directly (``ring_flash_fwd``, ``ring_flash_bwd``)."""

    def __init__(self, size):
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots = [None] * size

    def rank(self, r):
        return _ThreadRank(self, r)


class _ThreadRank:
    """One thread rank's side of a ``ThreadRing``. A collective computes
    its result from the others' tensors before any rank leaves it, so a
    rank may overwrite what it contributed as soon as the call returns;
    ``shift`` alone hands over references, which the sender must not
    write in place afterwards."""

    def __init__(self, world, rank):
        self.world, self.rank, self.size = world, rank, world.size

    def _exchange(self, value, combine=list):
        """``combine`` of every rank's ``value`` (rank order), taken while
        every rank is inside the exchange."""
        w = self.world
        w._slots[self.rank] = value
        w._barrier.wait()
        out = combine(list(w._slots))
        w._barrier.wait()
        return out

    def shift(self, *tensors, reverse=False):
        src = (self.rank + (1 if reverse else -1)) % self.size
        return self._exchange(tensors, lambda got: list(got[src]))

    def all_to_all(self, t, split_axis, concat_axis):
        return self._exchange(
            t.chunk(self.size, dim=split_axis),
            lambda got: torch.cat([got[j][self.rank]
                                   for j in range(self.size)],
                                  dim=concat_axis))

    def all_gather(self, t, dim):
        return self._exchange(t, lambda got: torch.cat(got, dim=dim))

    def reduce_scatter(self, t, dim):
        def combine(got):
            out = None
            for x in got:   # rank order: the same sum everywhere
                part = x.chunk(self.size, dim=dim)[self.rank]
                out = part.clone() if out is None else out + part
            return out
        return self._exchange(t, combine)

    def all_reduce(self, t, op=dist.ReduceOp.SUM):
        """The elementwise sum (max for ``ReduceOp.MAX``) of every rank's
        ``t``, taken in rank order, so every rank holds the same values."""
        def combine(got):
            out = got[0].clone()
            for x in got[1:]:
                out = torch.maximum(out, x) if op == dist.ReduceOp.MAX \
                    else out + x
            return out
        return self._exchange(t, combine)


def as_ring(axis_name="sp"):
    """The ring an ``axis_name`` stands for: a ring as it is, a process
    group's ring, or the ring of an axis of the global mesh (a name)."""
    if hasattr(axis_name, "shift"):
        return axis_name
    from ..mpi_ops import process_group
    return GroupRing(process_group(axis_name))


# differentiable exchanges (the transposes JAX derives for ppermute,
# all_to_all and all_gather)


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, ring, reverse, *tensors):
        ctx.ring, ctx.reverse = ring, reverse
        return tuple(ring.shift(*tensors, reverse=reverse))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *ctx.ring.shift(*grads, reverse=not ctx.reverse))


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ring, split_axis, concat_axis):
        ctx.args = ring, split_axis, concat_axis
        return ring.all_to_all(t, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        ring, split_axis, concat_axis = ctx.args
        return ring.all_to_all(g, concat_axis, split_axis), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, ring, dim):
        ctx.args = ring, dim
        return ring.all_gather(t, dim)

    @staticmethod
    def backward(ctx, g):
        ring, dim = ctx.args
        return ring.reduce_scatter(g, dim), None, None


def shift(ring, *tensors):
    """Differentiable ``ring.shift``: gradients travel the other way."""
    return _Shift.apply(ring, False, *tensors)


def all_to_all(t, ring, split_axis, concat_axis):
    return _AllToAll.apply(t, ring, split_axis, concat_axis)


def gather_sequence(t, ring, dim=1):
    """The whole sequence from every rank's shard (rank order), with the
    gradient reduced and scattered back to the shards."""
    return _AllGather.apply(t, ring, dim)


# ---------------------------------------------------------------------------
# attention


def _block_attn(q, k, v, mask, scale):
    """One q-block x k-block attention with fp32 logits.

    q: [b, sq, h, d]; k/v: [b, sk, h, d]; mask: [sq, sk] bool or None.
    Returns (scores_max [b,h,sq], exp_sums [b,h,sq], out [b,sq,h,d] fp32).
    """
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1)
    p = torch.exp(logits - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    return m, l, o


def _bhs_to_bshx(t):
    """[b, h, s] -> [b, s, h, 1], to scale a [b, s, h, d] tensor."""
    return t.transpose(1, 2)[..., None]


def ring_attention(q, k, v, axis_name="sp", causal=True):
    """Blockwise ring attention over the sequence-parallel ring.

    q, k, v: this rank's [batch, seq_local, heads, head_dim]; the global
    sequence is the concatenation of shards in rank order. ``causal``
    masks in *global* positions. Returns this rank's attention output
    [batch, seq_local, heads, head_dim] with exact softmax, accumulated in
    fp32. Differentiable: the K/V shifts send their gradients back.
    """
    ring = as_ring(axis_name)
    w, me = ring.size, ring.rank
    b, s_loc, h, d = q.shape
    scale = d ** -0.5
    pos = torch.arange(s_loc, device=q.device)
    q_pos = me * s_loc + pos
    o = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    for i in range(w):
        # the block held now arrived from rank (me - i) mod W
        src = (me - i) % w
        mask = (q_pos[:, None] >= (src * s_loc + pos)[None, :]
                if causal else None)
        bm, bl, bo = _block_attn(q, k_cur, v_cur, mask, scale)
        m_new = torch.maximum(m, bm)
        alpha, beta = torch.exp(m - m_new), torch.exp(bm - m_new)
        l = l * alpha + bl * beta
        o = o * _bhs_to_bshx(alpha) + bo * _bhs_to_bshx(beta)
        m = m_new
        if i < w - 1:
            k_cur, v_cur = shift(ring, k_cur, v_cur)
    out = o / _bhs_to_bshx(torch.clamp(l, min=1e-30))
    return out.to(q.dtype)


def ulysses_attention(q, k, v, axis_name="sp", causal=True, attn_fn=None):
    """All-to-all sequence parallelism (Ulysses).

    Reshards [b, s/W, H, d] → [b, s, H/W, d] with one all-to-all, runs
    full attention (or ``attn_fn``) over the complete sequence on this
    rank's head slice, and reshards back.
    """
    ring = as_ring(axis_name)
    h = q.shape[2]
    if h % ring.size:
        raise ValueError(
            f"num_heads {h} must divide the sp axis size {ring.size}")
    qg, kg, vg = (all_to_all(t, ring, 2, 1) for t in (q, k, v))
    if attn_fn is None:
        out = full_attention(qg, kg, vg, causal=causal)
    else:
        out = attn_fn(qg, kg, vg)
    return all_to_all(out.to(q.dtype), ring, 1, 2)


def _fit_block(block, s):
    from ..ops.flash_attention import fit_block_ref
    b = fit_block_ref(block, s)
    if s % b:
        raise ValueError(
            f"ring_flash_attention: local sequence {s} not divisible by "
            f"any block size <= {block}")
    return b


def ring_flash_fwd(q, k, v, ring, causal, scale, blocks):
    """The ring's forward pass on this rank: the flash forward per pair
    (causal only for the diagonal pair i = 0, non-causal after), each
    pair's ``(out, lse)`` merged into the running ones. Returns (out in
    q's dtype, merged lse fp32 [b, h, s_loc])."""
    from ..ops import flash_attention as fa
    w, me = ring.size, ring.rank
    b, s_loc, h, d = q.shape
    out_run = torch.zeros((b, s_loc, h, d), dtype=torch.float32,
                          device=q.device)
    lse_run = torch.full((b, h, s_loc), NEG_INF, dtype=torch.float32,
                         device=q.device)
    k_cur, v_cur = k, v
    for i in range(w):
        o_i, lse_i = fa.flash_fwd(q, k_cur, v_cur, causal and i == 0,
                                  *blocks, scale=scale)
        lse_i = lse_i.reshape(b, h, s_loc)
        if causal and i > 0 and me < i:
            # the block from rank (me - i) % W is in the future: it merges
            # with weight exp(-1e30 - lse) = 0
            lse_i = torch.full_like(lse_i, NEG_INF)
        lse_new = torch.logaddexp(lse_run, lse_i)
        out_run = (out_run * _bhs_to_bshx(torch.exp(lse_run - lse_new)) +
                   o_i.float() * _bhs_to_bshx(torch.exp(lse_i - lse_new)))
        lse_run = lse_new
        if i < w - 1:
            k_cur, v_cur = ring.shift(k_cur, v_cur)
    return out_run.to(q.dtype), lse_run


def ring_flash_bwd(q, k, v, out, lse, g, ring, causal, scale, blocks):
    """The ring's backward pass on this rank: per pair, the flash backward
    against the MERGED lse (p = exp(s - lse) is the global softmax
    restricted to the pair) and the merged out (delta = rowsum(g∘out));
    a future pair's rows get lse +1e30, so p underflows to exactly 0
    inside the kernels. dK/dV partials ride the ring with their block and
    arrive home after W shifts. Returns (dq, dk, dv) in the inputs'
    dtypes."""
    from ..ops import flash_attention as fa
    w, me = ring.size, ring.rank
    b, s_loc, h, d = q.shape
    dq = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros_like(dq)
    dv_cur = torch.zeros_like(dq)
    lse_flat = lse.reshape(b * h, s_loc).contiguous()
    k_cur, v_cur = k, v
    for i in range(w):
        lse_i = lse_flat
        if causal and i > 0 and me < i:
            lse_i = torch.full_like(lse_flat, FUTURE_LSE)
        dq_i, dk_i, dv_i = fa.flash_bwd(q, k_cur, v_cur, out, lse_i, g,
                                        causal and i == 0, *blocks,
                                        scale=scale)
        dq = dq + dq_i.float()
        dk_cur = dk_cur + dk_i.float()
        dv_cur = dv_cur + dv_i.float()
        if i < w - 1:
            k_cur, v_cur, dk_cur, dv_cur = ring.shift(k_cur, v_cur, dk_cur,
                                                      dv_cur)
        else:
            dk_cur, dv_cur = ring.shift(dk_cur, dv_cur)
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


class _RingFlash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, ring, causal, scale, blocks):
        out, lse = ring_flash_fwd(q, k, v, ring, causal, scale, blocks)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = ring, causal, scale, blocks
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        grads = ring_flash_bwd(q, k, v, out, lse, g.contiguous(), *ctx.args)
        return (*grads, None, None, None, None)


def ring_flash_attention(q, k, v, axis_name="sp", causal=True, block_q=512,
                         block_k=512):
    """Ring attention with the flash kernels as the per-pair engine,
    forward AND backward.

    Same contract as ``ring_attention`` (this rank's [b, s_loc, h, d],
    exact softmax in global positions), but each ring step runs the fused
    kernel instead of materializing the [s_loc, s_loc] logits. The
    softmax scale is the true head dim's, whatever the kernels pad d to.
    ``block_q``/``block_k`` are fitted to the local sequence as the
    reference fits them (they set the plain walks' tiles on the CPU; the
    kernels walk their own). Comm volume: one K/V block per step forward;
    the backward also rotates the dK/dV partials with their blocks.
    """
    ring = as_ring(axis_name)
    s_loc, d = q.shape[1], q.shape[3]
    blocks = (_fit_block(block_q, s_loc), _fit_block(block_k, s_loc))
    return _RingFlash.apply(q, k, v, ring, causal, d ** -0.5, blocks)


def full_attention(q, k, v, causal=True):
    """Exact attention on ``[b, s, h, d]`` operands: fp32 logits from the
    input-dtype values, fp32 softmax, P in V's dtype, output in q's. The
    single-device reference (for tests and the sp=1 path)."""
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        s_q, s_k = q.shape[1], k.shape[1]
        mask = torch.ones((s_q, s_k), dtype=torch.bool,
                          device=q.device).tril()
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    return out.to(q.dtype)
