"""Plain PyTorch versions of the flash-attention kernels.

Forward: one function per variant, each walking the same tiles in the
same order as its CUDA kernels (``csrc/flash_fwd_sm90.cu`` in bf16,
``csrc/flash_fwd.cu`` in fp32) and its TPU original
(``horovod_tpu/ops/flash_attention.py``): the causal k loop stops at the
diagonal tile; ``lazy`` walks k tiles diagonal-first and rescales only
when ``any(m_tile > m)`` over the q tile; ``twopass`` takes the row max
in a first pass and accumulates against it in a second. The arithmetic is
the kernels': logits in fp32 from the input-dtype operands, the exp2
domain with log2(e) in the scale, the finite -1e30 mask sentinel, P
rounded to V's dtype before P@V, and lse = (m + log2 l)·ln2 with l
clipped at 1e-30.

Backward: ``flash_bwd_dq`` and ``flash_bwd_dkv``, the counterparts of the
CUDA kernels in ``csrc/flash_bwd_sm90.cu`` and ``csrc/flash_bwd.cu`` and
of the TPU's ``_dq_kernel`` and
``_dkv_kernel``, with ``flash_delta`` the plain rowsum(dO∘O) the JAX
package also leaves outside any kernel. dq walks q tiles, each over its k
tiles up to the causal diagonal; dk/dv walk k tiles, each over its q
tiles from the diagonal on. Each rebuilds p = exp2(s − lse·log2e) from the
forward's lse, rounds ds to the input dtype before ds@K and dsᵀ@Q and p
to dO's dtype before pᵀ@dO, accumulates in fp32 and applies the softmax
scale once, after the loop, to dq and dk (never to dv).

The CPU path of ``flash_attention`` runs these, and so do the tests;
on the card they are the yardstick the kernels are held against, and
run only when a caller asks for them with ``interpret=True``.
Operands are ``[b·h, s, d]``; each function returns ``(out [b·h, sq, d]
in q's dtype, lse [b·h, sq] fp32)``. The tiles need not divide the
sequence: a partial last tile holds only the rows up to the end, where
the kernels load a whole tile and mask the rest, which adds exact zeros.
"""

import torch

NEG_INF = -1e30
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453


class _Tiles:
    """The tile walk shared by the variants: q tile qi sees k tiles
    0..nk(qi)-1, and logits(qi, kb) gives its masked log2-unit logits."""

    def __init__(self, q, k, v, causal, block_q, block_k, scale):
        self.q, self.k, self.v = q, k, v
        self.causal = causal
        self.bq, self.bk = block_q, block_k
        self.sq, self.sk = q.shape[1], k.shape[1]
        self.scale2 = scale * LOG2E
        self.nk_total = -(-self.sk // block_k)
        self.nq = -(-self.sq // block_q)

    def nk(self, qi):
        if self.causal:
            return min(((qi + 1) * self.bq + self.bk - 1) // self.bk,
                       self.nk_total)
        return self.nk_total

    def q_rows(self, qi):
        return slice(qi * self.bq, min((qi + 1) * self.bq, self.sq))

    def k_rows(self, kb):
        return slice(kb * self.bk, min((kb + 1) * self.bk, self.sk))

    def logits(self, qi, kb):
        qr, kr = self.q_rows(qi), self.k_rows(kb)
        # fp32 products of the input-dtype values: what the tensor cores'
        # fp32 accumulation computes
        s = torch.matmul(self.q[:, qr].float(),
                         self.k[:, kr].float().transpose(1, 2)) * self.scale2
        if not self.causal:
            return s
        q_pos = torch.arange(qr.start, qr.stop, device=s.device)[:, None]
        k_pos = torch.arange(kr.start, kr.stop, device=s.device)[None, :]
        return torch.where(k_pos <= q_pos, s, torch.full_like(s, NEG_INF))

    def pv(self, p, kb):
        v = self.v[:, self.k_rows(kb)]
        return torch.matmul(p.to(v.dtype).float(), v.float())

    def init(self, qi):
        bh, d = self.q.shape[0], self.q.shape[2]
        rows = self.q_rows(qi).stop - self.q_rows(qi).start
        dev = self.q.device
        return (torch.full((bh, rows), NEG_INF, dtype=torch.float32,
                           device=dev),
                torch.zeros((bh, rows), dtype=torch.float32, device=dev),
                torch.zeros((bh, rows, d), dtype=torch.float32, device=dev))

    def q_stats(self, stat, qi):
        """Rows of a per-query fp32 statistic ``[b·h, sq]`` for q tile
        qi, as a column ``[b·h, rows, 1]``."""
        return stat[:, self.q_rows(qi), None]


def _finish(tiles, parts):
    """Normalize each q tile's (m, l, acc) into out and lse."""
    outs, lses = [], []
    for m, l, acc in parts:
        l = torch.clamp(l, min=1e-30)
        outs.append((acc / l[..., None]).to(tiles.q.dtype))
        lses.append((m + torch.log2(l)) * LN2)
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _default_scale(q, scale):
    return q.shape[-1] ** -0.5 if scale is None else scale


def flash_fwd_online(q, k, v, causal, block_q, block_k, scale=None):
    """The online chain: every k tile rescales m, l and acc."""
    t = _Tiles(q, k, v, causal, block_q, block_k, _default_scale(q, scale))
    parts = []
    for qi in range(t.nq):
        m, l, acc = t.init(qi)
        for kb in range(t.nk(qi)):
            s = t.logits(qi, kb)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp2(s - m_new[..., None])
            alpha = torch.exp2(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + t.pv(p, kb)
            m = m_new
        parts.append((m, l, acc))
    return _finish(t, parts)


def flash_fwd_lazy(q, k, v, causal, block_q, block_k, scale=None):
    """Deferred rescale, k tiles diagonal-first: m, l and acc are
    corrected only on tiles where some row of the q tile raises its max;
    on the others alpha is exactly 1 and the correction is skipped."""
    t = _Tiles(q, k, v, causal, block_q, block_k, _default_scale(q, scale))
    parts = []
    for qi in range(t.nq):
        m, l, acc = t.init(qi)
        nk = t.nk(qi)
        for step in range(nk):
            kb = nk - 1 - step
            s = t.logits(qi, kb)
            m_tile = s.amax(dim=-1)
            # one predicate per (b·h, q tile), as the TPU kernel takes it
            rises = (m_tile > m).any(dim=-1, keepdim=True)
            m_new = torch.where(rises, torch.maximum(m, m_tile), m)
            alpha = torch.where(rises, torch.exp2(m - m_new),
                                torch.ones_like(m))
            l = l * alpha
            acc = acc * alpha[..., None]
            m = m_new
            p = torch.exp2(s - m[..., None])
            l = l + p.sum(dim=-1)
            acc = acc + t.pv(p, kb)
        parts.append((m, l, acc))
    return _finish(t, parts)


def flash_fwd_twopass(q, k, v, causal, block_q, block_k, scale=None):
    """Pass 1: the exact row max over every visited k tile. Pass 2:
    recompute the logits and accumulate exp2(s − m) with no carried
    correction."""
    t = _Tiles(q, k, v, causal, block_q, block_k, _default_scale(q, scale))
    parts = []
    for qi in range(t.nq):
        m, l, acc = t.init(qi)
        nk = t.nk(qi)
        for kb in range(nk):
            m = torch.maximum(m, t.logits(qi, kb).amax(dim=-1))
        for kb in range(nk):
            p = torch.exp2(t.logits(qi, kb) - m[..., None])
            l = l + p.sum(dim=-1)
            acc = acc + t.pv(p, kb)
        parts.append((m, l, acc))
    return _finish(t, parts)


FWD = {"online": flash_fwd_online, "lazy": flash_fwd_lazy,
       "twopass": flash_fwd_twopass}


def flash_delta(out, dout):
    """delta = rowsum(dO ∘ O) in fp32, ``[b·h, sq]``: the dP correction
    term of the backward."""
    return (dout.float() * out.float()).sum(dim=-1)


def _probs(t, lse2, qi, kb):
    """p of q tile qi against k tile kb, rebuilt from the forward's lse
    (``lse2`` = lse·log2e); exactly 0 where masked."""
    return torch.exp2(t.logits(qi, kb) - t.q_stats(lse2, qi))


def flash_bwd_dq(q, k, v, dout, lse, delta, causal, block_q, block_k,
                 scale=None):
    """dq = scale · Σ_k [p∘(dP − delta)]@K, dP = dO@Vᵀ; ``[b·h, sq, d]`` in
    q's dtype. Each q tile walks its k tiles up to the causal diagonal."""
    scale = _default_scale(q, scale)
    t = _Tiles(q, k, v, causal, block_q, block_k, scale)
    lse2 = lse * LOG2E
    parts = []
    for qi in range(t.nq):
        do = dout[:, t.q_rows(qi)].float()
        dq = torch.zeros(do.shape, dtype=torch.float32, device=q.device)
        for kb in range(t.nk(qi)):
            kr = t.k_rows(kb)
            p = _probs(t, lse2, qi, kb)
            dp = torch.matmul(do, v[:, kr].float().transpose(1, 2))
            ds = (p * (dp - t.q_stats(delta, qi))).to(k.dtype)
            dq = dq + torch.matmul(ds.float(), k[:, kr].float())
        parts.append((dq * scale).to(q.dtype))
    return torch.cat(parts, dim=1)


def flash_bwd_dkv(q, k, v, dout, lse, delta, causal, block_q, block_k,
                  scale=None):
    """(dk, dv): dv = Σ_q pᵀ@dO, dk = scale · Σ_q dsᵀ@Q; ``[b·h, sk, d]`` in
    k's and v's dtypes. Each k tile walks its q tiles from the first one
    that can see it (the diagonal, for causal attention) to the end."""
    scale = _default_scale(q, scale)
    t = _Tiles(q, k, v, causal, block_q, block_k, scale)
    lse2 = lse * LOG2E
    dks, dvs = [], []
    for kb in range(t.nk_total):
        kr = t.k_rows(kb)
        vt = v[:, kr].float().transpose(1, 2)
        dk = torch.zeros(k[:, kr].shape, dtype=torch.float32,
                         device=k.device)
        dv = torch.zeros_like(dk)
        # first q tile whose last row can see this k tile's first row
        qb_start = (kb * block_k) // block_q if causal else 0
        for qi in range(qb_start, t.nq):
            qr = t.q_rows(qi)
            do = dout[:, qr].float()
            p = _probs(t, lse2, qi, kb)
            dv = dv + torch.matmul(p.to(dout.dtype).float().transpose(1, 2),
                                   do)
            dp = torch.matmul(do, vt)
            ds = (p * (dp - t.q_stats(delta, qi))).to(q.dtype)
            dk = dk + torch.matmul(ds.float().transpose(1, 2),
                                   q[:, qr].float())
        dks.append((dk * scale).to(k.dtype))
        dvs.append(dv.to(v.dtype))
    return torch.cat(dks, dim=1), torch.cat(dvs, dim=1)
