"""Fused (flash) attention for the port: public side and dispatch.

The counterpart of ``horovod_tpu/ops/flash_attention.py``, forward and
backward. A CUDA tensor goes to the hand-written Hopper kernels: every
bf16 forward (online, lazy, twopass) up to head dim 256 on wgmma and TMA
in ``csrc/flash_fwd_sm90.cu``, and above 256 up to 1024 in
``csrc/flash_fwd_sm90_dyn.cu`` (d at run time); the bf16 backward's dq
and dk/dv kernels up to head dim 256 on wgmma and TMA in
``csrc/flash_bwd_sm90.cu``; the fp32 forward and backward on the CUDA
cores in ``csrc/flash_fwd.cu`` (register-blocked) and
``csrc/flash_bwd.cu``; and every other head dim above 256 (the fp32
forward, the bf16 forward above 1024, the backward) in
``csrc/flash_dyn.cu``, which takes d at run time. A CPU tensor goes to
their plain PyTorch versions in ``flash_attention_ref.py``, which walk
the same tiles. Nothing on a
CUDA tensor takes the plain version unless the caller asks for it with
``interpret=True`` (the port's counterpart of Pallas interpret mode): if
a kernel cannot build or launch, the call raises.

``flash_attention`` is differentiable through a ``torch.autograd.Function``
(the counterpart of the JAX package's ``custom_vjp``): the forward saves
q, k, v, O and lse; the backward computes delta = rowsum(dO∘O) as plain
torch, as the JAX package does, and launches the two backward kernels.

Lengths. ``flash_attention`` accepts exactly what the reference accepts:
its ``block_q``/``block_k`` (default 512) are fitted to the sequence by
the reference's ``fit_block``, and a length the fitted block does not
divide is refused unless the call is causal self-attention. The kernels
need no such blocks: each masks a partial last q tile and a partial last
k tile itself, so every accepted length runs unpadded. The CUDA-core
kernels walk 64-row tiles (the fp32 forward's k tiles are 128 keys, the
backward's 32 at d 256);
the wgmma kernels walk 128 keys per k tile and 64 or 128 query rows per
CTA (``sm90_cta_rows``; dk/dv 128 keys per CTA and 64 queries per q
tile), and at d 256 64 keys per k tile or dk/dv CTA and 64 query rows
per dq CTA; the bf16 forward above 256 walks 64 keys per k tile and 64
or 128 query rows per CTA (``sm90dyn_cta_rows``). ``kernel_blocks`` and
``bwd_kernel_blocks``
name the walks of the kernels a call reaches, so their plain versions
can walk the same. On the CPU, and under ``interpret=True``, the plain
walks take the fitted blocks.

Head dims. The kernels are compiled for d in {16, 32, 64, 128, 256}
(the wgmma kernels at every one of them in bf16, the CUDA-core ones at
every one of them in fp32); on
the card any other d up to 256 is zero-padded on the host to the next of
those (``pad_head_dim``), with the softmax scale of the true d: a zero
column adds nothing to any dot product, and the padded output columns
are sliced off. A d above 256 runs on the run-time-d kernels: the bf16
forward up to 1024 on wgmma and TMA (``flash_fwd_sm90_dyn.cu``: 64-column
boxes, V's columns split over the grid; a d that is not a multiple of 8
zero-padded to one, ``fwd_head_dim``), everything else unpadded on
``flash_dyn.cu`` (32-row tiles, d walked in 64-column chunks, the fp32
accumulators in shared memory where they fit and in a device workspace
otherwise), so no head dim is refused.

``decode_attention`` — one query against the KV cache — stays plain
torch, as the JAX package keeps it plain XLA: a GEMV per (batch, head)
has no logits matrix to keep out of memory.
"""

import collections
import functools
import os
import threading

import torch
import torch.nn.functional as F

from ..common.device import check_on, resolve_device
from . import flash_attention_ref as ref
from ._build import extension

NEG_INF = ref.NEG_INF
LOG2E = ref.LOG2E

#: Forward accumulation variants (see flash_attention_ref.py for each one's
#: tile walk). The backward kernels are shared: every variant writes the
#: same natural-log lse.
VARIANTS = ("online", "lazy", "twopass")

#: Rows of Q and of K/V per tile of the CUDA-core kernels; the forward
#: variant is picked by the number of these tiles along k.
BLOCK = 64

#: Keys per k tile of the fp32 CUDA-core forward (``csrc/flash_fwd.cu``),
#: whose q tiles are ``BLOCK`` rows.
CC_BLOCK_K = 128

#: Keys per k tile of the CUDA-core (fp32) backward kernels at a head dim
#: above 128, where 64-row fp32 tiles would not fit a block's shared
#: memory.
BWD_BLOCK_K_WIDE = 32

#: ``block_q``/``block_k`` of ``flash_attention`` when the caller gives
#: none: the reference's defaults, which decide what it accepts.
DEFAULT_BLOCK = 512

#: The head dims the kernels are compiled for; on the card any other
#: d ≤ 256 is zero-padded to the next of these (``pad_head_dim``).
KERNEL_HEAD_DIMS = (16, 32, 64, 128, 256)

#: The largest head dim of the wgmma/TMA backward kernels: every compiled
#: head dim; the bf16 backward above it runs on the run-time-d kernels.
SM90_MAX_HEAD_DIM = 256

#: The largest head dim of the wgmma/TMA forward kernel: every compiled
#: head dim.
SM90_FWD_MAX_HEAD_DIM = 256

#: The largest head dim of the run-time-d wgmma/TMA forward
#: (``csrc/flash_fwd_sm90_dyn.cu``), which takes bf16 above 256: Q of one
#: 64-row CTA (d / 64 boxes of 8 KB) beside its K and V rings fills the
#: 227 KB of a block at 1024. The bf16 forward above it stays on
#: ``flash_dyn.cu``.
SM90_DYN_MAX_HEAD_DIM = 1024

#: Keys per k tile of the run-time-d wgmma/TMA forward, columns per TMA
#: box, K boxes and V slices in flight: copies of flash_fwd_sm90_dyn.cu's
#: constants, which tests/test_torch_port_dispatch.py holds them to
SM90_DYN_BLOCK_K = 64
_SM90_DYN_BOX = 64
_SM90_DYN_K_STAGES, _SM90_DYN_V_STAGES = 4, 2

#: Rows per tile of the run-time-d kernels (``csrc/flash_dyn.cu``), which
#: take every head dim above ``KERNEL_HEAD_DIMS[-1]``; d is walked in
#: chunks of ``DYN_CHUNK`` columns.
DYN_BLOCK = 32
DYN_CHUNK = 64

#: Shared memory of a run-time-d kernel besides its fp32 accumulators
#: (floats: the chunk tiles of 32 rows of 65 floats, the 32 x 33 score
#: tiles, dk/dv's lse and delta rows), and its accumulator tiles of
#: [32, d]: mirrors of ``fixed_floats``/``acc_tiles`` in flash_dyn.cu.
_DYN_CHUNK_TILE = DYN_BLOCK * (DYN_CHUNK + 1)
_DYN_SCORE_TILE = DYN_BLOCK * (DYN_BLOCK + 1)
_DYN_FIXED_FLOATS = {"fwd": 2 * _DYN_CHUNK_TILE + _DYN_SCORE_TILE,
                     "dq": 4 * _DYN_CHUNK_TILE + _DYN_SCORE_TILE,
                     "dkv": 4 * _DYN_CHUNK_TILE + 2 * _DYN_SCORE_TILE +
                     2 * DYN_BLOCK}
_DYN_ACC_TILES = {"fwd": 1, "dq": 1, "dkv": 2}

#: Bytes of shared memory a block may use on sm_90.
MAX_SMEM = 232448

#: Keys per k tile of the wgmma/TMA kernels (forward, dq; dk/dv's keys
#: per CTA).
SM90_BLOCK_K = 128

#: Keys per k tile of the wgmma/TMA forward and dq, and dk/dv's keys per
#: CTA, at a head dim above 128, where a 128-key K or V tile would take
#: 64 KB of shared memory.
SM90_BLOCK_K_WIDE = 64

#: Queries per q tile of the wgmma/TMA dk/dv kernel.
SM90_DKV_BLOCK_Q = 64

#: Kernel launches by kernel name, counted where each launch is made
#: (under a lock: ranks that share a card launch from threads).
launch_counts = collections.Counter()
_count_lock = threading.Lock()
_thread = threading.local()


def thread_launch_counts():
    """The launches made on this thread since its last reset: a rank that
    is a thread of this process reads its own."""
    counts = getattr(_thread, "counts", None)
    if counts is None:
        counts = _thread.counts = collections.Counter()
    return counts


def reset_launch_counts():
    """Zero the launch counts (and this thread's own)."""
    with _count_lock:
        launch_counts.clear()
    thread_launch_counts().clear()


def _counted(name):
    with _count_lock:
        launch_counts[name] += 1
    thread_launch_counts()[name] += 1


def resolve_variant(variant, causal=True, nk=1):
    """Resolve 'auto' (and the HVD_FLASH_VARIANT env override, which wins
    over any explicit argument) to a concrete forward variant: lazy
    whenever the k loop has two or more tiles, online for a one-tile
    loop; twopass only when asked for. ``causal`` is the reference's
    argument, which its rule does not read either."""
    env = os.environ.get("HVD_FLASH_VARIANT", "").strip().lower()
    if env:
        variant = env
    if variant not in VARIANTS + ("auto",):
        raise ValueError(
            f"unknown flash variant {variant!r}; expected one of "
            f"{VARIANTS + ('auto',)}")
    if variant == "auto":
        return "lazy" if nk >= 2 else "online"
    return variant


def fit_block(s, block=BLOCK):
    """Tile rows of the fp32 CUDA-core kernels for a sequence of ``s``:
    the full tile (``block`` rows), or one partial tile when the whole
    sequence is shorter. A longer sequence ends in a partial tile, which
    the kernels mask."""
    return min(block, s)


def fit_block_ref(block, s):
    """The reference's ``fit_block`` (horovod_tpu/ops/flash_attention.py):
    the largest block ≤ ``block`` that divides ``s``, halving no further
    than 128. It decides which lengths ``flash_attention`` accepts, and
    the plain walks' tiles on the CPU; the kernels walk their own."""
    b = min(block, s)
    while b > 128 and s % b:
        b //= 2
    return b


def accepted_blocks(sq, sk, causal, block_q=DEFAULT_BLOCK,
                    block_k=DEFAULT_BLOCK):
    """The fitted (block_q, block_k) of a call, raising as the reference
    does for a length they do not divide unless it is causal
    self-attention."""
    bq, bk = fit_block_ref(block_q, sq), fit_block_ref(block_k, sk)
    if (sq % bq or sk % bk) and not (causal and sq == sk):
        raise ValueError(
            f"flash_attention needs seq divisible by block sizes unless "
            f"causal self-attention: q {sq}%{bq}, k {sk}%{bk}")
    return bq, bk


def dkv_blocks(sq, sk, blocks, block_q_dkv=None, block_k_dkv=None):
    """The dk/dv walk's (block_q, block_k) as the reference takes them:
    each given block fitted to its sequence, the dq walk's where none is
    given or the fitted one does not divide."""
    bq2 = fit_block_ref(block_q_dkv, sq) if block_q_dkv else blocks[0]
    bk2 = fit_block_ref(block_k_dkv, sk) if block_k_dkv else blocks[1]
    return (blocks[0] if sq % bq2 else bq2, blocks[1] if sk % bk2 else bk2)


def on_dyn(d):
    """Whether head dim ``d`` runs on the run-time-d kernels
    (``csrc/flash_dyn.cu``): every d above the largest compiled one."""
    return d > KERNEL_HEAD_DIMS[-1]


def sm90dyn_plan(d):
    """(boxes, slices, boxes a slice) of the run-time-d wgmma forward at
    head dim ``d``: d in 64-column boxes, the boxes in as few slices of at
    most four as hold them, each slice as wide as the widest (3 or 4
    boxes: O m64n192 or m64n256); one CTA per slice, each computing the
    logits over the whole d."""
    boxes = -(-d // _SM90_DYN_BOX)
    slices = -(-boxes // 4)
    return boxes, slices, -(-boxes // slices)


def sm90dyn_fits(d, cta_rows):
    """Whether the run-time-d wgmma forward's shared memory at head dim
    ``d`` and ``cta_rows`` query rows fits a block: Q (cta_rows x d), 4 K
    boxes, 2 V slices and the barriers (mirrors ``smem_bytes`` in
    flash_fwd_sm90_dyn.cu): one consumer warpgroup up to d 1024, two up
    to d 576."""
    boxes, _, per = sm90dyn_plan(d)
    box = SM90_DYN_BLOCK_K * 2 * _SM90_DYN_BOX
    smem = (boxes * cta_rows * 2 * _SM90_DYN_BOX + _SM90_DYN_K_STAGES * box
            + _SM90_DYN_V_STAGES * per * box + 128 + 1024)
    return d <= SM90_DYN_MAX_HEAD_DIM and smem <= MAX_SMEM


def sm90dyn_cta_rows(bh, sq, d, sm_count):
    """Query rows per CTA of the run-time-d wgmma forward: 128 (two
    consumer warpgroups) when Q for 128 rows fits and
    ``bh·⌈sq/128⌉·slices`` CTAs fill the SMs, else 64."""
    slices = sm90dyn_plan(d)[1]
    fill = bh * -(-sq // 128) * slices >= sm_count
    return 128 if fill and sm90dyn_fits(d, 128) else 64


def kernel_head_dim(d):
    """The head dim a head dim of ``d`` runs at on the card: the next
    compiled one up to 256, ``d`` itself above (the run-time-d kernels)."""
    for kd in KERNEL_HEAD_DIMS:
        if d <= kd:
            return kd
    return d


def dyn_workspace(kind, bh, rows, d):
    """Floats of the fp32 device workspace a run-time-d kernel (``kind``
    'fwd', 'dq' or 'dkv') needs over ``bh`` heads of ``rows`` owned rows
    (sq for 'fwd' and 'dq', sk for 'dkv'): 0 when its accumulators fit a
    block's shared memory beside its tiles, else one slice of
    tiles · 32 · d per CTA."""
    tiles = _DYN_ACC_TILES[kind]
    if 4 * (_DYN_FIXED_FLOATS[kind] + tiles * DYN_BLOCK * d) <= MAX_SMEM:
        return 0
    return bh * -(-rows // DYN_BLOCK) * tiles * DYN_BLOCK * d


def _workspace(kind, qf, rows, force):
    """The workspace tensor of a run-time-d launch: empty (shared memory)
    unless the accumulators do not fit it, or ``force`` asks for device
    memory (a check of that path at a d whose accumulators would fit)."""
    n = dyn_workspace(kind, qf.shape[0], rows, qf.shape[2])
    if force and not n:
        n = (qf.shape[0] * -(-rows // DYN_BLOCK) * _DYN_ACC_TILES[kind] *
             DYN_BLOCK * qf.shape[2])
    return torch.empty(n, dtype=torch.float32, device=qf.device)


def fwd_head_dim(qf):
    """The head dim the forward of ``[b·h, s, d]`` operands runs at on the
    card: ``kernel_head_dim``, except that the bf16 forward on the
    run-time-d wgmma kernel takes d rounded up to a multiple of 8 (its
    tensor maps' rows must be multiples of 16 bytes)."""
    d = qf.shape[-1]
    if on_sm90dyn_fwd(qf):
        return -(-d // 8) * 8
    return kernel_head_dim(d)


def pad_head_dim(fn, tensors, n_sliced, to=None):
    """``fn(*tensors)`` with every tensor zero-padded along its last dim to
    ``to`` (default ``kernel_head_dim(d)``), and the first ``n_sliced``
    outputs sliced back to d. A zero column adds nothing to any dot
    product, so the result is the unpadded one as long as ``fn`` takes the
    softmax scale of the true d, which the callers pass."""
    d = tensors[0].shape[-1]
    pad = (kernel_head_dim(d) if to is None else to) - d
    if not pad:
        return fn(*tensors)
    outs = fn(*(F.pad(t, (0, pad)) for t in tensors))
    return tuple(o[..., :d].contiguous() if i < n_sliced else o
                 for i, o in enumerate(outs))


def _check_operands(qf, kf, vf):
    """Raise unless ``[b·h, s, d]`` q, k, v are what the kernels take."""
    if qf.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash kernel takes float32 or bfloat16, got "
                        f"{qf.dtype}")
    if not (qf.dtype == kf.dtype == vf.dtype):
        raise TypeError("q, k and v must share a dtype")
    if qf.shape[2] not in KERNEL_HEAD_DIMS and not on_dyn(qf.shape[2]):
        raise ValueError(f"flash kernel head_dim must be one of "
                         f"{KERNEL_HEAD_DIMS} or above "
                         f"{KERNEL_HEAD_DIMS[-1]}, got {qf.shape[2]}")
    if kf.shape != vf.shape or kf.shape[0] != qf.shape[0] or \
            kf.shape[2] != qf.shape[2]:
        raise ValueError(f"k/v shape {tuple(kf.shape)} does not fit q "
                         f"{tuple(qf.shape)}")
    _check_contiguous(qf, kf, vf)


def _check_contiguous(*ts):
    for t in ts:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("flash kernel operands must be contiguous and "
                             "16-byte aligned")


@functools.lru_cache(maxsize=None)
def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def sm90_cta_rows(bh, sq, sm_count):
    """Query rows per CTA of the wgmma kernel: 128 (two consumer
    warpgroups) when ``bh·⌈sq/128⌉`` CTAs fill the SMs, else 64 (one), so
    a thin grid is not made thinner."""
    return 128 if bh * -(-sq // 128) >= sm_count else 64


def sm90_dq_rows(qf, cta_rows=None):
    """Query rows per CTA of the wgmma dq kernel: as the forward's
    (``sm90_cta_rows``, or ``cta_rows`` when given) up to d 128; 64 at
    d 256, where Q and dO for 128 rows beside two stages of 64-key K and
    V tiles would not fit a block's shared memory."""
    if kernel_head_dim(qf.shape[2]) > 128:
        return 64
    return cta_rows or sm90_cta_rows(qf.shape[0], qf.shape[1],
                                     _sm_count(qf.device))


def on_sm90_fwd(qf):
    """Whether the forward of a ``[b·h, s, d]`` call runs on the wgmma/TMA
    kernel: bf16 at every head dim up to 256 (a d between the compiled
    ones padded up). fp32 runs on the CUDA-core kernel, d above 256 on the
    run-time-d one."""
    return qf.dtype == torch.bfloat16 and \
        qf.shape[2] <= SM90_FWD_MAX_HEAD_DIM


def on_sm90dyn_fwd(qf):
    """Whether the forward of a ``[b·h, s, d]`` call runs on the run-time-d
    wgmma/TMA kernel (``csrc/flash_fwd_sm90_dyn.cu``): bf16 at
    256 < d ≤ ``SM90_DYN_MAX_HEAD_DIM`` (1024, where shared memory sets the
    ceiling). fp32 above 256, and bf16 above 1024, run on
    ``flash_dyn.cu``."""
    return qf.dtype == torch.bfloat16 and \
        SM90_FWD_MAX_HEAD_DIM < qf.shape[2] <= SM90_DYN_MAX_HEAD_DIM


def on_sm90_bwd(qf):
    """Whether the backward of a ``[b·h, s, d]`` call runs on the
    wgmma/TMA kernels: bf16 at every head dim up to 256 (a d between the
    compiled ones padded up). fp32 runs on the CUDA-core kernels, d above
    256 on the run-time-d ones."""
    return qf.dtype == torch.bfloat16 and qf.shape[2] <= SM90_MAX_HEAD_DIM


def sm90_block_k(d):
    """Keys per k tile of the wgmma/TMA forward at head dim ``d``."""
    return SM90_BLOCK_K if kernel_head_dim(d) <= 128 else SM90_BLOCK_K_WIDE


def fwd_launch_name(qf, variant):
    """The launch count a forward call on ``[b·h, s, d]`` operands adds
    to: ``flash_fwd_{variant}`` on the wgmma/TMA kernel (bf16 up to
    d 256), ``flash_fwd_sm90dyn_{variant}`` on the run-time-d wgmma/TMA
    kernel (bf16 above 256 up to its shared-memory ceiling,
    ``SM90_DYN_MAX_HEAD_DIM`` = 1024), ``flash_fwd_cc_{variant}`` on the
    CUDA-core one (fp32 up to 256), ``flash_fwd_dyn_{variant}`` on the
    run-time-d CUDA-core one (fp32 above 256, bf16 above 1024)."""
    if on_sm90_fwd(qf):
        return f"flash_fwd_{variant}"
    if on_sm90dyn_fwd(qf):
        return f"flash_fwd_sm90dyn_{variant}"
    return f"flash_fwd_{_cc_family(qf)}_{variant}"


def _cc_family(qf):
    return "dyn" if on_dyn(qf.shape[2]) else "cc"


def bwd_launch_names(qf):
    """The launch counts (dq, dk/dv) a backward call on ``[b·h, s, d]``
    operands adds to, one per kernel family."""
    family = "sm90" if on_sm90_bwd(qf) else _cc_family(qf)
    return f"flash_bwd_{family}_dq", f"flash_bwd_{family}_dkv"


def kernel_blocks(qf, kf, variant, cta_rows=None):
    """(block_q, block_k) of the tile walk that the forward kernel a
    ``[b·h, s, d]`` call reaches takes (at the head dim it is padded to):
    the plain version walks the same tiles at these blocks."""
    if on_sm90_fwd(qf):
        rows = cta_rows or sm90_cta_rows(qf.shape[0], qf.shape[1],
                                         _sm_count(qf.device))
        return rows, sm90_block_k(qf.shape[2])
    if on_sm90dyn_fwd(qf):
        rows = cta_rows or sm90dyn_cta_rows(
            qf.shape[0], qf.shape[1], fwd_head_dim(qf), _sm_count(qf.device))
        return rows, SM90_DYN_BLOCK_K
    if on_dyn(qf.shape[2]):
        return _dyn_blocks(qf, kf)
    return fit_block(qf.shape[1]), fit_block(kf.shape[1], CC_BLOCK_K)


def _dyn_blocks(qf, kf):
    """The run-time-d CUDA-core kernels' 32-row tiles."""
    return min(DYN_BLOCK, qf.shape[1]), min(DYN_BLOCK, kf.shape[1])


def _kernel_fwd(qf, kf, vf, causal, scale, variant, cta_rows=None,
                workspace=False):
    """Launch the forward kernel on ``[b·h, s, d]`` operands: bf16 up to
    d 256 on the wgmma/TMA kernel and above it up to 1024 on the run-time-d
    wgmma/TMA one (``cta_rows`` 64 or 128 forces either's CTA shape; the
    latter takes d a multiple of 8, which ``fwd_head_dim`` pads to), fp32
    up to 256 on the CUDA-core one, every other d above 256 on the
    run-time-d CUDA-core one (``workspace=True`` puts its accumulators in
    device memory even where shared memory would hold them)."""
    _check_operands(qf, kf, vf)
    out = torch.empty_like(qf)
    lse = torch.empty(qf.shape[:2], dtype=torch.float32, device=qf.device)
    scale2 = float(scale * LOG2E)
    if on_sm90dyn_fwd(qf):
        rows, _ = kernel_blocks(qf, kf, variant, cta_rows)
        if qf.shape[2] % 8 or not sm90dyn_fits(qf.shape[2], rows):
            raise ValueError(
                f"the run-time-d wgmma forward takes a head dim that is a "
                f"multiple of 8 (fwd_head_dim pads to one) and fits "
                f"{rows} query rows; got d {qf.shape[2]}")
        extension().flash_fwd_sm90_dyn(qf, kf, vf, out, lse,
                                       VARIANTS.index(variant), bool(causal),
                                       scale2, rows)
    elif on_dyn(qf.shape[2]):
        extension().flash_fwd_dyn(
            qf, kf, vf, out, lse,
            _workspace("fwd", qf, qf.shape[1], workspace),
            VARIANTS.index(variant), bool(causal), scale2)
    elif on_sm90_fwd(qf):
        rows, _ = kernel_blocks(qf, kf, variant, cta_rows)
        extension().flash_fwd_sm90(qf, kf, vf, out, lse,
                                   VARIANTS.index(variant), bool(causal),
                                   scale2, rows)
    else:
        extension().flash_fwd(qf, kf, vf, out, lse, VARIANTS.index(variant),
                              bool(causal), scale2)
    _counted(fwd_launch_name(qf, variant))
    return out, lse


def bwd_kernel_blocks(qf, kf, cta_rows=None):
    """((block_q, block_k) of dq, (block_q, block_k) of dk/dv): the tile
    walks that the backward kernels a ``[b·h, s, d]`` call reaches take,
    the counterpart of ``kernel_blocks``. bf16 up to d 256 runs the wgmma
    kernels: up to d 128 dq over 64 or 128 query rows × 128 keys
    (``cta_rows`` forcing the rows) and dk/dv over 128 keys × 64 queries;
    at d 256 dq over 64 × 64 and dk/dv over 64 keys × 64 queries. fp32
    runs the CUDA-core ones at 64-row tiles (32-key tiles above d 128),
    above d 256 the run-time-d ones at 32-row tiles."""
    if on_sm90_bwd(qf):
        bk = sm90_block_k(qf.shape[2])
        return (sm90_dq_rows(qf, cta_rows), bk), (SM90_DKV_BLOCK_Q, bk)
    if on_dyn(qf.shape[2]):
        blocks = _dyn_blocks(qf, kf)
        return blocks, blocks
    bk = BWD_BLOCK_K_WIDE if qf.shape[2] > 128 else BLOCK
    blocks = fit_block(qf.shape[1]), min(bk, kf.shape[1])
    return blocks, blocks


def _kernel_bwd(qf, kf, vf, dof, lse, delta, causal, scale, cta_rows=None,
                workspace=False):
    """Launch the backward kernels on ``[b·h, s, d]`` operands (dO like
    q; lse and delta fp32 ``[b·h, sq]``); returns (dq, dk, dv). bf16 up to
    d 256 runs on the wgmma/TMA kernels (``cta_rows`` 64 or 128 forces
    dq's CTA shape up to d 128; d 256 takes 64), fp32 on the CUDA-core
    ones, every d above 256 on the run-time-d ones (``workspace`` as in
    ``_kernel_fwd``)."""
    _check_operands(qf, kf, vf)
    if dof.shape != qf.shape or dof.dtype != qf.dtype:
        raise ValueError(f"dO {tuple(dof.shape)} {dof.dtype} does not fit "
                         f"q {tuple(qf.shape)} {qf.dtype}")
    for stat in (lse, delta):
        if stat.dtype != torch.float32 or stat.shape != qf.shape[:2]:
            raise ValueError("lse and delta must be fp32 [b·h, sq]")
    _check_contiguous(dof, lse, delta)
    dq, dk, dv = (torch.empty_like(t) for t in (qf, kf, vf))
    ext = extension()
    args = (bool(causal), float(scale * LOG2E), float(scale))
    if on_dyn(qf.shape[2]):
        ext.flash_bwd_dyn_dq(qf, kf, vf, dof, lse, delta, dq,
                             _workspace("dq", qf, qf.shape[1], workspace),
                             *args)
        ext.flash_bwd_dyn_dkv(qf, kf, vf, dof, lse, delta, dk, dv,
                              _workspace("dkv", qf, kf.shape[1], workspace),
                              *args)
    elif on_sm90_bwd(qf):
        (rows, _), _ = bwd_kernel_blocks(qf, kf, cta_rows)
        ext.flash_bwd_sm90_dq(qf, kf, vf, dof, lse, delta, dq, *args, rows)
        ext.flash_bwd_sm90_dkv(qf, kf, vf, dof, lse, delta, dk, dv, *args)
    else:
        ext.flash_bwd_dq(qf, kf, vf, dof, lse, delta, dq, *args)
        ext.flash_bwd_dkv(qf, kf, vf, dof, lse, delta, dk, dv, *args)
    for name in bwd_launch_names(qf):
        _counted(name)
    return dq, dk, dv


def _fwd_flat(qf, kf, vf, causal, blocks, variant, interpret=False,
              scale=None):
    """(out, lse) of ``[b·h, s, d]`` operands: the kernel on the card
    (at the kernel head dim), the plain version at ``blocks`` on the CPU
    or when ``interpret`` asks for it; ``scale`` is d^-0.5 of the true d
    unless given."""
    scale = qf.shape[-1] ** -0.5 if scale is None else scale
    if interpret or qf.device.type == "cpu":
        return ref.FWD[variant](qf, kf, vf, causal, *blocks, scale)
    if qf.is_cuda:
        return _card_fwd(qf, kf, vf, causal, scale, variant)
    raise ValueError(f"flash attention runs on cuda or cpu, not {qf.device}")


def _card_fwd(qf, kf, vf, causal, scale, variant):
    """The card path of a forward: the kernel the call reaches, on the
    operands zero-padded to ``fwd_head_dim`` (O sliced back)."""
    return pad_head_dim(
        lambda q, k, v: _kernel_fwd(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal, scale, variant),
        (qf, kf, vf), 1, fwd_head_dim(qf))


def _bwd_flat(qf, kf, vf, of, lse, dof, causal, blocks, dkv_walk=None,
              interpret=False, scale=None):
    """(dq, dk, dv) of ``[b·h, s, d]`` operands given the forward's out
    and lse and the output gradient dO: the kernels on the card (at the
    kernel head dim), the plain versions on the CPU or when ``interpret``
    asks for it, dq at ``blocks`` and dk/dv at ``dkv_walk`` (default
    ``blocks``); ``scale`` is d^-0.5 unless given. delta is rowsum(dO∘O)
    of the ``of`` given, and ``lse`` reaches the kernels unchanged: a
    ring's merged lse with +1e30 rows makes those rows' p exactly 0."""
    scale = qf.shape[-1] ** -0.5 if scale is None else scale
    delta = ref.flash_delta(of, dof)
    if interpret or qf.device.type == "cpu":
        dq = ref.flash_bwd_dq(qf, kf, vf, dof, lse, delta, causal, *blocks,
                              scale)
        dk, dv = ref.flash_bwd_dkv(qf, kf, vf, dof, lse, delta, causal,
                                   *(dkv_walk or blocks), scale)
        return dq, dk, dv
    if qf.is_cuda:
        return pad_head_dim(
            lambda q, k, v, do: _kernel_bwd(
                q.contiguous(), k.contiguous(), v.contiguous(),
                do.contiguous(), lse, delta, causal, scale),
            (qf, kf, vf, dof), 3)
    raise ValueError(f"flash attention runs on cuda or cpu, not {qf.device}")


def _layout_dims(q, k, layout):
    """(b, h, sq, sk, d) of operands in ``layout``."""
    if layout == "bhsd":
        b, h, sq, d = q.shape
        return b, h, sq, k.shape[2], d
    if layout == "bshd":
        b, sq, h, d = q.shape
        return b, h, sq, k.shape[1], d
    raise ValueError(f"unknown layout {layout!r}")


def _flat(t, layout):
    """``[b, s, h, d]`` or ``[b, h, s, d]`` to ``[b·h, s, d]``."""
    if layout == "bhsd":
        return t.reshape(-1, t.shape[2], t.shape[3])
    return t.transpose(1, 2).reshape(-1, t.shape[1], t.shape[3])


def _unflat(t, b, h, layout):
    t = t.reshape(b, h, t.shape[1], t.shape[2])
    return t if layout == "bhsd" else t.transpose(1, 2)


def flash_fwd(q, k, v, causal, block_q=BLOCK, block_k=BLOCK, layout="bshd",
              variant="online", scale=None):
    """Forward on ``q, k, v`` in ``layout`` ('bshd' [b, s, h, d] or 'bhsd'
    [b, h, s, d]); returns ``(out, lse)`` with out in q's layout and
    dtype, lse the natural-log row log-sum-exp, fp32, ``[b·h, sq]``: the
    counterpart of the JAX package's ``_flash_fwd``, which a ring pair
    calls (non-causal after the first pair). ``scale`` is the softmax
    scale, d^-0.5 of the given d by default.

    CUDA tensors launch the kernel, which walks its own tiles (see
    ``kernel_blocks``); CPU tensors run the plain version at the given
    blocks, a partial last tile where they do not divide the sequence."""
    if variant not in VARIANTS:
        raise ValueError(f"unknown flash variant {variant!r}")
    b, h, sq, sk, _ = _layout_dims(q, k, layout)
    out, lse = _fwd_flat(_flat(q, layout), _flat(k, layout),
                         _flat(v, layout), causal,
                         (min(block_q, sq), min(block_k, sk)), variant,
                         scale=scale)
    return _unflat(out, b, h, layout), lse


def flash_bwd(q, k, v, out, lse, g, causal, block_q=BLOCK, block_k=BLOCK,
              layout="bshd", scale=None):
    """Gradients ``(dq, dk, dv)`` in the operands' layout, given the
    forward's ``out`` (layout like q) and ``lse`` (``[b·h, sq]``) and the
    output gradient ``g`` (like out): the counterpart of the JAX
    package's ``_flash_bwd``. ``out`` and ``lse`` may be a ring's merged
    ones: delta = rowsum(g∘out) uses the ``out`` given, and a row whose
    lse is +1e30 contributes exactly nothing. CUDA tensors launch the dq
    and dk/dv kernels; CPU tensors run their plain versions at the given
    blocks."""
    b, h, sq, sk, _ = _layout_dims(q, k, layout)
    dq, dk, dv = _bwd_flat(*(_flat(t, layout) for t in (q, k, v, out)), lse,
                           _flat(g, layout), causal,
                           (min(block_q, sq), min(block_k, sk)), scale=scale)
    return tuple(_unflat(t, b, h, layout) for t in (dq, dk, dv))


class _FlashAttention(torch.autograd.Function):
    """Attention on ``[b·h, s, d]`` operands with the flash backward."""

    @staticmethod
    def forward(ctx, qf, kf, vf, causal, blocks, dkv_walk, variant,
                interpret):
        out, lse = _fwd_flat(qf, kf, vf, causal, blocks, variant, interpret)
        ctx.save_for_backward(qf, kf, vf, out, lse)
        ctx.walk = (causal, blocks, dkv_walk, interpret)
        return out

    @staticmethod
    def backward(ctx, g):
        qf, kf, vf, out, lse = ctx.saved_tensors
        dq, dk, dv = _bwd_flat(qf, kf, vf, out, lse, g, *ctx.walk)
        return dq, dk, dv, None, None, None, None, None


def flash_attention(q, k, v, causal=True, block_q=DEFAULT_BLOCK,
                    block_k=DEFAULT_BLOCK, interpret=None, block_q_dkv=None,
                    block_k_dkv=None, layout="bshd", variant="auto",
                    device=None):
    """Fused attention; q/k/v ``[b, s, h, d]`` (or ``[b, h, s, d]`` with
    ``layout="bhsd"``), the reference's signature. Causal mask in global
    positions; exact softmax with fp32 statistics, matching
    ``parallel.ring.full_attention``. Differentiable: gradients come from
    the flash backward (the kernels on the card, their plain versions on
    the CPU), the same for every forward variant.

    ``device`` is where the caller means to run (CUDA unless it says
    ``"cpu"``); the tensors must lie there. ``block_q``/``block_k`` decide
    which lengths are accepted, as in the reference (``accepted_blocks``:
    a length the fitted block does not divide is refused unless the call
    is causal self-attention), and the plain walks' tiles; the kernels
    walk their own tiles and mask partial ones, so nothing is padded.
    ``block_q_dkv``/``block_k_dkv`` are fitted as the reference fits them
    and set the plain dk/dv walk's tiles. ``interpret=True`` runs the
    plain walks on the tensors' device, the port's interpret mode; it
    launches no kernel. ``variant`` is 'auto' or one of VARIANTS
    (HVD_FLASH_VARIANT overrides both)."""
    device = resolve_device(device)
    check_on(device, q, k, v)
    b, h, sq, sk, _ = _layout_dims(q, k, layout)
    blocks = accepted_blocks(sq, sk, causal, block_q, block_k)
    dkv_walk = dkv_blocks(sq, sk, blocks, block_q_dkv, block_k_dkv)
    variant = resolve_variant(variant, nk=-(-sk // BLOCK))
    qf, kf, vf = (_flat(t, layout).contiguous() for t in (q, k, v))
    out = _FlashAttention.apply(qf, kf, vf, causal, blocks, dkv_walk,
                                variant, bool(interpret))
    return _unflat(out, b, h, layout)


def decode_attention(q, k, v, lengths, scale=None, head_sharding=None):
    """Single-query attention against a cached K/V prefix — the decode
    step of the serving plane.

    q        [batch, 1, heads, head_dim] — the current token's query
    k, v     [batch, s_max, heads, head_dim] — the KV cache; only the
             first ``lengths[b]`` positions of row b are real
    lengths  [batch] int — valid prefix length per row
    scale    optional softmax scale (default head_dim ** -0.5, matching
             flash_attention)
    head_sharding  optional ``parallel.mesh.HeadSharding``
             (``decode_head_sharding``): under tensor-parallel serving q,
             k and v are already this rank's heads, and each must hold
             the sharding's shard of the heads, or the call raises; each
             rank attends its own heads, with no collective until the
             output projection's all-reduce

    Plain torch on purpose (see the module docstring). Numerics as the
    JAX version: fp32 logits from the input-dtype values, fp32 softmax,
    P in V's dtype with fp32 accumulation, output in q's dtype.
    """
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"decode_attention wants q [b, 1, h, d], got "
                         f"{tuple(q.shape)}")
    if head_sharding is not None:
        want = head_sharding.local_heads()
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.shape[2] != want:
                raise ValueError(
                    f"decode_attention: {name} holds {t.shape[2]} heads, "
                    f"the head sharding gives this rank {want} of "
                    f"{head_sharding.num_heads}")
    s_max = k.shape[1]
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    # [b, h, d] x [b, s, h, d] -> [b, h, s]
    logits = torch.einsum("bhd,bshd->bhs", q[:, 0].float(), k.float())
    logits = logits * scale
    pos = torch.arange(s_max, device=q.device)[None, None, :]
    valid = pos < lengths.to(torch.int64)[:, None, None]
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhs,bshd->bhd", p.to(v.dtype).float(), v.float())
    return out.to(q.dtype)[:, None]
