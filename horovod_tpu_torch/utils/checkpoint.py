"""Checkpoint plane: durable, restart-based failure recovery.

The port of ``horovod_tpu/utils/checkpoint.py``, with the same on-disk
byte layout, so that a checkpoint written by either package restores in
the other. The reference fork's contribution is restart-based
elasticity (submitjob.py kills and restarts the job with fewer slots);
correctness comes from checkpoint + broadcast on startup, so how often a
save is affordable bounds what a preemption costs, and how fast a
restore runs bounds the recovery time of the elastic loop.

Two layers:

  * ``save()`` / ``restore()`` / ``exists()`` / ``latest_step()`` — the
    rank-0, synchronous, single-npz format 1; ``restore()`` and
    ``latest_step()`` read both formats.

  * ``CheckpointManager`` — format 2:

      - async double-buffered saves: ``save()`` copies the tree to host
        memory at the step boundary (the only blocking part) and hands
        serialization, fsync and rename to a writer thread; the buffer is
        latest-wins (a snapshot still queued when the next arrives is
        dropped and counted);
      - sharded per-rank writes: each rank writes the leaves it owns
        (round-robin by leaf index) and a rank manifest; rank 0 commits
        the global manifest LAST, the single atomic commit point;
      - fail-loud integrity: every file's crc32 is recorded and verified
        on restore (``CorruptCheckpointError`` names the file);
      - reshard on restore: the full tree is reassembled from however
        many rank shards the saving world wrote;
      - retention: keep-last-K commits; stale partials of crashed saves
        are collected at the next commit.

Format 2 layout (one directory per committed step)::

    <dir>/step-0000000042/
        rank00000.npz     leaf shard (keys are global leaf indices)
        rank00000.json    rank manifest: owned indices, shard crc32
        manifest.json     global manifest — THE commit point, rank 0,
                          written last (atomic tmp + fsync + rename)

Trees are nested dicts, lists and tuples of tensors (or numpy arrays);
leaf names are ``jax.tree_util.keystr``'s (``['opt']['mu'][0]``, dict
keys in sorted order), so a ``like=`` tree of the same shape matches a
checkpoint of either package. A bfloat16 (float8) leaf is written as the
2-byte (1-byte) void array numpy makes of an ml_dtypes leaf, the same
bytes; a void leaf restores to the ``like`` leaf's dtype, or to bfloat16
(float8_e4m3fn) without one. A DTensor leaf is saved whole.

As in the JAX package, the manager feeds the metrics registry
(``hvd_ckpt_*``: saves by kind, bytes, save and blocking seconds, the
newest step and its epoch seconds on the shared clock, dropped snapshots,
retention removals) and the event ring (``ckpt_commit``), and a
format-2 restore counts ``hvd_ckpt_restores_total`` by outcome (a
corrupt one also emits ``ckpt_corrupt``); ``CheckpointManager.stats``
keeps the newest save's times as before.

The fleet plane's publication pointer (``manifest_signature``,
``write_pointer``, ``latest_manifest``) is the JAX package's: a top-level
``<dir>/manifest.json`` holding the newest committed step's global
manifest plus ``generation`` and ``dir``, byte for byte the JSON the JAX
package writes, so each package reads the other's pointers.
"""

import json
import os
import re
import shutil
import tempfile
import threading
import time
import zlib

import numpy as np
import torch

from ..common.config import env_bool, env_int
from ..common.exceptions import CheckpointError, CorruptCheckpointError

_MANIFEST = "manifest.json"
_ARRAYS = "arrays.npz"

_STEP_DIR_RE = re.compile(r"^step-(\d{10})$")
CHECKPOINT_FORMAT = 2

# Torture-test failpoints: every interruption point between "save
# called" and "manifest renamed" can be made to raise. Production leaves
# this empty and _failpoint is a dict miss.
_FAILPOINTS = {}


def _failpoint(name):
    hook = _FAILPOINTS.get(name)
    if hook is not None:
        hook()


# -- trees ------------------------------------------------------------------


def _registry():
    from . import metrics as hvd_metrics
    return hvd_metrics.get_registry()


def _epoch_seconds():
    from . import metrics as hvd_metrics
    return hvd_metrics.shared_clock().epoch_us() / 1e6


def _flatten_with_names(tree):
    """(names, leaves) in jax.tree_util's order: dict keys sorted, lists
    and tuples in order, None an empty subtree."""
    names, leaves = [], []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}[{k!r}]")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif node is not None:
            names.append(path)
            leaves.append(node)
    walk(tree, "")
    return names, leaves


def _unflatten(like, leaves):
    """``like``'s structure with its leaves replaced, in flatten order,
    by ``leaves`` (each converted to the like leaf's kind)."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            vals = [build(v) for v in node]
            if isinstance(node, list):
                return vals
            return type(node)(*vals) if hasattr(node, "_fields") \
                else tuple(vals)
        if node is None:
            return None
        return _as_like(next(it), node)
    return build(like)


_VOID_DEFAULT = {2: torch.bfloat16, 1: torch.float8_e4m3fn}
_INT_OF_SIZE = {1: torch.int8, 2: torch.int16}


def _to_host(leaf):
    """A host numpy copy of ``leaf``: a void array of the same bytes for
    dtypes numpy lacks (bfloat16, float8)."""
    if isinstance(leaf, torch.Tensor):
        from torch.distributed.tensor import DTensor
        t = leaf.full_tensor() if isinstance(leaf, DTensor) else leaf
        t = t.detach()
        t = t.cpu() if t.is_cuda else t.clone()
        if t.dtype == torch.bfloat16 or (t.is_floating_point() and
                                         t.element_size() == 1):
            size = t.element_size()
            return t.view(_INT_OF_SIZE[size]).numpy().view(f"V{size}")
        return t.numpy()
    return np.array(leaf, copy=True)


def _void_to_torch(arr, dtype=None):
    size = arr.dtype.itemsize
    dtype = dtype or _VOID_DEFAULT[size]
    ints = torch.from_numpy(np.ascontiguousarray(arr).view(
        {1: np.int8, 2: np.int16}[size]))
    return ints.view(dtype)


def _as_torch(arr, dtype=None):
    """A numpy leaf as a CPU tensor (a void leaf as ``dtype`` or its
    default)."""
    if arr.dtype.kind == "V":
        return _void_to_torch(arr, dtype)
    t = torch.from_numpy(np.array(arr, copy=True))
    return t if dtype is None else t.to(dtype)


def _as_like(arr, like):
    """A restored numpy leaf in ``like``'s kind: a tensor of its dtype on
    its device, or a numpy array."""
    if isinstance(like, torch.Tensor):
        dev = like.device
        from torch.distributed.tensor import DTensor
        if isinstance(like, DTensor):
            dev = like.to_local().device
        return _as_torch(arr, like.dtype).to(dev)
    return arr


def tree_digest(tree):
    """crc32 over the leaf names and their host bytes in flatten order:
    two trees with the same digest hold the same bits."""
    names, leaves = _flatten_with_names(tree)
    crc = 0
    for name, leaf in zip(names, leaves):
        crc = zlib.crc32(name.encode(), crc)
        arr = np.ascontiguousarray(_to_host(leaf))
        crc = zlib.crc32(arr.view(np.uint8).reshape(-1).data
                         if arr.size else b"", crc)
    return crc


def _check_like(names, like):
    """Fail loud when ``like``'s structure does not match the saved
    checkpoint: rebuilding a changed model from mismatched leaves would
    silently scramble every weight past the first structural change."""
    like_names, _ = _flatten_with_names(like)
    if like_names == list(names):
        return
    saved, want = set(names), set(like_names)
    missing = sorted(want - saved)
    unexpected = sorted(saved - want)
    detail = []
    if missing:
        detail.append(f"leaves in `like` but not in the checkpoint: "
                      f"{missing[:5]}{'...' if len(missing) > 5 else ''}")
    if unexpected:
        detail.append(f"leaves in the checkpoint but not in `like`: "
                      f"{unexpected[:5]}{'...' if len(unexpected) > 5 else ''}")
    if not detail:
        detail.append("same leaf names in a different order "
                      "(tree structure changed)")
    raise CheckpointError(
        f"checkpoint/model structure mismatch: checkpoint has "
        f"{len(names)} leaves, `like` has {len(like_names)}; "
        + "; ".join(detail) +
        ". The model changed between save and resume — restore into the "
        "matching architecture, or pass like=None for a raw name->tensor "
        "dict.")


def _rebuild(names, leaves, like):
    if like is not None:
        _check_like(names, like)
        return _unflatten(like, leaves)
    return {n: _as_torch(a) for n, a in zip(names, leaves)}


# -- files ------------------------------------------------------------------


def _file_crc(path):
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _write_atomic(path, payload_writer):
    """Write via tmp + flush + fsync + rename: the file either exists
    complete or not at all."""
    tmp = f"{path}.tmp-{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            payload_writer(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise


def _fsync_dir(path):
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass  # directory fsync is best-effort (FS-dependent)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# format 1 (rank-0 full-tree npz)
# ---------------------------------------------------------------------------

def save(path, tree, step=0, force_all_processes=False):
    """Atomically save a tree checkpoint (format 1). Rank 0 writes; other
    ranks no-op unless ``force_all_processes``. Prefer
    ``CheckpointManager`` (async, sharded, checksummed, retained)."""
    from ..common import state as state_mod
    st = state_mod.global_state()
    if st.initialized and st.rank != 0 and not force_all_processes:
        return path
    names, leaves = _flatten_with_names(tree)
    tmp = tempfile.mkdtemp(prefix=".ckpt-tmp-",
                           dir=os.path.dirname(os.path.abspath(path)) or ".")
    try:
        arrays = {str(i): _to_host(leaf) for i, leaf in enumerate(leaves)}
        np.savez(os.path.join(tmp, _ARRAYS), **arrays)
        with open(os.path.join(tmp, _MANIFEST), "w") as f:
            json.dump({"step": int(step), "names": names,
                       "treedef": _treedef_str(tree), "n": len(leaves)}, f)
        # crash-safe overwrite: at every instant <path> or <path>.old
        # holds a complete checkpoint; restore() falls back to .old
        old = path + ".old"
        if os.path.isdir(old):
            shutil.rmtree(old)
        if os.path.isdir(path):
            os.replace(path, old)
        os.replace(tmp, path)
        shutil.rmtree(old, ignore_errors=True)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return path


def _treedef_str(tree):
    """An informational description of the structure (the JAX package
    writes its PyTreeDef's text here; nothing reads it back)."""
    def desc(node):
        if isinstance(node, dict):
            return "{" + ", ".join(f"{k!r}: {desc(node[k])}"
                                   for k in sorted(node)) + "}"
        if isinstance(node, (list, tuple)):
            inner = ", ".join(desc(v) for v in node)
            return f"[{inner}]" if isinstance(node, list) else f"({inner})"
        return "None" if node is None else "*"
    return f"PyTreeDef({desc(tree)})"


def _legacy_dir(path):
    """The directory holding a format-1 checkpoint: ``path``, or
    ``path + ".old"`` when a crash interrupted an overwrite; None when
    neither exists."""
    for p in (path, path + ".old"):
        if os.path.exists(os.path.join(p, _MANIFEST)) and \
                os.path.exists(os.path.join(p, _ARRAYS)):
            return p
    return None


def _restore_legacy(path, like):
    p = _legacy_dir(path)
    if p is None:
        raise FileNotFoundError(
            f"no checkpoint at {path!r} (no {_MANIFEST}, no committed "
            f"step-* directory, no .old fallback)")
    with open(os.path.join(p, _MANIFEST)) as f:
        manifest = json.load(f)
    with np.load(os.path.join(p, _ARRAYS)) as data:
        leaves = [data[str(i)] for i in range(manifest["n"])]
    return _rebuild(manifest["names"], leaves, like), manifest["step"]


# ---------------------------------------------------------------------------
# format 2: committed step directories
# ---------------------------------------------------------------------------

def _rank_npz(rank):
    return f"rank{rank:05d}.npz"


def _rank_json(rank):
    return f"rank{rank:05d}.json"


def _step_dir(path, step):
    return os.path.join(path, f"step-{step:010d}")


def _committed_steps(path):
    """{step: dir} for every step directory whose global manifest
    exists."""
    out = {}
    try:
        entries = os.listdir(path)
    except OSError:
        return out
    for name in entries:
        m = _STEP_DIR_RE.match(name)
        if not m:
            continue
        d = os.path.join(path, name)
        if os.path.exists(os.path.join(d, _MANIFEST)):
            out[int(m.group(1))] = d
    return out


def _read_global_manifest(d):
    try:
        with open(os.path.join(d, _MANIFEST)) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CorruptCheckpointError(
            f"unreadable checkpoint manifest in {d!r}: {e}") from e
    if manifest.get("format") != CHECKPOINT_FORMAT:
        raise CorruptCheckpointError(
            f"checkpoint {d!r} has format {manifest.get('format')!r}, "
            f"this build reads format {CHECKPOINT_FORMAT}")
    return manifest


def _verify_files(d, manifest):
    """Checksum every file the manifest lists; raise naming the first
    bad one."""
    for fname, meta in sorted(manifest.get("files", {}).items()):
        fpath = os.path.join(d, fname)
        if not os.path.exists(fpath):
            raise CorruptCheckpointError(
                f"checkpoint {d!r} is missing {fname!r} promised by its "
                f"manifest")
        size = os.path.getsize(fpath)
        if size != meta["bytes"]:
            raise CorruptCheckpointError(
                f"checkpoint file {fname!r} in {d!r} is {size} bytes, "
                f"manifest recorded {meta['bytes']}")
        crc = _file_crc(fpath)
        if crc != meta["crc"]:
            raise CorruptCheckpointError(
                f"checkpoint file {fname!r} in {d!r} fails its checksum "
                f"(crc32 {crc:#010x} != recorded {meta['crc']:#010x})")


def _restore_v2(path, steps, like, step, verify):
    if step is None:
        step = max(steps)
    elif step not in steps:
        raise FileNotFoundError(
            f"no committed checkpoint for step {step} under {path!r} "
            f"(committed steps: {sorted(steps)})")
    d = steps[step]
    reg = _registry()
    restores = reg.counter("hvd_ckpt_restores_total",
                           "Checkpoint restore attempts by outcome.",
                           labels=("outcome",))
    try:
        manifest = _read_global_manifest(d)
        if verify:
            _verify_files(d, manifest)
        n = manifest["n"]
        leaves = [None] * n
        # reshard: reassemble from however many rank shards the saving
        # world wrote; the restoring world's size plays no part
        for rm_name in manifest["ranks"]:
            with open(os.path.join(d, rm_name)) as f:
                rank_manifest = json.load(f)
            shard = os.path.join(d, rank_manifest["shard"])
            with np.load(shard) as data:
                for i in rank_manifest["indices"]:
                    leaves[i] = data[str(i)]
        missing = [i for i, v in enumerate(leaves) if v is None]
        if missing:
            raise CorruptCheckpointError(
                f"checkpoint {d!r} is incomplete: no rank shard owns "
                f"leaves {missing[:8]}{'...' if len(missing) > 8 else ''}")
    except CorruptCheckpointError:
        restores.labels(outcome="corrupt").inc()
        reg.event("ckpt_corrupt", step=int(step), dir=d)
        raise
    tree = _rebuild(manifest["names"], leaves, like)
    restores.labels(outcome="ok").inc()
    return tree, manifest["step"], manifest.get("extra") or {}


def restore(path, like=None, step=None, verify=None):
    """Load a checkpoint -> (tree, step), from either format.

    ``like`` gives the structure to rebuild into and is checked against
    the saved leaf names; without it a flat {name: tensor} dict is
    returned. Format 2 restores the newest committed step (or ``step=``),
    checksum-verified (``verify=False`` skips; default from
    HVD_CKPT_VERIFY). Format 1 falls back to <path>.old."""
    if verify is None:
        verify = env_bool("CKPT_VERIFY", True)
    steps = _committed_steps(path)
    if steps:
        tree, got_step, _extra = _restore_v2(path, steps, like, step, verify)
        return tree, got_step
    return _restore_legacy(path, like)


def restore_with_extra(path, like=None, step=None, verify=None):
    """Like ``restore`` but returns (tree, step, extra); ``extra`` is the
    JSON dict saved alongside (data position, ...), empty for format 1."""
    if verify is None:
        verify = env_bool("CKPT_VERIFY", True)
    steps = _committed_steps(path)
    if steps:
        return _restore_v2(path, steps, like, step, verify)
    tree, got_step = _restore_legacy(path, like)
    return tree, got_step, {}


def saved_layout(path, step=None):
    """The mesh layout ({axis: size}) the checkpoint was saved under, or
    None (format 1, or saved without one). Informational: shards hold
    whole leaves, so any layout restores any checkpoint."""
    steps = _committed_steps(path)
    if not steps:
        return None
    if step is None:
        step = max(steps)
    elif step not in steps:
        return None
    return _read_global_manifest(steps[step]).get("layout")


def restore_on_mesh(path, like, spec_tree, mesh=None, step=None,
                    verify=None):
    """Cross-layout restore: a checkpoint saved under any mesh layout,
    every leaf placed on the restoring mesh (the global mesh when
    ``mesh`` is None) by ``spec_tree`` as a DTensor -> (tree, step,
    extra). ``like`` and ``spec_tree`` are nested dicts of the same
    shape. Bit-exact whatever the saving layout: shards hold whole
    leaves, only the placement changes."""
    from ..parallel import mesh as mesh_lib
    tree, got_step, extra = restore_with_extra(path, like=like, step=step,
                                               verify=verify)
    return mesh_lib.device_put_tree(tree, spec_tree, mesh), got_step, extra


def exists(path):
    return bool(_committed_steps(path)) or _legacy_dir(path) is not None


def latest_step(path):
    """Newest durable step under ``path`` (either format), or None."""
    steps = _committed_steps(path)
    if steps:
        return max(steps)
    p = _legacy_dir(path)
    if p is None:
        return None
    with open(os.path.join(p, _MANIFEST)) as f:
        return json.load(f)["step"]


# ---------------------------------------------------------------------------
# publication pointer (the fleet plane's watch primitive)
# ---------------------------------------------------------------------------
#
# A top-level <path>/manifest.json holding a copy of the newest committed
# step's global manifest plus {"generation", "dir"}. The fleet plane's
# WeightPublisher writes it through _write_atomic AFTER the step commit and
# BEFORE retention GC runs, so by the time an old step directory can
# vanish the pointer already names its replacement. Pollers stat and read
# ONE file instead of scanning the directory. It is never taken for a
# format-1 checkpoint: _legacy_dir also requires the arrays file.

def manifest_signature(path):
    """Cheap change detector for ``latest_manifest`` polling: one stat
    of the publication pointer -> (mtime_ns, size), or None when no
    pointer exists. Atomic rename replaces the inode, so any republish
    changes the signature even when sizes collide."""
    try:
        st = os.stat(os.path.join(path, _MANIFEST))
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size)


def write_pointer(path, pointer):
    """Atomically publish ``pointer`` (a global manifest dict extended
    with generation/dir) as <path>/manifest.json."""
    payload = json.dumps(pointer).encode()
    _write_atomic(os.path.join(path, _MANIFEST),
                  lambda f: f.write(payload))
    _fsync_dir(path)


def latest_manifest(path, retries=3):
    """Newest committed global manifest under ``path`` without a
    directory scan -> (step, step_dir, manifest) or None.

    Fast path: read the publication pointer (one file). Fallback for
    directories no publisher ever touched, and for a stale pointer (one
    naming a step GC already removed, possible only if the publisher
    died between commit and publish): the ``_committed_steps`` scan,
    retried when GC unlinks a manifest between the listdir and the
    read."""
    doc = None
    try:
        with open(os.path.join(path, _MANIFEST)) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        # absent, or torn by a crash before _write_atomic: as absent
        doc = None
    if isinstance(doc, dict) and doc.get("format") == CHECKPOINT_FORMAT \
            and "dir" in doc:
        d = os.path.join(path, str(doc["dir"]))
        if os.path.exists(os.path.join(d, _MANIFEST)):
            return int(doc["step"]), d, doc
    elif isinstance(doc, dict) and "dir" not in doc:
        return None  # a format-1 checkpoint lives AT path: no steps
    for _ in range(max(1, int(retries))):
        steps = _committed_steps(path)
        if not steps:
            return None
        step = max(steps)
        d = steps[step]
        try:
            return step, d, _read_global_manifest(d)
        except CorruptCheckpointError as e:
            if isinstance(e.__cause__, FileNotFoundError):
                continue  # GC won the race for this step; rescan
            raise
    return None


# ---------------------------------------------------------------------------
# the checkpoint plane
# ---------------------------------------------------------------------------

class CheckpointManager:
    """Async, sharded, checksummed, retained checkpoints (format 2).

    One instance per process. ``save()`` blocks only for the host
    snapshot; serialization, fsync and the commit rename run on a
    writer thread. ``rank``/``world_size`` describe the saving job:
    every rank writes its round-robin leaf shard, rank 0 commits the
    global manifest last. ``stats`` holds the newest save's blocking
    and whole times and the counts of saves, dropped snapshots and
    collected directories."""

    def __init__(self, directory, rank=0, world_size=1, keep=None,
                 async_save=None, shard=None, commit_timeout_s=120.0,
                 on_commit=None, layout=None):
        self.directory = directory
        self.layout = ({str(k): int(v) for k, v in dict(layout).items()}
                       if layout else None)
        # rank-0 post-commit hook: on_commit(step, step_dir, manifest)
        # runs on the writer thread after the manifest rename and before
        # retention GC
        self.on_commit = on_commit
        self.rank = int(rank)
        self.world_size = max(1, int(world_size))
        self.keep = env_int("CKPT_KEEP", 3) if keep is None else int(keep)
        self.async_save = (env_bool("CKPT_ASYNC", True)
                           if async_save is None else bool(async_save))
        # sharding is pointless at world 1; on by default otherwise
        self.shard = ((self.world_size > 1)
                      if shard is None else bool(shard)) and \
            self.world_size > 1
        self.commit_timeout_s = commit_timeout_s
        os.makedirs(directory, exist_ok=True)
        self.stats = {"saves": 0, "dropped": 0, "gc": 0, "bytes": 0,
                      "block_s": None, "save_s": None}
        self._cv = threading.Condition()
        self._pending = None  # guarded_by: _cv; latest queued snapshot
        self._busy = False    # guarded_by: _cv
        self._error = None    # guarded_by: _cv
        self._thread = None   # guarded_by: _cv
        self._closed = False  # guarded_by: _cv

    # -- instruments (looked up per use, so HVD_METRICS=0 stays free) --

    def _instruments(self):
        reg = _registry()
        return {
            "saves": reg.counter(
                "hvd_ckpt_saves_total",
                "Committed checkpoint saves by kind "
                "(async/sync/emergency).", labels=("kind",)),
            "bytes": reg.counter(
                "hvd_ckpt_bytes_total",
                "Bytes of checkpoint shard data written by this rank."),
            "save_s": reg.histogram(
                "hvd_ckpt_save_seconds",
                "Wall time of one background checkpoint write "
                "(serialize + fsync + commit)."),
            "block_s": reg.histogram(
                "hvd_ckpt_block_seconds",
                "Time the TRAIN LOOP was blocked per save() call (the "
                "host snapshot; the async contract keeps this tiny)."),
            "last_step": reg.gauge(
                "hvd_ckpt_last_step",
                "Step of the newest checkpoint committed by this rank."),
            "last_ts": reg.gauge(
                "hvd_ckpt_last_save_ts_seconds",
                "Epoch seconds of the newest committed checkpoint "
                "(dashboards render now - this as last-save age)."),
            "dropped": reg.counter(
                "hvd_ckpt_dropped_snapshots_total",
                "Snapshots superseded in the latest-wins write buffer "
                "before reaching disk (writer slower than cadence)."),
            "gc": reg.counter(
                "hvd_ckpt_gc_total",
                "Checkpoint directories removed by retention GC."),
        }

    # -- public API ----------------------------------------------------

    def save(self, tree, step, extra=None, block=False, kind=None):
        """Snapshot ``tree`` at ``step`` and make it durable.

        Blocking cost to the caller: one host copy of the leaves (plus,
        with ``block=True`` or ``async_save=False``, the whole write).
        ``extra`` is a small JSON-able dict carried in the manifest.
        Returns the committed directory for synchronous saves, None for
        queued ones."""
        self._raise_if_failed()
        with self._cv:
            if self._closed:
                raise CheckpointError("CheckpointManager is closed")
        t0 = time.perf_counter()
        names, leaves = _flatten_with_names(tree)
        # host copies NOW, at the step boundary: the step loop may
        # overwrite the live tensors the moment save() returns
        arrays = [_to_host(leaf) for leaf in leaves]
        self.stats["block_s"] = time.perf_counter() - t0
        self._instruments()["block_s"].observe(self.stats["block_s"])
        job = (int(step), names, arrays,
               dict(extra) if extra else {},
               kind or ("sync" if (block or not self.async_save)
                        else "async"),
               self.layout)
        if block or not self.async_save:
            # drain queued/in-flight writes first so that commits stay
            # step-ordered (an emergency save lands newest-last)
            self.wait()
            return self._write(*job)
        with self._cv:
            if self._pending is not None:
                self.stats["dropped"] += 1
                self._instruments()["dropped"].inc()
            self._pending = job
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._writer_loop, name="hvd-ckpt-writer",
                    daemon=True)
                self._thread.start()
            self._cv.notify_all()
        return None

    def wait(self, timeout=None):
        """Drain queued and in-flight writes; re-raise writer errors."""
        with self._cv:
            done = self._cv.wait_for(
                lambda: self._pending is None and not self._busy,
                timeout)
        self._raise_if_failed()
        if not done:
            raise CheckpointError(
                f"checkpoint writer did not drain within {timeout}s")

    def restore(self, like=None, step=None, verify=None, mesh=None,
                spec_tree=None):
        """(tree, step, extra) from the newest committed checkpoint
        (either format). With ``spec_tree`` every leaf is placed on the
        mesh (``restore_on_mesh``)."""
        if spec_tree is not None:
            return restore_on_mesh(self.directory, like, spec_tree,
                                   mesh=mesh, step=step, verify=verify)
        return restore_with_extra(self.directory, like=like, step=step,
                                  verify=verify)

    def exists(self):
        return exists(self.directory)

    def latest_step(self):
        return latest_step(self.directory)

    def close(self):
        """Drain and stop the writer. Idempotent."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
            thread, self._thread = self._thread, None
        if thread is not None:
            thread.join(timeout=self.commit_timeout_s)
        self._raise_if_failed()

    # -- writer --------------------------------------------------------

    def _raise_if_failed(self):
        with self._cv:
            err, self._error = self._error, None
        if err is not None:
            raise CheckpointError(
                f"background checkpoint write failed: {err!r}") from err

    def _writer_loop(self):
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None:
                    return  # closed and drained
                job, self._pending = self._pending, None
                self._busy = True
            try:
                self._write(*job)
            except BaseException as e:  # noqa: BLE001 — re-raised on the
                # train loop's next save/wait/close, the only thread that
                # can stop the job
                with self._cv:
                    self._error = e
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def _owned_indices(self, n):
        if not self.shard:
            return list(range(n)) if self.rank == 0 else []
        return list(range(self.rank, n, self.world_size))

    def _write(self, step, names, arrays, extra, kind, layout=None):
        t0 = time.perf_counter()
        d = _step_dir(self.directory, step)
        os.makedirs(d, exist_ok=True)
        n = len(names)
        own = self._owned_indices(n)
        _failpoint("pre_shard")
        shard_name = _rank_npz(self.rank)
        shard_path = os.path.join(d, shard_name)
        _write_atomic(shard_path, lambda f: np.savez(
            f, **{str(i): arrays[i] for i in own}))
        _failpoint("post_shard")
        shard_bytes = os.path.getsize(shard_path)
        rank_manifest = {
            "format": CHECKPOINT_FORMAT, "step": step, "rank": self.rank,
            "world_size": self.world_size, "indices": own,
            "shard": shard_name, "crc": _file_crc(shard_path),
            "bytes": shard_bytes,
        }
        _failpoint("pre_rank_manifest")
        payload = json.dumps(rank_manifest).encode()
        _write_atomic(os.path.join(d, _rank_json(self.rank)),
                      lambda f: f.write(payload))
        _failpoint("post_rank_manifest")
        self.stats["bytes"] += shard_bytes
        ins = self._instruments()
        ins["bytes"].inc(shard_bytes)
        if self.rank != 0:
            self.stats["saves"] += 1
            self.stats["save_s"] = time.perf_counter() - t0
            ins["saves"].labels(kind=kind).inc()
            ins["save_s"].observe(self.stats["save_s"])
            ins["last_step"].set(step)
            ins["last_ts"].set(_epoch_seconds())
            return d
        # -- rank 0: gather rank manifests, then commit ---------------
        rank_manifests = self._await_rank_manifests(d, step)
        files = {}
        for rm_name, rm in rank_manifests.items():
            files[rm["shard"]] = {"crc": rm["crc"], "bytes": rm["bytes"]}
            rm_path = os.path.join(d, rm_name)
            files[rm_name] = {"crc": _file_crc(rm_path),
                              "bytes": os.path.getsize(rm_path)}
        manifest = {
            "format": CHECKPOINT_FORMAT, "step": step,
            "world_size": self.world_size, "n": n, "names": names,
            "extra": extra, "ranks": sorted(rank_manifests),
            "files": files,
        }
        if layout is not None:
            manifest["layout"] = layout
        _failpoint("pre_commit")
        mpayload = json.dumps(manifest).encode()
        tmp = os.path.join(d, f"{_MANIFEST}.tmp-{os.getpid()}")
        with open(tmp, "wb") as f:
            f.write(mpayload)
            f.flush()
            os.fsync(f.fileno())
        _failpoint("mid_commit")
        os.replace(tmp, os.path.join(d, _MANIFEST))  # THE commit point
        _fsync_dir(d)
        _failpoint("post_commit")
        self.stats["saves"] += 1
        self.stats["save_s"] = dt = time.perf_counter() - t0
        ins["saves"].labels(kind=kind).inc()
        ins["save_s"].observe(dt)
        ins["last_step"].set(step)
        ins["last_ts"].set(_epoch_seconds())
        _registry().event("ckpt_commit", step=step, save_kind=kind,
                          bytes=sum(m["bytes"] for m in files.values()),
                          ms=round(dt * 1e3, 3))
        if self.on_commit is not None:
            self.on_commit(step, d, manifest)
        self._gc()
        return d

    def _await_rank_manifests(self, d, step):
        """Rank 0's commit barrier: every rank's manifest must exist and
        describe this step before the global manifest may commit."""
        deadline = time.monotonic() + self.commit_timeout_s
        wanted = {_rank_json(r) for r in range(self.world_size)}
        out = {}
        while True:
            for rm_name in sorted(wanted - set(out)):
                p = os.path.join(d, rm_name)
                if not os.path.exists(p):
                    continue
                with open(p) as f:
                    rm = json.load(f)
                if rm["step"] != step or \
                        rm["world_size"] != self.world_size:
                    raise CheckpointError(
                        f"rank manifest {rm_name} in {d!r} describes "
                        f"step {rm['step']} world {rm['world_size']}, "
                        f"expected step {step} world {self.world_size} "
                        f"— two jobs are writing the same checkpoint "
                        f"directory")
                out[rm_name] = rm
            if len(out) == self.world_size:
                return out
            if time.monotonic() > deadline:
                raise CheckpointError(
                    f"checkpoint commit timed out after "
                    f"{self.commit_timeout_s}s: rank manifests "
                    f"{sorted(wanted - set(out))} never appeared in "
                    f"{d!r} (a peer rank died mid-save; this partial "
                    f"checkpoint stays uncommitted and will be GC'd)")
            time.sleep(0.02)

    def _gc(self):
        """Keep the newest ``keep`` commits; drop older commits and any
        uncommitted partial older than the newest commit (a partial newer
        than it may be a save in flight)."""
        committed = _committed_steps(self.directory)
        if not committed:
            return
        newest = max(committed)
        doomed = sorted(committed)[:-self.keep] if self.keep > 0 else []
        gc = self._instruments()["gc"]
        for step in doomed:
            shutil.rmtree(committed[step], ignore_errors=True)
            self.stats["gc"] += 1
            gc.inc()
        try:
            entries = os.listdir(self.directory)
        except OSError:
            return
        for name in entries:
            m = _STEP_DIR_RE.match(name)
            if not m:
                continue
            step = int(m.group(1))
            if step in committed or step >= newest:
                continue
            shutil.rmtree(os.path.join(self.directory, name),
                          ignore_errors=True)
            self.stats["gc"] += 1
            gc.inc()
