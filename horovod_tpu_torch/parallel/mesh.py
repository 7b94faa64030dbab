"""Device-mesh construction for every parallelism strategy, port of
``horovod_tpu/parallel/mesh.py``.

All strategies are axes of one named mesh of ranks (one rank per card):

  dp  — data parallel (gradient allreduce; the Horovod axis)
  pp  — pipeline parallel (stage dimension)
  tp  — tensor/model parallel (weight shards; activation collectives)
  sp  — sequence/context parallel (ring attention / all-to-all)
  ep  — expert parallel (MoE dispatch)

The leading axis varies slowest over the ranks. ``Mesh`` is the port's
counterpart of ``jax.sharding.Mesh``: its layout (``shape``,
``axis_names``, the rank array ``devices``) is plain data, and its
``device_mesh`` is a ``torch.distributed.device_mesh.DeviceMesh`` over the
same ranks, built at first use, which gives each axis its process group.
A ``PartitionSpec`` (``P``, the port's own small tuple) places a tensor on
the mesh as a DTensor: a dim named by an axis is ``Shard``ed over it, every
other axis ``Replicate``s.

``comm(axis)`` gives an axis's group object (``parallel.ring``), which the
tensor-parallel layers, the ring collectives and the hierarchical
allreduce run over. ``thread_meshes`` gives each rank of a mesh whose ranks
are threads of one process (sharing one card, where NCCL refuses two
ranks on one device) a view of its own, ``ThreadMesh``, whose axes are
``ThreadRing``s; ``use_mesh`` makes a view the global mesh of the thread
that drives that rank. The two-level ``("slices", "chips")`` mesh of the
hierarchical allreduce is ``build_hierarchical_mesh``, laid over the
hosts by ``infer_slice_structure``.
"""

import contextlib
import os
import threading

import numpy as np
import torch
import torch.distributed as dist

AXES = ("dp", "pp", "tp", "sp", "ep")

# The process-global named mesh. One mesh per process, fixed for the life
# of the run; a layout change is a restart. Guarded by a lock only for the
# installation race; readers see a committed mesh or None.
_GLOBAL_LOCK = threading.Lock()
_GLOBAL_MESH = None
# A thread's own global mesh (``use_mesh``): a rank that is a thread of
# this process sees its view of the mesh, never another rank's.
_THREAD = threading.local()
# The ("slices", "chips") mesh of every rank, one slice per host, built at
# first use by ``hierarchy_mesh`` when the global mesh has no such axes.
_WORLD_HIERARCHY = None


class P(tuple):
    """A PartitionSpec: one entry per tensor dim, each None (not split),
    an axis name, or a tuple of axis names (split over their product,
    the first the slowest). Trailing dims not named are not split."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Mesh:
    """Ranks laid out on named axes: ``devices`` is the rank array of shape
    ``[size of each axis]``, ``shape`` maps axis name to size in axis
    order (as ``jax.sharding.Mesh.shape``). ``device_type`` ("cuda" or
    "cpu") names the devices the ranks drive; the process group is needed
    only by ``device_mesh`` and what uses it."""

    def __init__(self, devices, axis_names, device_type=None):
        self.devices = np.asarray(devices)
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError(f"mesh of shape {self.devices.shape} needs "
                             f"{self.devices.ndim} axis names, got "
                             f"{self.axis_names}")
        self.device_type = device_type
        self._device_mesh = None
        self._lock = threading.Lock()

    @property
    def shape(self):
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self):
        return int(self.devices.size)

    def __repr__(self):
        return f"Mesh({self.shape})"

    @property
    def device_mesh(self):
        """The ``DeviceMesh`` over these ranks, with one process group per
        axis; built at first use (a collective call on every rank)."""
        with self._lock:
            if self._device_mesh is None:
                from torch.distributed.device_mesh import DeviceMesh
                self._device_mesh = DeviceMesh(
                    self.device_type or _device_type(),
                    torch.as_tensor(self.devices),
                    mesh_dim_names=self.axis_names)
            return self._device_mesh

    def group(self, axis):
        """This rank's process group along ``axis``."""
        return self.device_mesh.get_group(axis)

    def coordinate(self, axis, rank=None):
        """Where ``rank`` (this process's by default) sits along ``axis``."""
        rank = dist.get_rank() if rank is None else rank
        where = np.argwhere(self.devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return int(where[0][self.axis_names.index(axis)])

    def comm(self, axis):
        """The group object (``parallel.ring.GroupRing``) of this rank's
        process group along ``axis``."""
        from .ring import GroupRing
        return GroupRing(self.group(axis))

    def world_comm(self):
        """The group object of every rank of the mesh, which spans the
        process group's world."""
        from .ring import GroupRing
        if self.size != dist.get_world_size():
            raise ValueError(f"{self} does not span the world of "
                             f"{dist.get_world_size()} ranks")
        return GroupRing(None)


class ThreadMesh(Mesh):
    """Rank ``rank``'s view of a mesh whose ranks are threads of this
    process: each axis is the ``ThreadRing`` of the ranks that share this
    rank's other coordinates (``thread_meshes`` builds them). There is no
    DeviceMesh and no DTensor: a rank holds plain shards."""

    def __init__(self, devices, axis_names, rank, comms, world,
                 device_type=None):
        super().__init__(devices, axis_names, device_type)
        self.rank = rank
        self._comms = comms
        self._world = world

    def __repr__(self):
        return f"ThreadMesh({self.shape}, rank={self.rank})"

    @property
    def device_mesh(self):
        raise RuntimeError("ranks that are threads of one process have no "
                           "DeviceMesh; place plain shards (local_slice)")

    def comm(self, axis):
        return self._comms[axis]

    def world_comm(self):
        return self._world

    def coordinate(self, axis, rank=None):
        return super().coordinate(axis, self.rank if rank is None else rank)


def thread_meshes(mesh):
    """Per-rank views of ``mesh`` (ranks 0..n-1) for ranks that are threads
    of this process: element r is rank r's ``ThreadMesh``, which rank r's
    thread uses (``use_mesh``)."""
    from .ring import ThreadRing
    devices = np.asarray(mesh.devices)
    n = devices.size
    if sorted(devices.ravel().tolist()) != list(range(n)):
        raise ValueError(f"thread ranks are 0..{n - 1}, got {devices}")
    comms = [{} for _ in range(n)]
    for i, axis in enumerate(mesh.axis_names):
        lines = np.moveaxis(devices, i, -1).reshape(-1, devices.shape[i])
        for line in lines:
            ring = ThreadRing(len(line))
            for pos, r in enumerate(line):
                comms[int(r)][axis] = ring.rank(pos)
    world = ThreadRing(n)
    return [ThreadMesh(devices, mesh.axis_names, r, comms[r], world.rank(r),
                       mesh.device_type) for r in range(n)]


@contextlib.contextmanager
def use_mesh(mesh):
    """Within the block, ``mesh`` is this thread's global mesh (what
    ``global_mesh`` and ``global_mesh_if_set`` return on this thread): a
    thread rank's ``ThreadMesh`` for its thread."""
    prev = getattr(_THREAD, "mesh", None)
    _THREAD.mesh = mesh
    try:
        yield mesh
    finally:
        _THREAD.mesh = prev


def _device_type():
    """The device type of this process's ranks: the initialized port's
    device, else what the process group's backend drives."""
    from ..common import state
    if state.is_initialized():
        return state.device().type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _world_ranks():
    return list(range(dist.get_world_size() if dist.is_initialized() else 1))


def build_mesh(dp=None, pp=1, tp=1, sp=1, ep=1, devices=None,
               axis_order=AXES):
    """Build a 5-axis mesh; unknown ``dp`` is inferred from the rank count.

    ``devices`` are the ranks to lay out (every rank of the process group
    by default). Size-1 axes are kept so code can be written against the
    full axis set regardless of the actual factorization (collectives
    over a size-1 axis are free)."""
    if devices is None:
        devices = _world_ranks()
    n = len(devices)
    sizes = {"pp": pp, "tp": tp, "sp": sp, "ep": ep}
    explicit = pp * tp * sp * ep
    if dp is None:
        if n % explicit != 0:
            raise ValueError(
                f"{n} devices not divisible by pp*tp*sp*ep={explicit}")
        dp = n // explicit
    sizes["dp"] = dp
    total = dp * explicit
    if total != n:
        raise ValueError(
            f"Mesh {sizes} needs {total} devices, have {n}")
    shape = tuple(sizes[a] for a in axis_order)
    return Mesh(np.asarray(devices).reshape(shape), axis_order)


def build_hierarchical_mesh(num_slices, devices=None,
                            axis_names=("slices", "chips")):
    """Two-level mesh: inter-slice x intra-slice, the ranks ``devices``
    (every rank by default) in ``num_slices`` rows.

    The analogue of the reference's LOCAL/CROSS communicator split:
    ``chips`` is the fast axis within a host (NVLink), ``slices`` the slow
    one across hosts. Used by the hierarchical allreduce
    (``parallel/hierarchical.py``)."""
    if devices is None:
        devices = _world_ranks()
    n = len(devices)
    if n % num_slices != 0:
        raise ValueError(f"{n} devices not divisible into {num_slices} slices")
    arr = np.asarray(devices).reshape(num_slices, n // num_slices)
    return Mesh(arr, axis_names)


def infer_slice_structure(devices=None):
    """Group the ranks ``devices`` (every rank by default) by host, the
    ranks of one host being ``local_size`` consecutive ranks (the node of
    ``rank // local_size``), so the hierarchical path can lay the slow
    axis across hosts. A single slice when the port is not initialized or
    every rank is on one host: the TPU groups by slice, a GPU cluster by
    host."""
    from ..common import state
    if devices is None:
        devices = _world_ranks()
    local = state.local_size() if state.is_initialized() else len(devices)
    groups = {}
    for r in devices:
        groups.setdefault(int(r) // max(local, 1), []).append(r)
    return [groups[k] for k in sorted(groups)]


def hierarchy_mesh():
    """The ("slices", "chips") mesh the hierarchical allreduce runs over:
    the global mesh when it has both axes, else the world's, one slice per
    host (``infer_slice_structure``), built at first use and kept until
    ``reset_global_mesh``."""
    global _WORLD_HIERARCHY
    mesh = global_mesh_if_set()
    if mesh is not None and {"slices", "chips"} <= set(mesh.axis_names):
        return mesh
    with _GLOBAL_LOCK:
        if _WORLD_HIERARCHY is None:
            _WORLD_HIERARCHY = build_hierarchical_mesh(
                len(infer_slice_structure()))
        return _WORLD_HIERARCHY


def mesh_axis_size(mesh, name):
    return mesh.shape[name] if name in mesh.shape else 1


def parse_mesh_spec(spec):
    """Parse a ``HOROVOD_MESH`` spec string into an axis-size dict.

    Grammar: comma-separated ``axis=size`` pairs over the named axes
    (``"dp=2,tp=4"``). ``dp`` may be omitted — ``build_mesh`` infers it
    from the device count. Unknown axes and non-positive sizes fail loud
    (a silent typo here would train on the wrong layout).
    """
    sizes = {}
    for part in str(spec).split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(
                f"HOROVOD_MESH entry {part!r} is not axis=size (axes: {AXES})")
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in AXES:
            raise ValueError(
                f"HOROVOD_MESH axis {name!r} unknown (axes: {AXES})")
        if name in sizes:
            raise ValueError(f"HOROVOD_MESH axis {name!r} given twice")
        try:
            size = int(val)
        except ValueError:
            raise ValueError(
                f"HOROVOD_MESH size for {name!r} is not an int: {val!r}")
        if size < 1:
            raise ValueError(f"HOROVOD_MESH size for {name!r} must be >= 1")
        sizes[name] = size
    return sizes


def mesh_from_env(devices=None, environ=None):
    """Build the data-plane mesh from the environment knobs.

    ``HOROVOD_MESH`` (full ``axis=size`` spec) wins; otherwise the
    per-axis integer knobs ``HOROVOD_MESH_TP`` / ``HOROVOD_MESH_SP`` /
    ``HOROVOD_MESH_PP`` / ``HOROVOD_MESH_EP`` fill in and ``dp`` absorbs
    the remaining devices. With nothing set this is the pure-dp mesh.
    """
    env = os.environ if environ is None else environ
    spec = env.get("HOROVOD_MESH", "")
    if spec:
        sizes = parse_mesh_spec(spec)
    else:
        sizes = {}
        for axis, var in (("tp", "HOROVOD_MESH_TP"), ("sp", "HOROVOD_MESH_SP"),
                          ("pp", "HOROVOD_MESH_PP"), ("ep", "HOROVOD_MESH_EP")):
            raw = env.get(var, "")
            if raw:
                sizes[axis] = int(raw)
    return build_mesh(dp=sizes.get("dp"),
                      pp=sizes.get("pp", 1), tp=sizes.get("tp", 1),
                      sp=sizes.get("sp", 1), ep=sizes.get("ep", 1),
                      devices=devices)


def set_global_mesh(mesh):
    """Install ``mesh`` as the process-global data-plane mesh.

    Idempotent for the same mesh; replacing a different committed mesh is
    an error — tensors already placed on the old mesh would silently
    disagree with the new layout. Tests use ``reset_global_mesh()``
    between layouts.
    """
    global _GLOBAL_MESH
    with _GLOBAL_LOCK:
        if _GLOBAL_MESH is not None and _GLOBAL_MESH is not mesh \
                and dict(_GLOBAL_MESH.shape) != dict(mesh.shape):
            raise RuntimeError(
                f"global mesh already set to {dict(_GLOBAL_MESH.shape)}; "
                f"refusing to replace with {dict(mesh.shape)} "
                "(reset_global_mesh() first)")
        _GLOBAL_MESH = mesh
    return mesh


def global_mesh(devices=None):
    """The process-global mesh, lazily built from the env knobs (this
    thread's ``use_mesh`` mesh first).

    First call wins: it builds from ``HOROVOD_MESH`` (or the per-axis
    knobs) over ``devices`` and installs the result; later calls return
    the committed mesh regardless of env changes.
    """
    mine = getattr(_THREAD, "mesh", None)
    if mine is not None:
        return mine
    with _GLOBAL_LOCK:
        if _GLOBAL_MESH is not None:
            return _GLOBAL_MESH
    return set_global_mesh(mesh_from_env(devices=devices))


def global_mesh_if_set():
    """This thread's ``use_mesh`` mesh, else the committed global mesh, or
    None — never triggers a lazy build."""
    mine = getattr(_THREAD, "mesh", None)
    return mine if mine is not None else _GLOBAL_MESH


def reset_global_mesh():
    """Drop the committed global mesh and the world's hierarchy (test
    isolation between layouts)."""
    global _GLOBAL_MESH, _WORLD_HIERARCHY
    with _GLOBAL_LOCK:
        _GLOBAL_MESH = None
        _WORLD_HIERARCHY = None


def _resolve(mesh):
    return global_mesh() if mesh is None else mesh


def axis_size(name, mesh=None):
    return mesh_axis_size(_resolve(mesh), name)


def mesh_layout(mesh=None):
    """Plain ``{axis: size}`` dict — the form checkpoint manifests record."""
    return {a: int(s) for a, s in _resolve(mesh).shape.items()}


def _names(part):
    if part is None:
        return ()
    return tuple(part) if isinstance(part, (tuple, list)) else (part,)


def spec_shard_shape(shape, spec, mesh=None):
    """Per-rank shard shape of ``shape`` under a PartitionSpec — pure
    axis-size math, no tensors placed. Indivisible dims stay whole
    (replicate, don't rag)."""
    if spec is None:
        return tuple(shape)
    sizes = mesh_layout(mesh) if not isinstance(mesh, dict) else mesh
    entries = tuple(spec)
    out = []
    for i, dim in enumerate(shape):
        part = entries[i] if i < len(entries) else None
        if part is None:
            out.append(dim)
            continue
        div = 1
        for name in _names(part):
            div *= int(sizes.get(name, 1))
        out.append(dim // div if div and dim % div == 0 else dim)
    return tuple(out)


class NamedSharding:
    """A PartitionSpec on a mesh: the DTensor placements it stands for
    (one per mesh axis: ``Shard(dim)`` where the spec names the axis,
    else ``Replicate()``), and the slicing of a whole tensor into this
    rank's shard."""

    def __init__(self, mesh, spec):
        self.mesh = mesh
        self.spec = P(*spec) if spec is not None else P()
        seen = [n for part in self.spec for n in _names(part)]
        unknown = set(seen) - set(mesh.axis_names)
        if unknown or len(seen) != len(set(seen)):
            raise ValueError(f"spec {self.spec} does not fit the mesh axes "
                             f"{mesh.axis_names}")

    def __repr__(self):
        return f"NamedSharding({self.mesh.shape}, {self.spec})"

    def placements(self):
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dims = [i for i, part in enumerate(self.spec)
                    if axis in _names(part)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def shard_shape(self, shape):
        return spec_shard_shape(shape, self.spec, self.mesh.shape)

    def local_slice(self, tensor, rank=None):
        """This rank's shard of the whole ``tensor``; a named dim must
        divide by its axes' size."""
        out = tensor
        for i, part in enumerate(self.spec):
            names = _names(part)
            if not names:
                continue
            n, idx = 1, 0
            for name in names:   # the first name the slowest
                size = self.mesh.shape[name]
                n, idx = n * size, idx * size + self.mesh.coordinate(name,
                                                                     rank)
            if tensor.shape[i] % n:
                raise ValueError(
                    f"dim {i} of {tuple(tensor.shape)} does not divide over "
                    f"{names} of size {n} (spec {self.spec})")
            step = tensor.shape[i] // n
            out = out.narrow(i, idx * step, step)
        return out

    def wrap(self, local, shape):
        """This rank's shard ``local`` of a whole tensor of ``shape``, as a
        DTensor; no communication."""
        from torch.distributed.tensor import DTensor
        stride = torch.empty(shape, device="meta").stride()
        return DTensor.from_local(local, self.mesh.device_mesh,
                                  self.placements(), run_check=False,
                                  shape=torch.Size(shape), stride=stride)

    def place(self, tensor):
        """``tensor`` (whole, the same on every rank) as a DTensor holding
        this rank's shard; no communication."""
        return self.wrap(self.local_slice(tensor.detach()).contiguous(),
                         tensor.shape)


def named_sharding(spec, mesh=None):
    """The one sanctioned ``NamedSharding`` constructor: every placement
    of the trainer goes through here (or the tree-wide wrappers below), so
    the whole data plane shares one mesh contract."""
    return NamedSharding(_resolve(mesh), spec)


def tree_shardings(spec_tree, mesh=None):
    """Map a PartitionSpec tree (a dict, possibly nested) to a matching
    NamedSharding tree."""
    mesh = _resolve(mesh)
    if isinstance(spec_tree, dict):
        return {k: tree_shardings(v, mesh) for k, v in spec_tree.items()}
    return named_sharding(spec_tree, mesh)


def device_put_tree(tree, spec_tree, mesh=None):
    """Place every tensor of ``tree`` (a dict of whole tensors, the same on
    every rank) on the mesh as a DTensor by the matching leaf of
    ``spec_tree``."""
    shardings = tree_shardings(spec_tree, mesh)

    def put(t, s):
        if isinstance(t, dict):
            return {k: put(t[k], s[k]) for k in t}
        return s.place(t)
    return put(tree, shardings)


def replicate_tree(tree, mesh=None):
    """Place every tensor fully replicated (spec ``P()``) on the mesh."""
    def specs(t):
        return {k: specs(v) for k, v in t.items()} if isinstance(t, dict) \
            else P()
    return device_put_tree(tree, specs(tree), mesh)


def kv_cache_spec(num_heads, mesh=None):
    """PartitionSpec for the serving KV cache ``[layers, slots, len,
    heads, head_dim]``: heads sharded over tp when tp divides them,
    replicated otherwise."""
    mesh = _resolve(mesh)
    tp = mesh_axis_size(mesh, "tp")
    if tp > 1 and num_heads % tp == 0:
        return P(None, None, None, "tp", None)
    return P()


class HeadSharding(NamedSharding):
    """``P(None, None, "tp", None)`` over ``[batch, s, heads, head_dim]``
    activations of ``num_heads`` heads: what ``decode_attention`` holds
    this rank's q, k and v to."""

    def __init__(self, mesh, num_heads):
        super().__init__(mesh, P(None, None, "tp", None))
        self.num_heads = num_heads

    def local_heads(self):
        return self.shard_shape((1, 1, self.num_heads, 1))[2]


def decode_head_sharding(num_heads, mesh=None):
    """The head sharding (``HeadSharding``) of ``[batch, s, heads,
    head_dim]`` decode activations when the mesh (the committed global
    one by default: read only, never built from the environment) has
    tp > 1 dividing ``num_heads``, else None."""
    mesh = global_mesh_if_set() if mesh is None else mesh
    if mesh is None:
        return None
    tp = mesh_axis_size(mesh, "tp")
    if tp > 1 and num_heads % tp == 0:
        return HeadSharding(mesh, num_heads)
    return None
