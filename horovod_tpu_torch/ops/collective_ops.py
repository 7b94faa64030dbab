"""Which ranks a collective spans, and the group object it runs over.

The routing half of ``horovod_tpu/ops/collective_ops.py``. The JAX
package resolves a collective's axis against the axes ``shard_map``
binds while it traces; the port has no traced context, so the *bound
axes* are those of the committed global mesh (this thread's view of it
for a rank that is a thread, ``parallel.mesh.use_mesh``) and the worker
axis ``hvd`` (every worker), and, while ``HOROVOD_HIERARCHICAL_ALLREDUCE``
is on and the global mesh has no such axes, the ``("slices", "chips")``
of the world's hierarchy (one slice per host, ``parallel.mesh.
hierarchy_mesh``). An axis is then an axis name, a tuple of axis names
(a reduction spanning a whole hierarchy), a process group, or a group
object of ``parallel.ring``; ``comm_of`` gives the group object it runs
over.
"""

import torch.distributed as dist

from ..common import state as state_mod

#: The worker axis: every worker of the process group (or every thread
#: rank of this thread's mesh).
WORLD_AXIS = state_mod.HVD_AXIS
HIER_FAST_AXIS = "chips"
HIER_SLOW_AXIS = "slices"
HIER_AXES = (HIER_FAST_AXIS, HIER_SLOW_AXIS)


def _config():
    return (state_mod.global_state().config
            if state_mod.is_initialized() else None)


def is_group(axis):
    """Whether ``axis`` names its ranks itself: a group object of
    ``parallel.ring`` or a process group."""
    return hasattr(axis, "all_reduce") or isinstance(axis,
                                                     dist.ProcessGroup)


def bound_axes():
    """The axis names a collective may span now (see the module
    docstring)."""
    from ..parallel import mesh as mesh_lib
    names = [WORLD_AXIS]
    mesh = mesh_lib.global_mesh_if_set()
    if mesh is not None:
        names += [a for a in mesh.axis_names if a not in names]
    cfg = _config()
    if cfg is not None and cfg.hierarchical_allreduce:
        names += [a for a in HIER_AXES if a not in names]
    return names


def _spans_world(axis):
    """Whether a reduction over ``axis`` spans every rank."""
    from ..parallel import mesh as mesh_lib
    if axis is None or axis == WORLD_AXIS:
        return True
    world = comm_of(WORLD_AXIS).size
    if is_group(axis):
        return comm_of(axis).size == world
    mesh = mesh_lib.global_mesh_if_set()
    return (isinstance(axis, str) and mesh is not None
            and axis in mesh.axis_names and mesh.shape[axis] == world)


def resolve_axis(axis_name=None, prefer_hierarchy=False):
    """The axis a collective runs over: ``axis_name`` (a tuple only when
    every member is bound), the worker axis for None. ``prefer_hierarchy``
    (the allreduce entry points) resolves a reduction that spans every
    rank to the hierarchy pair when HOROVOD_HIERARCHICAL_ALLREDUCE is on
    and both hierarchy axes are bound, so that the operation manager's
    two-level backend, which matches on the exact pair, can win;
    single-axis collectives never get the tuple."""
    bound = bound_axes()
    if isinstance(axis_name, (tuple, list)):
        return tuple(axis_name) if all(a in bound for a in axis_name) \
            else None
    cfg = _config()
    if (prefer_hierarchy and cfg is not None and cfg.hierarchical_allreduce
            and all(a in bound for a in HIER_AXES)
            and _spans_world(axis_name)):
        return HIER_AXES
    return WORLD_AXIS if axis_name is None else axis_name


def comm_of(axis):
    """The group object (``parallel.ring``) of the ranks ``axis`` spans."""
    from ..parallel import mesh as mesh_lib
    from ..parallel.ring import GroupRing
    if hasattr(axis, "all_reduce"):
        return axis
    if isinstance(axis, dist.ProcessGroup):
        return GroupRing(axis)
    mesh = mesh_lib.global_mesh_if_set()
    if axis is None or axis == WORLD_AXIS:
        return mesh.world_comm() if isinstance(
            mesh, mesh_lib.ThreadMesh) else GroupRing(None)
    hier = set(HIER_AXES)
    if isinstance(axis, (tuple, list)):
        for m in (mesh, mesh_lib.hierarchy_mesh() if set(axis) <= hier
                  else None):
            if m is not None and set(axis) == set(m.axis_names):
                return m.world_comm()
        raise ValueError(f"axes {tuple(axis)} do not span a whole mesh")
    if mesh is None and axis not in hier:
        mesh = mesh_lib.global_mesh()
    if mesh is not None and axis in mesh.axis_names:
        return mesh.comm(axis)
    if axis in hier:
        return mesh_lib.hierarchy_mesh().comm(axis)
    raise ValueError(f"no mesh axis {axis!r} to run a collective over")


def axis_size(axis):
    """Ranks a reduction over ``axis`` spans (its average's divisor)."""
    return comm_of(axis).size
