"""The resharding sentinel's matching rule, from
``horovod_tpu/utils/memory.py`` (``scan_resharding``).

The JAX package scans a compiled step's HLO for collectives that undo a
declared parameter sharding. The port has no HLO: its serving forwards
record each collective they issue (op, result shape, operand shapes,
gathered dim; ``serving.decode.ServingWeights.recording``), and the same
rule runs over those records. A collective is flagged when its result
shape equals a parameter's full shape while one of its operands has that
parameter's declared shard shape: a full-shape gather of something
declared sharded. Activation collectives never match a parameter's
(full, shard) pair. A result shape that is also the full shape of a
parameter declared replicated is ambiguous and stays silent: the rule is
precision-first. The rest of the memory plane comes with the port's
observability slice.
"""

from ..parallel.mesh import spec_shard_shape


def leaf_table(params, spec_tree, mesh_shape):
    """(name, full shape, declared shard shape, spec) of every parameter
    of ``params`` (name -> tensor) under ``spec_tree`` (name -> spec) on
    a mesh of ``mesh_shape`` ({axis: size})."""
    table = []
    for name, t in params.items():
        shape = tuple(t.shape)
        if not shape:
            continue
        spec = spec_tree.get(name)
        table.append((name, shape, spec_shard_shape(shape, spec, mesh_shape),
                      spec))
    return table


def _axis_for(spec, dim, ratio, mesh_shape):
    """The mesh axis a gather undoes: the axis the declared spec put on
    that dim, else any mesh axis whose size matches the ratio."""
    entries = tuple(spec) if spec is not None else ()
    if dim is not None and dim < len(entries) and entries[dim] is not None:
        part = entries[dim]
        names = part if isinstance(part, (tuple, list)) else (part,)
        return "+".join(str(n) for n in names)
    for name, size in mesh_shape.items():
        if int(size) == ratio:
            return str(name)
    return None


def scan_resharding(collectives, params, spec_tree, mesh_shape,
                    site="serve_decode"):
    """Findings (one dict per flagged collective: leaf, op, axis, dim,
    full and shard shapes, site) of ``collectives`` (records of ``op``,
    ``result_shape``, ``operand_shapes``, ``dim``) against the parameters'
    declared shardings; empty on a clean spec tree."""
    full_table = leaf_table(params, spec_tree, mesh_shape)
    table = [row for row in full_table if row[1] != row[2]]
    replicated_fulls = {row[1] for row in full_table if row[1] == row[2]}
    findings = []
    for coll in collectives:
        result = tuple(coll["result_shape"])
        if result in replicated_fulls:
            continue
        operands = [tuple(s) for s in coll["operand_shapes"]]
        for name, full, shard, spec in table:
            if result != full or shard not in operands:
                continue
            dim = coll.get("dim")
            if dim is None:
                dim = next((i for i, (f, s) in enumerate(zip(full, shard))
                            if f != s), None)
            ratio = (full[dim] // max(1, shard[dim])
                     if dim is not None and dim < len(full) else 0)
            findings.append({
                "leaf": name, "op": coll["op"],
                "axis": _axis_for(spec, dim, ratio, mesh_shape),
                "dim": dim, "full_shape": list(full),
                "shard_shape": list(shard), "site": site})
            break
    return findings
