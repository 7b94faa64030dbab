"""Load flax checkpoints into the port's models.

Pure tensor remaps of the trees that ``horovod_tpu``'s models produce (as
numpy arrays, e.g. from ``jax.device_get(variables)``); they are the only
bridge between the two packages, and need neither jax nor flax: a tree is
nested dicts of arrays.

``params_from_flax``: the ``TransformerLM`` param tree. Each Dense
``kernel [in, out]`` becomes a ``weight [out, in]``; ``embed/embedding``,
the RMSNorm ``scale``s and ``lm_head/kernel`` (absent when the embedding
is tied) copy across.

``vision_from_flax``: a vision model's ``{"params", "batch_stats"}``. The
port's vision modules carry the flax module names, so a dotted parameter
name is its flax path; Conv ``kernel [kh, kw, in, out]`` becomes
``weight [out, in, kh, kw]``, Dense ``kernel [in, out]`` ``weight [out,
in]``, and the BatchNorm ``scale``/``bias`` and running ``mean``/``var``
copy across.
"""

import dataclasses
import itertools
import re

import numpy as np
import torch

from .transformer import TransformerLM, set_trainable


def _dense_names(i):
    base = f"layer_{i}"
    return {
        f"layers.{i}.attn.qkv.weight": (base, "attn", "qkv", "kernel"),
        f"layers.{i}.attn.out.weight": (base, "attn", "out", "kernel"),
        f"layers.{i}.mlp.gate.weight": (base, "mlp", "gate", "kernel"),
        f"layers.{i}.mlp.up.weight": (base, "mlp", "up", "kernel"),
        f"layers.{i}.mlp.down.weight": (base, "mlp", "down", "kernel"),
    }


def _leaf(tree, path):
    for key in path:
        if key not in tree:
            raise KeyError(f"flax params have no {'/'.join(path)}")
        tree = tree[key]
    return np.asarray(tree)


def params_from_flax(tree, cfg, device=None, dtype=None, train=False,
                     param_dtype=None):
    """A ``TransformerLM`` for ``cfg`` on ``device`` holding ``tree``.

    ``dtype`` is the model's working dtype (``cfg.dtype`` by default; the
    returned model's ``cfg`` carries it). ``train=True`` gives a training
    model with gradients on, whose dense and embedding weights keep the
    flax fp32 values unrounded (``param_dtype`` fp32 by default), so that
    a training step from converted weights is the same function in both
    packages; otherwise they are stored in ``param_dtype`` or the working
    dtype and frozen, for serving. RMSNorm scales stay fp32."""
    if dtype is not None and dtype != cfg.dtype:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    if param_dtype is None and train:
        param_dtype = torch.float32
    model = TransformerLM(cfg, device, param_dtype)
    mapping = {"embed.weight": (("embed", "embedding"), False),
               "ln_f.scale": (("ln_f", "scale"), False)}
    for i in range(cfg.num_layers):
        mapping[f"layers.{i}.ln_attn.scale"] = (
            (f"layer_{i}", "ln_attn", "scale"), False)
        mapping[f"layers.{i}.ln_mlp.scale"] = (
            (f"layer_{i}", "ln_mlp", "scale"), False)
        for name, path in _dense_names(i).items():
            mapping[name] = (path, True)
    if not cfg.tie_embeddings:
        mapping["lm_head.weight"] = (("lm_head", "kernel"), True)
    params = dict(model.named_parameters())
    if set(params) != set(mapping):
        raise KeyError(f"model and mapping disagree: "
                       f"{sorted(set(params) ^ set(mapping))}")
    with torch.no_grad():
        for name, (path, transpose) in mapping.items():
            arr = _leaf(tree, path)
            if transpose:
                arr = arr.T
            p = params[name]
            if tuple(arr.shape) != tuple(p.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} "
                                 f"does not fit {name} {tuple(p.shape)}")
            p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).to(
                device=p.device, dtype=p.dtype))
    return set_trainable(model, train)


_NORM_NAME = re.compile(r"^(Tpu)?BatchNorm_(\d+)$")


def _child(tree, key):
    """``tree[key]``, where a norm's auto-name may differ by norm impl:
    ``BatchNorm_j`` stands for ``TpuBatchNorm_j`` and the other way round.
    Returns (the key found, the subtree)."""
    if key in tree:
        return key, tree[key]
    m = _NORM_NAME.match(key)
    if m:
        alt = (f"BatchNorm_{m.group(2)}" if m.group(1)
               else f"TpuBatchNorm_{m.group(2)}")
        if alt in tree:
            return alt, tree[alt]
    raise KeyError(key)


def _flax_leaves(tree, prefix=()):
    for key, value in tree.items():
        if isinstance(value, dict):
            yield from _flax_leaves(value, prefix + (key,))
        else:
            yield prefix + (key,)


def vision_from_flax(variables, model):
    """Copy a flax vision model's ``{"params", "batch_stats"}`` (numpy)
    into the port's ``model`` (``models.build(...)`` of the same
    architecture) and return it. Auto-named norms match across norm impls
    (``BatchNorm_j`` and ``TpuBatchNorm_j``); a missing or left-over leaf
    raises KeyError, a shape that does not fit ValueError."""
    trees = {"params": variables["params"],
             "batch_stats": variables.get("batch_stats", {})}
    used = set()
    entries = itertools.chain(model.named_parameters(), model.named_buffers())
    with torch.no_grad():
        for name, t in entries:
            *mods, leaf = name.split(".")
            collection = ("batch_stats" if leaf in ("mean", "var")
                          else "params")
            node, path = trees[collection], [collection]
            try:
                for key in mods:
                    key, node = _child(node, key)
                    path.append(key)
                key = "kernel" if leaf == "weight" else leaf
                arr = np.asarray(node[key])
            except KeyError:
                raise KeyError(f"flax variables have no leaf for {name} "
                               f"(under {'/'.join(path)})") from None
            path.append(key)
            if leaf == "weight":
                arr = arr.transpose(3, 2, 0, 1) if arr.ndim == 4 else arr.T
            if tuple(arr.shape) != tuple(t.shape):
                raise ValueError(f"{'/'.join(path)}: shape {arr.shape} "
                                 f"does not fit {name} {tuple(t.shape)}")
            t.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)).to(
                device=t.device, dtype=t.dtype))
            used.add(tuple(path))
    left = {(c,) + p for c, tree in trees.items() for p in _flax_leaves(tree)}
    left -= used
    if left:
        raise KeyError(f"flax leaves the model has no place for: "
                       f"{sorted('/'.join(p) for p in left)}")
    return model
