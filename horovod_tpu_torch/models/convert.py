"""Load a flax ``TransformerLM`` checkpoint into the port's model.

A pure tensor remap of the param tree that ``horovod_tpu``'s
``TransformerLM.init`` produces (as numpy arrays, e.g. from
``jax.device_get(params)``): each Dense ``kernel [in, out]`` becomes a
``weight [out, in]``; ``embed/embedding``, the RMSNorm ``scale``s and
``lm_head/kernel`` (absent when the embedding is tied) copy across. It is
the only bridge between the two packages, and it needs neither jax nor
flax: the tree is nested dicts of arrays.
"""

import dataclasses

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
