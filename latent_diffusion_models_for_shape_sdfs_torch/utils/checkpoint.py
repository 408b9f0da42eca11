"""Reader and writer of the `pack_tree_npz` stage-1 packs, and the JAX <->
torch parameter conversion.

A pack is one compressed npz whose keys are `jax.tree_util.keystr` paths
of a pytree, e.g. `['params']['lin0']['v']` or `['codes']` (written by the
JAX package's `utils/checkpoint.py::pack_tree_npz`). Reading it needs no
JAX: the keys parse back into nested dicts of numpy arrays, and
`pack_tree_npz` writes the same keys from nested dicts.

The JAX decoder stores each layer as `v [in, out]`, `g [out]`, `b [out]`;
the port keeps torch's `nn.Linear` layout `v [out, in]`. `params_from_jax`
and `params_to_jax` are the only code that converts between the two.
"""

from __future__ import annotations

import pathlib
import re

import numpy as np
import torch

_KEY_PART = re.compile(r"\['([^'\]]*)'\]|\[(\d+)\]")


def _parse_keystr(key: str) -> list:
    """"['params']['lin0']['v']" -> ['params', 'lin0', 'v']; integer
    subscripts ("[3]") become ints. Raises on any other path syntax."""
    parts, pos = [], 0
    for m in _KEY_PART.finditer(key):
        if m.start() != pos:
            break
        parts.append(m.group(1) if m.group(1) is not None
                     else int(m.group(2)))
        pos = m.end()
    if pos != len(key) or not parts:
        raise ValueError(f"unsupported pack key {key!r}")
    return parts


def load_tree_npz(path: str | pathlib.Path) -> dict:
    """Pack -> nested dict of numpy arrays (saved dtypes kept)."""
    tree: dict = {}
    with np.load(str(path)) as z:
        for key in z.files:
            *head, leaf = _parse_keystr(key)
            node = tree
            for p in head:
                node = node.setdefault(p, {})
            if leaf in node:
                raise ValueError(f"duplicate pack key {key!r}")
            node[leaf] = z[key]
    return tree


def params_from_jax(tree: dict) -> dict:
    """JAX decoder params {'lin0': {'v' [in,out], 'g', 'b'}, ...} (numpy)
    -> the port's state dict {'lin0.v' [out,in], 'lin0.g', 'lin0.b', ...}
    of float tensors. Bit-exact (a transpose and a copy)."""
    sd = {}
    for name, layer in tree.items():
        for k, a in layer.items():
            a = np.asarray(a)
            if k == "v":
                a = a.T
            sd[f"{name}.{k}"] = torch.from_numpy(np.array(a, order="C"))
    return sd


def params_to_jax(state_dict: dict) -> dict:
    """Inverse of params_from_jax: state dict -> nested numpy JAX tree."""
    tree: dict = {}
    for key, t in state_dict.items():
        name, k = key.split(".")
        a = t.detach().cpu().numpy()
        if k == "v":
            a = np.ascontiguousarray(a.T)
        tree.setdefault(name, {})[k] = a
    return tree


def load_stage1_pack(path: str | pathlib.Path) -> tuple:
    """Committed stage-1 pack -> (decoder state dict, codes np.float32
    [n_scenes, L])."""
    tree = load_tree_npz(path)
    return params_from_jax(tree["params"]), np.asarray(tree["codes"],
                                                       np.float32)


def _keystr(path: tuple) -> str:
    return "".join(f"[{p}]" if isinstance(p, int) else f"['{p}']"
                   for p in path)


def pack_tree_npz(path: str | pathlib.Path, tree: dict) -> None:
    """Nested dicts of arrays -> one compressed npz keyed by keystr paths
    (the JAX package's `pack_tree_npz` format; its `restore_tree_npz`
    reads it back bit for bit)."""
    flat: dict = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, prefix + (k,))
        else:
            a = node.detach().cpu().numpy() if isinstance(
                node, torch.Tensor) else np.asarray(node)
            flat[_keystr(prefix)] = a

    walk(tree, ())
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(str(path), **flat)


def save_stage1_pack(path: str | pathlib.Path, state_dict: dict,
                     codes) -> None:
    """Decoder state dict + codes [n_scenes, L] -> a stage-1 pack
    (`['params']['lin0']['v']` in the JAX [in, out] layout, `['codes']`),
    readable by `load_stage1_pack` and by the JAX package."""
    codes = (codes.detach().cpu().numpy() if isinstance(codes, torch.Tensor)
             else np.asarray(codes))
    pack_tree_npz(path, {"params": params_to_jax(state_dict),
                         "codes": codes.astype(np.float32)})


# flax leaf name -> torch parameter name (Dense kernels are transposed)
_FLAX_LEAF = {"kernel": "weight", "bias": "bias", "scale": "weight",
              "embedding": "weight"}


def denoiser_params_from_jax(tree: dict) -> dict:
    """Flax CondDenoiser (or bare body) params, nested dicts of numpy
    arrays, -> the state dict of models.denoiser.CondDenoiser: a Dense
    `kernel` [in, out] becomes `weight` [out, in]; LayerNorm `scale` and
    Embed `embedding` become `weight`; scopes join with dots
    (`body/block0/ln/scale` -> `body.block0.ln.weight`). Bit-exact."""
    sd = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + (k,))
                continue
            if k not in _FLAX_LEAF:
                raise ValueError(f"unknown flax leaf {'/'.join(prefix + (k,))}")
            a = np.asarray(v)
            if k == "kernel":
                a = a.T
            sd[".".join(prefix + (_FLAX_LEAF[k],))] = torch.from_numpy(
                np.array(a, dtype=np.float32, order="C"))

    walk(tree, ())
    return sd


def denoiser_params_to_jax(state_dict: dict) -> dict:
    """Inverse of denoiser_params_from_jax: state dict -> nested numpy flax
    tree (1-D `weight` is a LayerNorm scale, the class table `cls` an
    Embed, every other 2-D `weight` a Dense kernel)."""
    tree: dict = {}
    for key, t in state_dict.items():
        *scope, leaf = key.split(".")
        a = t.detach().cpu().numpy()
        if leaf == "weight":
            if a.ndim == 1:
                leaf = "scale"
            elif scope[-1] == "cls":
                leaf = "embedding"
            else:
                leaf, a = "kernel", np.ascontiguousarray(a.T)
        node = tree
        for s in scope:
            node = node.setdefault(s, {})
        node[leaf] = a
    return tree
