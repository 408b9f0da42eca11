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

Full training state is checkpointed per stage as torch files
(`StageCheckpointer`; the JAX package's orbax trees cannot be read without
JAX); the npz packs stay the exchange format with the JAX package.
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


def _numpy(a) -> np.ndarray:
    return (a.detach().cpu().numpy() if isinstance(a, torch.Tensor)
            else np.asarray(a))


def _leaves(node, prefix: tuple = ()):
    """(keystr path, leaf) of every leaf of nested dicts."""
    if isinstance(node, dict):
        for k, v in node.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield _keystr(prefix), node


def pack_tree_npz(path: str | pathlib.Path, tree: dict) -> None:
    """Nested dicts of arrays -> one compressed npz keyed by keystr paths
    (the JAX package's `pack_tree_npz` format; its `restore_tree_npz`
    reads it back bit for bit)."""
    flat = {k: _numpy(a) for k, a in _leaves(tree)}
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(str(path), **flat)


def _restore_into(template, saved: dict, source: str, prefix: tuple = ()):
    """`template`'s nested dicts with each leaf taken from `saved` (keystr
    path -> array) by its path: KeyError if one is missing, ValueError if
    its shape differs from the template leaf's."""
    if isinstance(template, dict):
        return {k: _restore_into(v, saved, source, prefix + (k,))
                for k, v in template.items()}
    key = _keystr(prefix)
    if key not in saved:
        raise KeyError(f"pack {source} missing leaf {key}")
    v = saved[key]
    if tuple(v.shape) != tuple(np.shape(template)):
        raise ValueError(f"{key}: packed shape {tuple(v.shape)} != "
                         f"template {tuple(np.shape(template))}")
    return v


def restore_tree_npz(path: str | pathlib.Path, template: dict) -> dict:
    """Inverse of pack_tree_npz against a template: `template`'s nested
    dicts with every leaf read from the pack by its keystr path, in the
    SAVED dtype (the template gives the structure and the shapes). Raises
    KeyError for a leaf the pack lacks and ValueError for a shape that
    differs, as the JAX package's `restore_tree_npz` does."""
    with np.load(str(path)) as z:
        saved = {k: z[k] for k in z.files}
    return _restore_into(template, saved, str(path))


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
    `kernel` [in, out] becomes `weight` [out, in], a Conv `kernel` [k, in,
    out] becomes `weight` [out, in, k]; LayerNorm and GroupNorm `scale`
    and Embed `embedding` become `weight`; scopes join with dots
    (`body/block0/ln/scale` -> `body.block0.ln.weight`). Bit-exact. The
    encoder's tree (models.encoder) maps by the same rules."""
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
                a = a.T          # reverses the axes of Dense and Conv kernels
            sd[".".join(prefix + (_FLAX_LEAF[k],))] = torch.from_numpy(
                np.array(a, dtype=np.float32, order="C"))

    walk(tree, ())
    return sd


def denoiser_params_to_jax(state_dict: dict) -> dict:
    """Inverse of denoiser_params_from_jax: state dict -> nested numpy flax
    tree (1-D `weight` is a LayerNorm or GroupNorm scale, the class table
    `cls` an Embed, every other `weight` a Dense (2-D) or Conv (3-D)
    kernel)."""
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


# the LatentEncoder's leaves are Dense and LayerNorm ones, mapped by the
# denoiser's rules; the names mirror the reference's
encoder_params_from_jax = denoiser_params_from_jax
encoder_params_to_jax = denoiser_params_to_jax


# ------------------------------------------------- stage checkpoints


class StageCheckpointer:
    """Full-state checkpoints of one stage of an experiment as torch files,
    `<exp>/checkpoints/<stage>/<step>.pt` (the JAX package keeps orbax
    trees in the same place; those cannot be read without JAX). A save is
    written to a temporary name and renamed, so a crash leaves the last
    complete file; the newest `max_to_keep` steps are kept."""

    def __init__(self, exp_dir: str | pathlib.Path, stage: str,
                 max_to_keep: int = 3):
        self.root = pathlib.Path(exp_dir).resolve() / "checkpoints" / stage
        self.root.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def steps(self) -> list:
        return sorted(int(p.stem) for p in self.root.glob("*.pt")
                      if p.stem.isdigit())

    def latest_step(self):
        steps = self.steps()
        return steps[-1] if steps else None

    def save(self, step: int, tree: dict) -> pathlib.Path:
        """Tensors in `tree` are saved from host copies."""
        path = self.root / f"{int(step)}.pt"
        tmp = path.with_suffix(".pt.tmp")
        torch.save(_to_host(tree), tmp)
        tmp.replace(path)
        for old in self.steps()[:-self.max_to_keep]:
            (self.root / f"{old}.pt").unlink(missing_ok=True)
        return path

    def restore(self, step=None) -> dict:
        """The saved tree of `step` (default: the latest), on the CPU."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.root}")
        return torch.load(self.root / f"{int(step)}.pt", map_location="cpu",
                          weights_only=True)


def restore_stage1(exp_dir: str | pathlib.Path, template: dict,
                   pack_name: str = "stage1_pack.npz") -> dict:
    """A stage-1 tree (e.g. {"params", "codes"}) matched against
    `template` as restore_tree_npz does: the latest checkpoint of the
    experiment's "ad" stage first (StageCheckpointer; CPU tensors), else
    the npz pack `<exp_dir>/<pack_name>` (numpy arrays); raises
    FileNotFoundError when there is neither."""
    exp_dir = pathlib.Path(exp_dir)
    ck = StageCheckpointer(exp_dir, "ad", max_to_keep=1)
    if ck.latest_step() is not None:
        return _restore_into(template, dict(_leaves(ck.restore())),
                             str(ck.root))
    pack = exp_dir / pack_name
    if pack.exists():
        return restore_tree_npz(pack, template)
    raise FileNotFoundError(
        f"no stage-1 checkpoint under {ck.root} and no {pack_name} pack "
        f"in {exp_dir}")


def save_array_dict(path: str | pathlib.Path, tree: dict) -> None:
    """A flat dict of arrays -> an (uncompressed) npz, as the JAX
    package's `save_array_dict` writes it."""
    pathlib.Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(str(path), **{k: _numpy(v) for k, v in tree.items()})


def load_array_dict(path: str | pathlib.Path) -> dict:
    """An npz -> a flat dict of numpy arrays."""
    with np.load(str(path)) as z:
        return {k: z[k] for k in z.files}


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_host(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def load_adam_state(optimizer: torch.optim.Optimizer, saved: dict) -> None:
    """Load a saved Adam state dict, keeping this optimizer's own
    `capturable`/`foreach`/`fused` settings (torch would take the saved
    ones), so a capturable optimizer gets its step counts on its
    parameters' device whatever device the checkpoint was written on, and
    its own tensor learning rate (train.encoder fills it each step)."""
    live_lr = [g["lr"] for g in optimizer.param_groups]
    saved = dict(saved, param_groups=[
        dict(sg, **{k: g[k] for k in ("capturable", "foreach", "fused")
                    if k in g})
        for sg, g in zip(saved["param_groups"], optimizer.param_groups)])
    optimizer.load_state_dict(saved)
    groups = optimizer.param_groups
    for group, lr in zip(groups, live_lr):
        if torch.is_tensor(lr):       # a rate the step fills stays the same
            group["lr"] = lr          # tensor, on its device
    for group in groups:
        for p in group["params"]:
            st = optimizer.state.get(p, {})
            step = st.get("step")
            if group.get("capturable") and step is not None \
                    and step.device != p.device:
                raise RuntimeError("capturable Adam restored with its step "
                                   f"on {step.device}, params on {p.device}")


def ad_state_tree(state, epoch: int) -> dict:
    """Stage 1's full state (train.auto_decoder.AdTrainState): decoder
    state dict, latent codes, the Adam state of both groups, the epoch."""
    return {"decoder": state.decoder.state_dict(), "codes": state.codes,
            "optimizer": state.optimizer.state_dict(), "epoch": int(epoch)}


def restore_ad_state(state, tree: dict) -> int:
    """Load a stage-1 tree into `state` in place; returns its epoch."""
    state.decoder.load_state_dict(tree["decoder"])
    with torch.no_grad():
        state.codes.copy_(tree["codes"])
    load_adam_state(state.optimizer, tree["optimizer"])
    return int(tree["epoch"])


def diff_state_tree(state, mu, sigma) -> dict:
    """Stage 2's full state (train.diffusion.DiffTrainState): params, EMA,
    Adam, step, and the code moments mu/sigma sampling needs."""
    return {"params": state.model.state_dict(), "ema": dict(state.ema),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "mu": mu, "sigma": sigma}


def restore_diff_state(state, tree: dict) -> tuple:
    """Load a stage-2 tree into `state` in place; returns (mu, sigma) on
    the state's device."""
    state.model.load_state_dict(tree["params"])
    with torch.no_grad():
        for k, v in state.ema.items():
            v.copy_(tree["ema"][k])
    load_adam_state(state.optimizer, tree["optimizer"])
    state.step = int(tree["step"])
    dev = next(state.model.parameters()).device
    return tree["mu"].to(dev), tree["sigma"].to(dev)


def enc_state_tree(state, mu, sigma) -> dict:
    """The encoder's full state (train.encoder.EncTrainState): params,
    Adam, step, and the code moments mu/sigma its predictions need."""
    return {"params": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step), "mu": mu, "sigma": sigma}


def restore_enc_state(state, tree: dict) -> tuple:
    """Load an encoder tree into `state` in place; returns (mu, sigma) on
    the state's device."""
    state.model.load_state_dict(tree["params"])
    load_adam_state(state.optimizer, tree["optimizer"])
    state.step = int(tree["step"])
    dev = next(state.model.parameters()).device
    return tree["mu"].to(dev), tree["sigma"].to(dev)


def save_stage2_pack(path: str | pathlib.Path, state, mu, sigma) -> None:
    """Stage-2 exchange pack `{params, ema_params, mu, sigma}` under the
    flax CondDenoiser's keys, in `pack_tree_npz` format: the JAX package's
    `restore_tree_npz` reads it into a flax template."""
    ema_sd = {k: state.ema.get(k, v) for k, v in
              state.model.state_dict().items()}
    pack_tree_npz(path, {
        "params": denoiser_params_to_jax(state.model.state_dict()),
        "ema_params": denoiser_params_to_jax(ema_sd),
        "mu": mu, "sigma": sigma})


def load_stage2_pack(path: str | pathlib.Path) -> tuple:
    """Stage-2 pack -> (params state dict, EMA state dict, mu, sigma),
    float32 CPU tensors."""
    tree = load_tree_npz(path)
    return (denoiser_params_from_jax(tree["params"]),
            denoiser_params_from_jax(tree["ema_params"]),
            torch.from_numpy(np.asarray(tree["mu"], np.float32)),
            torch.from_numpy(np.asarray(tree["sigma"], np.float32)))
