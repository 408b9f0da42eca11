"""Faults planted under the timed path, to show that `correct` catches
them: used by benchmark/tests/test_bench_runs.py on the CPU and by
benchmark/calibrate.py on the card. Each is a context manager that
breaks the port's code for the block it holds and puts it back.
"""

from __future__ import annotations

import contextlib
import importlib
from typing import Iterator

PORT = "latent_diffusion_models_for_shape_sdfs_torch"


@contextlib.contextmanager
def _patched(module: str, name: str, value) -> Iterator[None]:
    mod = importlib.import_module(f"{PORT}.{module}")
    old = getattr(mod, name)
    setattr(mod, name, value)
    try:
        yield
    finally:
        setattr(mod, name, old)


@contextlib.contextmanager
def unchanged() -> Iterator[None]:
    """Every optimizer step returns the state unchanged."""
    import torch
    old = torch.optim.Adam.step
    torch.optim.Adam.step = lambda self, closure=None: None
    try:
        yield
    finally:
        torch.optim.Adam.step = old


@contextlib.contextmanager
def half_batch() -> Iterator[None]:
    """The bank step trains on the first half of its scenes, the loss the
    mean over them."""
    import dataclasses
    ad = importlib.import_module(f"{PORT}.train.auto_decoder")
    real = ad.make_bank_step

    def make(decoder, cfg, bank, generator):
        half = dataclasses.replace(cfg, scenes_per_batch=cfg.scenes_per_batch
                                   // 2)
        step = real(decoder, half, bank, generator)
        return lambda state, ids, epoch, seed: step(
            state, ids[:ids.shape[0] // 2], epoch, seed)

    with _patched("train.auto_decoder", "make_bank_step", make):
        yield


@contextlib.contextmanager
def db_halved() -> Iterator[None]:
    """Kernel #3b's layer entry emits half of each hidden bias's
    gradient."""
    rd = importlib.import_module(f"{PORT}.ops.relu_dropout")
    real = rd.relu_dropout_bwd_out

    def half(*a, **k):
        gb, db = real(*a, **k)
        return gb, db * 0.5

    with _patched("ops.relu_dropout", "relu_dropout_bwd_out", half):
        yield


@contextlib.contextmanager
def labels_bf16() -> Iterator[None]:
    """The chair bank's labels rounded to bf16 where they are made."""
    dev = importlib.import_module(f"{PORT}.data.analytic_device")
    real = dev.bank_from_chairs

    def rounded(*a, **k):
        bank = real(*a, **k)
        for rows in (bank.pos, bank.neg):
            rows[..., 3] = rows[..., 3].bfloat16().float()
        return bank

    with _patched("data.analytic_device", "bank_from_chairs", rounded):
        yield


@contextlib.contextmanager
def half_batch_diff() -> Iterator[None]:
    """The stage-2 loss is the mean over the first half of the batch."""
    losses = importlib.import_module(f"{PORT}.losses")
    real = losses.eps_mse

    def half(eps, eps_hat):
        n = eps.shape[0] // 2
        return real(eps[:n], eps_hat[:n])

    with _patched("losses", "eps_mse", half):
        yield


@contextlib.contextmanager
def swapped() -> Iterator[None]:
    """Each served mesh is the next latent's: an answer altered where it
    is produced."""
    serve = importlib.import_module(f"{PORT}.serve")
    real = serve.serve_meshes

    def rotated(apply_fn, latents, *a, **k):
        latents = list(latents)
        return real(apply_fn, latents[1:] + latents[:1], *a, **k)

    with _patched("serve", "serve_meshes", rotated):
        yield


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "db_halved": db_halved, "labels_bf16": labels_bf16,
          "half_batch_diff": half_batch_diff, "swapped": swapped}
