"""Stage-1 auto-decoder training: joint decoder + latent-table optimisation.

Counterpart of the JAX package's `train/auto_decoder.py` (SEMANTICS.md
sections 1-5): per step, gather each batch scene's code, run the decoder
over scenes_per_batch x samples_per_scene (xyz, sdf) pairs, minimise
clamped-L1 + warm-up code regularisation, and update with **two** Adam
groups (decoder lr 5e-4, latents lr 1e-3) whose lr steps per epoch.

Two routes compute the loss and the gradients, with one shared update:
  * autograd: `SdfDecoder` in training mode and `loss.backward()`; with
    `dropout_impl="pallas"` every hidden relu goes through the relu+dropout
    kernel pair (ops/relu_dropout.py);
  * fused (`AdConfig.use_pallas`): the fused train kernel
    (ops/fused_train.py) computes loss and gradients in one pass.

PyTorch is stateful where JAX is pure: `AdTrainState` holds the decoder
(its parameters), the dense latent table `codes` (a leaf tensor whose
gradient is dense, so untouched rows move through Adam's m/v as in the
lineage) and one `torch.optim.Adam` with a decoder group and a latent
group; a step updates them in place.

Two feeds: the host feed (a producer thread draws each batch's samples
from the `SdfDataset`) and, with `device_data=True`, the on-device sample
bank (data/device_bank.py): the host sends only scene ids and the
balanced draw runs on the device. `data_parallel=True` over an
initialised `torch.distributed` group of more than one rank takes the
data-parallel step of parallel/dp.py on either feed and route; without
a group, or with a group of one rank, it takes the single-device step,
as the JAX package does on one device.

A step's phases are spans (`utils.profiling.span`, live only while a
profiler runs): `ad.draw` (the bank's draw), `ad.forward` and
`ad.backward` (the autograd route; the fused route is one pass between
the draw and the update), `ad.update` (the lr, the logged gradient
norms, Adam); on the host feed `ad.produce` (the producer thread making
one batch) and `ad.feed_wait` (the loop waiting for it).
"""

from __future__ import annotations

import collections
import queue
import threading
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch import losses
from latent_diffusion_models_for_shape_sdfs_torch.config import AdConfig
from latent_diffusion_models_for_shape_sdfs_torch.data.device_bank import (
    DeviceSampleBank)
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.models.latent_table import (
    gather_codes, init_latent_table)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger)


class AdTrainState(NamedTuple):
    decoder: SdfDecoder          # parameters trained in place
    codes: torch.Tensor          # dense latent table [num_scenes, L], leaf
    optimizer: torch.optim.Adam  # group 0: decoder, group 1: codes


def step_lr(lr0: float, epoch, factor: float, interval: int) -> float:
    """lr0 * factor^floor(epoch / interval), in float32 (lineage
    StepLearningRateSchedule; a function of the epoch)."""
    e = np.float32(epoch)
    return float(np.float32(lr0) * np.power(np.float32(factor),
                                            np.floor(e / np.float32(interval))))


def init_ad_state(cfg: AdConfig, decoder: Optional[SdfDecoder] = None,
                  seed: int = 0, device="cuda", params: Optional[dict] = None,
                  codes=None) -> AdTrainState:
    """Fresh state from `seed` (decoder init, then latent init, drawn in
    that order from one `torch.Generator` seeded with it), or from given
    `params` (a decoder state dict) and `codes` [num_scenes, L]."""
    dev = resolve_device(device)
    decoder = decoder or SdfDecoder(cfg.decoder)
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed))
    if params is None:
        for layer in range(len(decoder.layer_dims())):
            getattr(decoder, f"lin{layer}").reset_parameters(generator=gen)
    else:
        decoder.load_state_dict({k: torch.as_tensor(v)
                                 for k, v in params.items()})
    decoder.to(dev).train()
    if codes is None:
        codes = init_latent_table(gen, cfg.num_scenes,
                                  cfg.decoder.latent_size, cfg.code_init_std)
    codes = torch.as_tensor(codes, dtype=torch.float32).to(dev).clone()
    codes.requires_grad_(True)
    optimizer = torch.optim.Adam(
        [{"params": list(decoder.parameters()), "lr": cfg.lr_decoder},
         {"params": [codes], "lr": cfg.lr_latent}],
        betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    return AdTrainState(decoder, codes, optimizer)


def pallas_train_ok(cfg: AdConfig) -> bool:
    """Whether a step takes the fused train kernel route. The port's plain
    version draws the same dropout mask as the kernel, so unlike the JAX
    package's CPU interpret mode it runs with dropout on the CPU too."""
    return bool(cfg.use_pallas)


def make_ad_train_step(decoder: SdfDecoder, cfg: AdConfig,
                       reg_scene_count: Optional[int] = None,
                       all_reduce: Optional[Callable] = None) -> Callable:
    """step(state, scene_ids [S], xyz [S,P,3], sdf [S,P], epoch, seed)
    -> metrics (tensors on the state's device). Updates `state` in place.

    The loss and gradients come from the fused kernel (ops/fused_train.py)
    when `cfg.use_pallas`, else from autograd; either leaves them in
    `.grad`, and one Adam update follows. For a data-parallel shard
    (parallel/dp.py): `reg_scene_count` normalises the code-reg term
    (default: the local batch's scene count; a shard passes the global
    `cfg.scenes_per_batch`), and `all_reduce(tensors)` sums the loss
    terms and the gradients over the ranks in place before the update."""
    S, P = cfg.scenes_per_batch, cfg.samples_per_scene
    num_sdf_samples = S * P

    def autograd_value_and_grads(codes, scene_ids, xyz, sdf, epoch, seed):
        with profiling.span("ad.forward"):
            z = gather_codes(codes, scene_ids, cfg.code_bound)
            L = z.shape[-1]
            flat_z = z[:, None, :].expand(z.shape[0], xyz.shape[1], L)
            pred = decoder(flat_z.reshape(-1, L), xyz.reshape(-1, 3),
                           seed=seed)
            l1 = losses.clamped_l1(pred, sdf.reshape(-1), cfg.clamp_dist,
                                   num_sdf_samples)
            # lineage sums ||z|| over per-sample rows / num_sdf_samples;
            # with equal samples per scene that is the sum over scenes / S
            reg = losses.code_reg(z, epoch, cfg.code_reg_lambda,
                                  cfg.code_reg_warmup_epochs,
                                  num_sdf_samples=reg_scene_count
                                  or z.shape[0],
                                  squared=cfg.code_reg_squared)
        with profiling.span("ad.backward"):
            (l1 + reg).backward()
        l1, reg = l1.detach(), reg.detach()
        if all_reduce is not None:
            all_reduce([l1, reg, codes.grad,
                        *(p.grad for p in decoder.parameters())])
        return l1 + reg, {"loss_l1": l1, "loss_reg": reg}

    if pallas_train_ok(cfg):
        from latent_diffusion_models_for_shape_sdfs_torch.ops.fused_train \
            import make_fused_ad_loss_grads
        value_and_grads = make_fused_ad_loss_grads(decoder, cfg,
                                                   reg_scene_count,
                                                   all_reduce)
    else:
        value_and_grads = autograd_value_and_grads

    def step(state: AdTrainState, scene_ids, xyz, sdf, epoch, seed: int):
        state.decoder.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = value_and_grads(state.codes, scene_ids, xyz, sdf, epoch,
                                    seed)
        with profiling.span("ad.update"):
            lr_dec = step_lr(cfg.lr_decoder, epoch, cfg.lr_decay_factor,
                             cfg.lr_decay_interval)
            lr_lat = step_lr(cfg.lr_latent, epoch, cfg.lr_decay_factor,
                             cfg.lr_decay_interval)
            g_dec = [p.grad for p in state.decoder.parameters()]
            metrics = {"loss": loss, **aux, "lr_dec": lr_dec,
                       "lr_lat": lr_lat,
                       "grad_norm_dec": torch.linalg.vector_norm(torch.stack(
                           [torch.linalg.vector_norm(g) for g in g_dec])),
                       "grad_norm_lat": torch.linalg.vector_norm(
                           state.codes.grad)}
            groups = state.optimizer.param_groups
            groups[0]["lr"] = lr_dec
            groups[1]["lr"] = lr_lat
            state.optimizer.step()
        return metrics

    return step


def make_bank_step(decoder: SdfDecoder, cfg: AdConfig,
                   bank: DeviceSampleBank,
                   generator: torch.Generator) -> Callable:
    """bank_step(state, scene_ids [S], epoch, seed) -> metrics: the
    balanced draw from `bank` (uniforms from `generator`, on the bank's
    device), then make_ad_train_step's step on either route."""
    step = make_ad_train_step(decoder, cfg)
    P = cfg.samples_per_scene

    def bank_step(state: AdTrainState, scene_ids, epoch, seed: int):
        xyz, sdf = bank.sample_batch(generator, scene_ids, P)
        return step(state, scene_ids, xyz, sdf, epoch, seed)

    return bank_step


def _dp_mesh(cfg: AdConfig):
    """The data mesh when `cfg.data_parallel` and an initialised
    torch.distributed group has more than one rank, else None."""
    if not cfg.data_parallel:
        return None
    import torch.distributed as dist
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return None
    from latent_diffusion_models_for_shape_sdfs_torch.parallel.mesh import (
        make_mesh)
    return make_mesh()


def train_auto_decoder(cfg: AdConfig, dataset: Optional[SdfDataset] = None,
                       logger: Optional[MetricLogger] = None,
                       decoder: Optional[SdfDecoder] = None,
                       state: Optional[AdTrainState] = None,
                       start_epoch: int = 0,
                       checkpoint_fn: Optional[Callable] = None,
                       on_step: Optional[Callable] = None,
                       device="cuda",
                       bank: Optional[DeviceSampleBank] = None) -> tuple:
    """Full stage-1 loop. Returns (decoder, final AdTrainState, metrics).

    A producer thread makes each epoch's batches with
    `np.random.default_rng(cfg.seed + 1)` (the JAX package's batch
    stream) and puts them, as pinned host tensors on a card, into a queue
    of depth 2; the loop copies each batch host -> device with
    `non_blocking=True` and keeps its host tensors alive until that copy's
    event has fired. On the host feed a batch is the dataset's balanced
    draw; xyz travels as bf16 when `use_pallas` or bf16 compute is set
    (the decoder rounds it to bf16 anyway), else as f32. With
    `cfg.device_data` a batch is only its scene ids (each epoch a
    permutation in `scenes_per_batch` slices, the last padded from a
    fresh permutation) and the draw runs on the device from a
    `torch.Generator` there seeded with `cfg.seed`; `bank` (a prebuilt
    DeviceSampleBank, e.g. from data/analytic_device.py) then makes
    `dataset` optional, else the bank is uploaded from `dataset`. The
    host reads nothing back between steps. Dropout seeds come from
    `np.random.default_rng((cfg.seed, 2))`.

    `checkpoint_fn(epoch, state)` runs every `cfg.snapshot_every` epochs
    and after the last; `on_step(step, epoch, metrics)` after every step;
    `logger` gets an `ad_epoch` record every 10 epochs and after the last.
    """
    dev = resolve_device(device)
    if dataset is not None:
        if len(dataset) != cfg.num_scenes:
            raise ValueError(f"dataset has {len(dataset)} scenes, config "
                             f"says {cfg.num_scenes}")
    elif bank is None or not cfg.device_data:
        raise ValueError("dataset=None needs a prebuilt bank and "
                         "cfg.device_data")
    if not cfg.device_data:
        bank = None
    elif bank is None:
        bank = DeviceSampleBank.from_dataset(dataset, device=dev)
    if bank is not None and (bank.pos.shape[0] != cfg.num_scenes
                             or bank.pos.device != dev):
        raise ValueError(f"bank of {bank.pos.shape[0]} scenes on "
                         f"{bank.pos.device}; config says {cfg.num_scenes} "
                         f"scenes on {dev}")
    if state is None:
        state = init_ad_state(cfg, decoder, seed=cfg.seed, device=dev)
    decoder = state.decoder
    mesh = _dp_mesh(cfg)
    if mesh is not None:
        from latent_diffusion_models_for_shape_sdfs_torch.parallel import dp
    if bank is not None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(cfg.seed))
        step_fn = (make_bank_step(decoder, cfg, bank, gen) if mesh is None
                   else dp.make_dp_bank_step(decoder, cfg, mesh, bank, gen))
    else:
        step_fn = (make_ad_train_step(decoder, cfg) if mesh is None
                   else dp.make_dp_ad_train_step(decoder, cfg, mesh))
    logger = logger or MetricLogger()
    rng = np.random.default_rng(cfg.seed + 1)
    seed_rng = np.random.default_rng((cfg.seed, 2))
    xyz_wire = (torch.bfloat16 if (cfg.use_pallas or
                                   cfg.decoder.compute_dtype == "bfloat16")
                else torch.float32)
    pin = dev.type == "cuda"

    def to_host(*t):
        return tuple(x.pin_memory() for x in t) if pin else t

    def batches(epoch):
        if bank is None:
            for b in dataset.epoch_batches(rng, cfg.scenes_per_batch,
                                           cfg.samples_per_scene):
                yield to_host(torch.from_numpy(b.scene_ids.astype(np.int64)),
                              torch.from_numpy(b.xyz).to(xyz_wire),
                              torch.from_numpy(b.sdf))
            return
        n, spb = cfg.num_scenes, cfg.scenes_per_batch
        order = rng.permutation(n)
        for start in range(0, n, spb):
            ids = order[start:start + spb]
            if len(ids) < spb:
                pad = rng.permutation(n)[:spb - len(ids)]
                ids = np.concatenate([ids, pad])
            yield to_host(torch.from_numpy(ids.astype(np.int64)))

    def producer(q, epochs):
        try:
            for epoch in epochs:
                made = batches(epoch)
                while True:
                    with profiling.span("ad.produce"):
                        host = next(made, None)
                    if host is None:
                        break
                    q.put((epoch, host))
        except BaseException as e:     # re-raised by the consumer
            q.put(e)
        finally:
            q.put(None)

    q: queue.Queue = queue.Queue(maxsize=2)
    th = threading.Thread(target=producer,
                          args=(q, range(start_epoch, cfg.num_epochs)),
                          daemon=True)
    th.start()

    last_metrics: dict = {}
    steps_done = 0
    cur_epoch = start_epoch
    saw_batch = False
    in_flight: collections.deque = collections.deque()   # (event, host)
    t_start = time.perf_counter()

    def on_epoch_end(epoch):
        if epoch % 10 == 0 or epoch == cfg.num_epochs - 1:
            m = {k: float(v) for k, v in last_metrics.items()}
            dt = time.perf_counter() - t_start
            logger.log("ad_epoch", epoch=epoch, steps=steps_done,
                       steps_per_sec=steps_done / max(dt, 1e-9), **m)
        if checkpoint_fn and cfg.snapshot_every and (
                (epoch + 1) % cfg.snapshot_every == 0
                or epoch == cfg.num_epochs - 1):
            checkpoint_fn(epoch, state)

    while True:
        with profiling.span("ad.feed_wait"):
            item = q.get()
        if item is None:
            break
        if isinstance(item, BaseException):
            raise item
        epoch, host = item
        if saw_batch and epoch != cur_epoch:
            on_epoch_end(cur_epoch)
        on_dev = [x.to(dev, non_blocking=pin) for x in host]
        if pin:
            ev = torch.cuda.Event()
            ev.record()
            in_flight.append((ev, host))
            while in_flight and in_flight[0][0].query():
                in_flight.popleft()
        seed = int(seed_rng.integers(0, 2 ** 31 - 1))
        if bank is None:
            last_metrics = step_fn(state, *on_dev, epoch, seed)
        else:
            last_metrics = step_fn(state, on_dev[0], epoch, seed)
        if on_step is not None:
            on_step(steps_done, epoch, last_metrics)
        steps_done += 1
        cur_epoch = epoch
        saw_batch = True
    if saw_batch:
        on_epoch_end(cur_epoch)
    th.join()
    if pin:
        torch.cuda.synchronize(dev)
    in_flight.clear()
    return decoder, state, last_metrics
