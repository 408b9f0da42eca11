"""Experiment pipeline of the port: config + data + training + checkpoints
+ sampling + evaluation around the experiment-dir convention.

Counterpart of the JAX package's `pipeline.py`: the main path `train-ad`
-> `train-diff` -> `sample` -> `eval` (from `analytic:` or `sdf:` data),
latent interpolation and sphere-traced renders, the amortized encoder
(`train-encoder`) and reconstruction from observations (`reconstruct`). Stage 2 reads stage 1's
checkpoint read-only (frozen codes); sampling reads both; every stage
resumes from its latest checkpoint (utils.checkpoint.StageCheckpointer,
torch files). Every entry point takes `device` (default "cuda", which
raises without a card; pass "cpu" to run on the CPU). Every decode goes
through `ops.cuda_kernels.make_kernel_apply`: kernel #1 on a card, its
plain version (bf16 fast_apply) on the CPU.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch.config import (
    ExperimentConfig, experiment_layout)
from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler import (
    ddim_sample, ddpm_sample, dpm_solver_sample, guided_denoise_fn)
from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule import (
    DiffusionSchedule)
from latent_diffusion_models_for_shape_sdfs_torch.evaluation import (
    chamfer_l2, fscore, normal_consistency, sample_mesh_surface_with_normals,
    sdf_normals)
from latent_diffusion_models_for_shape_sdfs_torch.models.decoder import (
    SdfDecoder)
from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
    make_kernel_apply)
from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
    decode_grid, decode_grid_adaptive)
from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
    extract_mesh, simplify_mesh)
from latent_diffusion_models_for_shape_sdfs_torch.train.auto_decoder import (
    AdTrainState, init_ad_state, train_auto_decoder)
from latent_diffusion_models_for_shape_sdfs_torch.train.diffusion import (
    chunk_seed, init_diff_state, train_diffusion, unnormalize_codes)
from latent_diffusion_models_for_shape_sdfs_torch.utils import (
    meshio, profiling)
from latent_diffusion_models_for_shape_sdfs_torch.utils.checkpoint import (
    StageCheckpointer, ad_state_tree, diff_state_tree, enc_state_tree,
    restore_ad_state, restore_diff_state, restore_enc_state)
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)
from latent_diffusion_models_for_shape_sdfs_torch.utils.logging import (
    MetricLogger)


def build_dataset(cfg: ExperimentConfig) -> SdfDataset:
    """The experiment's SDF sample store: `analytic:<family>` (closed-form
    shapes) or `sdf:<dir>` (the `preprocess` tool's .npz files,
    SdfDataset.from_dir). Build an analytic store before CUDA is first
    touched where you can: from_analytic's process pool forks until then
    and must spawn after."""
    src = cfg.data_source
    if src.startswith("analytic:"):
        family = src.split(":", 1)[1]
        shapes = analytic.make_synthetic_split(family, cfg.ad.num_scenes,
                                               seed=cfg.ad.seed)
        return SdfDataset.from_analytic(shapes)
    if src.startswith("sdf:"):
        return SdfDataset.from_dir(src.split(":", 1)[1])
    raise ValueError(f"unknown data source {src!r}")


# --------------------------------------------------------------- stage 1


def run_train_ad(exp_dir: str, resume: bool = False,
                 dataset: Optional[SdfDataset] = None,
                 fault_inject_epoch: Optional[int] = None,
                 debug_nans: bool = False, tensorboard: bool = False,
                 device="cuda", dist_backend: str = "nccl") -> AdTrainState:
    """Stage-1 training with a full-state checkpoint every
    `ad.snapshot_every` epochs and after the last. `resume` continues from
    the latest checkpoint. `fault_inject_epoch`: exit with SystemExit(42)
    right after that epoch's checkpoint (the failure-recovery drill;
    resume with `resume=True`). `debug_nans`: train under
    utils.profiling.debug_nans (the first op or kernel that writes a NaN
    raises FloatingPointError). `tensorboard`: mirror the log's scalars
    into event files under logs/tb/ad.

    Under `torchrun` (WORLD_SIZE > 1) each process is one rank: it starts
    the process group from the environment with `dist_backend` (nccl: one
    card a rank, pinned to cuda:LOCAL_RANK; gloo: any), trains with the
    data-parallel step when `ad.data_parallel` is set, and at the end
    checks that every rank holds the same parameters (one all_reduce of
    a checksum). Only rank 0 writes the log and the checkpoints; every
    rank reads them on resume."""
    import torch.distributed as dist
    cfg = ExperimentConfig.load(exp_dir)
    lay = experiment_layout(exp_dir)
    started = (int(os.environ.get("WORLD_SIZE", "1")) > 1
               and not dist.is_initialized())
    if started:
        from latent_diffusion_models_for_shape_sdfs_torch.parallel.mesh \
            import init_from_env
        device = init_from_env(dist_backend, device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank == 0:
        logger = MetricLogger(lay["logs"] / "train_ad.jsonl", echo=True,
                              tensorboard=(lay["logs"] / "tb" / "ad")
                              if tensorboard else None)
    else:
        logger = MetricLogger()
    dataset = dataset or build_dataset(cfg)
    dev = resolve_device(device)
    decoder = SdfDecoder(cfg.ad.decoder)
    ckpt = StageCheckpointer(exp_dir, "auto_decoder")
    state = init_ad_state(cfg.ad, decoder, seed=cfg.ad.seed, device=dev)
    start_epoch = 0
    if resume and ckpt.latest_step() is not None:
        start_epoch = restore_ad_state(state, ckpt.restore()) + 1
        logger.log("resume", stage="auto_decoder", epoch=start_epoch)

    def save(epoch, st):
        if rank == 0:
            ckpt.save(epoch, ad_state_tree(st, epoch))
        if fault_inject_epoch is not None and epoch >= fault_inject_epoch:
            logger.log("fault_injected", epoch=epoch)
            raise SystemExit(42)

    try:
        with profiling.debug_nans(debug_nans):
            _, state, _ = train_auto_decoder(
                cfg.ad, dataset, logger=logger, decoder=decoder, state=state,
                start_epoch=start_epoch, checkpoint_fn=save, device=dev)
        save(cfg.ad.num_epochs - 1, state)
        if dist.is_initialized() and dist.get_world_size() > 1:
            from latent_diffusion_models_for_shape_sdfs_torch.parallel import (
                dp, mesh)
            logger.log("replicas_equal", ranks=dist.get_world_size(),
                       checksum=dp.check_replicas(state, mesh.make_mesh()))
    finally:
        logger.close()
        if started:
            dist.destroy_process_group()
    return state


def load_ad_state(exp_dir: str, device="cuda") -> tuple:
    """(decoder, AdTrainState) from the latest stage-1 checkpoint."""
    cfg = ExperimentConfig.load(exp_dir)
    decoder = SdfDecoder(cfg.ad.decoder)
    state = init_ad_state(cfg.ad, decoder, seed=cfg.ad.seed, device=device)
    restore_ad_state(state, StageCheckpointer(exp_dir,
                                              "auto_decoder").restore())
    return decoder, state


# --------------------------------------------------------------- stage 2


def _cond_banks(cfg: ExperimentConfig, dataset: Optional[SdfDataset]):
    """(class_ids, obs_xyz, obs_sdf) conditioning banks for training: the
    dataset's class ids, and per scene a balanced draw of obs_bank_points
    (0: 4 x partial_points) observation rows from
    `np.random.default_rng(diff.seed)` (the reference's bank bit for
    bit), which the step re-subsamples to partial_points."""
    dn = cfg.diff.denoiser
    class_ids = obs_xyz = obs_sdf = None
    if dataset is not None and dn.num_classes > 0:
        class_ids = dataset.class_ids
    if dataset is not None and dn.partial_sdf_cond:
        rng = np.random.default_rng(cfg.diff.seed)
        bank = dn.obs_bank_points or 4 * dn.partial_points
        xs, ds_ = [], []
        for i in range(len(dataset)):
            rows = dataset.sample_scene(i, bank, rng)
            xs.append(rows[:, :3])
            ds_.append(rows[:, 3])
        obs_xyz = np.stack(xs)
        obs_sdf = np.stack(ds_)
    return class_ids, obs_xyz, obs_sdf


def run_train_diff(exp_dir: str, resume: bool = False,
                   dataset: Optional[SdfDataset] = None,
                   tensorboard: bool = False, device="cuda") -> tuple:
    """Stage-2 training on the frozen stage-1 codes, with a full-state
    checkpoint every `diff.snapshot_every` steps and after the last;
    `resume` continues from the latest. Returns (model, state, (mu,
    sigma))."""
    cfg = ExperimentConfig.load(exp_dir)
    lay = experiment_layout(exp_dir)
    logger = MetricLogger(lay["logs"] / "train_diff.jsonl", echo=True,
                          tensorboard=(lay["logs"] / "tb" / "diff")
                          if tensorboard else None)
    if dataset is None and (cfg.diff.denoiser.num_classes > 0
                            or cfg.diff.denoiser.partial_sdf_cond):
        dataset = build_dataset(cfg)
    class_ids, obs_xyz, obs_sdf = _cond_banks(cfg, dataset)
    dev = resolve_device(device)
    _, ad_state = load_ad_state(exp_dir, device=dev)
    ckpt = StageCheckpointer(exp_dir, "diffusion")
    state = init_diff_state(cfg.diff, seed=cfg.diff.seed, device=dev)
    if resume and ckpt.latest_step() is not None:
        restore_diff_state(state, ckpt.restore())
        logger.log("resume", stage="diffusion", step=state.step)

    def save(step, st, mu, sigma):
        ckpt.save(step, diff_state_tree(st, mu, sigma))

    model, state, (mu, sigma), _ = train_diffusion(
        cfg.diff, ad_state.codes.detach(), class_ids=class_ids,
        obs_xyz=obs_xyz, obs_sdf=obs_sdf, logger=logger, state=state,
        checkpoint_fn=save, device=dev)
    save(state.step, state, mu, sigma)
    logger.close()
    return model, state, (mu, sigma)


def load_diff_state(exp_dir: str, device="cuda") -> tuple:
    """(model, DiffTrainState, (mu, sigma)) from the latest stage-2
    checkpoint."""
    cfg = ExperimentConfig.load(exp_dir)
    state = init_diff_state(cfg.diff, seed=cfg.diff.seed, device=device)
    mu, sigma = restore_diff_state(
        state, StageCheckpointer(exp_dir, "diffusion").restore())
    return state.model, state, (mu, sigma)


# ------------------------------------------------- amortized encoder

BANK_TAG = 0xBA17        # the encoder bank's stream, apart from the steps'
BANK_BLOCK = 512         # chairs sampled on the device at once


def _enc_bank(cfg: ExperimentConfig, dataset: Optional[SdfDataset],
              device="cuda") -> tuple:
    """Per-scene observation bank [S, P, 3] / [S, P] for encoder training,
    P = encoder.obs_bank_points (0: 4 x n_obs).

    `analytic:chair`: sampled on `device` by data.analytic_device (the
    preprocessor's sample distribution), each block of 512 chairs from a
    generator keyed by (encoder.seed, 0xBA17, block start); returns
    tensors. Every other source: the store's balanced draw
    (`dataset.sample_scene`) from `np.random.default_rng(encoder.seed)`,
    as the reference draws it; returns numpy arrays."""
    ec = cfg.encoder
    bank = ec.obs_bank_points or 4 * ec.n_obs
    if cfg.data_source == "analytic:chair":
        from latent_diffusion_models_for_shape_sdfs_torch.data import (
            analytic_device)
        dev = resolve_device(device)
        shapes = analytic.make_synthetic_split("chair", cfg.ad.num_scenes,
                                               seed=cfg.ad.seed)
        xs, ds_ = [], []
        for start in range(0, len(shapes), BANK_BLOCK):
            params = analytic_device.pack_chairs(
                shapes[start:start + BANK_BLOCK], device=dev)
            gen = torch.Generator(device=dev).manual_seed(
                chunk_seed(ec.seed, BANK_TAG, start))
            xyz, d = analytic_device.sample_sdf_points_device(params, gen,
                                                              bank)
            xs.append(xyz)
            ds_.append(d)
        return torch.cat(xs), torch.cat(ds_)
    rng = np.random.default_rng(ec.seed)
    xs, ds_ = [], []
    for i in range(len(dataset)):
        rows = dataset.sample_scene(i, bank, rng)
        xs.append(rows[:, :3])
        ds_.append(rows[:, 3])
    return np.stack(xs), np.stack(ds_)


def run_train_encoder(exp_dir: str, resume: bool = False,
                      dataset: Optional[SdfDataset] = None,
                      tensorboard: bool = False, device="cuda") -> tuple:
    """Train the amortized latent encoder against the frozen stage-1 table
    (train.encoder), with a full-state checkpoint when a multiple of
    `encoder.snapshot_every` is crossed and after the last step; `resume`
    continues from the latest. Needs a completed train-ad stage. The
    store is built only for sources other than `analytic:chair`, whose
    bank is sampled on the device. Returns (model, state, (mu, sigma))."""
    from latent_diffusion_models_for_shape_sdfs_torch.train.encoder import (
        init_enc_state, train_encoder)
    cfg = ExperimentConfig.load(exp_dir)
    lay = experiment_layout(exp_dir)
    logger = MetricLogger(lay["logs"] / "train_enc.jsonl", echo=True,
                          tensorboard=(lay["logs"] / "tb" / "enc")
                          if tensorboard else None)
    if dataset is None and cfg.data_source != "analytic:chair":
        dataset = build_dataset(cfg)
    dev = resolve_device(device)
    obs_xyz, obs_sdf = _enc_bank(cfg, dataset, device=dev)
    _, ad_state = load_ad_state(exp_dir, device=dev)
    ckpt = StageCheckpointer(exp_dir, "encoder")
    state = init_enc_state(cfg.encoder, seed=cfg.encoder.seed, device=dev)
    if resume and ckpt.latest_step() is not None:
        restore_enc_state(state, ckpt.restore())
        logger.log("resume", stage="encoder", step=state.step)

    def save(step, st, mu, sigma):
        ckpt.save(step, enc_state_tree(st, mu, sigma))

    model, state, (mu, sigma), _ = train_encoder(
        cfg.encoder, ad_state.codes.detach(), obs_xyz, obs_sdf,
        logger=logger, state=state, checkpoint_fn=save, device=dev)
    save(state.step, state, mu, sigma)
    logger.close()
    return model, state, (mu, sigma)


def load_encoder_state(exp_dir: str, device="cuda") -> tuple:
    """(model, EncTrainState, (mu, sigma)) from the latest encoder
    checkpoint, the model in eval mode."""
    from latent_diffusion_models_for_shape_sdfs_torch.train.encoder import (
        init_enc_state)
    cfg = ExperimentConfig.load(exp_dir)
    state = init_enc_state(cfg.encoder, seed=cfg.encoder.seed, device=device)
    mu, sigma = restore_enc_state(
        state, StageCheckpointer(exp_dir, "encoder").restore())
    state.model.eval()
    return state.model, state, (mu, sigma)


# --------------------------------------------------------------- sampling


def _obs_cond_batch(obs_xyz: np.ndarray, obs_sdf: np.ndarray, npts: int,
                    num: int, seed: int, device="cpu") -> tuple:
    """One observation set [N,3]/[N] -> fixed-size conditioning batch
    (num, npts, 3)/(num, npts) on `device` (subsample without replacement
    when N >= npts, else with; the reference's draw)."""
    obs_xyz = np.asarray(obs_xyz, np.float32)
    obs_sdf = np.asarray(obs_sdf, np.float32)
    n = len(obs_xyz)
    rng = np.random.default_rng(seed)
    idx = (rng.permutation(n)[:npts] if n >= npts
           else rng.integers(0, n, npts))
    ox = torch.from_numpy(obs_xyz[idx]).to(device).expand(num, npts, 3)
    od = torch.from_numpy(obs_sdf[idx]).to(device).expand(num, npts)
    return ox, od


def run_sample(exp_dir: str, num: Optional[int] = None,
               res: Optional[int] = None, class_id: Optional[int] = None,
               seed: Optional[int] = None, use_ema: bool = True,
               write_meshes: bool = True,
               obs_xyz: Optional[np.ndarray] = None,
               obs_sdf: Optional[np.ndarray] = None,
               mesh_format: str = "obj",
               simplify_faces: Optional[int] = None,
               simplify_ratio: Optional[float] = None,
               device="cuda") -> list:
    """Sample latents (DDIM / DPM-Solver++(2M) / DDPM, `sample.sampler`,
    from a torch.Generator on `device` seeded with `seed`), decode them to
    meshes under <exp>/samples. Returns a list of (verts, faces).

    `obs_xyz [N,3]` / `obs_sdf [N]`: observed SDF samples of one target
    shape, conditioning all `num` samples (needs a denoiser trained with
    `partial_sdf_cond`)."""
    cfg = ExperimentConfig.load(exp_dir)
    if obs_xyz is not None and not cfg.diff.denoiser.partial_sdf_cond:
        raise ValueError(
            "observations given but the denoiser was trained without "
            "partial_sdf_cond (set diff.denoiser.partial_sdf_cond=true)")
    lay = experiment_layout(exp_dir)
    sc = cfg.sample
    num = num or sc.num_samples
    res = res or sc.grid_res
    seed = sc.seed if seed is None else seed
    dev = resolve_device(device)

    decoder, ad_state = load_ad_state(exp_dir, device=dev)
    model, dstate, (mu, sigma) = load_diff_state(exp_dir, device=dev)
    if use_ema:
        model.load_state_dict(dstate.ema)
    model.eval()
    schedule = DiffusionSchedule.create(cfg.diff.timesteps,
                                        cfg.diff.beta_start,
                                        cfg.diff.beta_end, device=dev)
    cid = (torch.full((num,), class_id, dtype=torch.long, device=dev)
           if class_id is not None else None)
    cond = {}
    if obs_xyz is not None:
        ox, od = _obs_cond_batch(obs_xyz, obs_sdf,
                                 cfg.diff.denoiser.partial_points, num, seed,
                                 device=dev)
        cond = {"obs_xyz": ox, "obs_sdf": od}
    fn = guided_denoise_fn(model, sc.guidance_scale, class_id=cid, **cond)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    L = cfg.diff.denoiser.latent_size
    if sc.sampler == "ddim":
        zn = ddim_sample(fn, schedule, gen, num, L, steps=sc.ddim_steps)
    elif sc.sampler == "dpm":
        zn = dpm_solver_sample(fn, schedule, gen, num, L, steps=sc.dpm_steps)
    else:
        zn = ddpm_sample(fn, schedule, gen, num, L)
    zs = unnormalize_codes(zn, mu, sigma)

    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=dev)
    out_dir = lay["samples"] if write_meshes else None
    return _decode_latents_to_meshes(apply_fn, zs, res, cfg,
                                     out_dir=out_dir, prefix="sample",
                                     mesh_format=mesh_format,
                                     simplify_faces=simplify_faces,
                                     simplify_ratio=simplify_ratio,
                                     device=dev)


def decoder_params(ad_state: AdTrainState) -> dict:
    """The trained decoder's state dict, detached."""
    return {k: v.detach() for k, v in ad_state.decoder.state_dict().items()}


def _decode_latents_to_meshes(apply_fn, zs, res: int, cfg, out_dir=None,
                              prefix: str = "sample",
                              mesh_format: str = "obj",
                              simplify_faces=None, simplify_ratio=None,
                              device="cuda") -> list:
    """Decode a batch of latents to meshes; write <out_dir>/<prefix>_###
    files when out_dir is given. Returns a list of (verts, faces).

    Resolutions >= 64 and 16-divisible at iso 0 take the serving path
    (serve.serve_meshes: every decode enqueued up front, the near-surface
    payload to the host; int8, or float32 in the fp32 parity mode).
    Otherwise each latent goes through decode_grid_adaptive (or the dense
    decode with `sample.hierarchical` off) and extract_mesh."""
    sc = cfg.sample
    meshes = []

    def _emit(i, v, f):
        meshes.append((v, f))
        if out_dir is not None:
            meshio.write_mesh(out_dir / f"{prefix}_{i:03d}.{mesh_format}",
                              v, f)

    if sc.hierarchical and res >= 64 and res % 16 == 0 \
            and sc.iso_level == 0.0:
        from latent_diffusion_models_for_shape_sdfs_torch.serve import (
            serve_meshes)
        payload_dtype = ("float32"
                         if cfg.ad.decoder.compute_dtype == "float32"
                         else "int8")
        for i, (v, f, _st) in enumerate(serve_meshes(
                apply_fn, list(zs), res=res, iso=sc.iso_level,
                out_dtype=payload_dtype, simplify_faces=simplify_faces,
                simplify_ratio=simplify_ratio, device=device)):
            _emit(i, v, f)
        return meshes
    for i in range(len(zs)):
        if sc.hierarchical:
            grid = decode_grid_adaptive(apply_fn, zs[i], res,
                                        chunk=sc.grid_chunk)
        else:
            grid = decode_grid(apply_fn, zs[i], res,
                               chunk=sc.grid_chunk).cpu().numpy()
        v, f = extract_mesh(grid, iso=sc.iso_level)
        if simplify_faces is not None or simplify_ratio is not None:
            v, f = simplify_mesh(v, f, target_faces=simplify_faces,
                                 ratio=simplify_ratio)
        _emit(i, v, f)
    return meshes


def run_interpolate(exp_dir: str, scene_a: int, scene_b: int,
                    steps: int = 8, res: Optional[int] = None,
                    mode: str = "lerp", name: str = "interp",
                    mesh_format: str = "obj",
                    simplify_faces: Optional[int] = None,
                    simplify_ratio: Optional[float] = None,
                    device="cuda") -> list:
    """Latent-space shape morphing: decode meshes at `steps` evenly spaced
    latents on the path between two trained stage-1 codes.

    `mode`: "lerp" (straight line, the lineage convention) or "slerp"
    (great-circle path at interpolated norm, falling back to lerp when
    the codes are (anti)parallel). The path is computed on the host in
    float64, as the reference does. Writes
    <exp>/interpolations/<name>_###.<mesh_format>; returns the list of
    (verts, faces)."""
    cfg = ExperimentConfig.load(exp_dir)
    lay = experiment_layout(exp_dir)
    res = res or cfg.sample.grid_res
    dev = resolve_device(device)
    decoder, ad_state = load_ad_state(exp_dir, device=dev)
    codes = ad_state.codes.detach().cpu().numpy()
    for s in (scene_a, scene_b):
        if not 0 <= s < len(codes):
            raise ValueError(f"scene id {s} out of range [0, {len(codes)})")
    za = np.asarray(codes[scene_a], np.float64)
    zb = np.asarray(codes[scene_b], np.float64)
    t = np.linspace(0.0, 1.0, steps)[:, None]
    if mode == "slerp":
        na, nb = np.linalg.norm(za), np.linalg.norm(zb)
        ua, ub = za / na, zb / nb
        cos = float(np.clip(np.dot(ua, ub), -1.0, 1.0))
        omega = np.arccos(cos)
        if np.sin(omega) < 1e-6:
            # parallel (omega~0) or antiparallel (omega~pi): the
            # great circle is degenerate/undefined, fall back to lerp
            zs = (1 - t) * za + t * zb
        else:
            arc = (np.sin((1 - t) * omega) * ua
                   + np.sin(t * omega) * ub) / np.sin(omega)
            zs = arc * ((1 - t) * na + t * nb)
    elif mode == "lerp":
        zs = (1 - t) * za + t * zb
    else:
        raise ValueError(f"unknown interpolation mode {mode!r}")
    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=dev)
    lay["interpolations"].mkdir(parents=True, exist_ok=True)
    return _decode_latents_to_meshes(
        apply_fn, torch.as_tensor(zs.astype(np.float32), device=dev), res,
        cfg, out_dir=lay["interpolations"], prefix=name,
        mesh_format=mesh_format, simplify_faces=simplify_faces,
        simplify_ratio=simplify_ratio, device=dev)


# ----------------------------------------------------------- render


def run_render(exp_dir: str, scene: int = 0,
               latent_file: Optional[str] = None,
               name: str = "render", size: int = 512,
               frames: int = 1, steps: int = 96, device="cuda") -> list:
    """Sphere-trace a trained latent straight off the decoder (ops.render
    through kernel #1, no grid decode, no meshing) and write PNG previews
    under <exp>/renders/. `latent_file` (.npy, [L] or [k,L]: row 0)
    overrides `scene`. `frames` > 1 writes a turntable. Returns the list
    of written paths."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.render import (
        render_sdf, render_turntable)
    from latent_diffusion_models_for_shape_sdfs_torch.utils.image import (
        write_png)
    lay = experiment_layout(exp_dir)
    dev = resolve_device(device)
    decoder, ad_state = load_ad_state(exp_dir, device=dev)
    if latent_file is not None:
        z = np.asarray(np.load(latent_file), np.float32)
        z = torch.from_numpy(z[0] if z.ndim == 2 else z).to(dev)
    else:
        n_codes = int(ad_state.codes.shape[0])
        if not 0 <= scene < n_codes:
            raise ValueError(f"scene id {scene} out of range [0, {n_codes})")
        z = ad_state.codes.detach()[scene]
    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=dev)
    lay["renders"].mkdir(parents=True, exist_ok=True)
    paths = []
    if frames <= 1:
        rgb, _ = render_sdf(apply_fn, z, width=size, height=size,
                            steps=steps)
        paths.append(lay["renders"] / f"{name}.png")
        write_png(paths[-1], rgb)
    else:
        for i, (rgb, _) in enumerate(render_turntable(
                apply_fn, z, frames=frames, width=size, height=size,
                steps=steps)):
            paths.append(lay["renders"] / f"{name}_{i:03d}.png")
            write_png(paths[-1], rgb)
    return paths


# ----------------------------------------------------------- reconstruct


def run_reconstruct(exp_dir: str, obs_xyz: np.ndarray, obs_sdf: np.ndarray,
                    name: str = "recon", res: Optional[int] = None,
                    mesh_format: str = "obj",
                    simplify_faces: Optional[int] = None,
                    simplify_ratio: Optional[float] = None,
                    diffusion_prior: bool = False, sds_weight: float = 1e-3,
                    encoder: bool = False,
                    refine_steps: Optional[int] = None,
                    device="cuda") -> tuple:
    """Latent-optimise against observations, decode (dense `decode_grid`
    through kernel #1 at `res`, default sample.grid_res), write the mesh
    to <exp>/reconstructions/<name>.<mesh_format> (optional QEM LOD).

    `diffusion_prior=True` adds the trained stage-2 EMA denoiser's score
    distillation (reconstruct.reconstruct_latent_diffusion_prior; needs a
    train-diff stage). `encoder=True` starts from the amortized encoder's
    one-shot prediction (needs a train-encoder stage), then runs
    `refine_steps` latent-optimisation steps warm-started there (lr drop
    at half of them; 0 = the one-shot alone; None = the full
    reconstruct.num_steps budget). The two are exclusive. Returns (z
    [L] tensor, verts, faces)."""
    import dataclasses
    from latent_diffusion_models_for_shape_sdfs_torch.reconstruct import (
        reconstruct_latent, reconstruct_latent_diffusion_prior)
    if encoder and diffusion_prior:
        raise ValueError("--encoder and --diffusion-prior are mutually "
                         "exclusive reconstruction modes")
    cfg = ExperimentConfig.load(exp_dir)
    lay = experiment_layout(exp_dir)
    res = res or cfg.sample.grid_res
    dev = resolve_device(device)
    decoder, ad_state = load_ad_state(exp_dir, device=dev)
    ox = torch.as_tensor(np.asarray(obs_xyz, np.float32), device=dev)
    od = torch.as_tensor(np.asarray(obs_sdf, np.float32), device=dev)
    if encoder:
        from latent_diffusion_models_for_shape_sdfs_torch.models.encoder \
            import encode_latent
        enc, _, (emu, esig) = load_encoder_state(exp_dir, device=dev)
        z = encode_latent(enc, ox, od, emu, esig)
        if refine_steps is None or refine_steps > 0:
            rcfg = cfg.reconstruct
            if refine_steps is not None:
                rcfg = dataclasses.replace(
                    rcfg, num_steps=refine_steps,
                    lr_decay_at=max(refine_steps // 2, 1))
            z, _ = reconstruct_latent(decoder, ox, od, rcfg, z_init=z)
    elif diffusion_prior:
        model, dstate, (mu, sigma) = load_diff_state(exp_dir, device=dev)
        model.load_state_dict(dstate.ema)
        model.eval()
        schedule = DiffusionSchedule.create(
            cfg.diff.timesteps, cfg.diff.beta_start, cfg.diff.beta_end,
            device=dev)
        z, _ = reconstruct_latent_diffusion_prior(
            decoder, ox, od, guided_denoise_fn(model, 0.0), schedule, mu,
            sigma, cfg.reconstruct, sds_weight=sds_weight)
    else:
        z, _ = reconstruct_latent(decoder, ox, od, cfg.reconstruct)
    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=dev)
    grid = decode_grid(apply_fn, z, res,
                       chunk=cfg.sample.grid_chunk).cpu().numpy()
    v, f = extract_mesh(grid)
    if simplify_faces is not None or simplify_ratio is not None:
        v, f = simplify_mesh(v, f, target_faces=simplify_faces,
                             ratio=simplify_ratio)
    meshio.write_mesh(lay["reconstructions"] / f"{name}.{mesh_format}", v, f)
    return z, v, f


# ------------------------------------------------------------------ eval


def run_eval(exp_dir: str, num_points: int = 30_000,
             fscore_tau: float = 0.01, device="cuda") -> dict:
    """Chamfer-L2 and F-score@tau (+ normal consistency where GT normals
    exist) of each training scene's mesh (its code, dense decode at
    `sample.grid_res`) against its ground truth.

    GT surfaces: `analytic:` sources sample the closed-form surface (GT
    normals = the exact SDF's gradient); `sdf:` sources use the first
    `num_points` rows of the `surface` array the preprocess tool stores
    per scene (in the normalized frame the decoder trains in; no stored
    normals, so normal consistency is skipped). Scenes beyond the trained
    codes are not evaluated. Writes <exp>/evals/chamfer.json and returns
    the same dict."""
    import pathlib
    cfg = ExperimentConfig.load(exp_dir)
    lay = experiment_layout(exp_dir)
    gt_normals = None
    if cfg.data_source.startswith("analytic:"):
        shapes = analytic.make_synthetic_split(
            cfg.data_source.split(":", 1)[1], cfg.ad.num_scenes,
            seed=cfg.ad.seed)

        def gt_normals(i, pts):
            return sdf_normals(lambda p: analytic.sdf(shapes[i], p), pts)

        def gt_points(i):
            return analytic.sample_surface(shapes[i], num_points,
                                           np.random.default_rng(i))
        n_scenes = len(shapes)
    elif cfg.data_source.startswith("sdf:"):
        files = sorted(pathlib.Path(
            cfg.data_source.split(":", 1)[1]).glob("*.npz"))

        def gt_points(i):
            with np.load(files[i]) as z:
                if "surface" not in z.files:
                    raise ValueError(
                        f"{files[i]} has no 'surface' array; re-run the "
                        "preprocess tool to store GT surface samples for "
                        "eval")
                return np.asarray(z["surface"], np.float32)[:num_points]
        n_scenes = len(files)
    else:
        raise ValueError(f"run_eval: no GT surface source for "
                         f"{cfg.data_source!r}")
    dev = resolve_device(device)
    decoder, ad_state = load_ad_state(exp_dir, device=dev)
    # a data dir may hold more files than the run trained codes for
    n_scenes = min(n_scenes, int(ad_state.codes.shape[0]))
    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=dev)
    codes = ad_state.codes.detach()
    results, f_results, nc_results = {}, {}, {}
    for i in range(n_scenes):
        grid = decode_grid(apply_fn, codes[i], cfg.sample.grid_res,
                           chunk=cfg.sample.grid_chunk).cpu().numpy()
        v, f = extract_mesh(grid)
        if len(f) == 0:
            results[str(i)] = float("inf")
            f_results[str(i)] = 0.0
            continue
        pred, pred_nrm = sample_mesh_surface_with_normals(
            v, f, num_points, seed=i)
        gt = gt_points(i)
        results[str(i)] = chamfer_l2(pred, gt)
        f_results[str(i)] = fscore(pred, gt, tau=fscore_tau)["fscore"]
        if gt_normals is not None:
            nc_results[str(i)] = normal_consistency(
                pred, pred_nrm, gt, gt_normals(i, gt))
    finite = [x for x in results.values() if np.isfinite(x)]
    out = {"chamfer_l2": results,
           "mean": float(np.mean(finite)) if finite else float("inf"),
           "num_failed": len(results) - len(finite),
           "fscore_tau": fscore_tau,
           "fscore": f_results,
           "fscore_mean": float(np.mean(list(f_results.values())))}
    if nc_results:
        out["normal_consistency"] = nc_results
        out["normal_consistency_mean"] = float(
            np.mean(list(nc_results.values())))
    lay["evals"].mkdir(parents=True, exist_ok=True)
    (lay["evals"] / "chamfer.json").write_text(json.dumps(out, indent=2))
    return out
