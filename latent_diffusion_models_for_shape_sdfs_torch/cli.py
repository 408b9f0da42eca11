"""CLI of the port: the main path's subcommands.

    python -m latent_diffusion_models_for_shape_sdfs_torch [--device cpu] <cmd> ...

Counterpart of the JAX package's `cli.py`, with its flags, for
`init-experiment`, `train-ad`, `train-diff`, `train-encoder`, `sample`,
`interpolate`, `render`, `reconstruct`, `eval`, `decode`,
`export-decoder`, `serve-daemon`, `export-sampler` and `preprocess`.
Every training and eval command takes an experiment directory holding
specs.json (write one with `init-experiment`; override fields with --set
dotted.key=value). `--device` (default cuda) picks the
device every command runs on; JAX picks its platform from the
environment instead. `train-ad` also runs data-parallel under torchrun
(`torchrun --nproc-per-node N -m latent_diffusion_models_for_shape_sdfs_torch
train-ad <dir>` with `ad.data_parallel` set): one rank a card over NCCL,
or `--dist-backend gloo`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys


def _parse_value(s: str):
    try:
        return json.loads(s)
    except json.JSONDecodeError:
        return s


def cmd_init(args):
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig, override)
    cfg = ExperimentConfig(name=pathlib.Path(args.exp_dir).name,
                           data_source=args.data)
    overrides = {"ad.num_scenes": args.scenes} if args.scenes else {}
    for kv in args.set or []:
        k, v = kv.split("=", 1)
        overrides[k] = _parse_value(v)
    if overrides:
        cfg = override(cfg, **overrides)
    path = cfg.save(args.exp_dir)
    print(f"wrote {path}")


def cmd_train_ad(args):
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_train_ad)
    run_train_ad(args.exp_dir, resume=args.resume,
                 fault_inject_epoch=args.fault_inject,
                 debug_nans=args.debug_nans, tensorboard=args.tensorboard,
                 device=args.device, dist_backend=args.dist_backend)
    print("stage-1 training complete")


def cmd_train_diff(args):
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_train_diff)
    run_train_diff(args.exp_dir, resume=args.resume,
                   tensorboard=args.tensorboard, device=args.device)
    print("stage-2 training complete")


def cmd_train_encoder(args):
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_train_encoder)
    run_train_encoder(args.exp_dir, resume=args.resume,
                      tensorboard=args.tensorboard, device=args.device)
    print("encoder training complete")


def _load_obs_rows(path: str):
    """.npz with pos/neg [N,4] rows (native preprocess format) or a single
    [N,4] array -> (xyz [N,3], sdf [N])."""
    import numpy as np
    with np.load(path) as z:
        rows = (np.concatenate([z["pos"], z["neg"]])
                if "pos" in z.files else z[z.files[0]])
    rows = np.asarray(rows, np.float32)
    return rows[:, :3], rows[:, 3]


def cmd_sample(args):
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_sample)
    obs_xyz = obs_sdf = None
    if args.obs:
        obs_xyz, obs_sdf = _load_obs_rows(args.obs)
    meshes = run_sample(args.exp_dir, num=args.num, res=args.res,
                        class_id=args.class_id, seed=args.seed,
                        obs_xyz=obs_xyz, obs_sdf=obs_sdf,
                        mesh_format=args.format,
                        simplify_ratio=args.simplify,
                        simplify_faces=args.simplify_faces,
                        device=args.device)
    print(f"wrote {len(meshes)} meshes under "
          f"{pathlib.Path(args.exp_dir) / 'samples'}")


def cmd_interpolate(args):
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_interpolate)
    meshes = run_interpolate(args.exp_dir, args.scene_a, args.scene_b,
                             steps=args.steps, res=args.res,
                             mode=args.mode, name=args.name,
                             mesh_format=args.format,
                             simplify_ratio=args.simplify,
                             simplify_faces=args.simplify_faces,
                             device=args.device)
    print(f"wrote {len(meshes)} interpolation meshes under "
          f"{pathlib.Path(args.exp_dir) / 'interpolations'}")


def cmd_render(args):
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_render)
    paths = run_render(args.exp_dir, scene=args.scene,
                       latent_file=args.latent, name=args.name,
                       size=args.size, frames=args.frames,
                       steps=args.march_steps, device=args.device)
    print(f"wrote {len(paths)} render(s): "
          f"{', '.join(p.name for p in paths)} under "
          f"{pathlib.Path(args.exp_dir) / 'renders'}")


def cmd_reconstruct(args):
    """Observations (--obs rows, or --points samples of a demo analytic
    shape) -> latent -> mesh under <exp>/reconstructions."""
    import numpy as np
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_reconstruct)
    if args.obs:
        xyz, d = _load_obs_rows(args.obs)
        rows = np.concatenate([xyz, d[:, None]], axis=1)
    else:  # analytic demo observation set
        from latent_diffusion_models_for_shape_sdfs_torch.data import analytic
        shape = analytic.make_shape(args.analytic,
                                    np.random.default_rng(args.seed or 0))
        xyz, d = analytic.sample_sdf_points(shape, args.points,
                                            np.random.default_rng(1))
        rows = np.concatenate([xyz, d[:, None]], axis=1)
    idx = np.random.default_rng(2).permutation(len(rows))[:args.points]
    rows = rows[idx]
    _, v, f = run_reconstruct(args.exp_dir, rows[:, :3], rows[:, 3],
                              name=args.name, res=args.res,
                              mesh_format=args.format,
                              simplify_faces=args.simplify_faces,
                              simplify_ratio=args.simplify,
                              diffusion_prior=args.diffusion_prior,
                              sds_weight=args.sds_weight,
                              encoder=args.encoder,
                              refine_steps=args.refine_steps,
                              device=args.device)
    print(f"reconstructed mesh: {len(v)} verts, {len(f)} faces -> "
          f"{pathlib.Path(args.exp_dir) / 'reconstructions' / args.name}"
          f".{args.format}")


def cmd_eval(args):
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        run_eval)
    out = run_eval(args.exp_dir, num_points=args.points,
                   fscore_tau=args.fscore_tau, device=args.device)
    print(json.dumps(out, indent=2))


def _add_lod_flags(s):
    """--simplify / --simplify-faces on every mesh-producing command."""
    s.add_argument("--simplify", type=float, default=None,
                   help="LOD: QEM-decimate each mesh to this fraction "
                   "of its face count (native lib required)")
    s.add_argument("--simplify-faces", type=int, default=None,
                   help="LOD: QEM-decimate to an absolute face budget")


def cmd_decode(args):
    """Latent codes -> meshes: the serving path for 16-divisible
    resolutions >= 64, the adaptive decode otherwise. Codes come from
    --codes file.npy ([L] or [N, L]) or --scene ids (rows of the stage-1
    latent table)."""
    import numpy as np
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.grid_eval import (
        decode_grid_adaptive)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.isosurface import (
        extract_mesh, simplify_mesh)
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        decoder_params, load_ad_state)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        serve_meshes)
    from latent_diffusion_models_for_shape_sdfs_torch.utils import meshio
    import torch

    decoder, ad_state = load_ad_state(args.exp_dir, device=args.device)
    if args.codes:
        zs = np.asarray(np.load(args.codes), np.float32)
        zs = zs[None] if zs.ndim == 1 else zs
        names = [f"code_{i:03d}" for i in range(len(zs))]
    elif args.scene:
        zs = ad_state.codes.detach().cpu().numpy()[np.asarray(args.scene)]
        names = [f"scene_{i:03d}" for i in args.scene]
    else:
        sys.exit("decode needs --codes FILE.npy or --scene IDs")
    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=args.device)
    dev = apply_fn.device
    out_dir = pathlib.Path(args.out or
                           pathlib.Path(args.exp_dir) / "decoded")
    out_dir.mkdir(parents=True, exist_ok=True)
    res = args.res
    if res >= 64 and res % 16 == 0:
        meshes = ((v, f) for v, f, _st in
                  serve_meshes(apply_fn, list(zs), res=res,
                               simplify_ratio=args.simplify,
                               simplify_faces=args.simplify_faces,
                               device=dev))
    else:
        def one(z):
            v, f = extract_mesh(decode_grid_adaptive(
                apply_fn, torch.as_tensor(z, device=dev), res))
            if args.simplify is None and args.simplify_faces is None:
                return v, f
            return simplify_mesh(v, f, target_faces=args.simplify_faces,
                                 ratio=args.simplify)
        meshes = (one(z) for z in zs)
    for name, (v, f) in zip(names, meshes):
        nrm = meshio.vertex_normals(v, f) if args.normals else None
        meshio.write_mesh(out_dir / f"{name}.{args.format}", v, f,
                          normals=nrm)
        print(f"{name}: {len(v)} verts, {len(f)} faces -> "
              f"{out_dir / name}.{args.format}")


def cmd_export_decoder(args):
    """Serialize the trained decoder's serving decode as an artifact
    (torch.export program on --device, weights as its constants, kernel
    #1 as the op sdfldm::fused_eval on a card; loadable without model
    code via export_artifact.load_decode_program)."""
    from latent_diffusion_models_for_shape_sdfs_torch.export_artifact import (
        export_decode_program)
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        decoder_params, load_ad_state)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        _default_caps)

    decoder, ad_state = load_ad_state(args.exp_dir, device=args.device)
    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=args.device)
    out = args.out or str(pathlib.Path(args.exp_dir)
                          / f"decoder_{args.res}.zip")
    blob = export_decode_program(
        apply_fn, decoder.cfg.latent_size, args.res,
        _default_caps(args.res),
        platforms=args.platforms.split(",") if args.platforms else None,
        path=out, device=apply_fn.device)
    print(f"wrote {out} ({len(blob)} bytes, res {args.res})")


def cmd_serve_daemon(args):
    """Watch-folder serving loop: latent .npy requests in, meshes out
    (serve.watch_and_serve); with --reconstruct, .npz observation requests
    too, reconstructed by latent optimisation or the encoder
    (serve.make_obs_reconstruct_fn); stop with a STOP file or
    --max-idle."""
    from latent_diffusion_models_for_shape_sdfs_torch.ops.cuda_kernels import (
        make_kernel_apply)
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        decoder_params, load_ad_state)
    from latent_diffusion_models_for_shape_sdfs_torch.serve import (
        watch_and_serve)

    decoder, ad_state = load_ad_state(args.exp_dir, device=args.device)
    apply_fn = make_kernel_apply(decoder, decoder_params(ad_state),
                                 device=args.device)
    recon_fn = None
    if args.reconstruct != "none":
        from latent_diffusion_models_for_shape_sdfs_torch.serve import (
            make_obs_reconstruct_fn)
        enc = moments = None
        if args.reconstruct == "encoder":
            from latent_diffusion_models_for_shape_sdfs_torch.pipeline \
                import load_encoder_state
            enc, _, moments = load_encoder_state(args.exp_dir,
                                                 device=args.device)
        recon_fn = make_obs_reconstruct_fn(
            decoder, encoder=enc, enc_moments=moments,
            refine_steps=args.refine_steps)
    n = watch_and_serve(apply_fn, args.in_dir, args.out_dir,
                        res=args.res, poll=args.poll,
                        mesh_format=args.format, max_idle=args.max_idle,
                        reconstruct_fn=recon_fn, device=apply_fn.device,
                        simplify_faces=args.simplify_faces,
                        simplify_ratio=args.simplify)
    print(f"served {n} request files")


def cmd_export_sampler(args):
    """Serialize the trained (EMA) denoiser's sampler as an artifact:
    z_T [num, L] -> decoder-space latents, loadable without model code
    via export_artifact.load_sampler_program. Pairs with export-decoder
    for a no-model-code noise -> meshes serving stack."""
    import torch
    from latent_diffusion_models_for_shape_sdfs_torch.config import (
        ExperimentConfig)
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.sampler \
        import guided_denoise_fn
    from latent_diffusion_models_for_shape_sdfs_torch.diffusion.schedule \
        import DiffusionSchedule
    from latent_diffusion_models_for_shape_sdfs_torch.export_artifact import (
        export_sampler_program)
    from latent_diffusion_models_for_shape_sdfs_torch.pipeline import (
        load_diff_state)

    cfg = ExperimentConfig.load(args.exp_dir)
    model, dstate, (mu, sigma) = load_diff_state(args.exp_dir,
                                                 device=args.device)
    model.load_state_dict(dstate.ema)
    model.eval()
    dev = mu.device
    schedule = DiffusionSchedule.create(cfg.diff.timesteps,
                                        cfg.diff.beta_start,
                                        cfg.diff.beta_end, device=dev)
    cid = (torch.full((args.num,), args.class_id, dtype=torch.long,
                      device=dev)
           if args.class_id is not None else None)
    fn = guided_denoise_fn(model, cfg.sample.guidance_scale, class_id=cid)
    out = args.out or str(pathlib.Path(args.exp_dir)
                          / f"sampler_{args.sampler}{args.steps}.zip")
    blob = export_sampler_program(
        fn, schedule, args.num, cfg.diff.denoiser.latent_size,
        steps=args.steps, sampler=args.sampler, mu=mu, sigma=sigma,
        platforms=args.platforms.split(",") if args.platforms else None,
        path=out)
    print(f"wrote {out} ({len(blob)} bytes, {args.sampler}-{args.steps}, "
          f"batch {args.num})")


def cmd_preprocess(args):
    """Mesh file(s) -> SDF sample .npz via the native C++ tool
    (native/build/preprocess_mesh; there is no fallback)."""
    root = pathlib.Path(__file__).resolve().parents[1]
    binary = root / "native" / "build" / "preprocess_mesh"
    if not binary.exists():
        sys.exit("native preprocess tool not built; run: "
                 "cmake -S native -B native/build && "
                 "cmake --build native/build")
    out_dir = pathlib.Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = ([pathlib.Path(args.mesh)] if pathlib.Path(args.mesh).is_file()
              else sorted(list(pathlib.Path(args.mesh).glob("*.obj"))
                          + list(pathlib.Path(args.mesh).glob("*.ply"))))
    for m in meshes:
        out = out_dir / (m.stem + ".npz")
        subprocess.run([str(binary), str(m), str(out),
                        str(args.samples)], check=True)
        print(f"{m} -> {out}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="ldm-sdf-torch", description=__doc__)
    p.add_argument("--device", default="cuda",
                   help="torch device of every command (default cuda; "
                   "cpu runs the kernels' plain versions)")
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("init-experiment", help="write specs.json")
    s.add_argument("exp_dir")
    s.add_argument("--data", default="analytic:sphere")
    s.add_argument("--scenes", type=int, default=None)
    s.add_argument("--set", action="append", metavar="KEY=VAL")
    s.set_defaults(fn=cmd_init)

    s = sub.add_parser("train-ad", help="stage-1 auto-decoder training")
    s.add_argument("exp_dir")
    s.add_argument("--resume", action="store_true")
    s.add_argument("--fault-inject", type=int, default=None,
                   metavar="EPOCH", help="debug: die after EPOCH's ckpt")
    s.add_argument("--debug-nans", action="store_true",
                   help="raise at the first op or kernel that writes a "
                   "NaN (utils.profiling.debug_nans)")
    s.add_argument("--tensorboard", action="store_true",
                   help="mirror the log's scalars as TensorBoard events "
                   "under logs/tb/")
    s.add_argument("--dist-backend", default="nccl", choices=("nccl", "gloo"),
                   help="torch.distributed backend under torchrun "
                   "(WORLD_SIZE > 1): nccl for one card a rank (the "
                   "default), gloo for CPU ranks or ranks sharing a card")
    s.set_defaults(fn=cmd_train_ad)

    s = sub.add_parser("train-diff", help="stage-2 diffusion training")
    s.add_argument("exp_dir")
    s.add_argument("--resume", action="store_true")
    s.add_argument("--tensorboard", action="store_true",
                   help="mirror the log's scalars as TensorBoard events "
                   "under logs/tb/")
    s.set_defaults(fn=cmd_train_diff)

    s = sub.add_parser("train-encoder", help="amortized latent encoder "
                       "(one-shot reconstruction; needs train-ad)")
    s.add_argument("exp_dir")
    s.add_argument("--resume", action="store_true")
    s.add_argument("--tensorboard", action="store_true",
                   help="mirror the log's scalars as TensorBoard events "
                   "under logs/tb/")
    s.set_defaults(fn=cmd_train_encoder)

    s = sub.add_parser("sample", help="sample latents -> meshes")
    s.add_argument("exp_dir")
    s.add_argument("--num", type=int, default=None)
    s.add_argument("--res", type=int, default=None)
    s.add_argument("--class-id", type=int, default=None)
    s.add_argument("--seed", type=int, default=None)
    s.add_argument("--obs", default=None, metavar="NPZ",
                   help="observed SDF samples (.npz, pos/neg or [N,4] rows)"
                        " for partial-SDF-conditioned sampling (config 4)")
    s.add_argument("--format", choices=("obj", "ply"), default="obj",
                   help="mesh output format (ply = binary little-endian)")
    _add_lod_flags(s)
    s.set_defaults(fn=cmd_sample)

    s = sub.add_parser("reconstruct", help="latent-optimize to a mesh")
    s.add_argument("exp_dir")
    s.add_argument("--obs", help=".npz with pos/neg [N,4] rows")
    s.add_argument("--analytic", default="sphere",
                   help="analytic family for a demo observation set")
    s.add_argument("--points", type=int, default=8000)
    s.add_argument("--name", default="recon")
    s.add_argument("--res", type=int, default=None)
    s.add_argument("--seed", type=int, default=None)
    s.add_argument("--format", choices=("obj", "ply"), default="obj",
                   help="mesh output format (ply = binary little-endian)")
    s.add_argument("--diffusion-prior", action="store_true",
                   help="regularize with the trained stage-2 denoiser "
                        "(score distillation) instead of the Gaussian "
                        "prior alone; needs a train-diff checkpoint")
    s.add_argument("--sds-weight", type=float, default=1e-3)
    s.add_argument("--encoder", action="store_true",
                   help="warm-start from the amortized encoder's one-shot"
                        " latent prediction; needs a train-encoder "
                        "checkpoint")
    s.add_argument("--refine-steps", type=int, default=None,
                   help="latent-opt steps after the encoder prediction "
                        "(0 = pure one-shot; default: full budget)")
    _add_lod_flags(s)
    s.set_defaults(fn=cmd_reconstruct)

    s = sub.add_parser("interpolate", help="latent-space shape morph "
                       "between two trained scene codes")
    s.add_argument("exp_dir")
    s.add_argument("scene_a", type=int)
    s.add_argument("scene_b", type=int)
    s.add_argument("--steps", type=int, default=8)
    s.add_argument("--res", type=int, default=None)
    s.add_argument("--mode", choices=("lerp", "slerp"), default="lerp")
    s.add_argument("--name", default="interp")
    s.add_argument("--format", choices=("obj", "ply"), default="obj",
                   help="mesh output format (ply = binary little-endian)")
    _add_lod_flags(s)
    s.set_defaults(fn=cmd_interpolate)

    s = sub.add_parser("render", help="sphere-traced PNG preview of a "
                       "trained latent, straight off the decoder (no "
                       "grid decode or meshing)")
    s.add_argument("exp_dir")
    s.add_argument("--scene", type=int, default=0)
    s.add_argument("--latent", help=".npy latent ([L] or [k,L]: row 0) "
                                    "overriding --scene")
    s.add_argument("--name", default="render")
    s.add_argument("--size", type=int, default=512)
    s.add_argument("--frames", type=int, default=1,
                   help=">1 writes a turntable sequence")
    s.add_argument("--march-steps", type=int, default=96)
    s.set_defaults(fn=cmd_render)

    s = sub.add_parser("eval", help="chamfer-L2 + F-score@tau (+ normal "
                       "consistency for analytic GT) vs ground truth")
    s.add_argument("exp_dir")
    s.add_argument("--points", type=int, default=30_000)
    s.add_argument("--fscore-tau", type=float, default=0.01,
                   help="F-score distance threshold (unit-sphere frame)")
    s.set_defaults(fn=cmd_eval)

    s = sub.add_parser("decode", help="latent codes -> meshes (serving "
                       "path)")
    s.add_argument("exp_dir")
    s.add_argument("--codes", help=".npy of [L] or [N,L] latents")
    s.add_argument("--scene", type=int, nargs="+",
                   help="stage-1 latent-table row ids")
    s.add_argument("--res", type=int, default=128)
    s.add_argument("--out", help="output dir (default <exp>/decoded)")
    s.add_argument("--format", choices=("obj", "ply"), default="obj",
                   help="mesh output format (ply = binary little-endian)")
    s.add_argument("--normals", action="store_true",
                   help="write angle-weighted vertex normals "
                   "(vn lines / nx,ny,nz properties)")
    _add_lod_flags(s)
    s.set_defaults(fn=cmd_decode)

    s = sub.add_parser("export-decoder", help="serving artifact "
                       "(torch.export, weights baked in)")
    s.add_argument("exp_dir")
    s.add_argument("--res", type=int, default=256)
    s.add_argument("--out")
    s.add_argument("--platforms",
                   help="comma list; must name the --device type (a "
                   "torch.export program runs where it was traced)")
    s.set_defaults(fn=cmd_export_decoder)

    s = sub.add_parser("serve-daemon", help="watch-folder serving loop: "
                       "latent .npy requests -> meshes")
    s.add_argument("exp_dir")
    s.add_argument("--in", dest="in_dir", required=True,
                   help="request dir (drop .npy latents; STOP to quit)")
    s.add_argument("--out", dest="out_dir", required=True)
    s.add_argument("--res", type=int, default=256)
    s.add_argument("--poll", type=float, default=0.5)
    s.add_argument("--max-idle", type=float, default=None,
                   help="exit after this many idle seconds (default: "
                   "run until STOP)")
    s.add_argument("--format", choices=("obj", "ply"), default="ply")
    s.add_argument("--reconstruct", choices=("none", "latent-opt",
                                             "encoder"), default="none",
                   help="also accept .npz observation requests "
                   "(obs_xyz/obs_sdf), served as reconstructions: "
                   "'encoder' = amortized one-shot (+--refine-steps), "
                   "'latent-opt' = optimization from scratch")
    s.add_argument("--refine-steps", type=int, default=0,
                   help="latent-opt steps refining the encoder one-shot")
    _add_lod_flags(s)
    s.set_defaults(fn=cmd_serve_daemon)

    s = sub.add_parser("export-sampler", help="sampler artifact "
                       "(torch.export: z_T -> decoder-space latents)")
    s.add_argument("exp_dir")
    s.add_argument("--num", type=int, default=64,
                   help="exported batch size (static in the artifact)")
    s.add_argument("--steps", type=int, default=50)
    s.add_argument("--sampler", choices=("ddim", "dpm"), default="ddim")
    s.add_argument("--class-id", type=int, default=None)
    s.add_argument("--out")
    s.add_argument("--platforms",
                   help="comma list; must name the --device type (a "
                   "torch.export program runs where it was traced)")
    s.set_defaults(fn=cmd_export_sampler)

    s = sub.add_parser("preprocess", help="mesh -> SDF samples (native)")
    s.add_argument("mesh", help="mesh file or directory")
    s.add_argument("out_dir")
    s.add_argument("--samples", type=int, default=500_000)
    s.set_defaults(fn=cmd_preprocess)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
