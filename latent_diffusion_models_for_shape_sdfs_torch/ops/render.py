"""Sphere-traced rendering of decoder SDFs on the device.

Counterpart of the JAX package's `ops/render.py`: for quick qualitative
previews this renders the neural SDF directly (no grid, no mesh, no host
geometry). Every pixel ray is sphere-traced against `apply_fn` (the ops
ApplyFn contract, `(z [L], xyz [N,3]) -> sdf [N]`), hits are shaded
Lambertian, and an image comes back. All rays march in lockstep: a fixed
trip count with masked updates and no data-dependent control flow, so the
march enqueues its `steps` evaluations of [H*W, 3] points without waiting
on the device; the host reads the image once, at the end.

With a kernel wrapper (`ops.cuda_kernels.make_kernel_apply`) on the card,
the latent rows are hoisted once per frame (`KernelApply.bind`): each of
the 96 march steps and the 6 central differences is one launch of kernel
#1 and nothing else.

Two SDF caveats shape the marcher:
- training clamps |sdf| at delta=0.1, so a step can never exceed ~0.1
  world units: rays start on the unit-sphere bound (shapes are
  normalized into it) rather than at the camera, and the step count
  default (96) covers the worst diameter at the clamp ceiling;
- the learned field is only approximately metric, so steps are scaled
  by `step_scale` (0.9) and hits accept |sdf| < eps.

Normals come from central differences (6 extra evaluations per pixel),
which match the marching-tetrahedra surface definition.
"""

from __future__ import annotations

from typing import Callable, Tuple

import numpy as np
import torch


def _normalize(v: torch.Tensor) -> torch.Tensor:
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True),
                           min=1e-9)


def _f32(x, device) -> torch.Tensor:
    """A small float32 constant on `device`, each element filled from a
    host scalar (a kernel argument): a copy from pageable host memory, as
    torch.as_tensor or item assignment makes, would wait for the device
    to drain."""
    a = np.asarray(x, np.float32)
    t = torch.empty(a.shape, dtype=torch.float32, device=device)
    flat = t.view(-1)
    for i, v in enumerate(a.reshape(-1).tolist()):
        flat[i].fill_(v)
    return t


def camera_rays(width: int, height: int, eye, target, fov_deg: float,
                device="cpu") -> tuple:
    """Perspective ray grid on `device`: (origins [H*W,3], dirs [H*W,3])."""
    eye = _f32(eye, device)
    target = _f32(target, device)
    fwd = _normalize(target - eye)
    world_up = _f32([0.0, 1.0, 0.0], device)
    # nudge if fwd is (anti)parallel to up
    world_up = torch.where(torch.abs(torch.dot(fwd, world_up)) > 0.999,
                           _f32([0.0, 0.0, 1.0], device), world_up)
    right = _normalize(torch.linalg.cross(fwd, world_up))
    up = torch.linalg.cross(right, fwd)
    aspect = width / height
    half_h = torch.tan(torch.deg2rad(_f32(fov_deg, device)) * 0.5)
    ys, xs = torch.meshgrid(
        _linspace(half_h, -half_h, height),
        _linspace(-half_h * aspect, half_h * aspect, width), indexing="ij")
    dirs = _normalize(fwd[None, None] + xs[..., None] * right[None, None]
                      + ys[..., None] * up[None, None])
    origins = eye.expand(dirs.shape)
    return origins.reshape(-1, 3), dirs.reshape(-1, 3)


def _linspace(start: torch.Tensor, stop: torch.Tensor,
              num: int) -> torch.Tensor:
    """jnp.linspace's f32 formula for 0-d tensor endpoints: start * (1 -
    k/(num-1)) + stop * k/(num-1) for k < num-1, then stop exactly."""
    if num == 1:
        return start.reshape(1)
    step = torch.arange(num - 1, device=start.device,
                        dtype=torch.float32) / (num - 1)
    return torch.cat([start * (1 - step) + stop * step, stop.reshape(1)])


def _ray_sphere_entry(o: torch.Tensor, d: torch.Tensor,
                      radius: float) -> torch.Tensor:
    """Distance along each ray to the bounding sphere (inf on miss)."""
    b = torch.sum(o * d, dim=-1)
    c = torch.sum(o * o, dim=-1) - radius * radius
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    return torch.where(disc >= 0.0, torch.clamp(t, min=0.0),
                       torch.full_like(t, float("inf")))


def _sdf_at(apply_fn: Callable, z: torch.Tensor) -> Callable:
    """xyz -> sdf f32 at latent z; through the kernel wrapper's `bind`
    (rows hoisted once) when it has one."""
    bind = getattr(apply_fn, "bind", None)
    if bind is not None:
        return bind(z)
    return lambda p: apply_fn(z, p).float()


def _render(sdf: Callable, width: int, height: int, steps: int, eye,
            target, fov_deg: float, eps: float, step_scale: float,
            bound: float, light, device) -> tuple:
    """The march and the shading: (img [H,W,3] f32, hit [H,W] bool) on
    `device`, enqueued without a host wait."""
    o, d = camera_rays(width, height, eye, target, fov_deg, device)
    n = o.shape[0]
    t0 = _ray_sphere_entry(o, d, bound)
    alive = torch.isfinite(t0)
    t0 = torch.where(alive, t0, torch.zeros_like(t0))
    t_exit = t0 + 2.0 * bound + 0.2     # leave the bound -> miss
    t, t_prev = t0, t0
    s_prev = torch.full((n,), 1e9, device=device)
    hit = torch.zeros(n, dtype=torch.bool, device=device)
    for _ in range(steps):
        s = sdf(o + t[:, None] * d)
        close = torch.abs(s) < eps
        # A positive-to-negative crossing means the ray overshot INTO the
        # surface (non-metric SDF regions): count it as a hit at the
        # secant-interpolated crossing instead of stalling inside.
        crossed = alive & (s < -eps) & (s_prev > 0.0)
        t_cross = t_prev + s_prev / torch.clamp(s_prev - s, min=1e-12) \
            * (t - t_prev)
        hit_now = alive & (close | crossed)
        hit = hit | hit_now
        step = torch.clamp(s * step_scale, min=1e-4)
        t_new = torch.where(alive & ~hit_now, t + step,
                            torch.where(crossed & ~close, t_cross, t))
        alive = alive & ~hit_now & (t_new < t_exit)
        t_prev, s_prev, t = t, s, t_new
    p = o + t[:, None] * d

    # central-difference normals
    h = 2e-3
    grads = []
    offsets = torch.eye(3, device=device) * h
    for ax in range(3):
        grads.append(sdf(p + offsets[ax]) - sdf(p - offsets[ax]))
    nrm = _normalize(torch.stack(grads, dim=-1))

    light = _normalize(_f32(light, device))
    view = -d
    lam = torch.clamp(torch.sum(nrm * light, dim=-1), min=0.0)
    head = torch.clamp(torch.sum(nrm * view, dim=-1), min=0.0)
    shade = 0.12 + 0.62 * lam + 0.26 * head
    base = _f32([0.78, 0.81, 0.86], device)
    fg = shade[:, None] * base[None, :]
    # background: vertical gradient
    yy = _linspace(_f32(1.0, device), _f32(0.0, device), height)[:, None]
    bg = (0.96 - 0.18 * yy)[..., None] * torch.ones((height, width, 3),
                                                    device=device)
    img = torch.where(hit[:, None], fg, bg.reshape(-1, 3))
    return img.reshape(height, width, 3), hit.reshape(height, width)


def render_sdf(apply_fn: Callable, z,
               width: int = 512, height: int = 512,
               eye=(1.6, 1.2, 1.6), target=(0.0, 0.0, 0.0),
               fov_deg: float = 40.0, steps: int = 96,
               eps: float = 2e-3, step_scale: float = 0.9,
               bound: float = 1.05,
               light=(0.5, 0.75, 0.43)) -> Tuple[np.ndarray, np.ndarray]:
    """Sphere-trace `apply_fn` at latent `z` into an image, on z's device
    (a tensor) or the wrapper's (`apply_fn.device`, for an array).

    Returns (rgb uint8 [H,W,3], hit-mask bool [H,W]): `steps` march
    evaluations and 6 for the normals, one host read at the end."""
    if not isinstance(z, torch.Tensor):
        z = torch.as_tensor(np.asarray(z, np.float32),
                            device=getattr(apply_fn, "device", "cpu"))
    img, hit = _render(_sdf_at(apply_fn, z), width, height, steps, eye,
                       target, fov_deg, float(eps), float(step_scale),
                       float(bound), light, z.device)
    rgb = (torch.clamp(img, 0.0, 1.0) * 255.0 + 0.5).cpu().numpy()
    return rgb.astype(np.uint8), hit.cpu().numpy()


def render_turntable(apply_fn: Callable, z, frames: int = 4,
                     radius: float = 2.3, elev: float = 0.6,
                     **kw) -> list:
    """`frames` views around the y axis -> list of (rgb, hit)."""
    out = []
    for i in range(frames):
        a = 2.0 * np.pi * i / frames
        eye = (radius * np.cos(a), elev, radius * np.sin(a))
        out.append(render_sdf(apply_fn, z, eye=eye, **kw))
    return out
