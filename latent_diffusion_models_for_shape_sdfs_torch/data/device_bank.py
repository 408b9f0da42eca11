"""Device-resident SDF sample bank: the host sends only scene ids a step.

Counterpart of the JAX package's `data/device_bank.py`. The whole
per-scene sample store goes to the device once, as padded rows
[S, Pmax, 4] (xyz, sdf) per sign with their counts, and the balanced draw
of `SdfDataset.sample_scene` (half positives then the rest negatives,
uniform with replacement) runs on the device inside the step. The
uniforms come from a `torch.Generator` on the bank's device; `gather`
takes them as given, so the index math can be held against the
reference's on its own uniforms.

Memory: 6,144 scenes x 16,384 samples x 16 B per sign is 3.0 GiB.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch.data.sdf_dataset import (
    SdfDataset)
from latent_diffusion_models_for_shape_sdfs_torch.utils import profiling
from latent_diffusion_models_for_shape_sdfs_torch.utils.device import (
    resolve_device)


class DeviceSampleBank(NamedTuple):
    pos: torch.Tensor         # [S, Pmax_pos, 4] (xyz, sdf)
    neg: torch.Tensor         # [S, Pmax_neg, 4]
    pos_count: torch.Tensor   # int32 [S]
    neg_count: torch.Tensor   # int32 [S]

    @classmethod
    def from_dataset(cls, ds: SdfDataset, dtype=torch.float32,
                     device="cuda") -> "DeviceSampleBank":
        """Upload `ds`. A scene with an empty side takes the other side's
        rows for it (SdfDataset.sample_scene's top-up); the fallback is
        applied before the buffers are sized."""
        S = len(ds)
        eff = []
        for i in range(S):
            p, n = ds.pos[i], ds.neg[i]
            if len(p) == 0:
                p = n
            if len(n) == 0:
                n = p
            eff.append((p, n))
        pmax = max(max(len(p) for p, _ in eff), 1)
        nmax = max(max(len(n) for _, n in eff), 1)
        pos = np.zeros((S, pmax, 4), np.float32)
        neg = np.zeros((S, nmax, 4), np.float32)
        pc = np.zeros((S,), np.int32)
        nc = np.zeros((S,), np.int32)
        for i, (p, n) in enumerate(eff):
            pos[i, :len(p)] = p
            neg[i, :len(n)] = n
            pc[i] = len(p)
            nc[i] = len(n)
        dev = resolve_device(device)
        return cls(*(torch.from_numpy(a).to(dev, dt) for a, dt in
                     ((pos, dtype), (neg, dtype), (pc, torch.int32),
                      (nc, torch.int32))))

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in self)

    def uniforms(self, generator: torch.Generator, batch: int,
                 samples_per_scene: int) -> tuple:
        """(u_pos [batch, half], u_neg [batch, rest]) in [0, 1) on the
        bank's device, drawn in that order."""
        half = samples_per_scene // 2
        dev = self.pos.device
        return (torch.rand((batch, half), generator=generator, device=dev),
                torch.rand((batch, samples_per_scene - half),
                           generator=generator, device=dev))

    def gather(self, scene_ids: torch.Tensor, u_pos: torch.Tensor,
               u_neg: torch.Tensor) -> tuple:
        """The draw for given uniforms: row int(u * count) of each side.
        Returns (xyz [B, P, 3] f32, sdf [B, P] f32)."""
        i1 = (u_pos * self.pos_count[scene_ids][:, None]).int()
        i2 = (u_neg * self.neg_count[scene_ids][:, None]).int()
        sid = scene_ids[:, None]
        rows = torch.cat([self.pos[sid, i1], self.neg[sid, i2]], dim=1)
        return rows[..., :3].float(), rows[..., 3].float()

    def sample_batch(self, generator: torch.Generator,
                     scene_ids: torch.Tensor,
                     samples_per_scene: int) -> tuple:
        """Balanced draw on the device: (xyz [B, P, 3], sdf [B, P]), in
        the span `ad.draw`."""
        with profiling.span("ad.draw"):
            u1, u2 = self.uniforms(generator, scene_ids.shape[0],
                                   samples_per_scene)
            return self.gather(scene_ids, u1, u2)
