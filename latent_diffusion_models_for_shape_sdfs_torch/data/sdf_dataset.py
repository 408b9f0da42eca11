"""Per-shape SDF sample store with balanced pos/neg subsampling.

Mirrors the lineage data layer's contract (DeepSDF `SDFSamples` /
`unpack_sdf_samples`): each scene owns a set of precomputed (xyz, sdf)
samples split by sign; every training step draws `samples_per_scene` points
per scene, **half from the positive set and half from the negative set**
(with replacement when a side is short), yielding fixed-shape device
batches. Host-side NumPy only — the device sees (scene_ids, xyz, sdf).

Sources:
  - ``SdfDataset.from_analytic(shapes, ...)`` — closed-form shapes
    (offline ShapeNet stand-in, data/analytic.py).
  - ``SdfDataset.from_dir(path)`` — ``<scene>.npz`` files with ``pos``/``neg``
    arrays of shape [N,4] (xyz+sdf), the native preprocess tool's output
    contract (`cli preprocess`).

The port's NumPy copy of the JAX package's `data/sdf_dataset.py`: the same
`default_rng` gives bit-identical batches in both packages. One change:
`from_analytic`'s process pool uses `spawn` once CUDA is initialised in
this process (a forked child of a CUDA process cannot use CUDA, and
fork after torch's thread pools start can deadlock).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import pathlib
from typing import Optional, Sequence

import numpy as np
import torch

from latent_diffusion_models_for_shape_sdfs_torch.data import analytic


def _sample_one_shape(args: tuple) -> tuple:
    """Worker for from_analytic (module-level for pickling)."""
    shape, n, seed, i = args
    rng = np.random.default_rng((seed, i))
    xyz, d = analytic.sample_sdf_points(shape, n, rng)
    rows = np.concatenate([xyz, d[:, None]], axis=1)
    return rows[d >= 0], rows[d < 0]


@dataclasses.dataclass
class SceneBatch:
    """One fixed-shape training batch (host arrays, ready for device put)."""

    scene_ids: np.ndarray  # int32 [S]
    xyz: np.ndarray        # float32 [S, P, 3]
    sdf: np.ndarray        # float32 [S, P]

    @property
    def num_sdf_samples(self) -> int:
        return int(self.xyz.shape[0] * self.xyz.shape[1])


class SdfDataset:
    """In-memory per-scene (pos, neg) sample sets + balanced batch draws."""

    def __init__(self, pos: Sequence[np.ndarray], neg: Sequence[np.ndarray],
                 class_ids: Optional[np.ndarray] = None,
                 shapes: Optional[list] = None,
                 transforms: Optional[list] = None):
        assert len(pos) == len(neg)
        self.pos = [np.asarray(p, np.float32).reshape(-1, 4) for p in pos]
        self.neg = [np.asarray(n, np.float32).reshape(-1, 4) for n in neg]
        self.class_ids = (np.zeros(len(pos), np.int32) if class_ids is None
                          else np.asarray(class_ids, np.int32))
        self.shapes = shapes  # analytic parameter trees, when available
        # per-scene (center [3], scale) of the preprocessor's unit-sphere
        # normalization x' = (x - center) * scale; None for analytic scenes.
        # Map decoded geometry back with x = x' / scale + center.
        self.transforms = transforms

    def __len__(self) -> int:
        return len(self.pos)

    # ------------------------------------------------------------- sources

    @classmethod
    def from_analytic(cls, shapes: list, samples_per_shape: int = 100_000,
                      seed: int = 0, workers: int = 0) -> "SdfDataset":
        """Generate per-shape sample sets. `workers=0` auto-parallelizes
        over processes for larger splits (the sampling is host-NumPy-bound;
        results are deterministic per (seed, index) regardless)."""
        if workers == 0:
            import os
            workers = min(os.cpu_count() or 1, len(shapes), 16)
        if workers > 1 and len(shapes) > 8:
            import concurrent.futures as cf
            ctx = multiprocessing.get_context(
                "spawn" if torch.cuda.is_initialized() else "fork")
            with cf.ProcessPoolExecutor(max_workers=workers,
                                        mp_context=ctx) as ex:
                results = list(ex.map(
                    _sample_one_shape,
                    [(shape, samples_per_shape, seed, i)
                     for i, shape in enumerate(shapes)],
                    chunksize=max(1, len(shapes) // (workers * 4))))
        else:
            results = [_sample_one_shape((shape, samples_per_shape, seed, i))
                       for i, shape in enumerate(shapes)]
        pos = [r[0] for r in results]
        neg = [r[1] for r in results]
        cids = np.asarray([s.get("class_id", 0) for s in shapes], np.int32)
        return cls(pos, neg, class_ids=cids, shapes=shapes)

    @classmethod
    def from_dir(cls, path: str | pathlib.Path) -> "SdfDataset":
        """Load every <scene>.npz (keys: pos[N,4], neg[M,4]) in a directory,
        sorted by filename for a stable scene-id assignment."""
        files = sorted(pathlib.Path(path).glob("*.npz"))
        if not files:
            raise FileNotFoundError(f"no .npz sample files under {path}")
        pos, neg, transforms = [], [], []
        for f in files:
            with np.load(f) as z:
                pos.append(z["pos"])
                neg.append(z["neg"])
                if "center" in z.files and "scale" in z.files:
                    transforms.append((np.asarray(z["center"], np.float32),
                                       float(z["scale"][0])))
                else:  # older sample sets without stored normalization
                    transforms.append(None)
        return cls(pos, neg, transforms=transforms)

    # ------------------------------------------------------------ sampling

    def _draw_side(self, rows: np.ndarray, k: int,
                   rng: np.random.Generator) -> np.ndarray:
        if len(rows) == 0:
            # Degenerate scene (e.g. convex shape with no interior samples
            # at this resolution): fall back to the other side's contract by
            # returning an empty draw; caller tops up from the other side.
            return np.empty((0, 4), np.float32)
        idx = rng.integers(0, len(rows), size=k)  # with replacement (lineage)
        return rows[idx]

    def sample_scene(self, scene_id: int, n: int,
                     rng: np.random.Generator) -> np.ndarray:
        """Balanced draw of n rows [n,4] for one scene: half pos, half neg."""
        half = n // 2
        a = self._draw_side(self.pos[scene_id], half, rng)
        b = self._draw_side(self.neg[scene_id], n - half, rng)
        rows = np.concatenate([a, b], axis=0)
        if len(rows) < n:  # one side was empty — top up from the union
            allr = np.concatenate([self.pos[scene_id], self.neg[scene_id]], 0)
            extra = self._draw_side(allr, n - len(rows), rng)
            rows = np.concatenate([rows, extra], axis=0)
        return rows.astype(np.float32)

    def sample_scene_batch(self, rng: np.random.Generator,
                           scene_ids: np.ndarray,
                           samples_per_scene: int) -> SceneBatch:
        """Fixed-shape batch for a list of scenes (one training step)."""
        rows = np.stack([self.sample_scene(int(s), samples_per_scene, rng)
                         for s in scene_ids])
        return SceneBatch(
            scene_ids=np.asarray(scene_ids, np.int32),
            xyz=rows[..., :3],
            sdf=rows[..., 3],
        )

    def epoch_batches(self, rng: np.random.Generator, scenes_per_batch: int,
                      samples_per_scene: int):
        """Shuffled pass over all scenes, fixed batch shape (wraps the tail
        batch with a re-draw so every step sees exactly scenes_per_batch)."""
        order = rng.permutation(len(self))
        n = len(self)
        for start in range(0, n, scenes_per_batch):
            ids = order[start:start + scenes_per_batch]
            if len(ids) < scenes_per_batch:  # pad from a fresh shuffle
                pad = rng.permutation(n)[: scenes_per_batch - len(ids)]
                ids = np.concatenate([ids, pad])
            yield self.sample_scene_batch(rng, ids, samples_per_scene)
