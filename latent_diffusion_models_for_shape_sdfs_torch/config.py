"""Typed experiment configs with JSON round-trip.

The PyTorch port's own copy of the JAX package's `config.py` (that
package's `__init__` imports JAX, so the port cannot import it). The
dataclasses, field names and defaults are identical, so the same
`configs/*/specs.json` files load into both packages unchanged.

Every run is driven from a per-experiment JSON spec directory (the DeepSDF
`specs.json` convention), typed here as dataclasses serialized one file per
experiment directory.
"""

from __future__ import annotations

import dataclasses
import json
import pathlib
from dataclasses import dataclass, field
from typing import Any, Optional


def _asdict(obj: Any) -> Any:
    if dataclasses.is_dataclass(obj):
        return {f.name: _asdict(getattr(obj, f.name)) for f in dataclasses.fields(obj)}
    if isinstance(obj, (list, tuple)):
        return [_asdict(x) for x in obj]
    return obj


def _fromdict(cls: Any, d: Any) -> Any:
    if dataclasses.is_dataclass(cls) and isinstance(d, dict):
        kwargs = {}
        for f in dataclasses.fields(cls):
            if f.name not in d:
                continue
            v = d[f.name]
            sub = f.type if dataclasses.is_dataclass(f.type) else _DATACLASS_FIELDS.get(
                (cls.__name__, f.name)
            )
            kwargs[f.name] = _fromdict(sub, v) if sub is not None else v
        return cls(**kwargs)
    return d


@dataclass(frozen=True)
class DecoderConfig:
    """DeepSDF auto-decoder MLP (SEMANTICS.md section 4)."""

    latent_size: int = 256
    hidden_dim: int = 512
    num_layers: int = 8              # number of linear layers incl. final
    latent_in: tuple = (4,)          # layers whose input re-concats (z, xyz)
    dropout_prob: float = 0.2
    use_dropout: bool = True
    use_tanh: bool = False           # tanh on the final scalar
    weight_norm: bool = True
    compute_dtype: str = "float32"   # "bfloat16" fast path for bench runs
    dropout_impl: str = "xla"        # "pallas": fused hw-PRNG relu+dropout
    latent_dropout: bool = False     # lineage option: dropout(0.2) on z input
    xyz_in_all: bool = False         # lineage option: concat xyz each layer


@dataclass(frozen=True)
class DenoiserConfig:
    """Latent-space epsilon-prediction network (MLP or UNet variant)."""

    arch: str = "mlp"                # "mlp" | "unet"
    latent_size: int = 256
    hidden_dim: int = 512
    num_blocks: int = 4              # residual MLP blocks / unet depth
    time_embed_dim: int = 128
    num_classes: int = 0             # >0 enables class conditioning
    cond_drop_prob: float = 0.1      # classifier-free guidance dropout
    partial_sdf_cond: bool = False   # enable partial-SDF encoder conditioning
    partial_points: int = 512        # observed (xyz, sdf) points fed to encoder
    obs_bank_points: int = 0         # per-scene training obs bank size; the
                                     # scan subsamples partial_points of them
                                     # per step (0 = auto: 4x partial_points)


@dataclass(frozen=True)
class EncoderConfig:
    """Amortized latent encoder network (models/encoder.py)."""

    latent_size: int = 256
    point_widths: tuple = (64, 128, 256, 512)   # per-point MLP widths
    head_widths: tuple = (512, 512)             # post-pool MLP widths


@dataclass(frozen=True)
class EncConfig:
    """Amortized-encoder training (train/encoder.py): regress the frozen
    stage-1 latent table from per-scene observation subsets."""

    encoder: EncoderConfig = field(default_factory=EncoderConfig)
    n_obs: int = 1024                # observation points fed per scene
    obs_bank_points: int = 0         # per-scene stored bank rows the scan
                                     # subsamples from (0 = auto: 4x n_obs)
    batch_scenes: int = 64
    num_steps: int = 20000
    lr: float = 3e-4
    lr_schedule: str = "cosine"      # "constant" | "cosine"
    warmup_steps: int = 500
    scan_chunk: int = 100            # steps fused per on-device lax.scan
    seed: int = 0
    snapshot_every: int = 5000


@dataclass(frozen=True)
class AdConfig:
    """Stage-1 auto-decoder training (SEMANTICS.md sections 1-5)."""

    decoder: DecoderConfig = field(default_factory=DecoderConfig)
    num_scenes: int = 1
    scenes_per_batch: int = 64
    samples_per_scene: int = 16384   # SDF samples drawn per scene per step
    clamp_dist: float = 0.1
    code_reg_lambda: float = 1e-4
    code_reg_warmup_epochs: int = 100
    code_reg_squared: bool = False   # paper form ||z||^2 instead of ||z||
    code_init_std: float = 1.0       # latent init N(0, (std/sqrt(L))^2)
    code_bound: float = 0.0          # >0: max-norm projection at gather
    lr_decoder: float = 5e-4
    lr_latent: float = 1e-3
    lr_decay_factor: float = 0.5
    lr_decay_interval: int = 500     # epochs
    num_epochs: int = 2001
    steps_per_epoch: int = 0         # 0: ceil(num_scenes / scenes_per_batch)
    seed: int = 0
    snapshot_every: int = 100        # epochs between checkpoints
    use_pallas: bool = False         # fused Pallas train kernel (M4)
    device_data: bool = False        # upload sample bank once, draw on device
    data_parallel: bool = False      # shard batch over the device mesh


@dataclass(frozen=True)
class DiffConfig:
    """Stage-2 latent diffusion training (SEMANTICS.md section 6)."""

    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    timesteps: int = 1000
    beta_start: float = 1e-4
    beta_end: float = 0.02
    batch_size: int = 256
    lr: float = 1e-4
    lr_schedule: str = "constant"    # "constant" | "cosine" (warmup ->
                                     # peak lr -> 5% of lr at num_steps)
    warmup_steps: int = 0            # linear warmup (cosine schedule)
    ema_decay: float = 0.999
    num_steps: int = 20000
    scan_chunk: int = 100            # steps fused per on-device lax.scan
    seed: int = 0
    snapshot_every: int = 5000       # steps between checkpoints


@dataclass(frozen=True)
class SampleConfig:
    """Generation: latent sampling + grid decode + isosurface."""

    num_samples: int = 8
    sampler: str = "ddim"            # "ddim" | "ddpm" | "dpm" (2M)
    ddim_steps: int = 50
    dpm_steps: int = 10              # DPM-Solver++(2M) denoiser calls
    guidance_scale: float = 0.0      # classifier-free guidance (cond models)
    grid_res: int = 128
    grid_chunk: int = 262144         # query points per decode chunk
    hierarchical: bool = True        # coarse->near-surface refined decode
    iso_level: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class ReconstructConfig:
    """Test-time latent optimization for unseen / partial shapes."""

    num_steps: int = 800
    lr: float = 5e-3
    lr_decay_at: int = 400           # step at which lr is divided by 10
    # prior term = (1/sigma^2) * ||z||^2 / n_obs (paper MAP form). At the
    # canonical n=8k/L=256 scale, sigma=10 matches the lineage's weak
    # 1e-4*mean(z^2) regularizer; sigma <= 1e-2 crushes z toward the mean
    # shape (measured: held-out l1 plateaus ~14x higher).
    code_reg_sigma: float = 10.0
    clamp_dist: float = 0.1
    init_std: float = 0.01
    num_inits: int = 1               # best-of-k random restarts (one program)
    seed: int = 0


_DATACLASS_FIELDS = {
    ("AdConfig", "decoder"): DecoderConfig,
    ("DiffConfig", "denoiser"): DenoiserConfig,
    ("EncConfig", "encoder"): EncoderConfig,
    ("ExperimentConfig", "ad"): AdConfig,
    ("ExperimentConfig", "diff"): DiffConfig,
    ("ExperimentConfig", "sample"): SampleConfig,
    ("ExperimentConfig", "reconstruct"): ReconstructConfig,
    ("ExperimentConfig", "encoder"): EncConfig,
}


@dataclass(frozen=True)
class ExperimentConfig:
    """One experiment directory = one of these, serialized as specs.json."""

    name: str = "experiment"
    data_source: str = "analytic:sphere"  # "analytic:<family>" | "sdf:<dir>"
    ad: AdConfig = field(default_factory=AdConfig)
    diff: DiffConfig = field(default_factory=DiffConfig)
    sample: SampleConfig = field(default_factory=SampleConfig)
    reconstruct: ReconstructConfig = field(default_factory=ReconstructConfig)
    encoder: EncConfig = field(default_factory=EncConfig)

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        return _fromdict(cls, json.loads(s))

    def save(self, exp_dir: str | pathlib.Path) -> pathlib.Path:
        p = pathlib.Path(exp_dir)
        p.mkdir(parents=True, exist_ok=True)
        f = p / "specs.json"
        f.write_text(self.to_json())
        return f

    @classmethod
    def load(cls, exp_dir: str | pathlib.Path) -> "ExperimentConfig":
        return cls.from_json((pathlib.Path(exp_dir) / "specs.json").read_text())


def override(cfg: Any, **kwargs: Any) -> Any:
    """Functional field override for frozen configs (dotted keys allowed)."""
    flat: dict = {}
    nested: dict = {}
    for k, v in kwargs.items():
        if "." in k:
            head, rest = k.split(".", 1)
            nested.setdefault(head, {})[rest] = v
        else:
            flat[k] = v
    for head, sub in nested.items():
        flat[head] = override(getattr(cfg, head), **sub)
    return dataclasses.replace(cfg, **flat)


def experiment_layout(exp_dir: str | pathlib.Path) -> dict:
    """Canonical experiment-dir layout (lineage workspace convention)."""
    p = pathlib.Path(exp_dir)
    return {
        "specs": p / "specs.json",
        "checkpoints": p / "checkpoints",
        "latents": p / "latents",
        "logs": p / "logs",
        "reconstructions": p / "reconstructions",
        "samples": p / "samples",
        "evals": p / "evals",
        "interpolations": p / "interpolations",
        "renders": p / "renders",
    }
