"""Single typed configuration: the port's copy of ``ct_pvae_tpu/config.py``.

Counterpart of ``ct_pvae_tpu.config.Config`` (config.py:19-232) and
``foam_paper_config`` (config.py:272-287), copied so the port never imports
the JAX package.  Field names, defaults and the JSON layout of a run's
``config.json`` are identical, so a run trained by the JAX package is served
by the port unchanged.  Fields that only steer the JAX/TPU build (mesh sizes,
Pallas, conv layout experiments) are kept so such files load; the port reads
the ones its path needs.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, List, Optional


@dataclass(frozen=True)
class Config:
    # --- paths / modes (ref main_ct_vae.py:51-52, 85-88, 95-115) ---
    input_path: Optional[str] = None          # folder with training data
    save_path: Optional[str] = None           # folder for run artifacts
    train: bool = False                       # --train
    visualize: bool = False                   # --visualize
    pixel_dist: bool = False                  # --pixel_dist
    # posterior-histogram scale (ref main_ct_vae.py:648: 10000 repeats x 100
    # draws per repeat)
    pixel_dist_repeats: int = 10000           # --num_repeats
    pixel_dist_samples_1: int = 100           # --ns1
    no_final_eval: bool = False               # --no_final_eval
    real_data: bool = False                   # --real
    restore: bool = False                     # --restore
    restore_num: Optional[int] = None         # -r
    use_latest_ckpt: bool = False             # --ulc
    # Kill/resume recovery semantics: num_iter counts TOTAL iterations
    # including the restored ones, and the relaunched loop replays the exact
    # key/index sequence of an uninterrupted run (vi/train.py).  Default
    # False keeps the "+num_iter extra" extension semantics.
    resume_total: bool = False                # --resume_total

    # --- data / measurement model (ref main_ct_vae.py:71-84, 93-94, 107-112) ---
    truncate_dataset: int = 100               # --td
    num_sparse_angles: int = 10               # --nsa
    angles_per_iter: int = 5                  # --api (stochastic angle subsampling)
    poisson_noise_multiplier: float = (2**16 - 1) * 0.41   # --pnm
    pnm_start: Optional[float] = None         # --pnm_start (anneals to pnm)
    train_pnm: bool = False                   # --train_pnm
    random_angles: bool = False               # --random (random vs uniform masks)
    toy_masks: bool = False                   # --toy_masks
    no_pad: bool = False                      # --no_pad
    algorithms: List[str] = field(default_factory=lambda: ["gridrec"])  # --algorithms
    # Random-roll angle augmentation: the reference ships this disabled and
    # flagged "XXX check correct" (helper_functions.py:85-92); here it is
    # implemented correctly (vi/augment.py) and opt-in.
    roll_augment: bool = False                # --roll
    # Reuse cached masks/measurements/recon-stack from save_path even when
    # training (content-checked by shape; SURVEY.md §5.4 build note).  The
    # reference only reloads these when train=False.
    reuse_cache: bool = False                 # --reuse_cache
    # Serving-only cheap-init mode: substitute the iterative init algorithms
    # (sirt/tv, ~90 projector applications each batch) with the one-shot
    # ramp-FBP while PRESERVING channel count and order, so a model trained
    # on the 5-channel stack still gets 5 channels.  Trades init fidelity for
    # serving latency; fidelity cost measured in BENCH.md serving table.
    cheap_init: bool = False                  # infer --cheap_init

    # --- model architecture (ref main_ct_vae.py:47-50, 57-66, 89-90) ---
    num_blocks: int = 3                       # --nb
    num_feature_maps: int = 20                # --nfm
    num_feature_maps_multiplier: float = 1.1  # --nfmm
    kernel_size: int = 4                      # --ks
    stride_encode: int = 2                    # --se
    intermediate_layers: int = 2              # --il
    intermediate_kernel: int = 4              # --ik
    dropout_prob: float = 0.0                 # --dp
    # Post-maxout normalization inside conv blocks.  The reference selects
    # norm_type but hard-disables it (apply_norm=False, main_ct_vae.py:286);
    # here "instance" actually works (models/pvae.py:InstanceNorm).
    norm_type: Optional[str] = None           # None | "instance"
    use_normal: bool = True                   # --normal (Normal vs Beta latents/output)
    deterministic: bool = False               # --det

    # --- training (ref main_ct_vae.py:33-46, 53-60, 67-68, 91-92) ---
    batch_size: int = 4                       # -b
    num_iter: int = 100                       # -i
    num_samples: int = 2                      # --ns (ELBO samples)
    learning_rate: float = 1e-4               # --lr
    adam_epsilon: float = 1e-7                # --ae
    kl_anneal_factor: float = 1.0             # --klaf
    kl_multiplier: float = 1.0                # --klm
    norm: float = 100.0                       # --norm (per-tensor grad clip)
    save_interval: int = 100000               # --si
    example_num: int = 0                      # --en (visualization example)

    # --- rebuild-only knobs (no reference equivalent) ---
    seed: int = 0                             # explicit PRNG seed (ref: np.random.seed(0))
    # Encoder input scaling and loss scaling are quirks preserved from the
    # reference (helper_functions.py:239 `/300`, main_ct_vae.py:478 `/1e5`).
    input_encode_scale: float = 300.0
    loss_scale: float = 1e5
    # Fields below steer the JAX package's multi-chip, Pallas and conv-layout
    # builds and its training loop.  The port keeps them so every run's
    # config.json loads; serving reads none of them, and build_models
    # accepts only the float32 / direct-conv settings it implements.
    mesh_data: int = 1
    mesh_angle: int = 1
    stream_batches: bool = False
    multihost: bool = False                   # --multihost
    use_pallas: bool = True
    compute_dtype: str = "float32"
    conv_precision: Optional[str] = None
    conv_layout: str = "NHWC"
    conv_impl: str = "direct"
    buffer_size: int = 100                    # shuffle buffer (ref create_dataset)
    metrics_every: int = 50
    profile_steps: int = 0
    steps_per_call: int = 8

    # ---- derived helpers ----
    @property
    def feature_maps_multiplier(self) -> int:
        # ref main_ct_vae.py:296-299 — probabilistic models double channels
        return 1 if self.deterministic else 2

    @property
    def num_algorithms(self) -> int:
        return len(self.algorithms)

    def feature_map_counts(self) -> List[int]:
        # ref main_ct_vae.py:295
        return [
            int(self.num_feature_maps * self.num_feature_maps_multiplier**i)
            for i in range(self.num_blocks)
        ]

    def replace(self, **kw: Any) -> "Config":
        return dataclasses.replace(self, **kw)

    # ---- serialization ----
    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        names = {f.name for f in dataclasses.fields(cls)}
        unknown = set(d) - names
        if unknown:
            raise ValueError(f"Unknown config keys: {sorted(unknown)}")
        # Coerce scalars to the declared field type.  YAML 1.1 (pyyaml) parses
        # "1.0e4" — no sign after the e — as a STRING, so numeric fields from
        # config files must be converted, and ints promote to float.
        coerced = dict(d)
        for f in dataclasses.fields(cls):
            if f.name not in coerced or coerced[f.name] is None:
                continue
            v = coerced[f.name]
            if f.type in ("float", "Optional[float]") and not isinstance(v, float):
                coerced[f.name] = float(v)
            elif f.type in ("int", "Optional[int]") and not isinstance(v, int):
                coerced[f.name] = int(v)
            elif f.type == "bool" and isinstance(v, str):
                coerced[f.name] = v.strip().lower() in ("1", "true", "yes", "on")
        return cls(**coerced)

    @classmethod
    def load(cls, path: str) -> "Config":
        """A JSON config (a run's ``config.json``).  YAML files, which the JAX
        package reads with PyYAML, are not supported (ROADMAP Queue 1, item 6)."""
        if path.endswith((".yaml", ".yml")):
            raise NotImplementedError(
                f"{path}: YAML configs are not ported (ROADMAP Queue 1, item 6); "
                "pass a JSON config such as a run's config.json"
            )
        with open(path) as f:
            return cls.from_dict(json.load(f))


# Recipe preset mirroring the reference's documented foam run (README.md:221).
def foam_paper_config(**kw: Any) -> Config:
    # README.md:221 foam paper recipe flags
    base = dict(
        truncate_dataset=1000,
        batch_size=10,
        num_iter=100000,
        num_sparse_angles=20,
        angles_per_iter=20,
        num_samples=2,
        random_angles=True,
        poisson_noise_multiplier=1e4,
        pnm_start=1e3,
        algorithms=["sirt", "tv", "fbp", "gridrec"],
    )
    base.update(kw)
    return Config(**base)
