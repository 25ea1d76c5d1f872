"""Serving state: the setup and eval half of the JAX package's ``vi/train.py`` Trainer.

``Server`` does the Trainer's setup (train.py:77-210): recon sizes, masks
and measurements, the classical-init stack, the pnm anneal factor and the
models built from the run's config; ``restore`` reads ``params``,
``kl_anneal``, ``pnm`` and ``step`` from a flax msgpack checkpoint with the
same "latest" rule (train.py:655-690); ``eval_step`` is the eval branch of
the step (train.py:233-402, ``training=False``) over all angles.
``vi/train.py`` ``Trainer`` extends it with the train step, Adam and the loop.

The projector is routed as the JAX Trainer routes it (train.py:249-256):
the fused Joseph kernels (A forward, B backward, on the kernel rows of the
full angle table, ``self.rows``) when ``use_pallas`` is set,
the detector has at least 64 pixels and the device is CUDA (the TPU's
counterpart) or the caller asks for the kernel route (``kernel_route``, the
counterpart of the JAX Trainer's mesh, which the parity tests give it);
otherwise the gather projector ``ops/radon.py`` ``radon`` on the drawn angle
subset (loss.py:70-71), another discretisation.
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data.masks import create_all_masks
from ..data.recon_init import classical_recon_stack
from ..models.pvae import build_models, params_from_flax
from ..ops.joseph_radon import angle_table_fused, kernel_rows, radon_fused
from ..ops.radon import pad_phantom, radon
from ..utils.flax_msgpack import load_checkpoint
from .loss import Draws, ElboAux, elbo_loss


def latest_checkpoint(run_path: str, ckpt_num: Optional[int] = None) -> str:
    """``run_path/training_checkpoints/ckpt-N.msgpack``: N given, or the largest."""
    ckpt_dir = os.path.join(run_path, "training_checkpoints")
    if ckpt_num is not None:
        return os.path.join(ckpt_dir, f"ckpt-{ckpt_num}.msgpack")
    cands = sorted(
        (f for f in os.listdir(ckpt_dir) if f.startswith("ckpt-") and f.endswith(".msgpack")),
        key=lambda f: int(f.split("-")[1].split(".")[0]),
    )
    if not cands:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return os.path.join(ckpt_dir, cands[-1])


def joseph_route(cfg: Config, n_det: int, device: torch.device, kernel_route: bool = False) -> bool:
    """Whether the likelihood projects with the Joseph kernels (train.py:254-256)."""
    return bool(cfg.use_pallas and n_det >= 64 and (device.type == "cuda" or kernel_route))


class Server:
    """Data, models and the eval step of a trained run, on one device.

    ``kernel_route`` asks for the Joseph kernels where the device alone would
    not select them (``joseph_route``): the port's plain versions on the CPU.
    """

    def __init__(self, cfg: Config, sinograms: np.ndarray, theta: np.ndarray, device: torch.device,
                 kernel_route: bool = False):
        if not cfg.use_normal or cfg.deterministic:
            raise NotImplementedError("the port serves Normal (non-deterministic) latents only")
        self.cfg, self.device = cfg, device
        sinograms = np.clip(np.asarray(sinograms, np.float32)[: cfg.truncate_dataset], 0, None)
        self.theta = np.asarray(theta, np.float32)
        self.num_examples = len(sinograms)
        self.num_angles = len(self.theta)
        self.n_det = sinograms.shape[-1]
        if cfg.no_pad:
            self.x_size = self.y_size = self.n_det
        else:
            self.x_size = self.y_size = int(np.floor(self.n_det / np.sqrt(2) - 2))
        if cfg.save_path:
            os.makedirs(cfg.save_path, exist_ok=True)
            cfg.save(os.path.join(cfg.save_path, "config.json"))

        # an evaluation-only run (train False) reads the run's artifacts, as the
        # JAX package's create_all_masks / classical_recon_stack do
        reuse = cfg.reuse_cache or not cfg.train
        masks, proj = create_all_masks(
            sinograms, self.num_angles, device,
            save_path=cfg.save_path,
            poisson_noise_multiplier=cfg.poisson_noise_multiplier,
            num_sparse_angles=cfg.num_sparse_angles,
            random=cfg.random_angles,
            real_data=cfg.real_data,
            truncate_dataset=cfg.truncate_dataset,
            toy_masks=cfg.toy_masks,
            seed=cfg.seed,
            reuse_cache=reuse,
        )
        stack = classical_recon_stack(
            proj, masks, self.theta, cfg.algorithms, self.x_size, self.y_size, device,
            save_path=cfg.save_path, reuse_cache=reuse, cheap_init=cfg.cheap_init,
        )
        self.data = {
            "proj_sample": torch.as_tensor(proj, device=device),
            "mask": torch.as_tensor(masks, device=device),
            "input_encode": torch.as_tensor(stack, device=device),
        }

        # pnm anneal factor (ref main_ct_vae.py:146-149)
        if cfg.pnm_start is not None:
            self.pnm_anneal_factor = float(
                np.exp(np.log(cfg.poisson_noise_multiplier / cfg.pnm_start) / max(cfg.num_iter, 1))
            )
            pnm0 = cfg.pnm_start
        else:
            self.pnm_anneal_factor = 1.0
            pnm0 = cfg.poisson_noise_multiplier
        self.kl_anneal, self.pnm, self.step = 1.0, float(np.float32(pnm0)), 0

        self.encoder, self.decoder, self.skip_shapes = build_models(
            self.x_size, self.y_size, stack.shape[-1], cfg
        )
        self.encoder.to(device)
        self.decoder.to(device)

        self.joseph = joseph_route(cfg, self.n_det, device, kernel_route)
        self.theta_t = torch.as_tensor(self.theta, device=device)
        # The Joseph projector integrates over the image support only, so a
        # table built for the unpadded square recon projects onto the same
        # n_det detector as the reference's pad-to-n_det (train.py:272-283).
        self.skip_pad = not cfg.no_pad and self.x_size == self.y_size
        if self.joseph:
            # the (A, 8) kernel rows of the full angle table, built once; a
            # train step selects its angles' rows on the device
            img_hw = self.x_size if self.skip_pad else self.n_det
            self.rows = torch.as_tensor(
                kernel_rows(angle_table_fused(self.theta, img_hw, img_hw, self.n_det)), device=device
            )

    def restore(self, run_path: str, ckpt_num: Optional[int] = None) -> str:
        """Load params and anneal state from a trained run's checkpoint."""
        path = latest_checkpoint(run_path, ckpt_num)
        self.load_state(load_checkpoint(path))
        return path

    def load_state(self, ckpt: dict) -> None:
        """Params and anneal state from a decoded flax ``TrainState``."""
        self.encoder.load_state_dict(params_from_flax(ckpt["params"]["encoder"]))
        self.decoder.load_state_dict(params_from_flax(ckpt["params"]["decoder"]))
        self.kl_anneal = float(ckpt["kl_anneal"])
        self.pnm = float(ckpt["pnm"])
        self.step = int(ckpt["step"])

    def annealed_pnm(self) -> torch.Tensor:
        """pnm * factor^min(step, num_iter) in float32, as train.py:341-353; a
        0-d CPU tensor, which device ops take as a scalar without a copy."""
        f32 = dict(dtype=torch.float32)
        power = torch.tensor(self.pnm_anneal_factor, **f32) ** torch.tensor(
            float(min(self.step, self.cfg.num_iter)), **f32
        )
        return torch.tensor(self.pnm, **f32) * power

    def project(self, recon: torch.Tensor, angles_i: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B, x, y) -> (B, A_sub, n_det) over the angles ``angles_i`` (all
        angles when None) on the routed projector; differentiable."""
        if not self.joseph:
            theta = self.theta_t if angles_i is None else self.theta_t.index_select(0, angles_i)
            return radon(recon, theta, pad=not self.cfg.no_pad, n_det=self.n_det)
        if not self.skip_pad and not self.cfg.no_pad:
            recon = pad_phantom(recon, self.n_det)
        rows = self.rows if angles_i is None else self.rows.index_select(0, angles_i)
        return radon_fused(recon.contiguous(), rows, self.n_det)

    def draw_shapes(self, batch: int) -> Tuple[List[Tuple[int, ...]], Tuple[int, ...]]:
        """NHWC shapes of the latent draws per level and of the output draw."""
        eps = [(batch, x, y, z // 2) for (x, y, z) in self.skip_shapes]
        return eps, (batch, self.x_size, self.y_size, 1)

    @torch.no_grad()
    def eval_step(self, batch_idx: torch.Tensor, draws: Draws) -> Tuple[torch.Tensor, ElboAux]:
        """Eval-mode ELBO of the examples ``batch_idx`` (all angles)."""
        cfg = self.cfg
        batch = {k: v.index_select(0, batch_idx) for k, v in self.data.items()}
        return elbo_loss(
            self.encoder, self.decoder,
            batch["input_encode"], batch["mask"], batch["proj_sample"], draws,
            project_fn=self.project,
            kl_anneal=self.kl_anneal,
            kl_multiplier=cfg.kl_multiplier,
            pnm=self.annealed_pnm(),
            num_blocks=cfg.num_blocks,
            input_encode_scale=cfg.input_encode_scale,
            loss_scale=cfg.loss_scale,
        )
