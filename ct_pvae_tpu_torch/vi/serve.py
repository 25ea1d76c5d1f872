"""Serving state: the setup and eval half of the JAX package's ``vi/train.py`` Trainer.

``Server`` does the Trainer's setup (train.py:77-210): recon sizes, masks
and measurements, the classical-init stack, the pnm anneal factor and the
models built from the run's config (Normal or Beta latents and output,
deterministic mode, the model options); ``restore`` reads ``params`` (with
``log_pnm`` under ``train_pnm``), ``kl_anneal``, ``pnm`` and ``step`` from a
flax msgpack checkpoint with the same "latest" rule (train.py:655-690);
``eval_step`` is the eval branch of the step (train.py:233-402,
``training=False``) over all angles.  Set-up and restore are timed in
``ctpvae.setup.*`` spans (``utils/trace.py``).  The Poisson multiplier
reaches the likelihood as a device tensor, ``pnm_base() *
anneal_power(step)``: the pnm, or exp(log_pnm) under ``train_pnm``, times
factor^min(step, num_iter).
``vi/train.py`` ``Trainer`` extends it with the train step, Adam and the loop.

The projector is routed as the JAX Trainer routes it (train.py:249-267):
the fused Joseph kernels (A forward, B backward, on the kernel rows of the
full angle table, ``self.rows``) when ``use_pallas`` is set,
the detector has at least 64 pixels and the device is CUDA (the TPU's
counterpart), the caller asks for the kernel route (``kernel_route``, which
the parity tests give it) or the run is on a mesh, and a mesh divides the
batch and the angles; otherwise the gather projector ``ops/radon.py``
``radon`` on the drawn angle subset (loss.py:70-71), another discretisation.

On a (data, angle) mesh of ranks (``parallel/mesh.py``) each rank takes its
share of an eval step (``vi/shard.py``): its examples of the batch and its
angles of all angles, its rows of the whole step's draws; the loss is
summed over the ranks.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data.masks import create_all_masks
from ..data.recon_init import classical_recon_stack
from ..models.pvae import build_models, params_from_flax
from ..ops.joseph_radon import angle_table_fused, kernel_rows, radon_fused
from ..ops.radon import pad_phantom, radon
from ..parallel.distributed import all_reduce_, is_initialized, is_primary, make_global_batch
from ..parallel.mesh import Mesh
from ..utils.flax_msgpack import load_checkpoint
from ..utils.trace import span
from .loss import Draws, DrawSource, ElboAux, elbo_loss
from .shard import StepShard


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


def joseph_route(cfg: Config, n_det: int, device: torch.device, kernel_route: bool = False,
                 mesh: Optional[Mesh] = None, num_angles: Optional[int] = None) -> bool:
    """Whether the likelihood projects with the Joseph kernels (train.py:254-267):
    a mesh counts as the kernel route, and takes it only where its axes
    divide the batch, the step's angles and all angles (else the gather)."""
    route = bool(cfg.use_pallas and n_det >= 64
                 and (device.type == "cuda" or kernel_route or mesh is not None))
    if route and mesh is not None:
        api = min(cfg.angles_per_iter, num_angles)
        route = not (cfg.batch_size % mesh.data or api % mesh.angle or num_angles % mesh.angle)
    return route


class Server:
    """Data, models and the eval step of a trained run, on one device.

    ``kernel_route`` asks for the Joseph kernels where the device alone would
    not select them (``joseph_route``): the port's plain versions on the CPU.
    ``mesh``: this rank's place on a mesh of ranks (``parallel.make_mesh``).
    """

    def __init__(self, cfg: Config, sinograms: np.ndarray, theta: np.ndarray, device: torch.device,
                 kernel_route: bool = False, mesh: Optional[Mesh] = None):
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
            if cfg.train and is_primary():  # an evaluation keeps the run's config (train.py:103-107)
                cfg.save(os.path.join(cfg.save_path, "config.json"))

        # an evaluation-only run (train False) reads the run's artifacts, as the
        # JAX package's create_all_masks / classical_recon_stack do
        reuse = cfg.reuse_cache or not cfg.train
        with span("ctpvae.setup.masks"):
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
                write_cache=is_primary(),
            )
        with span("ctpvae.setup.init_stack"):
            stack = classical_recon_stack(
                proj, masks, self.theta, cfg.algorithms, self.x_size, self.y_size, device,
                save_path=cfg.save_path, reuse_cache=reuse, cheap_init=cfg.cheap_init,
                write_cache=is_primary(),
            )
        # host copies, as the JAX Trainer keeps them (the eval stage reads them)
        self.x_train_sinograms, self.all_masks, self.all_proj_samples = sinograms, masks, proj
        # the dataset on the device, or in host memory when streamed
        # (--stream_batches: a step copies its examples to the device)
        self.stream = bool(cfg.stream_batches)
        home = "cpu" if self.stream else device
        self.data = {
            "proj_sample": torch.as_tensor(proj, device=home),
            "mask": torch.as_tensor(masks, device=home),
            "input_encode": torch.as_tensor(stack, device=home),
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
        f32 = dict(dtype=torch.float32, device=device)
        self.pnm_t = torch.tensor(self.pnm, **f32)  # updated in place on restore
        # --train_pnm: log pnm is a trainable leaf of the params (train.py:174-177)
        self.log_pnm = (torch.nn.Parameter(torch.log(torch.tensor(np.float32(pnm0), **f32)))
                        if cfg.train_pnm else None)

        with span("ctpvae.setup.models"):
            self.encoder, self.decoder, self.skip_shapes = build_models(
                self.x_size, self.y_size, stack.shape[-1], cfg
            )
            self.encoder.to(device)
            self.decoder.to(device)

        # the step's share of this rank on a mesh; sums over the ranks
        # wherever the process group is up (a world of one included)
        self.shard = (StepShard(mesh, cfg.batch_size, min(cfg.angles_per_iter, self.num_angles),
                                self.num_angles) if mesh is not None else None)
        self.reduce = mesh is not None or is_initialized()
        self.joseph = joseph_route(cfg, self.n_det, device, kernel_route, mesh, self.num_angles)
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
        with span("ctpvae.setup.restore"):
            path = latest_checkpoint(run_path, ckpt_num)
            self.load_state(load_checkpoint(path))
        return path

    def load_state(self, ckpt: dict) -> None:
        """Params and anneal state from a decoded flax ``TrainState``."""
        self.encoder.load_state_dict(params_from_flax(ckpt["params"]["encoder"]))
        self.decoder.load_state_dict(params_from_flax(ckpt["params"]["decoder"]))
        if self.log_pnm is not None:
            with torch.no_grad():
                self.log_pnm.copy_(torch.tensor(np.asarray(ckpt["params"]["log_pnm"], np.float32)))
        self.kl_anneal = float(ckpt["kl_anneal"])
        self.pnm = float(ckpt["pnm"])
        self.pnm_t.fill_(self.pnm)
        self.step = int(ckpt["step"])

    def anneal_power(self, step: int) -> float:
        """factor^min(step, num_iter) in float32 (train.py:341-346), as a float."""
        f32 = dict(dtype=torch.float32)
        return float(torch.tensor(self.pnm_anneal_factor, **f32)
                     ** torch.tensor(float(min(step, self.cfg.num_iter)), **f32))

    def pnm_base(self) -> torch.Tensor:
        """The 0-d device pnm the anneal scales: exp(log_pnm) under
        ``train_pnm`` (differentiable), else the state's pnm."""
        return torch.exp(self.log_pnm) if self.log_pnm is not None else self.pnm_t

    def annealed_pnm(self) -> torch.Tensor:
        """pnm * factor^min(step, num_iter) in float32, as train.py:341-353,
        at the current step: a 0-d device tensor."""
        return self.pnm_base() * torch.tensor(self.anneal_power(self.step), dtype=torch.float32)

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

    def batch_rows(self, idx: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The dataset's examples ``idx`` on the device: gathered there, or
        copied from host memory when the dataset is streamed."""
        if not self.stream:
            return {k: v.index_select(0, idx) for k, v in self.data.items()}
        rows = torch.as_tensor(idx).cpu()
        return make_global_batch({k: v.index_select(0, rows) for k, v in self.data.items()},
                                 self.device)

    @torch.no_grad()
    def eval_step(self, batch_idx: torch.Tensor, draws: Union[Draws, DrawSource]
                  ) -> Tuple[torch.Tensor, ElboAux]:
        """Eval-mode ELBO of the examples ``batch_idx`` (all angles).  On a
        mesh this rank evaluates its share: the loss is summed over the
        ranks, ``aux`` holds this rank's examples and its terms' shares."""
        cfg = self.cfg
        sh, angles = self.shard, None
        if sh is not None:
            batch_idx, draws, angles = sh.local_batch(batch_idx), sh.draws(draws), sh.eval_angles(self.device)
        batch = self.batch_rows(batch_idx)
        loss, aux = elbo_loss(
            self.encoder, self.decoder,
            batch["input_encode"], batch["mask"], batch["proj_sample"], draws,
            project_fn=self.project,
            angles_i=angles,
            kl_anneal=self.kl_anneal,
            kl_multiplier=cfg.kl_multiplier,
            pnm=self.annealed_pnm(),
            num_blocks=cfg.num_blocks,
            num_samples=cfg.num_samples,
            use_normal=cfg.use_normal,
            deterministic=cfg.deterministic,
            input_encode_scale=cfg.input_encode_scale,
            loss_scale=cfg.loss_scale,
            share=sh and sh.share,
        )
        if self.reduce:
            loss = all_reduce_(loss.clone())
        return loss, aux
