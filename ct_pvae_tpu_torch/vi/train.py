"""Training runtime (port of ``ct_pvae_tpu/vi/train.py`` ``Trainer``).

``Trainer`` extends the serving ``Server`` (the shared setup: data, masks,
init stack, anneal factor, models, projector table) with what training
adds (train.py:76-690):

  * parameters drawn from a seed with flax's initialisers (``init_params``);
  * the step: kl anneal ``clip(kl * factor, 0, 100)``, pnm annealed as
    ``pnm * factor**min(step, num_iter)`` in float32, the ELBO over the
    step's angle subset on the routed projector (``Server``: kernel A
    forward and kernel B backward, or the gather projector), then the
    optimiser ``nan_zero_and_clip`` + Adam;
  * the loop: ``IndexStream`` batch and angle streams (seeds seed+1 and
    seed+2), metrics flushed every ``metrics_every`` steps, the NaN-loss
    stop, ``setup_time.npy`` / ``training_time.npy``, checkpoints at
    ``save_interval`` and at the last step, and the ``resume_total`` replay;
  * ``final_evaluation`` (the unshuffled eval pass) and flax-msgpack
    ``TrainState`` checkpoints the JAX package reads back.

The optimiser works per flax leaf.  A port ``ConvBlock`` holds both maxout
branches in one tensor, where flax has two leaves (``Conv_0``, ``Conv_1``),
so the per-tensor clip takes the norm of each branch half of each weight and
bias separately.  Adam follows optax's arithmetic (moments, bias
correction, ``m / (sqrt(v) + eps)``) op for op in float32.

Random draws come from ``sampler(kind, index, ...)``: by default a
``torch.Generator`` seeded from (seed, kind, absolute step or eval batch),
so a resumed run replays the draws of an uninterrupted one, as
``fold_in(key, step)`` does in the JAX package; tests pass the JAX draws.

With ``roll_augment`` the train step rolls its batch (``vi/augment.py``)
by indices drawn from a generator seeded from (seed, step), as the JAX step
splits a roll key from its step key.

Not ported (each raises): ``train_pnm``, meshes, multi-host and streamed
batches, profiling.  ``steps_per_call`` (the
``lax.scan`` fusion of several steps) is ignored: it does not change the
numerics, and a CUDA graph is its GPU counterpart.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..config import Config
from ..data import io as data_io
from ..device import DeviceLike, resolve_device
from ..models.pvae import branch_halves, init_params, params_to_flax, params_from_flax
from ..utils.batching import IndexStream
from ..utils.flax_msgpack import load_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger
from .augment import roll_batch
from .loss import Draws, elbo_loss, standard_draws
from .serve import Server, latest_checkpoint

# sampler(kind "train" | "eval", step or eval batch, latent_shapes, output_shape, num_samples)
Sampler = Callable[[str, int, List[Tuple[int, ...]], Tuple[int, ...], int], Draws]

ADAM_B1, ADAM_B2 = 0.9, 0.999  # optax.adam defaults


class SeededSampler:
    """Standard normals and uniforms on the device from a fresh generator per
    (kind, index), seeded from ``seed``: restart-invariant draws."""

    def __init__(self, seed: int, device: torch.device):
        self.seed, self.device = seed, device

    def __call__(self, kind, index, latent_shapes, out_shape, num_samples) -> Draws:
        entropy = [self.seed, ("train", "eval").index(kind), index]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]) >> 1)
        return standard_draws(gen, latent_shapes, out_shape, num_samples, self.device)


def nan_zero_and_clip_(grad: torch.Tensor, leaves: Tuple[torch.Tensor, ...], norm: float) -> None:
    """In place: zero NaN gradients, then scale each flax leaf (a view of
    ``grad`` in ``leaves``) to norm at most ``norm`` (train.py:54-73)."""
    grad.masked_fill_(torch.isnan(grad), 0.0)
    for leaf in leaves:
        gnorm = torch.sqrt(torch.sum(torch.square(leaf)))
        leaf.mul_(torch.where(gnorm > norm, norm / (gnorm + 1e-30), 1.0))


def adam_bias_corrections(count: int) -> Tuple[float, float]:
    """(1 - b1**count, 1 - b2**count) computed in float32, as optax does."""
    n = torch.tensor(float(count))
    return (1 - torch.tensor(ADAM_B1) ** n).item(), (1 - torch.tensor(ADAM_B2) ** n).item()


def adam_(param: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
          corrections: Tuple[float, float], lr: float, eps: float) -> None:
    """optax.adam's update of one tensor, in place, in optax's op order:
    mu, nu as (1 - b) * g + b * m, then m_hat / (sqrt(v_hat) + eps) * -lr."""
    mu.copy_((1 - ADAM_B1) * grad + ADAM_B1 * mu)
    nu.copy_((1 - ADAM_B2) * (grad * grad) + ADAM_B2 * nu)
    bc1, bc2 = corrections
    param.add_((mu / bc1) / (torch.sqrt(nu / bc2) + eps) * -lr)


class _Slot(NamedTuple):
    """One torch parameter with its block (for the flax-leaf split) and Adam moments."""

    param: torch.Tensor
    block: torch.nn.Module
    kind: str  # "weight" | "bias"
    mu: torch.Tensor
    nu: torch.Tensor


class Trainer(Server):
    """Data, models, optimiser state and the train loop on one device."""

    def __init__(
        self,
        cfg: Config,
        sinograms: Optional[np.ndarray] = None,
        theta: Optional[np.ndarray] = None,
        device: DeviceLike = "cuda",
        sampler: Optional[Sampler] = None,
        kernel_route: bool = False,
    ):
        self.setup_start_time = time.time()
        not_ported = {
            "train_pnm": cfg.train_pnm,
            "mesh_data/mesh_angle > 1": cfg.mesh_data * cfg.mesh_angle > 1,
            "multihost": cfg.multihost,
            "stream_batches": cfg.stream_batches,
            "profile_steps": cfg.profile_steps > 0,
        }
        for name, on in not_ported.items():
            if on:
                raise NotImplementedError(f"{name} is not ported to the PyTorch trainer (ROADMAP)")
        dev = resolve_device(device)
        if sinograms is None:
            if cfg.input_path is None:
                raise ValueError(
                    "config.input_path is required (or pass sinograms/theta arrays); "
                    "create a dataset first: python -m ct_pvae_tpu_torch.cli make-data"
                )
            sinograms, theta, _ = data_io.load_dataset(cfg.input_path)
        super().__init__(cfg, sinograms, theta, dev, kernel_route)
        self.train_size = (self.num_examples // cfg.batch_size) * cfg.batch_size
        self.models = {"decoder": self.decoder, "encoder": self.encoder}  # flax's key order

        gen = torch.Generator().manual_seed(cfg.seed)
        init_params(self.encoder, gen)
        init_params(self.decoder, gen)
        self.adam_count = 0
        self.slots: List[_Slot] = []
        for model in self.models.values():
            for name, p in model.named_parameters():
                _, i, kind = name.split(".")
                self.slots.append(_Slot(p, model.blocks[int(i)], kind, torch.zeros_like(p),
                                        torch.zeros_like(p)))
        self.sampler = sampler if sampler is not None else SeededSampler(cfg.seed, dev)
        self.metrics = MetricsLogger(cfg.save_path)
        if cfg.restore and cfg.save_path:
            self.restore_state(cfg.restore_num, cfg.use_latest_ckpt)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def _adam_update(self, grads) -> None:
        """nan_zero_and_clip, then optax.adam's update, in place."""
        cfg = self.cfg
        self.adam_count += 1
        corrections = adam_bias_corrections(self.adam_count)
        for slot, g in zip(self.slots, grads):
            nan_zero_and_clip_(g, branch_halves(slot.block, slot.kind, g), cfg.norm)
            adam_(slot.param, g, slot.mu, slot.nu, corrections, cfg.learning_rate, cfg.adam_epsilon)

    def roll_indices(self, step: int) -> torch.Tensor:
        """The roll augmentation's (B,) indices of step ``step``, in [0, A),
        from a generator seeded from (seed, step): restart-invariant."""
        gen = torch.Generator().manual_seed(
            int(np.random.SeedSequence([self.cfg.seed, 2, step]).generate_state(1, np.uint64)[0]) >> 1)
        k = torch.randint(0, self.num_angles, (self.cfg.batch_size,), generator=gen)
        return k.to(self.device)

    def loss_and_grads(self, batch_idx: torch.Tensor, angle_idx: torch.Tensor, draws: Draws,
                       roll_k: Optional[torch.Tensor] = None):
        """The step's (loss, aux, grads) at the current state, kl anneal
        already advanced; the gradients are those of ``jax.value_and_grad``.
        ``roll_k``: roll the batch by these indices first (``roll_batch``)."""
        cfg = self.cfg
        batch = {k: v.index_select(0, batch_idx) for k, v in self.data.items()}
        if roll_k is not None:
            batch = roll_batch(batch, self.theta_t, roll_k)
        loss, aux = elbo_loss(
            self.encoder, self.decoder,
            batch["input_encode"], batch["mask"], batch["proj_sample"], draws,
            project_fn=self.project,
            angles_i=angle_idx,
            kl_anneal=self.kl_anneal,
            kl_multiplier=cfg.kl_multiplier,
            pnm=self.annealed_pnm(),
            num_blocks=cfg.num_blocks,
            input_encode_scale=cfg.input_encode_scale,
            loss_scale=cfg.loss_scale,
            training=True,
        )
        grads = torch.autograd.grad(loss, [slot.param for slot in self.slots])
        return loss, aux, grads

    def train_step(self, batch_idx: torch.Tensor, angle_idx: torch.Tensor, draws: Draws) -> torch.Tensor:
        """One step; returns the device row (loss, mean kl, loglik, kl_anneal)."""
        self.kl_anneal = float(np.clip(np.float32(self.kl_anneal) * np.float32(self.cfg.kl_anneal_factor),
                                       0.0, 100.0))
        roll_k = self.roll_indices(self.step) if self.cfg.roll_augment else None
        loss, aux, grads = self.loss_and_grads(batch_idx, angle_idx, draws, roll_k)
        self._adam_update(grads)
        self.step += 1
        return torch.stack([loss.detach(), aux.kl.detach().mean(), aux.loglik.detach(),
                            loss.new_full((), self.kl_anneal)])

    # ------------------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        dev = self.device
        batch_stream = IndexStream(self.num_examples, cfg.batch_size, cfg.seed + 1)
        angle_stream = IndexStream(self.num_angles, min(cfg.angles_per_iter, self.num_angles),
                                   cfg.seed + 2)
        start_step = self.step
        if start_step:  # replay the streams an uninterrupted run would have consumed
            batch_stream.skip(start_step)
            angle_stream.skip(start_step)
        target_iters = max(cfg.num_iter - start_step if cfg.resume_total else cfg.num_iter, 0)
        flush_every = max(1, cfg.metrics_every)
        latent_shapes, out_shape = self.draw_shapes(cfg.batch_size)
        rows: List[torch.Tensor] = []
        setup_time_saved = False
        start_time = time.time()
        for it in range(target_iters):
            bidx = torch.as_tensor(batch_stream.next(), device=dev)
            aidx = torch.as_tensor(angle_stream.next(), device=dev)
            draws = self.sampler("train", self.step, latent_shapes, out_shape, cfg.num_samples)
            rows.append(self.train_step(bidx, aidx, draws))
            stop = False
            if len(rows) >= flush_every or it == target_iters - 1:
                block = torch.stack(rows).cpu().numpy()  # one device->host read per block
                first = start_step + it + 2 - len(rows)
                for j, row in enumerate(block):
                    self.metrics.log(first + j, loss=row[0], kl=row[1], loglik=row[2],
                                     kl_anneal=row[3])
                rows = []
                if np.isnan(block[:, 0]).any():
                    print(f"NaN loss within steps ending at iter {it}; stopping")
                    stop = True
            if not setup_time_saved:
                setup_time_saved = True
                if cfg.save_path:
                    np.save(os.path.join(cfg.save_path, "setup_time.npy"),
                            (time.time() - self.setup_start_time) / 60.0)
                start_time = time.time()
            if cfg.save_path and (it % cfg.save_interval == 0 or it == target_iters - 1):
                self.metrics.save_npy_contract()
                self.checkpoint()
            if stop:
                break
        if cfg.save_path:
            np.save(os.path.join(cfg.save_path, "training_time.npy"), (time.time() - start_time) / 60.0)
            self.metrics.save_npy_contract()
            self.metrics.save_plots()

    def final_evaluation(self) -> float:
        """Unshuffled eval pass over ``train_size``; saves loss_final,
        reconstruction_final (a draw, the reference's quirk) and
        reconstruction_mean (train.py:593-632).  Returns the mean loss."""
        cfg = self.cfg
        stream = IndexStream(self.num_examples, cfg.batch_size, 0, shuffle=False)
        latent_shapes, out_shape = self.draw_shapes(cfg.batch_size)
        start = time.time()
        losses, recons, recon_means = [], [], []
        for bi in range(self.train_size // cfg.batch_size):
            idx = torch.as_tensor(stream.next(), device=self.device)
            draws = self.sampler("eval", bi, latent_shapes, out_shape, cfg.num_samples)
            loss, aux = self.eval_step(idx, draws)
            losses.append(float(loss))
            recons.append(aux.recon_sample.cpu().numpy()[..., None])
            recon_means.append(aux.recon_mean.cpu().numpy()[..., None])
        loss_final = np.asarray(losses)
        if cfg.save_path:
            np.save(os.path.join(cfg.save_path, "loss_final.npy"), loss_final)
            np.save(os.path.join(cfg.save_path, "reconstruction_final.npy"), np.concatenate(recons))
            np.save(os.path.join(cfg.save_path, "reconstruction_mean.npy"), np.concatenate(recon_means))
            np.save(os.path.join(cfg.save_path, "final_train_time.npy"), (time.time() - start) / 60.0)
        self.loss_final_mean = float(np.mean(loss_final))
        return self.loss_final_mean

    # ------------------------------------------------------------------
    def _moments(self, which: str) -> Dict[str, Dict]:
        """Adam's ``mu`` or ``nu`` as flax trees, keyed like ``params``."""
        out, slots = {}, iter(self.slots)
        for name, model in self.models.items():
            named = {k: getattr(next(slots), which) for k, _ in model.named_parameters()}
            out[name] = params_to_flax(model, named)
        return out

    def state_tree(self) -> Dict:
        """The flax ``TrainState`` as a state dict: params, opt_state =
        (EmptyState, (ScaleByAdamState(count, mu, nu), EmptyState)),
        kl_anneal, pnm, step."""
        adam = {"count": np.array(self.adam_count, np.int32),
                "mu": self._moments("mu"), "nu": self._moments("nu")}
        return {
            "params": {name: params_to_flax(model) for name, model in self.models.items()},
            "opt_state": {"0": {}, "1": {"0": adam, "1": {}}},
            "kl_anneal": np.array(self.kl_anneal, np.float32),
            "pnm": np.array(self.pnm, np.float32),
            "step": np.array(self.step, np.int32),
        }

    def checkpoint(self) -> str:
        """Write ``training_checkpoints/ckpt-<step>.msgpack`` atomically."""
        ckpt_dir = os.path.join(self.cfg.save_path, "training_checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"ckpt-{self.step}.msgpack")
        save_checkpoint(path, self.state_tree())
        return path

    def restore_state(self, restore_num: Optional[int] = None, use_latest: bool = False) -> str:
        """Load params, Adam state and anneal state from this run's checkpoint
        (the latest one, or ``ckpt-<restore_num>``), as ``Trainer.restore``."""
        path = latest_checkpoint(self.cfg.save_path, None if use_latest else restore_num)
        ckpt = load_checkpoint(path)
        self.load_state(ckpt)
        adam = ckpt["opt_state"]["1"]["0"]
        self.adam_count = int(adam["count"])
        slots = iter(self.slots)
        for name, model in self.models.items():
            mu, nu = params_from_flax(adam["mu"][name]), params_from_flax(adam["nu"][name])
            for k, _ in model.named_parameters():
                slot = next(slots)
                slot.mu.copy_(mu[k])
                slot.nu.copy_(nu[k])
        return path


def run(cfg: Config, sinograms=None, theta=None, device: DeviceLike = "cuda",
        sampler: Optional[Sampler] = None) -> float:
    """Train (if ``cfg.train``) and evaluate; returns the final mean loss
    (NaN with ``no_final_eval``), as the JAX package's ``run``."""
    from ..device import exact_f32

    exact_f32()
    trainer = Trainer(cfg, sinograms=sinograms, theta=theta, device=device, sampler=sampler)
    if cfg.train:
        trainer.train()
    return float("nan") if cfg.no_final_eval else trainer.final_evaluation()
