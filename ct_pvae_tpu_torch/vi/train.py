"""Training runtime (port of ``ct_pvae_tpu/vi/train.py`` ``Trainer``).

``Trainer`` extends the serving ``Server`` (the shared setup: data, masks,
init stack, anneal factor, models, projector table) with what training
adds (train.py:76-690):

  * parameters drawn from a seed with flax's initialisers (``init_params``),
    plus ``log_pnm`` under ``train_pnm`` (train.py:174-177);
  * the step: kl anneal ``clip(kl * factor, 0, 100)``, pnm annealed as
    ``pnm * factor**min(step, num_iter)`` in float32 (``exp(log_pnm)`` for
    pnm under ``train_pnm``), the ELBO over the step's angle subset on the
    routed projector (``Server``: kernel A forward and kernel B backward, or
    the gather projector), then the optimiser ``nan_zero_and_clip`` + Adam;
  * the loop: ``IndexStream`` batch and angle streams (seeds seed+1 and
    seed+2), chunks of ``steps_per_call`` steps cut at ``save_interval``
    boundaries as the JAX loop cuts its ``lax.scan`` calls (train.py:465-553),
    metrics flushed every ``metrics_every`` steps, the NaN-loss stop,
    ``setup_time.npy`` / ``training_time.npy``, checkpoints at
    ``save_interval`` and at the last step, the ``resume_total`` replay, and
    a ``torch.profiler`` trace of steps [2, 2 + ``profile_steps``) into
    ``<save_path>/profile`` (train.py:488-495; chunks are cut at both ends,
    so the traced steps run as an untraced run runs them, where the JAX
    loop traces 1-step chunks);
  * ``final_evaluation`` (the unshuffled eval pass) and flax-msgpack
    ``TrainState`` checkpoints the JAX package reads back.

A step reads its inputs from slot buffers on the device (``_slot_ints``:
batch, angle and roll indices; ``_slot_floats``: the kl anneal, the pnm
anneal power and Adam's bias corrections), which the host fills before it
runs.  On the card a full chunk replays a CUDA graph of the whole step
(``vi/step_graph.py``) once per step; partial chunks, ``steps_per_call: 1``
and the CPU run the same step body eagerly on the same buffers, so every
route does the same arithmetic.  A failed capture raises: there is no eager
fallback on the card.

The optimiser works per flax leaf.  A port ``ConvBlock`` holds both maxout
branches in one tensor, where flax has two leaves (``Conv_0``, ``Conv_1``),
so the per-tensor clip takes the norm of each branch half of each weight and
bias separately (``flax_leaves``).  Adam follows optax's arithmetic
(moments, bias correction, ``m / (sqrt(v) + eps)``) op for op in float32.

Random draws come from the trainer's generator, re-seeded from (seed,
absolute step) before each step, so a resumed run replays the draws of an
uninterrupted one, as ``fold_in(key, step)`` does in the JAX package, and a
graphed step draws what the eager one draws.  Tests pass a ``sampler(kind,
index, ...)`` whose ``Draws`` replace them (on the card such a run takes
the eager step).  With ``roll_augment`` the step rolls its batch
(``vi/augment.py``) by indices drawn on the host from a generator seeded
from (seed, step), as the JAX step splits a roll key from its step key.

On a (data, angle) mesh of ranks (``--mesh_data``/``--mesh_angle``, one
rank per device, ``parallel/``) every rank runs the same index streams and
re-seeds the same generator per step, draws the whole step's noise and
keeps its rows (``vi/shard.py``); it computes its share of the loss on its
examples and angles (kernels A and B on its own kernel rows), and one
all-reduce sums the gradients and the metric row over the ranks between
``torch.autograd.grad`` and the per-tensor clip, which so clips the whole
step's gradient, as the JAX package does.  Adam then runs the same on every
rank.  Rank 0 writes the config, caches, metrics and checkpoints; every rank
restores from the same file.  ``--stream_batches`` keeps the dataset in host
memory and copies each step's slice of the batch into fixed device buffers
before the step (train.py:443-523), so a streamed step is graphed as well.
On NCCL the captured step holds its all-reduce; gloo's collectives cannot
be captured, so a gloo run (two ranks on one card) takes the eager step,
and says so.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..config import Config
from ..data import io as data_io
from ..device import DeviceLike, resolve_device
from ..models.pvae import flax_leaves, init_params, params_to_flax, params_from_flax
from ..ops import joseph_radon, radon
from ..parallel import distributed
from ..parallel.distributed import all_reduce_, is_initialized, is_primary, put_replicated, rank_device
from ..parallel.mesh import make_mesh
from ..utils.batching import IndexStream
from ..utils.flax_msgpack import load_checkpoint, save_checkpoint
from ..utils.metrics import MetricsLogger
from ..utils.trace import span
from .augment import roll_batch
from .loss import Draws, DrawSource, GeneratorDraws, elbo_loss, standard_draws
from .serve import Server, latest_checkpoint
from .step_graph import StepGraph

# sampler(kind "train" | "eval", step or eval batch, latent_shapes, output_shape, num_samples)
Sampler = Callable[[str, int, List[Tuple[int, ...]], Tuple[int, ...], int], Draws]

ADAM_B1, ADAM_B2 = 0.9, 0.999  # optax.adam defaults


def draw_seed(seed: int, kind: str, index: int) -> int:
    """The generator seed of (run seed, "train" | "eval", absolute step or
    eval batch): restart-invariant."""
    entropy = [seed, ("train", "eval").index(kind), index]
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0]) >> 1


class SeededSampler:
    """Standard normals and uniforms on the device from a fresh generator per
    (kind, index), seeded with ``draw_seed``: restart-invariant ``Draws``
    (the Normal latents' explicit draws, which a caller can move to another
    device)."""

    def __init__(self, seed: int, device: torch.device):
        self.seed, self.device = seed, device

    def generator(self, kind: str, index: int) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(draw_seed(self.seed, kind, index))

    def __call__(self, kind, index, latent_shapes, out_shape, num_samples) -> Draws:
        return standard_draws(self.generator(kind, index), latent_shapes, out_shape, num_samples,
                              self.device)


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


Scalar = Union[float, torch.Tensor]


def adam_(param: torch.Tensor, grad: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
          corrections: Tuple[Scalar, Scalar], lr: float, eps: float) -> None:
    """optax.adam's update of one tensor, in place, in optax's op order:
    mu, nu as (1 - b) * g + b * m, then m_hat / (sqrt(v_hat) + eps) * -lr.
    The bias corrections are floats or 0-d tensors on ``param``'s device."""
    mu.copy_((1 - ADAM_B1) * grad + ADAM_B1 * mu)
    nu.copy_((1 - ADAM_B2) * (grad * grad) + ADAM_B2 * nu)
    bc1, bc2 = corrections
    param.add_((mu / bc1) / (torch.sqrt(nu / bc2) + eps) * -lr)


class _Slot(NamedTuple):
    """One torch parameter with its block (for the flax-leaf split; None for
    ``log_pnm``) and Adam moments."""

    param: torch.Tensor
    block: Optional[torch.nn.Module]
    kind: str  # "weight" | "bias" | "norm_scale" | "norm_offset" | "log_pnm"
    mu: torch.Tensor
    nu: torch.Tensor

    def leaves(self, tensor: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        return (tensor,) if self.block is None else flax_leaves(self.block, self.kind, tensor)


# the float slot: kl anneal, pnm anneal power, Adam's two bias corrections
KL, POWER, BC1, BC2 = range(4)


class Trainer(Server):
    """Data, models, optimiser state and the train loop on one device (this
    rank's, on a mesh of ranks)."""

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
        if cfg.multihost and not is_initialized():
            raise RuntimeError("multihost: join the process group first with "
                               "ct_pvae_tpu_torch.parallel.initialize() (cli train --multihost does)")
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None and is_initialized():
            dev = rank_device(dev)
        mesh = make_mesh(cfg.mesh_data, cfg.mesh_angle)  # raises unless there is a rank per device
        if sinograms is None:
            if cfg.input_path is None:
                raise ValueError(
                    "config.input_path is required (or pass sinograms/theta arrays); "
                    "create a dataset first: python -m ct_pvae_tpu_torch.cli make-data"
                )
            sinograms, theta, _ = data_io.load_dataset(cfg.input_path)
        super().__init__(cfg, sinograms, theta, dev, kernel_route, mesh)
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
        if self.log_pnm is not None:  # the third flax leaf of the params, after the models
            self.slots.append(_Slot(self.log_pnm, None, "log_pnm", torch.zeros_like(self.log_pnm),
                                    torch.zeros_like(self.log_pnm)))
        self.seeded = SeededSampler(cfg.seed, dev)
        # a sampler's Draws replace the trainer's own draws (the parity tests')
        self.replay_draws = sampler is not None
        self.sampler = sampler if sampler is not None else self.seeded
        self.angles_per_step = min(cfg.angles_per_iter, self.num_angles)
        # this rank's examples and angles of a step (all of them off a mesh)
        self.nb = self.shard.nb if self.shard else cfg.batch_size
        self.na = self.shard.na if self.shard else self.angles_per_step
        width = 2 * self.nb + self.na if cfg.roll_augment else self.nb + self.na
        self._slot_ints = torch.zeros(width, dtype=torch.long, device=dev)
        self._slot_floats = torch.zeros(4, dtype=torch.float32, device=dev)
        self._gen = torch.Generator(device=dev)  # re-seeded before every step
        self._graph: Optional[StepGraph] = None
        if self.stream:  # the step's examples, copied in from host memory before it runs
            self._stream_batch = {k: v[:self.nb].to(dev, copy=True) for k, v in self.data.items()}
        # the eager step where a graph cannot hold the step (its reason)
        self.eager_reason = ("gloo's collectives cannot be captured in a CUDA graph"
                             if self.reduce and distributed.backend() == "gloo" else None)
        self.metrics = MetricsLogger(cfg.save_path if is_primary() else None)
        if cfg.restore and cfg.save_path:
            self.restore_state(cfg.restore_num, cfg.use_latest_ckpt)
        put_replicated([t for slot in self.slots for t in (slot.param, slot.mu, slot.nu)])

    # ------------------------------------------------------------------
    def roll_indices(self, step: int) -> torch.Tensor:
        """The roll augmentation's (B,) indices of step ``step``, in [0, A),
        from a generator seeded from (seed, step): restart-invariant."""
        return self._roll_host(step).to(self.device)

    def _roll_host(self, step: int) -> torch.Tensor:
        gen = torch.Generator().manual_seed(
            int(np.random.SeedSequence([self.cfg.seed, 2, step]).generate_state(1, np.uint64)[0]) >> 1)
        return torch.randint(0, self.num_angles, (self.cfg.batch_size,), generator=gen)

    def _step_ints(self, step: int, batch_idx, angle_idx) -> torch.Tensor:
        """The int slot of step ``step`` on the host: batch indices, angle
        indices, then the roll indices under ``roll_augment`` (this rank's)."""
        parts = [batch_idx, angle_idx] + ([self._roll_host(step)] if self.cfg.roll_augment else [])
        parts = [torch.as_tensor(p).to("cpu", torch.long) for p in parts]
        if self.shard is not None:
            sh = self.shard
            parts = [sh.local_batch(parts[0]), sh.local_angles(parts[1])] + \
                [sh.local_batch(p) for p in parts[2:]]
        return torch.cat(parts)

    def _stage(self, k: int) -> Tuple[torch.Tensor, float]:
        """The float slots of the next ``k`` steps from the host state, (k, 4)
        float32 on the CPU, and the kl anneal after the last.  Changes no state."""
        kl, floats = self.kl_anneal, []
        for j in range(k):
            kl = float(np.clip(np.float32(kl) * np.float32(self.cfg.kl_anneal_factor), 0.0, 100.0))
            floats.append([kl, self.anneal_power(self.step + j),
                           *adam_bias_corrections(self.adam_count + j + 1)])
        return torch.tensor(floats, dtype=torch.float32), kl

    def _advance(self, k: int, kl: float) -> None:
        self.kl_anneal, self.step, self.adam_count = kl, self.step + k, self.adam_count + k

    def _fill_slots(self, ints: torch.Tensor, floats: torch.Tensor,
                    host_ints: Optional[torch.Tensor] = None) -> None:
        """Copy a step's slots (and a streamed step's examples) to the device;
        ``host_ints``: ``ints`` in host memory, where ``ints`` are on the card."""
        self._slot_ints.copy_(ints, non_blocking=True)
        self._slot_floats.copy_(floats, non_blocking=True)
        if self.stream:  # a copy from pageable memory: ordered after the last step's reads
            rows = (ints if host_ints is None else host_ints)[:self.nb]
            distributed.make_global_batch({k: v.index_select(0, rows) for k, v in self.data.items()},
                                          self.device, out=self._stream_batch)

    def _prepare(self, batch_idx, angle_idx, draws) -> float:
        """Fill the slots with the next step's inputs and seed its generator
        (unless ``draws`` replace it); returns the kl anneal after the step."""
        floats, kl = self._stage(1)
        self._fill_slots(self._step_ints(self.step, batch_idx, angle_idx), floats[0])
        if draws is None:
            self._seed(self.step)
        return kl

    def _slot_grads(self, draws: Optional[Union[Draws, DrawSource]] = None):
        """(loss, aux, grads) of the step in the slot buffers, drawing from the
        trainer's generator unless ``draws`` are given."""
        cfg = self.cfg
        b, n = self.nb, self.na
        ints, floats = self._slot_ints, self._slot_floats
        batch = dict(self._stream_batch) if self.stream else \
            {k: v.index_select(0, ints[:b]) for k, v in self.data.items()}
        if cfg.roll_augment:
            batch = roll_batch(batch, self.theta_t, ints[b + n:])
        src = GeneratorDraws(self._gen, self.device) if draws is None else draws
        loss, aux = elbo_loss(
            self.encoder, self.decoder,
            batch["input_encode"], batch["mask"], batch["proj_sample"],
            src if self.shard is None else self.shard.draws(src),
            project_fn=self.project,
            angles_i=ints[b:b + n],
            kl_anneal=floats[KL],
            kl_multiplier=cfg.kl_multiplier,
            pnm=self.pnm_base() * floats[POWER],
            num_blocks=cfg.num_blocks,
            num_samples=cfg.num_samples,
            use_normal=cfg.use_normal,
            deterministic=cfg.deterministic,
            input_encode_scale=cfg.input_encode_scale,
            loss_scale=cfg.loss_scale,
            training=True,
            share=self.shard and self.shard.share,
        )
        return loss, aux, torch.autograd.grad(loss, [slot.param for slot in self.slots])

    def _reduce(self, loss: torch.Tensor, aux, grads) -> Tuple[torch.Tensor, Sequence[torch.Tensor]]:
        """(loss, mean kl, loglik) and the gradients of the step, summed over
        the ranks (one all-reduce of them all) where the process group is up."""
        kl = aux.kl.detach()
        if self.shard is None:
            kl_mean = kl.mean()
        else:
            kl_mean = kl.sum() / self.cfg.batch_size if self.shard.whole else kl.new_zeros(())
        row = torch.stack([loss.detach(), kl_mean, aux.loglik.detach()])
        if not self.reduce:
            return row, grads
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads] + [row]))
        summed, lo = [], 0
        for g in grads:
            summed.append(flat[lo:lo + g.numel()].view_as(g))
            lo += g.numel()
        return flat[lo:], summed

    def _slot_step(self, draws: Optional[Union[Draws, DrawSource]] = None) -> torch.Tensor:
        """One train step from the slot buffers, device work only (what the
        graph captures): the loss, its gradients (summed over the ranks),
        nan_zero_and_clip and Adam in place.  Returns the device row (loss,
        mean kl, loglik, kl_anneal)."""
        row, grads = self._reduce(*self._slot_grads(draws))
        floats = self._slot_floats
        with torch.no_grad():
            for slot, g in zip(self.slots, grads):
                nan_zero_and_clip_(g, slot.leaves(g), self.cfg.norm)
                adam_(slot.param, g, slot.mu, slot.nu, (floats[BC1], floats[BC2]),
                      self.cfg.learning_rate, self.cfg.adam_epsilon)
        return torch.cat([row, floats[KL:KL + 1]])

    def _seed(self, step: int) -> None:
        self._gen.manual_seed(draw_seed(self.cfg.seed, "train", step))

    def loss_and_grads(self, batch_idx, angle_idx, draws: Optional[Union[Draws, DrawSource]] = None):
        """The next step's (loss, aux, grads) at the current state, without
        the update; the gradients are those of ``jax.value_and_grad``.
        ``draws``: the step's draws (default: the trainer's generator, as the
        step draws them).  On a mesh the loss and the gradients are the whole
        step's (summed over the ranks), ``aux`` this rank's."""
        self._prepare(batch_idx, angle_idx, draws)
        loss, aux, grads = self._slot_grads(draws)
        if self.reduce:
            row, grads = self._reduce(loss, aux, grads)
            loss = row[0]
        return loss, aux, grads

    def train_step(self, batch_idx, angle_idx, draws: Optional[Union[Draws, DrawSource]] = None
                   ) -> torch.Tensor:
        """One eager step; returns the device row (loss, mean kl, loglik, kl_anneal)."""
        with span("ctpvae.train.step"):
            kl = self._prepare(batch_idx, angle_idx, draws)
            row = self._slot_step(draws)
            self._advance(1, kl)
        return row

    def capture_step(self) -> StepGraph:
        """The CUDA graph of the train step, captured on first use (its
        warm-up leaves the state as it was)."""
        if self.device.type != "cuda":
            raise RuntimeError("CUDA graphs need a CUDA device; the CPU runs the step eagerly")
        if self._graph is None:
            with span("ctpvae.train.capture"):
                state = [t for slot in self.slots for t in (slot.param, slot.mu, slot.nu)]
                graph = StepGraph(self._slot_step, state, self._gen,
                                  [joseph_radon.LAUNCHES, radon.CALLS, distributed.CALLS])
                graph.capture(draw_seed(self.cfg.seed, "train", self.step))
            self._graph = graph
        return self._graph

    def train_chunk(self, batch_idxs: Sequence, angle_idxs: Sequence,
                    draws: Optional[Sequence[Draws]] = None) -> torch.Tensor:
        """``len(batch_idxs)`` steps, the slots staged for all of them at
        once: on the card each a replay of the captured step (the JAX
        package's ``lax.scan`` over K steps), on the CPU and over gloo the
        same step run eagerly.  ``draws``: per-step
        Draws replacing the trainer's (eager steps only).  Returns the (K, 4)
        device rows."""
        k = len(batch_idxs)
        graphed = self.device.type == "cuda" and self.eager_reason is None
        if graphed and draws is not None:
            raise ValueError("the graphed step draws from its own generator; "
                             "replayed Draws need steps_per_call 1")
        with span("ctpvae.train.chunk"):
            graph = self.capture_step() if graphed else None
            with span("ctpvae.train.stage"):
                floats, kl = self._stage(k)
                ints = torch.stack([self._step_ints(self.step + j, b, a)
                                    for j, (b, a) in enumerate(zip(batch_idxs, angle_idxs))])
                if graphed:
                    host_ints = ints
                    ints = ints.pin_memory().to(self.device, non_blocking=True)
                    floats = floats.pin_memory().to(self.device, non_blocking=True)
            rows = []
            for j in range(k):
                with span("ctpvae.train.replay" if graphed else "ctpvae.train.step"):
                    self._fill_slots(ints[j], floats[j], host_ints[j] if graphed else None)
                    if draws is None:
                        self._seed(self.step + j)
                    rows.append((graph.replay() if graphed
                                 else self._slot_step(draws and draws[j])).clone())
            self._advance(k, kl)
            return torch.stack(rows)

    # ------------------------------------------------------------------
    def train(self) -> None:
        cfg = self.cfg
        batch_stream = IndexStream(self.num_examples, cfg.batch_size, cfg.seed + 1)
        angle_stream = IndexStream(self.num_angles, self.angles_per_step, cfg.seed + 2)
        start_step = self.step
        if start_step:  # replay the streams an uninterrupted run would have consumed
            batch_stream.skip(start_step)
            angle_stream.skip(start_step)
        target_iters = max(cfg.num_iter - start_step if cfg.resume_total else cfg.num_iter, 0)
        flush_every = max(1, cfg.metrics_every)
        latent_shapes, out_shape = self.draw_shapes(cfg.batch_size)
        spc = max(1, int(cfg.steps_per_call))
        use_chunks = spc > 1
        graphs = use_chunks and self.device.type == "cuda"
        # the traced steps [2, 2 + profile_steps) begin and end at chunk boundaries
        profile_cuts = (2, 2 + cfg.profile_steps) if cfg.profile_steps and cfg.save_path else ()
        if graphs and self.eager_reason is not None:
            print(f"steps_per_call {spc}: {self.eager_reason}, so every step runs eagerly")
        elif graphs and self.replay_draws:
            raise ValueError("a sampler's Draws run on the eager step: set steps_per_call 1")
        if use_chunks and cfg.save_path and cfg.save_interval <= spc:
            print(f"warning: save_interval={cfg.save_interval} <= steps_per_call={spc} forces "
                  "1-step chunks and disables the graphed step; raise save_interval to fuse")
        si = max(1, cfg.save_interval)
        rows: List[torch.Tensor] = []
        buf_rows = 0
        setup_time_saved = False
        profiler = None
        start_time = time.time()
        it = 0
        while it < target_iters:
            if profile_cuts:
                if it == 2:  # trace steps [2, 2 + profile_steps), after the warm-up
                    if graphs and self.eager_reason is None:
                        self.capture_step()  # outside the trace: it holds replays alone
                    profiler = _start_profile(self.device)
                elif profiler is not None and it >= 2 + cfg.profile_steps:
                    _stop_profile(profiler, cfg.save_path)
                    profiler = None
            if use_chunks and cfg.save_path:
                # end the chunk at the next save boundary: an iter j with
                # j % si == 0 saves after it runs (train.py:503-507)
                j0 = it if it % si == 0 else ((it // si) + 1) * si
                k = min(spc, target_iters - it, j0 - it + 1)
            elif use_chunks:
                k = min(spc, target_iters - it)  # no checkpoints: full chunks
            else:
                k = 1
            for cut in profile_cuts:
                if cut > it:
                    k = min(k, cut - it)
            bidxs = [batch_stream.next() for _ in range(k)]
            aidxs = [angle_stream.next() for _ in range(k)]
            draws = ([self.sampler("train", self.step + j, latent_shapes, out_shape, cfg.num_samples)
                      for j in range(k)] if self.replay_draws else None)
            last = it + k - 1
            if k == spc and use_chunks:
                rows.append(self.train_chunk(bidxs, aidxs, draws))
            else:
                # partial chunks run step by step, as the JAX loop runs them
                for j in range(k):
                    rows.append(self.train_step(bidxs[j], aidxs[j], draws and draws[j])[None])
            buf_rows += k
            stop = False
            if buf_rows >= flush_every or last == target_iters - 1:
                block = torch.cat(rows).cpu().numpy()  # one device->host read per block
                first = start_step + last + 2 - buf_rows
                for j, row in enumerate(block):
                    self.metrics.log(first + j, loss=row[0], kl=row[1], loglik=row[2],
                                     kl_anneal=row[3])
                rows, buf_rows = [], 0
                if np.isnan(block[:, 0]).any():
                    print(f"NaN loss within steps ending at iter {last}; stopping")
                    stop = True
            if not setup_time_saved:
                setup_time_saved = True
                if cfg.save_path and is_primary():
                    np.save(os.path.join(cfg.save_path, "setup_time.npy"),
                            (time.time() - self.setup_start_time) / 60.0)
                start_time = time.time()
            if cfg.save_path and (last % cfg.save_interval == 0 or last == target_iters - 1):
                self.metrics.save_npy_contract()
                self.checkpoint()
            if stop:
                break
            it += k
        if profiler is not None:
            _stop_profile(profiler, cfg.save_path)
        if cfg.save_path and is_primary():
            np.save(os.path.join(cfg.save_path, "training_time.npy"), (time.time() - start_time) / 60.0)
            self.metrics.save_npy_contract()
            self.metrics.save_plots()

    def final_evaluation(self) -> float:
        """Unshuffled eval pass over ``train_size``; saves loss_final,
        reconstruction_final (a draw, the reference's quirk) and
        reconstruction_mean (train.py:593-632).  Returns the mean loss.  On a
        mesh each batch is sharded as the train step is: the losses are
        summed over the ranks and rank 0 writes the examples all ranks
        reconstructed."""
        cfg = self.cfg
        stream = IndexStream(self.num_examples, cfg.batch_size, 0, shuffle=False)
        latent_shapes, out_shape = self.draw_shapes(cfg.batch_size)
        start = time.time()
        losses, recons, recon_means = [], [], []
        for bi in range(self.train_size // cfg.batch_size):
            idx = torch.as_tensor(stream.next(), device=self.device)
            if self.replay_draws:
                draws = self.sampler("eval", bi, latent_shapes, out_shape, cfg.num_samples)
            else:
                draws = GeneratorDraws(self.seeded.generator("eval", bi), self.device)
            loss, aux = self.eval_step(idx, draws)
            losses.append(float(loss))
            recon, recon_mean = aux.recon_sample, aux.recon_mean
            if self.shard is not None:  # the batch's examples from the ranks that split it
                recon, recon_mean = self.shard.gather(recon), self.shard.gather(recon_mean)
            recons.append(recon.cpu().numpy()[..., None])
            recon_means.append(recon_mean.cpu().numpy()[..., None])
        loss_final = np.asarray(losses)
        if cfg.save_path and is_primary():
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
        if self.log_pnm is not None:
            out["log_pnm"] = _scalar(getattr(next(slots), which))
        return out

    def params_tree(self) -> Dict:
        """The flax ``params``: the models' trees, and ``log_pnm`` under ``train_pnm``."""
        tree = {name: params_to_flax(model) for name, model in self.models.items()}
        if self.log_pnm is not None:
            tree["log_pnm"] = _scalar(self.log_pnm)
        return tree

    def state_tree(self) -> Dict:
        """The flax ``TrainState`` as a state dict: params, opt_state =
        (EmptyState, (ScaleByAdamState(count, mu, nu), EmptyState)),
        kl_anneal, pnm, step."""
        adam = {"count": np.array(self.adam_count, np.int32),
                "mu": self._moments("mu"), "nu": self._moments("nu")}
        return {
            "params": self.params_tree(),
            "opt_state": {"0": {}, "1": {"0": adam, "1": {}}},
            "kl_anneal": np.array(self.kl_anneal, np.float32),
            "pnm": np.array(self.pnm, np.float32),
            "step": np.array(self.step, np.int32),
        }

    def checkpoint(self) -> str:
        """Write ``training_checkpoints/ckpt-<step>.msgpack`` atomically (rank
        0 only on a mesh: every rank holds the same state)."""
        if not is_primary():
            return ""
        ckpt_dir = os.path.join(self.cfg.save_path, "training_checkpoints")
        os.makedirs(ckpt_dir, exist_ok=True)
        path = os.path.join(ckpt_dir, f"ckpt-{self.step}.msgpack")
        save_checkpoint(path, self.state_tree())
        return path

    def restore_state(self, restore_num: Optional[int] = None, use_latest: bool = False) -> str:
        """Load params, Adam state and anneal state from this run's checkpoint
        (the latest one, or ``ckpt-<restore_num>``), as ``Trainer.restore``;
        every tensor is copied into its own storage (a captured step sees it)."""
        path = latest_checkpoint(self.cfg.save_path, None if use_latest else restore_num)
        ckpt = load_checkpoint(path)
        self.load_state(ckpt)
        adam = ckpt["opt_state"]["1"]["0"]
        self.adam_count = int(adam["count"])
        slots = iter(self.slots)
        with torch.no_grad():
            for name, model in self.models.items():
                mu, nu = params_from_flax(adam["mu"][name]), params_from_flax(adam["nu"][name])
                for k, _ in model.named_parameters():
                    slot = next(slots)
                    slot.mu.copy_(mu[k])
                    slot.nu.copy_(nu[k])
            if self.log_pnm is not None:
                slot = next(slots)
                slot.mu.copy_(torch.tensor(np.asarray(adam["mu"]["log_pnm"], np.float32)))
                slot.nu.copy_(torch.tensor(np.asarray(adam["nu"]["log_pnm"], np.float32)))
        return path


def _scalar(t: torch.Tensor) -> np.ndarray:
    return np.array(t.detach().cpu().numpy(), np.float32)


def _start_profile(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    prof = profile(activities=activities)
    prof.start()
    return prof


def _stop_profile(prof, save_path: str) -> None:
    """Stop the trace and write it as ``<save_path>/profile/trace.json``
    (Chrome trace format; the JAX package writes a TensorBoard profile there)."""
    prof.stop()
    out = os.path.join(save_path, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))


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
