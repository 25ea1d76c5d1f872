"""A CUDA graph of the train step: the GPU counterpart of ``steps_per_call``.

The JAX package fuses K train steps into one ``lax.scan`` call so that the
host dispatches once per K steps (``ct_pvae_tpu/vi/train.py:458-553``).  On
the card the host's cost is the step's thousand-odd launches (autograd, the
distributions, the per-leaf clip and Adam), so the port captures one whole
train step (the gather, encoder, draws, decoder, the likelihood through
kernel A, autograd through kernel B, the NaN-zero and clip, Adam) into a
``torch.cuda.CUDAGraph`` and replays it once per step of a chunk: a replay
is one launch.  One step graph replayed K times, rather than K steps
unrolled into one graph, keeps the capture and its memory pool one step's
size whatever K is, and the per-step host work left (two slot copies, a
generator seed and the replay) is a few launches beside the step's device
time.

What the captured step reads and writes stays put between replays:

  * its inputs are static slot buffers the trainer fills before each run
    (batch, angle and roll indices; the kl anneal, the pnm anneal power and
    Adam's two bias corrections), so no host value is baked into the graph;
  * its draws come from one ``torch.Generator`` registered with the graph
    and re-seeded from (seed, step) before each replay, which gives the
    draws a fresh generator seeded so would (the eager step's);
  * parameters and Adam moments are updated in place, in their own storage,
    so a checkpoint restore (an in-place copy) is seen by the next replay.

The eager step runs the same body on the same slot buffers, so one step
replayed and one step run eagerly do the same arithmetic.  Python counters
(``joseph_radon.LAUNCHES``, ``radon.CALLS``) move only while a step is
captured, so each replay adds what the capture added; the warm-up before
the capture adds nothing and leaves the state as it found it.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

WARMUP_RUNS = 2  # on a side stream before the capture: cuDNN, cuBLAS and the kernels' set-up


class StepGraph:
    """``body()`` (one device step returning its metric row) captured once
    and replayed.  ``state``: the tensors the body updates in place (kept
    across the warm-up); ``gen``: the generator the body draws from;
    ``counters``: the launch-count dicts the body moves."""

    def __init__(self, body: Callable[[], torch.Tensor], state: Sequence[torch.Tensor],
                 gen: torch.Generator, counters: Sequence[Dict[str, int]]):
        self.body, self.state, self.gen, self.counters = body, list(state), gen, list(counters)
        self.graph = None
        self.out = None
        self.delta: List[Dict[str, int]] = []

    def _set_counts(self, counts: List[Dict[str, int]]) -> None:
        for c, v in zip(self.counters, counts):
            c.update(v)

    def capture(self, seed: int) -> None:
        """Warm the body up, put the state back, and capture one run of it
        with the generator seeded ``seed``; raises if the capture fails."""
        before = [dict(c) for c in self.counters]
        saved = [t.detach().clone() for t in self.state]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(WARMUP_RUNS):
                self.gen.manual_seed(seed)
                self.body()
        torch.cuda.current_stream().wait_stream(side)
        with torch.no_grad():
            for t, v in zip(self.state, saved):
                t.copy_(v)
        self._set_counts(before)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        self.gen.manual_seed(seed)
        try:
            with torch.cuda.graph(graph):
                out = self.body()
        except Exception as exc:
            raise RuntimeError("capturing the train step as a CUDA graph failed") from exc
        self.delta = [{k: c[k] - b[k] for k in c} for c, b in zip(self.counters, before)]
        self._set_counts(before)
        self.graph, self.out = graph, out

    def replay(self) -> torch.Tensor:
        """One step: the graph's launch, with the counts its capture moved.
        Returns the graph's metric row (overwritten by the next replay)."""
        self.graph.replay()
        for c, d in zip(self.counters, self.delta):
            for k, v in d.items():
                c[k] += v
        return self.out
