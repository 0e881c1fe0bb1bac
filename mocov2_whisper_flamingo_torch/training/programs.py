"""Compiled programs of training (port-only, like ``decode/programs.py``): the
train step and the eval step as CUDA graphs on the card. They are the
counterparts of the JAX trainer's ``jax.jit`` of its train step (one program
per step, state donated) and of its eval step.

A ``TrainProgram`` serves one ``AVSRTask``, its ``Optimizer`` and the
trainer's generator of train-mode draws. A train step on the card is two
graphs of one pool with the losses run eagerly between them:

- **Graph F (forward):** the batch copied into static inputs, the on-device
  augmentation where it is configured, the frozen forward (under
  ``no_grad``) and the trainable fusion, bridge and head with dropout,
  ending in static outputs (``AVSRTask.forward_outputs``: the fp32 logits,
  or the features of ``feature_mse``). It is captured with autograd on, so
  that graph B differentiates it.
- **Losses (eager):** ``AVSRTask.losses_of`` on detached copies of the
  static outputs gives the losses and the outputs' gradients, which fill
  static buffers. ``F.ctc_loss`` cannot be captured: it turns its lengths
  into host integer lists and sizes its grids from them. Given the lengths
  on the host (``lengths``, which ``Trainer._put_batch`` keeps), it reads
  nothing back for them.
- **Graph B (backward and update):** the backward of F's trainable part from
  the outputs' gradients (with a checkpointed fusion, its recompute), then
  ``Optimizer.step``: accumulation, the non-finite guard from the static
  loss (``torch.where``: a poisoned micro-batch changes no state), the clip,
  the schedule read on the card from the update count, and AdamW.

- **The key** of a graph pair: the batch's names, shapes and dtypes, the
  device, the train settings that change the kernels (the trainer passes
  them: dropout, checkpointing, augmentation, accumulation, frozen weight
  storage, loss mode) and the ``data_ptr()`` of every parameter, buffer and
  optimizer state tensor (last, as in ``decode/programs.py``). A new key
  drops the pairs whose addresses differ.
- **Capture** follows ``GraphPool.capture_graph``: F's eager run advances the
  generator, which is put back and registered with F, so that each replay
  draws what the eager step draws from the same state and leaves the
  generator where the eager step leaves it. F is then replayed (B's eager
  run needs F's saved tensors), the losses fill B's inputs, and B is
  captured after an eager run whose update ``restore=`` undoes (the
  parameters and every optimizer state tensor). The first step thus makes
  one eager run and one capture of each graph and replays both. After B's
  capture the static outputs are detached: F's autograd graph is freed and
  its saved tensors' blocks return to the pool, where only a later key's
  graphs reuse them (a pair's graphs replay back to back, F first).
- **Draws under checkpointing:** a capture cannot rewind the generator for
  the recompute, which runs inside B; the checkpointed block keeps its first
  run's draws (``models/fusion.py``, ``models/layers.py::KeptDraws``).
- **The eval step** replays one graph of the net's eval forward per input
  shape (an ``EncodeProgram`` of the net, with its own pool); the losses and
  the ``argmax`` run eagerly after it.
- **On the CPU** there is no graph: the same object runs the same three
  parts eagerly, the plain version of the program. On the card a capture or
  replay error raises; nothing runs eagerly behind a program.

Only one process: a mesh of several ranks runs ``AVSRTask.train_step``,
since its gloo collectives cannot be captured (``Trainer``).
"""

from __future__ import annotations

import dataclasses

import torch

from mocov2_whisper_flamingo_torch.decode.programs import EncodeProgram, GraphPool
from mocov2_whisper_flamingo_torch.training.task import _inputs


@dataclasses.dataclass
class _Pair:
    """The graphs of one key and the static tensors they read and write."""

    forward: torch.cuda.CUDAGraph
    inputs: dict            # static batch: name -> tensor (or None)
    outputs: tuple          # F's static outputs
    grads: list             # the outputs' gradients, filled by the losses
    loss: torch.Tensor      # 0-d: the loss the guard reads
    used: list | None = None  # the outputs that have a gradient
    backward: torch.cuda.CUDAGraph | None = None


class TrainProgram(GraphPool):
    """The compiled train and eval steps of ``task`` (see the module doc).
    ``settings``: the train settings that change the kernels, part of every
    key. ``pairs``: key -> the graphs of one batch shape; ``captures`` and
    ``replays`` as in ``GraphPool``; ``eval_program``: the eval forward's
    graphs."""

    def __init__(self, task, optimizer, generator: torch.Generator | None, settings: dict):
        super().__init__()
        self.task = task
        self.optimizer = optimizer
        self.generator = generator
        self.settings = tuple(sorted(settings.items()))
        self.pairs: dict = {}
        self.eval_program = EncodeProgram(
            lambda *inputs: task.forward_outputs(dict(zip(_BATCH_INPUTS, inputs)), train=False),
            task.net)

    def key(self, batch: dict) -> tuple:
        """The key of the graph pair that trains on ``batch``."""
        tensors = sorted((k, v) for k, v in batch.items() if torch.is_tensor(v) or v is None)
        net = self.task.net
        return (tuple((k, None if v is None else (tuple(v.shape), v.dtype)) for k, v in tensors),
                self.optimizer.params[0].device, self.settings,
                tuple(t.data_ptr() for t in (*net.parameters(), *net.buffers(),
                                             *self.optimizer.state_tensors())))

    # -- the parts of a step ------------------------------------------------------

    def _forward(self, batch: dict) -> tuple:
        """F: augmentation and the forward in train mode."""
        generator = self.generator
        if self.task.augment_fn is not None and generator is not None:
            batch = self.task.augment_fn(batch, generator)
        return self.task.forward_outputs(batch, generator, train=True)

    def _losses(self, outputs: tuple, batch: dict, lengths: dict | None) -> tuple[dict, list]:
        """The global losses (with ``skipped``) and the gradient of the
        local loss by each output (None where it has none)."""
        leaves = [o.detach().requires_grad_() for o in outputs]
        with torch.enable_grad():
            local = self.task.losses_of(leaves, batch, lengths)
        grads = torch.autograd.grad(local["loss"], leaves, allow_unused=True)
        losses = self.task.global_losses(local)
        losses["skipped"] = (~torch.isfinite(losses["loss"])).float()
        return losses, list(grads)

    def _backward(self, outputs, grads, loss: torch.Tensor, retain: bool) -> None:
        """B: the gradients of the trainable parameters, then the
        optimizer's step under the guard."""
        params = self.optimizer.params
        got = torch.autograd.grad(outputs, params, grads, retain_graph=retain,
                                  allow_unused=True)
        got = [torch.zeros_like(p) if g is None else g for g, p in zip(got, params)]
        self.optimizer.step(got, torch.isfinite(loss))

    # -- steps ----------------------------------------------------------------------

    def train_step(self, batch: dict, lengths: dict | None = None, mark=None) -> dict:
        """One micro-batch; returns the detached global losses (and
        ``skipped``, a tensor). ``lengths``: ``audio_lengths`` and
        ``target_lengths`` on the host (``AVSRTask.compute_losses``).
        ``mark(part)``, if given, is called on the card after each part of a
        step that replays both graphs ("forward", "losses", "backward"), for
        a caller that times the parts."""
        mark = mark or (lambda part: None)
        if self.optimizer.params[0].device.type != "cuda":
            outputs = self._forward(batch)
            losses, grads = self._losses(outputs, batch, lengths)
            used = [i for i, g in enumerate(grads) if g is not None]
            self._backward([outputs[i] for i in used], [grads[i] for i in used],
                           losses["loss"], retain=False)
            return losses
        stream = torch.cuda.current_stream(self.optimizer.params[0].device)
        key = self.key(batch)
        pair = self.pairs.get(key)
        if pair is None:
            for stale in [k for k in self.pairs if k[-1] != key[-1]]:
                del self.pairs[stale]
            pair = self.pairs[key] = self._capture_forward(batch, stream)
        else:
            for name, dst in pair.inputs.items():
                if dst is not None:
                    dst.copy_(batch[name], non_blocking=True)
        self.replay(pair.forward)
        mark("forward")
        losses, grads = self._losses(pair.outputs, batch, lengths)
        if pair.used is None:
            pair.used = [i for i, g in enumerate(grads) if g is not None]
        for i in pair.used:
            pair.grads[i].copy_(grads[i])
        pair.loss.copy_(losses["loss"])
        mark("losses")
        if pair.backward is None:
            self._capture_backward(pair, stream)
        self.replay(pair.backward)
        mark("backward")
        return losses

    def eval_step(self, batch: dict, lengths: dict | None = None) -> tuple[dict, torch.Tensor]:
        """``(losses, predictions)`` as ``AVSRTask.eval_step``: on the card
        the forward is a replayed graph, the losses run after it."""
        if self.optimizer.params[0].device.type != "cuda":
            return self.task.eval_step(batch, lengths)
        outputs = self.eval_program(*(batch[k] for k in _BATCH_INPUTS))
        with torch.no_grad():
            return self.task.eval_losses(outputs, batch, lengths)

    # -- capture ------------------------------------------------------------------------

    def _capture_forward(self, batch: dict, stream) -> _Pair:
        held = {k: None if v is None else
                torch.empty_like(v, device=stream.device).copy_(v, non_blocking=True)
                for k, v in batch.items() if torch.is_tensor(v) or v is None}
        generators = (self.generator,) if self.generator is not None else ()
        graph, outputs = self.capture_graph(lambda: self._forward(held), stream,
                                            generators=generators, loop="train_forward",
                                            shape=list(batch["target_ids"].shape))
        return _Pair(forward=graph, inputs=held, outputs=tuple(outputs),
                     grads=[torch.empty_like(o) for o in outputs],
                     loss=torch.empty((), dtype=torch.float32, device=stream.device))

    def _capture_backward(self, pair: _Pair, stream) -> None:
        outputs = [pair.outputs[i] for i in pair.used]
        grads = [pair.grads[i] for i in pair.used]
        restore = (*(p.data for p in self.optimizer.params), *self.optimizer.state_tensors())
        pair.backward, _ = self.capture_graph(
            lambda: self._backward(outputs, grads, pair.loss, retain=True), stream,
            restore=restore, loop="train_backward", shape=list(pair.outputs[0].shape))
        # F's autograd graph is no longer needed: B holds its backward.
        pair.outputs = tuple(o.detach() for o in pair.outputs)


_BATCH_INPUTS = ("audio", "audio_mask", "video", "video_mask", "video_lengths")
