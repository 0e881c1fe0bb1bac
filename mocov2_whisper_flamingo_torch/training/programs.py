"""Compiled programs of training (port-only, like ``decode/programs.py``): the
train step and the eval step as CUDA graphs on the card. They are the
counterparts of the JAX trainer's ``jax.jit`` of its train step (one program
per step, state donated) and of its eval step.

A ``TrainProgram`` serves one ``AVSRTask``, its ``Optimizer`` and the
trainer's generator of train-mode draws. A train step on the card is one
graph per key, which replays ``AVSRTask.train_step`` whole:

- the batch copied into the graph's static inputs (before the replay), the
  on-device augmentation where it is configured;
- the frozen forward (under ``no_grad``) and the trainable fusion, bridge
  and head with dropout;
- the losses: log-softmax, the CTC kernel pair (``ops/losses.py``; its
  lengths and labels are read on the card) and the label-smoothed CE, or the
  feature-alignment loss;
- the backward of the trainable part (with a checkpointed fusion, its
  recompute), then ``Optimizer.step``: accumulation, the non-finite guard
  from the loss (``torch.where``: a poisoned micro-batch changes no state),
  the clip, the schedule read on the card from the update count, and AdamW.

Nothing in a replayed step reads the card back. The step's spans
(``utils/profiling.py::span``: ``train_step`` and, inside it,
``frozen_audio``, ``frozen_video``, ``trainable_forward``, ``losses``,
``backward`` and ``optimizer``) launch their marker kernels while the graph
is captured, so each replay puts its 14 markers on the device trace.

- **The key** of a graph: the batch's names, shapes and dtypes, the device,
  the train settings that change the kernels (the trainer passes them:
  dropout, checkpointing, augmentation, accumulation, frozen weight storage,
  loss mode) and the ``data_ptr()`` of every parameter, buffer and optimizer
  state tensor (last, as in ``decode/programs.py``). A new key drops the
  graphs whose addresses differ.
- **Capture** follows ``GraphPool.capture_graph``: the step's eager run is
  undone (``restore=``: the parameters through ``.data`` and every optimizer
  state tensor) and the generator put back and registered with the graph,
  so that each replay draws what the eager step draws from the same state
  and leaves the generator where the eager step leaves it. The first step
  thus makes one eager run and one capture and replays the graph; the
  capture and every replay count the kernels' launches as the eager step
  launches them (K1's, the CTC's and the ResNet's 1x1 GEMM's, credited at
  each replay).
- **Draws under checkpointing:** a capture cannot rewind the generator for
  the recompute in the backward; the checkpointed block keeps its first
  run's draws (``models/fusion.py``, ``models/layers.py::KeptDraws``).
- **The eval step** replays one graph of ``AVSRTask.eval_step`` per input
  shape: the net's eval forward, the losses and the ``argmax`` (an
  ``EncodeProgram`` of the net, with its own pool).
- **On the CPU** there is no graph: the same object runs
  ``AVSRTask.train_step`` and ``eval_step`` eagerly, the plain version of
  the programs. On the card a capture or replay error raises; nothing runs
  eagerly behind a program.

**Meshes** (``step_kind``). The step's collectives are device calls that
read nothing back: the tensor-parallel reduces and gathers of the forward
and the backward (``parallel/tensor_parallel.py``), the data group's flat
gradient reduce and the clip norm's model-group reduce
(``training/optim.py``), the global counts and losses and so the guard's
global decision (``training/task.py``). On NCCL groups a graph captures them
with the rest of the step, so a mesh of any ``(data, model)`` shape replays
its step as one process does, as the JAX step is one program on any mesh:

- every communicator the step uses is made by the capture's eager run,
  which goes through every group the step reduces over;
- every rank captures and replays the same graphs in the same order, since
  its keys change with the batch's shape, which ``DataModule`` keeps the
  same on every rank at every step (``datamodule/samplers.py::ShardedSampler``
  deals equal row counts and one padded target length a step), and with the weights' addresses,
  which change on every rank at the same step;
- a NaN row on one rank makes the global loss NaN on every rank, so the
  guard skips the update on every rank inside the graph.

Gloo's collectives cannot be captured: a gloo group (on the CPU, or on CUDA
tensors as when two ranks share one card) runs ``AVSRTask.train_step`` and
``eval_step`` eagerly, decided from the groups' backends before the first
step, never by catching a failed capture.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable

import torch

from mocov2_whisper_flamingo_torch.decode.programs import EncodeProgram, GraphPool
from mocov2_whisper_flamingo_torch.utils.profiling import span


def step_kind(device: torch.device, backends: Iterable[str]) -> str:
    """``"program"`` where the train and eval steps on ``device`` can be
    replayed graphs given the backends of the process groups they reduce
    over (``torch.distributed.get_backend`` of each; none for one process),
    ``"eager"`` where a group's collectives cannot be captured: gloo, and any
    backend but NCCL for CUDA tensors. A backend string of several
    (``"cpu:gloo,cuda:nccl"``) counts by ``device``'s type. On the CPU the
    program runs the eager step anyway, so only a group moves it there."""
    for backend in backends:
        if ":" in backend:
            by_device = dict(part.split(":", 1) for part in backend.split(","))
            backend = by_device.get(device.type, backend)
        if not (device.type == "cuda" and backend == "nccl"):
            return "eager"
    return "program"


@dataclasses.dataclass
class _Step:
    """The graph of one key and the static tensors it reads and writes."""

    graph: torch.cuda.CUDAGraph
    inputs: dict   # static batch: name -> tensor (or None)
    losses: dict   # the step's losses, ``skipped`` included


class TrainProgram(GraphPool):
    """The compiled train and eval steps of ``task`` (see the module doc).
    ``settings``: the train settings that change the kernels, part of every
    key. ``steps``: key -> the graph of one batch shape; ``captures`` and
    ``replays`` as in ``GraphPool``; ``eval_program``: the eval step's
    graphs."""

    def __init__(self, task, optimizer, generator: torch.Generator | None, settings: dict):
        super().__init__()
        self.task = task
        self.optimizer = optimizer
        self.generator = generator
        self.settings = tuple(sorted(settings.items()))
        self.steps: dict = {}
        self.eval_program = EncodeProgram(functools.partial(_eval_outputs, task), task.net)

    def key(self, batch: dict) -> tuple:
        """The key of the graph that trains on ``batch``."""
        tensors = sorted((k, v) for k, v in batch.items() if torch.is_tensor(v) or v is None)
        net = self.task.net
        return (tuple((k, None if v is None else (tuple(v.shape), v.dtype)) for k, v in tensors),
                self.optimizer.params[0].device, self.settings,
                tuple(t.data_ptr() for t in (*net.parameters(), *net.buffers(),
                                             *self.optimizer.state_tensors())))

    def _step(self, batch: dict) -> dict:
        return self.task.train_step(self.optimizer, batch, self.generator)

    def train_step(self, batch: dict) -> dict:
        """One micro-batch; returns the detached global losses (and
        ``skipped``, a tensor), as ``AVSRTask.train_step`` does.

        Host spans (``utils/profiling.py::span``), inside
        ``train_program.step``: ``train_program.key``, then
        ``train_program.capture`` (the eager run, the capture and the
        instantiation) or ``train_program.inputs`` (the batch's copies),
        then ``train_program.replay``. The step's own spans are device
        markers inside the graph."""
        with span("train_program.step"):
            if self.optimizer.params[0].device.type != "cuda":
                return self._step(batch)
            with span("train_program.key"):
                stream = torch.cuda.current_stream(self.optimizer.params[0].device)
                key = self.key(batch)
            step = self.steps.get(key)
            if step is None:
                for stale in [k for k in self.steps if k[-1] != key[-1]]:
                    del self.steps[stale]
                with span("train_program.capture"):
                    step = self.steps[key] = self._capture(batch, stream)
            else:
                with span("train_program.inputs"):
                    for name, dst in step.inputs.items():
                        if dst is not None:
                            dst.copy_(batch[name], non_blocking=True)
            with span("train_program.replay"):
                self.replay(step.graph)
            return {k: v.clone() for k, v in step.losses.items()}

    def eval_step(self, batch: dict) -> tuple[dict, torch.Tensor]:
        """``(losses, predictions)`` as ``AVSRTask.eval_step``: on the card a
        replayed graph of the whole eval step."""
        if self.optimizer.params[0].device.type != "cuda":
            return self.task.eval_step(batch)
        *values, preds = self.eval_program(*(batch[k] for k in _EVAL_INPUTS))
        return dict(zip(self.task.loss_names, values)), preds

    def _capture(self, batch: dict, stream) -> _Step:
        held = {k: None if v is None else
                torch.empty_like(v, device=stream.device).copy_(v, non_blocking=True)
                for k, v in batch.items() if torch.is_tensor(v) or v is None}
        restore = (*(p.data for p in self.optimizer.params), *self.optimizer.state_tensors())
        generators = (self.generator,) if self.generator is not None else ()
        graph, losses = self.capture_graph(lambda: self._step(held), stream, restore=restore,
                                           generators=generators, loop="train_step",
                                           shape=list(batch["target_ids"].shape))
        return _Step(graph=graph, inputs=held, losses=losses)


_EVAL_INPUTS = ("audio", "audio_mask", "video", "video_mask", "video_lengths", "audio_lengths",
                "target_ids", "target_lengths")


def _eval_outputs(task, *inputs) -> tuple:
    """``task.eval_step`` over a batch's tensors in ``_EVAL_INPUTS`` order, as
    a tuple: the losses in ``task.loss_names`` order, then the predictions."""
    losses, preds = task.eval_step(dict(zip(_EVAL_INPUTS, inputs)))
    return (*(losses[k] for k in task.loss_names), preds)
