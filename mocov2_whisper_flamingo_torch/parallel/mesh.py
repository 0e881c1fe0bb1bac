"""Process mesh and sharding rules (counterpart of ``parallel/mesh.py``).

Mesh axes, one process per card:

- ``data``: data parallelism. Each data index holds its own rows of the
  global batch; gradients are summed over the data group in one all-reduce
  of a flat buffer per micro-batch (``training/optim.py``).
- ``model``: Megatron tensor parallelism for the attention layers, the
  feed-forward layers and the vocabulary head: column-parallel then
  row-parallel linears (``parallel/tensor_parallel.py``), one all-reduce per
  pair.

The model axis is innermost: rank = data_index * M + model_index. The rules
are the JAX package's regexes over the parameter path, matched against the
port's dotted names with ``/`` for ``.``. A rule's ``"model"`` on a kernel's
dimension 1 (JAX "column") is the output dimension of the port's ``[d_in,
d_out]`` kernel, dimension 0 (JAX "row") its input dimension. The int8
leaves of ``QuantLinear`` (``kernel_q`` and its per-output-channel
``scale``) follow their float kernel's rule.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Mapping

import torch
import torch.distributed as dist

from mocov2_whisper_flamingo_torch.parallel.tensor_parallel import all_gather_cat

DATA_AXIS = "data"
MODEL_AXIS = "model"
REPLICATED: tuple = ()


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           backend: str | None = None,
                           timeout_s: float | None = None) -> None:
    """Join the process group: ``torch.distributed.init_process_group`` with
    the explicit arguments, or with torchrun's ``RANK``, ``WORLD_SIZE`` and
    ``MASTER_ADDR`` / ``MASTER_PORT``. ``coordinator_address`` is
    ``host:port`` or an init URL (``tcp://...``, ``file://...``). The
    backend is ``nccl`` where CUDA is available and ``gloo`` otherwise,
    unless one is passed.

    A no-op when the group is already initialised, or when there are neither
    arguments nor torchrun's variables (a single-process run). A bring-up
    with explicit arguments that fails raises: degrading silently to one
    process would train on 1/N of the data while reporting success."""
    if dist.is_initialized():
        return
    env = os.environ
    explicit = (coordinator_address is not None or num_processes is not None
                or process_id is not None)
    if not explicit and not all(k in env for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR")):
        return
    world = num_processes if num_processes is not None else env.get("WORLD_SIZE")
    rank = process_id if process_id is not None else env.get("RANK")
    if world is None or rank is None:
        raise ValueError("initialize_distributed needs the number of processes and this "
                         "process's id, as arguments or as WORLD_SIZE and RANK")
    world, rank = int(world), int(rank)
    if not 0 <= rank < world:
        raise ValueError(f"process id {rank} out of range for {world} processes")
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world, rank=rank,
                            **kwargs)


@dataclasses.dataclass
class Mesh:
    """This process's place in a ``("data", "model")`` mesh of processes.
    ``data_group`` / ``model_group`` are the process groups along each axis
    (None where the axis is 1)."""

    shape: dict
    data_index: int = 0
    model_index: int = 0
    data_group: Any = None
    model_group: Any = None

    @property
    def rank(self) -> int:
        return self.data_index * self.shape[MODEL_AXIS] + self.model_index

    def backends(self) -> list[str]:
        """The backend of each of this rank's groups (none for one process)."""
        return [dist.get_backend(g) for g in (self.data_group, self.model_group)
                if g is not None]


def make_mesh(n_data: int = -1, n_model: int = 1) -> Mesh:
    """The mesh over the processes of ``torch.distributed`` (the 1 x 1 mesh
    without a process group). ``n_data=-1`` takes the world size over
    ``n_model``. Raises ``ValueError`` when the world does not divide by
    ``n_model`` or the mesh does not cover the world exactly. Every process
    must call it, in the same order as any other group it makes."""
    n_data = -1 if n_data is None else int(n_data)
    n_model = int(n_model or 1)
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if world % n_model:
        raise ValueError(f"{world} processes not divisible by model={n_model}")
    if n_data == -1:
        n_data = world // n_model
    if n_data * n_model != world:
        raise ValueError(f"a mesh of data={n_data} x model={n_model} does not cover the "
                         f"{world} processes of this run")
    mesh = Mesh({DATA_AXIS: n_data, MODEL_AXIS: n_model}, rank // n_model, rank % n_model)
    if n_model > 1:  # one group per data index: its n_model consecutive ranks
        for d in range(n_data):
            group = dist.new_group([d * n_model + m for m in range(n_model)])
            if d == mesh.data_index:
                mesh.model_group = group
    if n_data > 1:  # one group per model index: the ranks n_model apart
        for m in range(n_model):
            group = dist.new_group([d * n_model + m for d in range(n_data)])
            if m == mesh.model_index:
                mesh.data_group = group
    return mesh


# (path regex) -> spec: the axis each dimension is split over, None for a
# whole dimension. Paths look like "whisper_encoder/layers/3/mlp/fc1/kernel".
DEFAULT_PARAM_RULES: tuple[tuple[str, tuple], ...] = (
    # Megatron-style TP for transformer blocks: column-parallel then
    # row-parallel.
    (r".*(self_attn|cross_attn|attn)/(q|k|v)/(kernel|kernel_q)$", (None, MODEL_AXIS)),
    (r".*(self_attn|cross_attn|attn)/(q|k|v)/(bias|scale)$", (MODEL_AXIS,)),
    (r".*(self_attn|cross_attn|attn)/out/(kernel|kernel_q)$", (MODEL_AXIS, None)),
    (r".*(mlp/fc1|ff1)/(kernel|kernel_q)$", (None, MODEL_AXIS)),
    (r".*(mlp/fc1|ff1)/(bias|scale)$", (MODEL_AXIS,)),
    (r".*(mlp/fc2|ff2)/(kernel|kernel_q)$", (MODEL_AXIS, None)),
    # Vocab-dim sharding for the big embedding / output head.
    (r".*embed_tokens/embedding$", (MODEL_AXIS, None)),
    (r".*decoder/kernel$", (None, MODEL_AXIS)),
    (r".*decoder/bias$", (MODEL_AXIS,)),
)


def param_sharding(mesh: Mesh, params: Mapping[str, torch.Tensor],
                   rules: tuple[tuple[str, tuple], ...] = DEFAULT_PARAM_RULES) -> dict:
    """``{name: spec}`` for ``{name: tensor}``: the first matching rule's
    spec, with axes of extent 1 dropped; ``REPLICATED`` where no rule
    matches, or where a split dimension does not divide by its axis."""
    out = {}
    for name, leaf in params.items():
        path, spec = name.replace(".", "/"), REPLICATED
        for pattern, rule in rules:
            if re.match(pattern, path):
                rule = tuple(a if a is not None and mesh.shape[a] > 1 else None for a in rule)
                if any(a is not None for a in rule) and all(
                        a is None or (dim < leaf.ndim and leaf.shape[dim] % mesh.shape[a] == 0)
                        for dim, a in enumerate(rule)):
                    spec = rule
                break
        out[name] = spec
    return out


_EXPECTED = {  # the specs a unit's leaves take when it is split: (kernel, bias / scale)
    "column": ((None, MODEL_AXIS), (MODEL_AXIS,)),
    "gather": ((None, MODEL_AXIS), (MODEL_AXIS,)),
    "row": ((MODEL_AXIS, None), REPLICATED),
}


def shard_module(module: torch.nn.Module, mesh: Mesh,
                 rules: tuple[tuple[str, tuple], ...] = DEFAULT_PARAM_RULES) -> dict[str, int]:
    """Keep this rank's shard of every parameter the rules split, in place,
    and wire the linears to the model group. Returns ``sharded_dims``.

    Linears split as units, each given by a submodule's
    ``tensor_parallel_units()`` as ``(heads, [(linear, mode), ...])``: an
    attention layer's q/k/v (column) and out (row), a feed-forward pair, a
    vocabulary head (gather). A unit is split only when every leaf of it
    resolves to its split spec and, for attention, the head count divides
    by M, so that a column shard holds whole heads for the attention
    kernel; otherwise all of it stays whole (GSPMD reshards such a leaf and
    gets the same numbers). Parameters of modules without units (the
    Whisper decoder's) stay whole."""
    m = mesh.shape[MODEL_AXIS]
    if m > 1:
        specs = param_sharding(mesh, dict(module.named_parameters()), rules)
        names = {id(mod): name for name, mod in module.named_modules()}
        for owner in module.modules():
            for heads, linears in getattr(owner, "tensor_parallel_units", lambda: [])():
                leaves = [(f"{names[id(lin)]}.{leaf}".lstrip("."), param, mode)
                          for lin, mode in linears
                          for leaf, param in lin.named_parameters(recurse=False)]
                whole = heads is not None and heads % m
                if whole or any(specs[name] != _EXPECTED[mode][param.ndim == 1]
                                for name, param, mode in leaves):
                    continue
                for name, param, _ in leaves:
                    if MODEL_AXIS in specs[name]:
                        param.data = local_shard(param.data, specs[name].index(MODEL_AXIS), mesh)
                for lin, mode in linears:
                    lin.tp_mode, lin.tp_group = mode, mesh.model_group
    return sharded_dims(module)


def sharded_dims(module: torch.nn.Module) -> dict[str, int]:
    """``{parameter name: split dimension}`` of the split parameters, read
    from the linears' ``tp_mode``: a kernel (float or int8) splits its
    output dimension under "column" and "gather" and its input dimension
    under "row"; a bias or a per-output-channel scale splits with the output
    dimension and stays whole under "row"."""
    out = {}
    for name, mod in module.named_modules():
        mode = getattr(mod, "tp_mode", None)
        if mode is None:
            continue
        for leaf, param in mod.named_parameters(recurse=False):
            if param.ndim == 2:
                dim = 0 if mode == "row" else 1
            else:
                dim = None if mode == "row" else 0
            if dim is not None:
                out[f"{name}.{leaf}".lstrip(".")] = dim
    return out


def gather_state_dict(module: torch.nn.Module, mesh: Mesh) -> dict:
    """``module.state_dict()`` with every split parameter gathered whole
    over the model group (a collective of the group)."""
    shards = sharded_dims(module)
    return {k: all_gather_cat(v, mesh.model_group, shards[k]) if k in shards else v
            for k, v in module.state_dict().items()}


def local_shard(value: torch.Tensor, dim: int | None, mesh: Mesh) -> torch.Tensor:
    """This rank's slice of a whole tensor split along ``dim`` (None: whole)."""
    if dim is None:
        return value
    return value.chunk(mesh.shape[MODEL_AXIS], dim)[mesh.model_index].contiguous()


def load_whole_state_dict(module: torch.nn.Module, state: Mapping, mesh: Mesh) -> None:
    """Load a whole state dict (one a single process or ``gather_state_dict``
    wrote) into a sharded module: each split parameter takes its slice."""
    shards = sharded_dims(module)
    module.load_state_dict({k: local_shard(v, shards.get(k), mesh) for k, v in state.items()})


def batch_sharding(mesh: Mesh, batch: Mapping) -> dict:
    """``{key: spec}``: the leading axis over ``"data"`` for every leaf
    whose leading dimension divides by the data axis, else replicated."""
    d = mesh.shape[DATA_AXIS]

    def spec(leaf):
        n = len(leaf) if isinstance(leaf, list) else (leaf.shape[0] if getattr(
            leaf, "ndim", 0) else None)
        return (DATA_AXIS,) if d > 1 and n is not None and n % d == 0 else REPLICATED

    return {k: spec(v) for k, v in batch.items() if v is not None}


def shard_batch(mesh: Mesh, batch: Mapping) -> dict:
    """This data index's rows of a global batch: the host-local rows of
    the JAX package's ``put_host_local_batch``. The global batch is the rows
    of every data index, in order; the ranks of one model group hold the
    same rows. A leaf whose leading dimension does not divide by the data
    axis raises: every data index holding it whole would count it D times."""
    d = mesh.shape[DATA_AXIS]
    if d == 1:
        return dict(batch)
    specs = batch_sharding(mesh, batch)
    out = {}
    for key, leaf in batch.items():
        if leaf is None:
            out[key] = None
            continue
        if specs[key] != (DATA_AXIS,):
            raise ValueError(f"batch leaf {key!r} has no leading dimension divisible by "
                             f"the data axis ({d})")
        n = len(leaf) // d
        out[key] = leaf[mesh.data_index * n:(mesh.data_index + 1) * n]
    return out
