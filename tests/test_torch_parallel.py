"""The port's mesh and sharding rules (``parallel/mesh.py``), unit by unit,
against the JAX package's where they have a counterpart; and two
multi-process cases of ``Trainer.fit``: the 2 x 2 mesh (4 processes) and
unequal token counts per data index, each against the JAX ``Trainer`` on the
same mesh shape (helpers and tolerances of tests/test_torch_multicard.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from mocov2_whisper_flamingo_torch.datamodule import data_module as t_dm
from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.parallel import (
    DEFAULT_PARAM_RULES, Mesh, batch_sharding, initialize_distributed, make_mesh,
    param_sharding, shard_batch, shard_module)
from mocov2_whisper_flamingo_torch.parallel.mesh import sharded_dims
from mocov2_whisper_flamingo_torch.parallel import tensor_parallel as TP
from mocov2_whisper_flamingo_torch.training.task import AVSRTask as TTask
from mocov2_whisper_flamingo_tpu.parallel import make_mesh as j_make_mesh
from mocov2_whisper_flamingo_tpu.parallel import param_sharding as j_param_sharding

from test_torch_multicard import (
    Ranks, assert_matches_jax, case_named, global_batches, jax_fit, same_on_every_rank)
from test_torch_training import LOSS_ATOL, VOCAB, _t, _torch_net, _tree
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)


def _mesh(d, m, data_index=0, model_index=0) -> Mesh:
    """A mesh without process groups, for the rules alone."""
    return Mesh({"data": d, "model": m}, data_index, model_index)


# -- the mesh --------------------------------------------------------------------------------


def test_make_mesh_without_a_process_group_is_one_by_one():
    assert not dist.is_initialized()
    for args in ((), (-1, 1), (1, 1), (None, None)):
        mesh = make_mesh(*args)
        assert mesh.shape == {"data": 1, "model": 1} and mesh.rank == 0
        assert mesh.data_group is None and mesh.model_group is None


@pytest.mark.parametrize("d,m,match", [(4, 1, "does not cover"), (2, 2, "not divisible"),
                                       (-1, 3, "not divisible")])
def test_make_mesh_raises_where_the_world_does_not_fit(d, m, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(d, m)


def test_initialize_distributed_without_a_cluster_is_a_no_op(monkeypatch):
    for key in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    initialize_distributed()
    assert not dist.is_initialized()


@pytest.mark.parametrize("kwargs,match", [
    ({"num_processes": 2, "process_id": 5}, "out of range"),
    ({"coordinator_address": "localhost:1"}, "number of processes"),
    ({"num_processes": 2}, "number of processes"),
])
def test_initialize_distributed_with_bad_explicit_arguments_raises(monkeypatch, kwargs, match):
    for key in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match=match):
        initialize_distributed(backend="gloo", **kwargs)
    assert not dist.is_initialized()


def test_megatron_functions_are_the_identity_without_a_model_group():
    x = torch.randn(2, 3, 4, requires_grad=True)
    for fn in (TP.copy_to_model_group, TP.reduce_from_model_group, TP.gather_from_model_group):
        assert fn(x, None) is x
    assert TP.all_reduce_sum(x, None) is x
    assert TP.all_gather_cat(x, None, 0) is x


# -- the rules --------------------------------------------------------------------------------


def _port_names_tree():
    """Leaves under the port's dotted names, and the same leaves as a JAX tree."""
    leaves = {
        "whisper_encoder.layers.0.self_attn.q.kernel": (64, 64),
        "whisper_encoder.layers.0.self_attn.q.bias": (64,),
        "whisper_encoder.layers.0.self_attn.out.kernel": (64, 64),
        "whisper_encoder.layers.0.self_attn.out.bias": (64,),
        "whisper_encoder.layers.0.mlp.fc1.kernel": (64, 256),
        "whisper_encoder.layers.0.mlp.fc2.kernel": (256, 64),
        "fusion.layers.0.attn.v.kernel": (64, 64),
        "fusion.layers.0.ff1.kernel": (64, 256),
        "fusion.layers.0.ff2.kernel": (256, 64),
        "fusion.layers.0.attn_ln.scale": (64,),
        "audio_ln.scale": (64,),
        "decoder.kernel": (64, 51866),
        "decoder.bias": (51866,),
        "odd.kernel": (7, 13),
    }
    named = {k: np.zeros(v, np.float32) for k, v in leaves.items()}
    tree: dict = {}
    for name, value in named.items():
        node = tree
        *path, leaf = name.split(".")
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = jnp.asarray(value)
    return named, tree


def test_rule_table_lays_out_the_port_names_as_the_jax_rules_do():
    """The layout of tests/test_parallel.py on the port's names, leaf for leaf
    equal to the JAX ``param_sharding`` of the same tree on a 4 x 2 mesh."""
    named, tree = _port_names_tree()
    ours = param_sharding(_mesh(4, 2), named)
    assert ours["whisper_encoder.layers.0.self_attn.q.kernel"] == (None, "model")  # column
    assert ours["whisper_encoder.layers.0.self_attn.q.bias"] == ("model",)
    assert ours["whisper_encoder.layers.0.self_attn.out.kernel"] == ("model", None)  # row
    assert ours["whisper_encoder.layers.0.self_attn.out.bias"] == ()  # added after the reduce
    assert ours["whisper_encoder.layers.0.mlp.fc1.kernel"] == (None, "model")
    assert ours["whisper_encoder.layers.0.mlp.fc2.kernel"] == ("model", None)
    assert ours["fusion.layers.0.ff1.kernel"] == (None, "model")
    assert ours["audio_ln.scale"] == ()
    assert ours["decoder.kernel"] == (None, "model")  # vocab sharded
    assert ours["odd.kernel"] == ()  # indivisible -> replicated

    flat = jax.tree_util.tree_flatten_with_path(
        j_param_sharding(j_make_mesh(n_data=4, n_model=2), tree))[0]
    ref = {".".join(str(k.key) for k in path): spec.spec for path, spec in flat}
    assert sorted(ref) == sorted(ours)
    for name, spec in ours.items():
        assert P(*spec) == ref[name], name


def test_trivial_axes_drop_and_the_int8_leaves_follow_their_kernel():
    assert param_sharding(_mesh(8, 1), {"fusion.layers.0.ff1.kernel": torch.zeros(4, 8)}) == {
        "fusion.layers.0.ff1.kernel": ()}
    names = {"x.self_attn.q.kernel_q": (32, 64), "x.self_attn.q.scale": (64,),
             "x.self_attn.out.kernel_q": (64, 32), "x.self_attn.out.scale": (32,),
             "x.mlp.fc1.kernel_q": (32, 64), "x.mlp.fc1.scale": (64,),
             "x.mlp.fc2.kernel_q": (64, 32), "x.mlp.fc2.scale": (32,),
             "x.self_attn_ln.scale": (32,)}
    specs = param_sharding(_mesh(1, 2), {k: torch.zeros(v) for k, v in names.items()})
    assert specs == {"x.self_attn.q.kernel_q": (None, "model"), "x.self_attn.q.scale": ("model",),
                     "x.self_attn.out.kernel_q": ("model", None), "x.self_attn.out.scale": (),
                     "x.mlp.fc1.kernel_q": (None, "model"), "x.mlp.fc1.scale": ("model",),
                     "x.mlp.fc2.kernel_q": ("model", None), "x.mlp.fc2.scale": (),
                     "x.self_attn_ln.scale": ()}
    assert len(DEFAULT_PARAM_RULES) == 9


def _net(d_model=48, n_heads=3, vocab=51865, fusion=(32, 4)):
    cfg = TConfig(n_mels=80, d_model=d_model, encoder_layers=1, decoder_layers=1,
                  n_heads=n_heads, d_ff=64, vocab_size=vocab, max_source_positions=64,
                  max_target_positions=32)
    return TNet("audiovisual", None, 96, (fusion[0], fusion[1], 2, 3000, 128, 0.0), vocab,
                device="cpu", whisper_config=cfg)


def test_shard_module_splits_whole_units_and_replicates_what_does_not_divide():
    """At M=2: the encoder's 3 heads do not divide, so its whole attention
    stays whole although every leaf would; its feed-forward pair splits; the
    fusion (4 heads) splits; the odd vocabulary of 51865 keeps the head
    whole, as the JAX rules do."""
    net = _net()
    before = {n: p.shape for n, p in net.named_parameters()}
    dims = shard_module(net, _mesh(1, 2, model_index=1))
    assert dims == sharded_dims(net)
    enc = "whisper_encoder.layers.0."
    assert not any(n.startswith(enc + "self_attn.") for n in dims)
    assert dims[enc + "mlp.fc1.kernel"] == 1 and dims[enc + "mlp.fc2.kernel"] == 0
    assert dims[enc + "mlp.fc1.bias"] == 0 and enc + "mlp.fc2.bias" not in dims
    fusion = "fusion.layers.0."
    assert {n[len(fusion):] for n in dims if n.startswith(fusion)} == {
        "attn.q.kernel", "attn.q.bias", "attn.k.kernel", "attn.k.bias", "attn.v.kernel",
        "attn.v.bias", "attn.out.kernel", "ff1.kernel", "ff1.bias", "ff2.kernel"}
    assert "decoder.kernel" not in dims and net.decoder.tp_mode is None
    for name, param in net.named_parameters():
        want = list(before[name])
        if name in dims:
            want[dims[name]] //= 2
        assert list(param.shape) == want, name
    assert net.fusion.layers[0].attn.out.tp_mode == "row"
    assert net.whisper_encoder.layers[0].self_attn.q.tp_mode is None

    jtree = {"decoder": {"kernel": jnp.zeros((32, 51865))}}
    assert j_param_sharding(j_make_mesh(n_data=4, n_model=2), jtree)["decoder"]["kernel"].spec == P()


def test_shard_module_keeps_this_ranks_slice_and_splits_a_divisible_head():
    whole = _net(d_model=64, n_heads=4, vocab=48)
    for i, (_, p) in enumerate(whole.named_parameters()):
        p.data = torch.full_like(p, float(i))
    for index in range(2):
        net = _net(d_model=64, n_heads=4, vocab=48)
        net.load_state_dict(whole.state_dict())
        dims = shard_module(net, _mesh(1, 2, model_index=index))
        assert net.decoder.tp_mode == "gather" and dims["decoder.kernel"] == 1
        assert net.whisper_encoder.layers[0].self_attn.q.tp_mode == "column"
        ref = dict(whole.named_parameters())
        for name, param in net.named_parameters():
            want = ref[name] if name not in dims else ref[name].chunk(2, dims[name])[index]
            assert torch.equal(param, want), name


def test_batch_rows_by_data_index():
    batch = {"audio": np.arange(8).reshape(4, 2), "target_text": list("abcd"), "video": None}
    assert batch_sharding(_mesh(2, 2), batch) == {"audio": ("data",), "target_text": ("data",)}
    assert batch_sharding(_mesh(1, 2), batch) == {"audio": (), "target_text": ()}
    rows = shard_batch(_mesh(2, 2, data_index=1, model_index=1), batch)
    np.testing.assert_array_equal(rows["audio"], [[4, 5], [6, 7]])
    assert rows["target_text"] == ["c", "d"] and rows["video"] is None
    assert shard_batch(_mesh(1, 2), batch)["target_text"] == list("abcd")
    with pytest.raises(ValueError, match="divisible"):
        shard_batch(_mesh(3, 1), batch)


@pytest.mark.parametrize("rank", range(4))
def test_the_sampler_deals_by_data_index(monkeypatch, rank):
    """4 processes at model=2: ranks 0 and 1 are data index 0, ranks 2 and 3
    data index 1 (the model axis is innermost)."""
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 4)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: rank)
    assert t_dm._data_shard(2) == (2, rank // 2)
    assert t_dm._data_shard(1) == (4, rank)


# -- multi-process fits -----------------------------------------------------------------------


CASES_B2 = [{"name": "pad", "mesh": (2, 1), "batches": "uneven", "max_steps": 4,
             "overrides": {"training.pad_to_ignore": True}}]
CASES_B4 = [{"name": "dp_tp", "mesh": (2, 2), "batches": "main", "max_steps": 4}]
for _case in CASES_B2 + CASES_B4:
    _case["vocab"] = VOCAB


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tree, batches = _tree(), global_batches()
    two = Ranks(tmp_path_factory.mktemp("two_ranks"), 2, CASES_B2, tree, batches)
    four = Ranks(tmp_path_factory.mktemp("four_ranks"), 4, CASES_B4, tree, batches)
    yield {"tree": tree, "batches": batches, "two": two, "four": four}
    two.kill()
    four.kill()


def test_data_and_tensor_parallel_fit_matches_jax(runs, tmp_path):
    ref = jax_fit(tmp_path, runs, case_named(CASES_B4, "dp_tp"))
    ours = same_on_every_rank(runs["four"], "dp_tp", 4)
    assert [runs["four"].result("dp_tp", r)["mesh"] for r in range(4)] == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    assert ours["count"] == 2
    assert_matches_jax(ours, ref, runs["tree"])


def test_unequal_token_counts_use_the_global_batch_normalisation(runs, tmp_path):
    """``pad_to_ignore`` with long targets on data index 0 and short ones on
    data index 1: the CE is the global batch's token mean. A mean of the two
    ranks' means would be off by far more than the tolerance."""
    ref = jax_fit(tmp_path, runs, case_named(CASES_B2, "pad"))
    assert_matches_jax(same_on_every_rank(runs["two"], "pad", 2), ref, runs["tree"])
    batch = _t({k: v for k, v in runs["batches"]["uneven"][0].items() if k != "target_text"})
    task = TTask(_torch_net(0.0, runs["tree"]), pad_to_ignore=True)

    def ce(rows):
        with torch.no_grad():
            return float(task.loss_fn({k: v[rows] for k, v in batch.items()}, None, False)[1]
                         ["ce_loss"])

    whole, halves = ce(slice(0, 4)), (ce(slice(0, 2)) + ce(slice(2, 4))) / 2
    assert abs(whole - halves) > 100 * LOSS_ATOL
