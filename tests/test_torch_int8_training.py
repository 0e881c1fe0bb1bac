"""int8 storage of the frozen Whisper encoder in the port's training path
(``AVNet.quantize_frozen_params``, ``training.frozen_weight_quant: int8``)
against the JAX package on the CPU, at the tiny configuration and with the
helpers of tests/test_torch_training.py: the quantized leaves bit for bit,
the encoder's output, the dtypes after ``cast_frozen_params``, two fp32
``Trainer.fit`` steps against the JAX train step, and a checkpoint round
trip.

Tolerances: those of tests/test_torch_training.py; with bf16 storage of the
frozen trees ``BF16_FROZEN_*`` (see ``test_int8_frozen_fit_matches_jax``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_tpu.training import optim as JO
from mocov2_whisper_flamingo_tpu.training.task import AVSRTask as JTask

from test_torch_training import (
    LOSS_ATOL, PARAM_ATOL, TINY, _DataModule, _j, _jax_net, _named, _torch_net, _trainer, _tree)

# bf16 storage of the frozen trees (see test_int8_frozen_fit_matches_jax)
BF16_FROZEN_LOSS_ATOL = 1e-3
BF16_FROZEN_PARAM_ATOL = 2e-4  # video_proj: the frontend features differ as there


def test_int8_frozen_encoder_matches_jax():
    """``quantize_frozen_params``: the encoder's int8 leaves and scales equal
    the JAX tree's, conv/LayerNorm leaves are untouched, and the quantized
    encoder's output matches the JAX ``apply`` on that tree."""
    tree = _tree()
    jnet = _jax_net(0.0)
    jparams = jnet.quantize_frozen_params(jax.tree.map(jnp.asarray, tree))
    net = _torch_net(0.0, tree).quantize_frozen_params()
    ref = _named(jparams)
    ours = dict(net.named_parameters())
    enc = {n for n in ours if n.startswith("whisper_encoder.layers.")}
    assert enc == {n for n in ref if n.startswith("whisper_encoder.layers.")}
    quantized = [n for n in ours if n.endswith("kernel_q")]
    assert len(quantized) == 6 * TINY["encoder_layers"]
    assert all(n.startswith("whisper_encoder.layers.") for n in quantized)
    for name in quantized:
        assert ours[name].dtype == torch.int8 and not ours[name].requires_grad
        np.testing.assert_array_equal(ours[name].numpy(), ref[name])
        scale = name[: -len("kernel_q")] + "scale"
        np.testing.assert_array_equal(ours[scale].detach().numpy(), ref[scale])
    mel = np.random.default_rng(0).standard_normal((2, 80, 128)).astype(np.float32)
    want = jax.jit(jnet.whisper_encoder.apply)(jparams["whisper_encoder"], jnp.asarray(mel))
    with torch.no_grad():
        got = net.whisper_encoder(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    net.quantize_frozen_params()  # a second call leaves the quantized encoder as it is
    assert all(torch.equal(p, ours[n]) for n, p in net.named_parameters())


def test_cast_frozen_params_casts_the_int8_scales():
    """With both knobs the JAX package maps every floating frozen leaf to
    bf16, the int8 scales included; the port's scales are parameters, so
    its cast reaches them too. int8 weights and trainable leaves keep their
    dtypes."""
    tree = _tree()
    jnet = _jax_net(0.0)
    ref = _named(jnet.cast_frozen_params(jnet.quantize_frozen_params(
        jax.tree.map(jnp.asarray, tree))))
    net = _torch_net(0.0, tree).quantize_frozen_params().cast_frozen_params(torch.bfloat16)
    names = {"int8": torch.int8, "float32": torch.float32, "bfloat16": torch.bfloat16}
    for name, param in net.named_parameters():
        if name in ref:  # the frontend's folded BatchNorms have no JAX leaf
            assert param.dtype == names[str(ref[name].dtype)], name
        else:
            assert name.startswith(("visual_frontend.", "whisper_encoder.conv"))
            assert param.dtype == torch.bfloat16, name
    assert net.whisper_encoder.layers[0].mlp.fc1.scale.dtype == torch.bfloat16


@pytest.mark.parametrize("frozen_dtype", [None, "bf16"], ids=["int8", "int8_bf16"])
def test_int8_frozen_fit_matches_jax(tmp_path, frozen_dtype):
    """Two fp32 ``Trainer.fit`` steps with ``training.frozen_weight_quant:
    int8`` (and ``frozen_param_dtype: bf16``) against the JAX train step on
    the tree the JAX trainer's ``setup`` makes: quantized, then cast.

    With bf16 storage the tolerances are ``BF16_FROZEN_*``: the port folds
    each frozen BatchNorm into its conv before the cast, where the JAX
    package casts conv and BatchNorm leaves apart; that alone moves the first
    loss by 4.2e-4, with or without int8."""
    tree = _tree()
    extra = {"training.frozen_weight_quant": "int8", "training.epochs": 1}
    if frozen_dtype:
        extra["training.frozen_param_dtype"] = frozen_dtype
    trainer = _trainer(tmp_path, net=_torch_net(0.0, tree), **extra)
    dm = _DataModule()
    trainer.fit(dm, max_steps=2)

    jnet = _jax_net(0.0)
    params = jnet.quantize_frozen_params(jax.tree.map(jnp.asarray, tree))
    if frozen_dtype:
        params = jnet.cast_frozen_params(params)
    jopt, _ = JO.make_optimizer(trainer.config["training"], 2,
                                JO.trainable_mask_for(jnet, params))
    jstep = jax.jit(JTask(jnet).make_train_step(jopt))
    opt_state = jopt.init(params)
    loss_atol, param_atol = ((BF16_FROZEN_LOSS_ATOL, BF16_FROZEN_PARAM_ATOL) if frozen_dtype
                             else (LOSS_ATOL, PARAM_ATOL))
    losses = {step: v for tag, v, step in trainer.writer.scalars if tag == "train/loss"}
    for i, batch in enumerate(dm.batches):
        batch = {k: v for k, v in batch.items() if k != "target_text"}
        params, opt_state, jl = jstep(params, opt_state, _j(batch), jax.random.PRNGKey(i))
        assert losses[i + 1] == pytest.approx(float(jl["loss"]), abs=loss_atol), i
    ref = _named(params)
    for name, param in trainer.net.named_parameters():
        if TNet.trainable_filter(name):
            np.testing.assert_allclose(param.detach().numpy(), ref[name], atol=param_atol,
                                       rtol=0, err_msg=name)
        elif param.dtype == torch.int8:
            np.testing.assert_array_equal(param.numpy(), ref[name], err_msg=name)
    assert trainer.net.whisper_encoder.layers[0].self_attn.q.kernel_q.dtype == torch.int8


def test_int8_frozen_checkpoint_round_trip(tmp_path):
    """Checkpoints hold the quantized encoder; a resume on a fresh net (the
    trainer quantizes it, then loads) takes it back bit for bit."""
    trainer = _trainer(tmp_path, **{"training.frozen_weight_quant": "int8",
                                    "training.epochs": 1})
    trainer.fit(_DataModule(), max_steps=2)
    restored = trainer.ckpt.restore()
    key = "whisper_encoder.layers.0.mlp.fc2.kernel_q"
    assert restored["params"][key].dtype == torch.int8
    resumed = _trainer(tmp_path, net=_torch_net(0.0, _tree(seed=3)),
                       **{"training.frozen_weight_quant": "int8", "training.epochs": 1})
    resumed.fit(_DataModule(), max_steps=3, resume="last")
    assert resumed.global_step == 3
    state = resumed.net.state_dict()
    for name, value in restored["params"].items():
        if not TNet.trainable_filter(name):  # frozen: as the checkpoint holds it
            assert torch.equal(state[name], value), name
    with pytest.raises(ValueError, match="frozen_weight_quant"):
        _trainer(tmp_path, **{"training.frozen_weight_quant": "int4"}).setup(2)
