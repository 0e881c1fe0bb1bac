"""The port's checkpoint loaders against the JAX package's on the CPU: a MoCo
v2 checkpoint in its own layout (random tensors, saved with ``torch.save``)
through ``AVNet(MoCofile=...)``, and an HF Whisper state dict from a random
tiny ``transformers.WhisperModel`` through ``load_whisper_torch`` of
``AVNet`` and ``AVWhisperNet``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.models import convert as C
from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet as TAVW
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_tpu.models.av_net import AVNet as JNet
from mocov2_whisper_flamingo_tpu.models.av_whisper import AVWhisperNet as JAVW
from mocov2_whisper_flamingo_tpu.models.convert import resnet50_from_moco as j_resnet50_from_moco
from mocov2_whisper_flamingo_tpu.models.visual_frontend import MoCoVisualFrontend as JFrontend
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

ATOL = 1e-5  # fp32 modules (the frontend parity test's tolerance, scaled by the output's size)
VOCAB = 64
MODELARGS = (32, 4, 2, 3000, 128, 0.0)
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=64, max_target_positions=32)
MISSING_BLOCK = "layer3.2"


class _NotATensor:
    """Pickled into a checkpoint that ``weights_only`` loading refuses."""


def _jax_net(moco_file):
    net = JNet("audiovisual", moco_file, 96, MODELARGS, VOCAB, whisper_name="whisper-tiny",
               backend="xla")
    cfg = JConfig(**TINY)
    net.whisper_config = cfg
    net.whisper_encoder = JEncoder(cfg, net.precision, "xla")
    return net


def _torch_net(moco_file=None):
    return TNet("audiovisual", moco_file, 96, MODELARGS, VOCAB, device="cpu",
                whisper_config=TConfig(**TINY))


def _moco_state(seed=0) -> dict:
    """A MoCo v2 ``state_dict`` of random tensors in the checkpoint's layout:
    the query encoder's stem, layer1-4 and MLP head, the key encoder, and
    ``MISSING_BLOCK`` left out."""
    g = torch.Generator().manual_seed(seed)
    sd = {}

    def conv(name, c_out, c_in, k):
        std = (2.0 / (c_in * k * k)) ** 0.5
        sd[f"{name}.weight"] = torch.randn((c_out, c_in, k, k), generator=g) * std

    def bn(name, c):
        sd[f"{name}.weight"] = torch.rand((c,), generator=g) + 0.5
        sd[f"{name}.bias"] = torch.randn((c,), generator=g) * 0.1
        sd[f"{name}.running_mean"] = torch.randn((c,), generator=g) * 0.1
        sd[f"{name}.running_var"] = torch.rand((c,), generator=g) + 0.5
        sd[f"{name}.num_batches_tracked"] = torch.tensor(1000)

    q = "module.encoder_q"
    conv(f"{q}.conv1", 64, 3, 7)
    bn(f"{q}.bn1", 64)
    c_in = 64
    for stage, (blocks, mid, stride) in enumerate(((3, 64, 1), (4, 128, 2), (6, 256, 2),
                                                   (3, 512, 2)), start=1):
        for i in range(blocks):
            p = f"{q}.layer{stage}.{i}"
            if f"layer{stage}.{i}" != MISSING_BLOCK:
                conv(f"{p}.conv1", mid, c_in, 1), bn(f"{p}.bn1", mid)
                conv(f"{p}.conv2", mid, mid, 3), bn(f"{p}.bn2", mid)
                conv(f"{p}.conv3", mid * 4, mid, 1), bn(f"{p}.bn3", mid * 4)
                if i == 0:
                    conv(f"{p}.downsample.0", mid * 4, c_in, 1), bn(f"{p}.downsample.1", mid * 4)
            c_in = mid * 4
    sd[f"{q}.fc.0.weight"] = torch.randn((2048, 2048), generator=g) * 0.01
    sd[f"{q}.fc.2.weight"] = torch.randn((128, 2048), generator=g) * 0.01
    sd["module.encoder_k.layer1.0.conv1.weight"] = torch.zeros((64, 64, 1, 1))
    return sd


@pytest.fixture(scope="module")
def moco_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("moco") / "moco_v2_800ep_pretrain.pth.tar"
    torch.save({"epoch": 800, "arch": "resnet50", "state_dict": _moco_state()}, path)
    return str(path)


@pytest.fixture(scope="module")
def moco_pair(moco_file):
    """JAX: ``AVNet(MoCofile=path).init``; the port: the same random init
    (the JAX init without the file, through the bridge), then
    ``load_moco``."""
    key = jax.random.PRNGKey(3)
    init = jax.tree.map(lambda x: np.array(x, np.float32), _jax_net(None).init(key))
    loaded = jax.tree.map(lambda x: np.array(x, np.float32), _jax_net(moco_file).init(key))
    net = C.load_jax_params(_torch_net(), init)
    report = net.load_moco(moco_file)
    return init, loaded, net, report


def test_moco_frontend_forward_matches_jax(moco_pair):
    _, loaded, net, _ = moco_pair
    rng = np.random.default_rng(5)
    video = rng.standard_normal((2, 5, 3, 32, 32)).astype(np.float32)
    x_len = np.array([5, 3], np.int32)
    ref = np.asarray(jax.jit(JFrontend().apply)(
        jax.tree.map(jnp.asarray, loaded["visual_frontend"]), jnp.asarray(video),
        jnp.asarray(x_len)))
    with torch.no_grad():
        ours = net.visual_frontend(torch.from_numpy(video), torch.from_numpy(x_len)).numpy()
    assert ours.shape == (2, 5, 2048)
    np.testing.assert_allclose(ours, ref, atol=ATOL * max(np.abs(ref).max(), 1.0), rtol=0)


def test_moco_report_and_weights_follow_the_checkpoint(moco_pair, moco_file):
    init, loaded, net, report = moco_pair
    checkpoint = torch.load(moco_file, map_location="cpu", weights_only=False)
    ref = j_resnet50_from_moco(checkpoint, init["visual_frontend"]["body"])["_conversion_report"]
    assert report == ref
    assert report["blocks_loaded"] == 15 and len(report["skipped"]) == 1
    assert report["skipped"][0].startswith(MISSING_BLOCK + ": ")
    body = net.visual_frontend.body.state_dict()
    stage, block = MISSING_BLOCK.split(".")
    for name, value in C.from_jax_params({"b": init["visual_frontend"]["body"]}).items():
        key = name.removeprefix("b.")
        kept = key.startswith(f"{stage}.{block}.")
        assert torch.equal(body[key], torch.from_numpy(value)) == kept, key
    # the constructor loads the same checkpoint into the same blocks
    fresh = _torch_net(moco_file)
    assert fresh.moco_report == report
    weights, _ = C.resnet50_from_moco(checkpoint)
    for key, value in weights.items():
        assert torch.equal(fresh.visual_frontend.body.state_dict()[key], torch.from_numpy(value))
    assert not fresh.visual_frontend.body.state_dict()[f"{MISSING_BLOCK}.conv1.weight"].any()


def test_moco_missing_and_unreadable_files(tmp_path, caplog):
    net = _torch_net(str(tmp_path / "absent.pth.tar"))
    assert net.moco_report is None and "not found" in caplog.text
    path = tmp_path / "pickled.pth"
    torch.save({"state_dict": {}, "args": _NotATensor()}, path)
    with pytest.raises(RuntimeError, match="weights_only"):
        _torch_net(str(path))


# -- HF Whisper state dicts ----------------------------------------------------------------


@pytest.fixture(scope="module")
def hf_state():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("USE_TF", "0")  # no TensorFlow import: the torch model is all this needs
        transformers = pytest.importorskip("transformers")
    hf_cfg = transformers.WhisperConfig(
        vocab_size=VOCAB, num_mel_bins=80, encoder_layers=1, encoder_attention_heads=4,
        decoder_layers=1, decoder_attention_heads=4, d_model=32, encoder_ffn_dim=64,
        decoder_ffn_dim=64, max_source_positions=64, max_target_positions=32,
        pad_token_id=0, bos_token_id=1, eos_token_id=2, decoder_start_token_id=1)
    torch.manual_seed(0)
    return transformers.WhisperModel(hf_cfg).eval().state_dict()


def test_avnet_load_whisper_torch_matches_jax(hf_state):
    mel = np.random.default_rng(1).standard_normal((2, 80, 128)).astype(np.float32)
    jnet = _jax_net(None)
    params = jnet.load_whisper_torch(jnet.init(jax.random.PRNGKey(0)), hf_state)
    ref = np.asarray(jnet.whisper_encoder.apply(params["whisper_encoder"], jnp.asarray(mel)))
    net = _torch_net()
    assert net.load_whisper_torch(hf_state) is net
    with torch.no_grad():
        ours = net.whisper_encoder(torch.from_numpy(mel)).numpy()
    assert ours.shape == (2, 64, 32)
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_av_whisper_load_whisper_torch_matches_jax(hf_state):
    jnet = JAVW(modelargs=MODELARGS, vocab_size=VOCAB, whisper_name="whisper-tiny",
                backend="xla")
    cfg = JConfig(**TINY)
    jnet.whisper_config = jnet.trunk.whisper_config = cfg
    jnet.trunk.whisper_encoder = JEncoder(cfg, jnet.trunk.precision, "xla")
    jnet.decoder = JDecoder(cfg, jnet.precision, "xla")
    params = jnet.load_whisper_torch(jnet.init(jax.random.PRNGKey(0)), hf_state)
    mel = np.random.default_rng(2).standard_normal((2, 80, 128)).astype(np.float32)
    ref = np.asarray(jnet.trunk.whisper_encoder.apply(params["trunk"]["whisper_encoder"],
                                                      jnp.asarray(mel)))
    net = TAVW(modelargs=MODELARGS, vocab_size=VOCAB, device="cpu",
               whisper_config=TConfig(**TINY))
    assert net.load_whisper_torch(hf_state) is net
    with torch.no_grad():
        ours = net.trunk.whisper_encoder(torch.from_numpy(mel)).numpy()
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)
    decoder = C.load_jax_params(TDecoder(TConfig(**TINY), device="cpu"), jax.tree.map(
        lambda x: np.array(x, np.float32), params["decoder"]))
    for (name, a), (_, b) in zip(net.decoder.state_dict().items(), decoder.state_dict().items()):
        assert torch.equal(a, b), name
