"""The port's compiled decode programs (``decode/programs.py``) on the CPU,
where a ``DecodePrograms`` runs the eager loop over its prepared decoder: the
in-place refresh of a prepared decoder against a fresh
``WhisperDecoder.prepare_decode_params`` bit for bit, the entries preparing
the decoder once, weight updates reaching the next decode, tensor and list
prefixes, and the graph keys. Tiny configurations from a seed; the card's
side (graphs against the eager loop) is in ``tests/test_torch_kernels_cuda.py``.
The entries' parity with the JAX package is held by
``tests/test_torch_av_whisper.py``, ``test_torch_asr.py`` and
``test_torch_serving.py``, which now decode through these programs."""

import copy

import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode.beam import beam_search
from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode
from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules
from mocov2_whisper_flamingo_torch.decode.programs import DecodePrograms, program_key
from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.models import whisper
from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_asr_params, random_jax_params)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig, WhisperDecoder

VOCAB, EOS = 96, 20  # EOS: a token the random decoder emits mid-sequence
PREFIX = [1, 2]
TINY = dict(n_mels=80, d_model=64, encoder_layers=1, decoder_layers=2, n_heads=2, d_ff=128,
            vocab_size=VOCAB, max_source_positions=16, max_target_positions=24)
N_SAMPLES = 32 * 160  # 32 mel frames = 2 * max_source_positions
MAX_LEN = 12


def _lively(tree_decoder: dict, rng) -> None:
    """Position embeddings larger than the token embeddings keep a random
    decoder from copying its input token: it emits varied tokens and EOS."""
    tree_decoder["pos_embed"] = 4.0 * rng.standard_normal(
        tree_decoder["pos_embed"].shape).astype(np.float32)
    tree_decoder["embed_tokens"]["embedding"] *= np.float32(0.5)


def _tree(asr, seed: int) -> dict:
    tree = random_asr_params(asr, seed=seed)
    _lively(tree["decoder"], np.random.default_rng(seed + 100))
    return tree


def _asr(seed: int = 0, precision=L.FP32) -> WhisperASR:
    asr = WhisperASR(config=WhisperConfig(**TINY), precision=precision, device="cpu")
    return load_jax_params(asr, _tree(asr, seed))


@pytest.fixture(scope="module")
def wavs():
    return (0.1 * np.random.default_rng(3).standard_normal((3, N_SAMPLES))).astype(np.float32)


def _decode(asr, wavs, beam_size: int, **kw) -> np.ndarray:
    return asr.transcribe_tokens(wavs, PREFIX, beam_size=beam_size, max_len=MAX_LEN,
                                 eos_id=EOS, pad_to=N_SAMPLES, **kw).numpy()


def _params(module) -> dict:
    return dict(module.named_parameters(remove_duplicate=False))


@pytest.mark.parametrize("precision,weight_quant", [(L.FP32, None), (L.BF16, None),
                                                    (L.FP32, "int8"), (L.BF16, "int8")],
                         ids=["fp32", "bf16", "fp32-w8", "bf16-w8"])
def test_refresh_equals_a_fresh_prepare_bit_for_bit(precision, weight_quant):
    """After an in-place change of every source weight, the refreshed
    decoder holds a fresh ``prepare_decode_params``'s values, dtypes and
    vocab table, in the tensors it had (nothing reallocated)."""
    dec = _asr(precision=precision).decoder
    prepared = dec.prepare_decode_params(weight_quant)
    before = {n: p.data_ptr() for n, p in _params(prepared).items()}
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in dec.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    assert dec.refresh_decode_params(prepared) is prepared
    fresh = dec.prepare_decode_params(weight_quant)
    got, want = _params(prepared), _params(fresh)
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].data_ptr() == before[name], name
        assert got[name].dtype == want[name].dtype, name
        assert torch.equal(got[name], want[name]), name
    if weight_quant is None:
        assert torch.equal(prepared.vocab_table, fresh.vocab_table)
    else:
        assert prepared.vocab_table is None and fresh.vocab_table is None


@pytest.fixture(scope="module")
def av_net():
    cfg = WhisperConfig(**TINY)
    net = AVWhisperNet(modelargs=(32, 4, 1, 3000, 64, 0.0), vocab_size=VOCAB, device="cpu",
                       whisper_config=cfg)
    tree = random_jax_params(net, seed=5)
    _lively(tree["decoder"], np.random.default_rng(6))
    load_jax_params(net, tree)
    rng = np.random.default_rng(7)
    b, tv = 2, 4
    batch = (torch.from_numpy(rng.standard_normal((b, 80, 32)).astype(np.float32)),
             torch.ones((b, 32), dtype=torch.bool),
             torch.from_numpy(rng.standard_normal((b, tv, 3, 32, 32)).astype(np.float32)),
             torch.ones((b, tv), dtype=torch.bool), torch.tensor([4, 3], dtype=torch.int32))
    return net, batch


@pytest.mark.parametrize("entry", ["beam", "greedy", "transcribe_tokens"])
def test_a_second_call_prepares_nothing_anew(entry, av_net, wavs, monkeypatch):
    if entry == "transcribe_tokens":
        owner = _asr()
        call = lambda: _decode(owner, wavs, beam_size=3, weight_quant="int8")
    else:
        owner, batch = av_net
        kw = dict(max_len=MAX_LEN, eos_id=EOS, cache_quant="int8")
        call = ((lambda: owner.beam(batch, PREFIX, beam_size=3, **kw).sequences)
                if entry == "beam" else lambda: owner.greedy(batch, PREFIX, **kw))
    owner.decode_programs = DecodePrograms(owner.decoder)  # nothing prepared yet
    counts = {"prepare": 0, "deepcopy": 0}
    prepare, deepcopy = WhisperDecoder.prepare_decode_params, copy.deepcopy

    def counting_prepare(self, *args, **kwargs):
        counts["prepare"] += 1
        return prepare(self, *args, **kwargs)

    def counting_deepcopy(*args, **kwargs):
        counts["deepcopy"] += 1
        return deepcopy(*args, **kwargs)

    monkeypatch.setattr(WhisperDecoder, "prepare_decode_params", counting_prepare)
    monkeypatch.setattr(whisper.copy, "deepcopy", counting_deepcopy)
    first = call()
    made = dict(counts)
    assert made["prepare"] == 1 and made["deepcopy"] >= 1
    second = call()
    assert counts == made  # the second call prepared and copied nothing
    assert torch.equal(torch.as_tensor(first), torch.as_tensor(second))
    assert owner.decode_programs.programs == {} and owner.decode_programs.pool is None


def _perturb_in_place(asr):
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # as an optimizer step writes
        for p in asr.decoder.parameters():
            p.add_(0.5 * torch.randn(p.shape, generator=gen))


def _replace_by_assignment(asr):
    gen = torch.Generator().manual_seed(1)
    for p in asr.decoder.parameters():
        p.data = p.data + 0.5 * torch.randn(p.shape, generator=gen)


@pytest.mark.parametrize("beam_size", [1, 3], ids=["greedy", "beam"])
@pytest.mark.parametrize("update", ["in_place", "assignment", "load_jax_params"])
def test_a_weight_update_reaches_the_next_decode(update, beam_size, wavs):
    """The next decode after an update equals a freshly built net's on the
    updated weights, and differs from the decode before it."""
    asr = _asr(seed=0)
    before = _decode(asr, wavs, beam_size)
    fresh = _asr(seed=0)
    if update == "load_jax_params":
        load_jax_params(asr, _tree(asr, seed=1))
        fresh = _asr(seed=1)
    else:
        change = _perturb_in_place if update == "in_place" else _replace_by_assignment
        change(asr)
        change(fresh)
    after = _decode(asr, wavs, beam_size)
    np.testing.assert_array_equal(after, _decode(fresh, wavs, beam_size))
    assert not np.array_equal(after, before)


@pytest.mark.parametrize("loop", ["beam", "greedy"])
def test_a_tensor_prefix_decodes_as_the_list(loop, av_net):
    net, batch = av_net
    feats, valid = net.encode(batch)
    dec = net.decoder.prepare_decode_params()
    kw = dict(max_len=MAX_LEN, eos_id=EOS, encoder_valid=valid)
    as_tensor = torch.tensor(PREFIX, dtype=torch.long)
    if loop == "beam":
        a = beam_search(dec, feats, PREFIX, beam_size=3, **kw)
        b = beam_search(dec, feats, as_tensor, beam_size=3, **kw)
        c = net.decode_programs.beam(feats, valid, as_tensor, beam_size=3, max_len=MAX_LEN,
                                     eos_id=EOS)
        for got in (b, c):
            assert torch.equal(got.sequences, a.sequences) and torch.equal(got.scores, a.scores)
    else:
        a = greedy_decode(dec, feats, PREFIX, **kw)
        assert torch.equal(greedy_decode(dec, feats, as_tensor, **kw), a)
        assert torch.equal(net.decode_programs.greedy(feats, valid, as_tensor, MAX_LEN, EOS), a)


BEAM_STATIC = dict(beam_size=5, max_len=32, eos_id=EOS, length_penalty=1.0,
                   early_stopping=False, renorm_after_rules=False, cache_quant=None)
RULES = LogitRules(vocab_size=VOCAB, suppress=(3,))


def _key_args():
    feats = torch.zeros((4, 10, TINY["d_model"]))
    return dict(loop="beam", features=feats, valid=torch.ones((4, 10), dtype=torch.bool),
                n_prefix=2, logit_rules=RULES, weight_quant=None), dict(BEAM_STATIC)


KEY_CHANGES = {
    "loop": lambda a, s: a.update(loop="greedy"),
    "rows": lambda a, s: a.update(features=torch.zeros((2, 10, TINY["d_model"]))),
    "t_enc": lambda a, s: a.update(features=torch.zeros((4, 12, TINY["d_model"]))),
    "dtype": lambda a, s: a.update(features=a["features"].bfloat16()),
    "device": lambda a, s: a.update(features=a["features"].to("meta")),
    "valid_given": lambda a, s: a.update(valid=None),
    "beam_size": lambda a, s: s.update(beam_size=3),
    "max_len": lambda a, s: s.update(max_len=33),
    "prefix_length": lambda a, s: a.update(n_prefix=3),
    "eos_id": lambda a, s: s.update(eos_id=EOS + 1),
    "length_penalty": lambda a, s: s.update(length_penalty=0.6),
    "early_stopping": lambda a, s: s.update(early_stopping=True),
    "renorm_after_rules": lambda a, s: s.update(renorm_after_rules=True),
    "logit_rules": lambda a, s: a.update(logit_rules=LogitRules(vocab_size=VOCAB)),
    "cache_quant": lambda a, s: s.update(cache_quant="int8"),
    "weight_quant": lambda a, s: a.update(weight_quant="int8"),
}


@pytest.mark.parametrize("field", sorted(KEY_CHANGES) + ["parameter_address"])
def test_keys_differ_in_each_field(field):
    dec = _asr().decoder
    args, static = _key_args()
    base = program_key(decoder=dec, **args, **static)
    assert program_key(decoder=dec, **args, **static) == base
    if field == "parameter_address":
        dec.layers[0].mlp.fc1.kernel.data = dec.layers[0].mlp.fc1.kernel.data.clone()
    else:
        KEY_CHANGES[field](args, static)
    assert program_key(decoder=dec, **args, **static) != base


def test_an_in_place_update_keeps_the_key():
    dec = _asr().decoder
    args, static = _key_args()
    base = program_key(decoder=dec, **args, **static)
    with torch.no_grad():
        for p in dec.parameters():
            p.mul_(2.0)
    assert program_key(decoder=dec, **args, **static) == base


def test_programs_on_the_cpu_reject_an_unknown_layout_and_quant(av_net):
    net, batch = av_net
    feats, valid = net.encode(batch)
    programs = DecodePrograms(net.decoder)
    with pytest.raises(ValueError, match="cache_layout"):
        programs.beam(feats, valid, PREFIX, cache_layout="columns")
    with pytest.raises(ValueError, match="weight_quant"):
        programs.greedy(feats, valid, PREFIX, weight_quant="int4")
