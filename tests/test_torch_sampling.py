"""The port's sampler and quality-gated fallback (``decode/sampling.py``)
against the JAX package's on the CPU, fp32, at the tiny configuration of
tests/test_sampling.py, on the same weights through the bridge.

The port takes its sampler's noise from a draw source; ``JaxDraws``
(tests/longform_helpers.py) hands it JAX's own Gumbel draws along the JAX fold
chain, so the tokens must be equal (tolerance 0).
Tolerances: summed and average logprobs ``LOGPROB_ATOL`` (fp32 sums of a
dozen log-softmax values from two frameworks), the no-speech probability
``PROB_ATOL``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.decode import sampling as T
from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules as TRules
from mocov2_whisper_flamingo_torch.models.convert import load_jax_params
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.models.whisper import WhisperDecoder as TDecoder
from mocov2_whisper_flamingo_tpu.decode import sampling as J
from mocov2_whisper_flamingo_tpu.decode.logit_rules import LogitRules as JRules
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder

from longform_helpers import JaxDraws, lively

CFG = dict(n_mels=80, d_model=48, encoder_layers=1, decoder_layers=2, n_heads=4, d_ff=96,
           vocab_size=50, max_source_positions=16, max_target_positions=32)
EOS = 3
PREFIX = [1, 2]
MAX_LEN = 12
RULES = dict(vocab_size=50, suppress=(5, 9, 33), begin_suppress=(EOS, 7), eos_id=EOS)
LOGPROB_ATOL = 1e-5
PROB_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    jdec = JDecoder(JConfig(**CFG))
    tree = jax.tree.map(lambda x: np.array(x, np.float32), jdec.init(jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    lively(tree, rng)
    tdec = load_jax_params(TDecoder(TConfig(**CFG), device="cpu"), tree).prepare_decode_params()
    enc = rng.standard_normal((2, 16, 48)).astype(np.float32)
    return jdec, jax.tree.map(jnp.asarray, tree), tdec, enc


@pytest.mark.parametrize("rules", [False, True], ids=["no_rules", "rules"])
@pytest.mark.parametrize("temperature", [0.7, 4.0])
def test_sample_decode_matches_jax_with_jax_draws(setup, temperature, rules):
    jdec, params, tdec, enc = setup
    key = jax.random.PRNGKey(5)
    kw = dict(temperature=temperature, num_samples=3, max_len=MAX_LEN, eos_id=EOS)
    want = J.sample_decode(jdec, params, jnp.asarray(enc), PREFIX, key=key,
                           logit_rules=JRules(**RULES) if rules else None, **kw)
    got = T.sample_decode(tdec, torch.from_numpy(enc), PREFIX, draws=JaxDraws(key),
                          logit_rules=TRules(**RULES) if rules else None, **kw)
    seqs = got.sequences.numpy()
    np.testing.assert_array_equal(seqs, np.asarray(want.sequences))
    np.testing.assert_allclose(got.sum_logprob.numpy(), np.asarray(want.sum_logprob),
                               atol=LOGPROB_ATOL, rtol=0)
    np.testing.assert_allclose(got.avg_logprob.numpy(), np.asarray(want.avg_logprob),
                               atol=LOGPROB_ATOL, rtol=0)
    assert len({tuple(row) for row in seqs.reshape(-1, MAX_LEN)}) > 1  # the draws matter
    if rules:
        assert not np.isin(seqs[..., len(PREFIX):], RULES["suppress"]).any()


def test_sample_decode_t0_is_greedy_and_default_draws_are_seeded(setup):
    _, _, tdec, enc = setup
    from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode

    enc = torch.from_numpy(enc)
    greedy = greedy_decode(tdec, enc, PREFIX, MAX_LEN, EOS)
    r = T.sample_decode(tdec, enc, PREFIX, temperature=0.0, num_samples=2, max_len=MAX_LEN,
                        eos_id=EOS)
    assert torch.equal(r.sequences[:, 0], greedy) and torch.equal(r.sequences[:, 1], greedy)
    kw = dict(temperature=4.0, num_samples=3, max_len=MAX_LEN, eos_id=EOS)
    a = T.sample_decode(tdec, enc, PREFIX, seed=1, **kw).sequences
    assert torch.equal(a, T.sample_decode(tdec, enc, PREFIX, seed=1, **kw).sequences)
    assert not torch.equal(a, T.sample_decode(tdec, enc, PREFIX, seed=2, **kw).sequences)
    # noise made on the CPU for another device is the same noise
    on_cpu = T.GumbelDraws(1, generate_on="cpu")
    assert torch.equal(T.sample_decode(tdec, enc, PREFIX, draws=on_cpu, **kw).sequences, a)


def test_gumbel_draws_fold_and_distribution():
    d = T.GumbelDraws(3)
    g = d.fold(7).gumbel((400, 500), "cpu")
    assert g.dtype == torch.float32 and torch.isfinite(g).all()
    assert torch.equal(g, T.GumbelDraws(3).fold(7).gumbel((400, 500), "cpu"))
    assert not torch.equal(g, d.fold(8).gumbel((400, 500), "cpu"))
    assert not torch.equal(g, T.GumbelDraws(4).fold(7).gumbel((400, 500), "cpu"))
    # standard Gumbel: mean = Euler's constant, variance = pi^2 / 6
    assert abs(g.mean().item() - 0.5772) < 0.01 and abs(g.var().item() - 1.6449) < 0.03


@pytest.mark.parametrize("sot_index", [0, 1])
def test_no_speech_probability_matches_jax(setup, sot_index):
    jdec, params, tdec, enc = setup
    want = J.no_speech_probability(jdec, params, jnp.asarray(enc), PREFIX, 7,
                                   sot_index=sot_index)
    got = T.no_speech_probability(tdec, torch.from_numpy(enc), PREFIX, 7, sot_index=sot_index)
    assert got.shape == (2,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=PROB_ATOL, rtol=0)


GATE_TEXTS = {
    "empty": "",
    "ordinary": "a perfectly ordinary sentence with varied content and words",
    "looped": "the same words " * 50,
    "vietnamese": "xin chào các bạn, hôm nay trời đẹp quá",
    "bytes": bytes(range(40)) * 3,
}
GATE_CASES = [  # (avg_logprob, thresholds, no-speech probe and threshold)
    (-0.1, -1.0, 2.4, None, None),
    (-2.0, -1.0, 2.4, None, None),
    (-9.0, None, None, None, None),
    (-9.0, -1.0, 2.4, 0.9, 0.6),
    (-9.0, -1.0, 2.4, 0.3, 0.6),
    (-9.0, -1.0, 2.4, 0.9, None),
    (-0.5, -1.0, 1.2, None, None),
]


@pytest.mark.parametrize("name", GATE_TEXTS)
def test_compression_ratio_and_gates_match_jax(name):
    text = GATE_TEXTS[name]
    assert T.compression_ratio(text) == J.compression_ratio(text)
    for avg, lp, cr, ns, ns_thr in GATE_CASES:
        args = (avg, text, lp, cr)
        kw = dict(no_speech_prob=ns, no_speech_threshold=ns_thr)
        assert T.needs_fallback(*args, **kw) == J.needs_fallback(*args, **kw), (avg, lp, cr, ns)


FALLBACKS = {
    # logprobs are <= 0, so a threshold of 10 is never met: the whole ladder
    "whole_ladder": dict(temperatures=(0.0, 0.5, 4.0), logprob_threshold=10.0),
    "gates_disabled": dict(logprob_threshold=None, compression_ratio_threshold=None),
    # the silence override accepts the first rung although the gate fails
    "no_speech_override": dict(temperatures=(0.0, 0.5, 4.0), logprob_threshold=10.0,
                               no_speech_id=5, no_speech_threshold=-1.0),
}


@pytest.mark.parametrize("name", FALLBACKS)
def test_decode_with_fallback_matches_jax(setup, name):
    jdec, params, tdec, enc = setup
    key = jax.random.PRNGKey(9)
    kw = dict(beam_size=2, best_of=3, max_len=MAX_LEN, eos_id=EOS, **FALLBACKS[name])
    want = J.decode_with_fallback(jdec, params, jnp.asarray(enc), PREFIX, key=key, **kw)
    got = T.decode_with_fallback(tdec, torch.from_numpy(enc), PREFIX, draws=JaxDraws(key), **kw)
    np.testing.assert_array_equal(got.sequences, want.sequences)
    np.testing.assert_array_equal(got.temperature, want.temperature)
    np.testing.assert_array_equal(got.gates_passed, want.gates_passed)
    np.testing.assert_array_equal(got.compression_ratio, want.compression_ratio)
    np.testing.assert_allclose(got.avg_logprob, want.avg_logprob, atol=LOGPROB_ATOL, rtol=0)
    if want.no_speech_prob is None:
        assert got.no_speech_prob is None
    else:
        np.testing.assert_allclose(got.no_speech_prob, want.no_speech_prob, atol=PROB_ATOL,
                                   rtol=0)
    assert got.gates_passed.all() == (name != "whole_ladder")
    if name == "whole_ladder":
        assert (got.temperature == 4.0).all()
    else:
        assert (got.temperature == 0.0).all()


def test_fallback_rejects_empty_temperatures(setup):
    _, _, tdec, enc = setup
    with pytest.raises(ValueError, match="non-empty"):
        T.decode_with_fallback(tdec, torch.from_numpy(enc), PREFIX, temperatures=())
