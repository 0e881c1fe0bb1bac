"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
Skipped on hosts without a CUDA card.
"""

import pytest
import torch

from mocov2_whisper_flamingo_torch.ops import flash_attention as fa
from mocov2_whisper_flamingo_torch.ops import losses as TL


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("shape,lens,causal", [
    ((2, 130, 70, 3, 64), (70, 1), False),
    ((2, 13, 27, 2, 32), None, True),
    ((1, 100, 130, 2, 128), (0,), True),
])
def test_cuda_kernel_matches_plain(shape, lens, causal, dtype, atol):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((b, t, h, d), generator=gen).to("cuda", dtype) for t in (tq, tk, tk))
    mask = None if lens is None else (
        torch.arange(tk)[None, :] < torch.tensor(lens)[:, None]).cuda()
    before = fa.launches
    out = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= atol


def _cuda_qkv(shape, dtype, strided=False, seed=0):
    b, tq, tk, h, d = shape
    gen = torch.Generator().manual_seed(seed)
    if strided:  # chunks of one [B, T, 3*H*Dh] projection, as the encoder passes them
        proj = torch.randn((b, tq, 3 * h * d), generator=gen).to("cuda", dtype)
        return tuple(x.view(b, tq, h, d) for x in proj.chunk(3, dim=-1))
    return tuple(torch.randn((b, t, h, d), generator=gen).to("cuda", dtype) for t in (tq, tk, tk))


def _cuda_mask(lens, tk):
    return None if lens is None else (torch.arange(tk)[None, :] < torch.tensor(lens)[:, None]).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("name,shape,lens,causal,strided", [
    ("encoder", (4, 1500, 1500, 12, 64), None, False, False),
    ("fusion", (4, 400, 400, 8, 64), (400, 317, 64, 1), False, False),
    ("encoder_strided", (2, 1500, 1500, 12, 64), None, False, True),
    ("single_tile", (2, 100, 100, 3, 64), None, False, False),
    ("tail_27", (2, 27, 27, 2, 64), (27, 3), False, False),
    ("tail_130", (2, 130, 130, 4, 64), None, False, False),
    ("tail_130_strided", (2, 130, 130, 4, 64), None, False, True),
    ("causal_13x27", (2, 13, 27, 2, 64), None, True, False),
    ("causal_130x400", (2, 130, 400, 2, 64), (400, 300), True, False),
    ("causal_400x130", (2, 400, 130, 2, 64), None, True, False),
    ("dh32", (2, 130, 400, 2, 32), (400, 7), False, False),
    ("dh128", (2, 400, 130, 2, 128), (130, 1), False, False),
    ("dh128_causal", (2, 130, 400, 2, 128), None, True, False),
    # the request server: the encoder at buckets 1, 2 and 16, the fusion at
    # bucket 1, the teacher-forced decoder's causal and cross attentions
    ("encoder_b1", (1, 1500, 1500, 12, 64), None, False, False),
    ("encoder_b2", (2, 1500, 1500, 12, 64), None, False, False),
    ("encoder_b16", (16, 1500, 1500, 12, 64), None, False, False),
    ("fusion_b1", (1, 400, 400, 8, 64), (317,), False, False),
    ("forced_causal", (4, 160, 160, 12, 64), None, True, True),
    ("forced_cross_audio", (4, 160, 1500, 12, 64), None, False, False),
    ("forced_cross_av", (4, 160, 400, 12, 64), (400, 317, 64, 1), False, False),
    # the continuous engine's admission buckets 2, 8 and 16 that no other
    # path reaches
    ("encoder_b8", (8, 1500, 1500, 12, 64), None, False, False),
    ("fusion_b2", (2, 400, 400, 8, 64), (400, 64), False, False),
    ("fusion_b8", (8, 400, 400, 8, 64), (400, 317, 64, 1, 400, 399, 200, 2), False, False),
    ("fusion_b16", (16, 400, 400, 8, 64), (400, 317, 64, 1) * 4, False, False),
    # the word-time alignment forward's causal self-attention at its token
    # buckets (chunks of the fused QKV projection)
    ("align_causal_32", (1, 32, 32, 12, 64), None, True, True),
    ("align_causal_64", (1, 64, 64, 12, 64), None, True, True),
    ("align_causal_128", (1, 128, 128, 12, 64), None, True, True),
    ("align_causal_256", (1, 256, 256, 12, 64), None, True, True),
    ("align_causal_448", (1, 448, 448, 12, 64), None, True, True),
    # a rank's heads under tensor parallelism at model=2: the encoder's 6 (B=4,
    # and B=2 a data index on a 2 x 2 mesh) and the fusion's 4
    ("encoder_tp2", (4, 1500, 1500, 6, 64), None, False, False),
    ("encoder_tp2_dp2", (2, 1500, 1500, 6, 64), None, False, False),
    ("fusion_tp2", (4, 400, 400, 4, 64), (400, 317, 64, 1), False, False),
    # the model tools: the export check's encoder at B=3, the fusion at
    # verify_model's and the export's (B, frames), every frame valid
    ("encoder_b3", (3, 1500, 1500, 12, 64), None, False, False),
    ("fusion_tools_b2_t16", (2, 16, 16, 8, 64), (16, 16), False, False),
    ("fusion_tools_b1_t8", (1, 8, 8, 8, 64), (8,), False, False),
    ("fusion_tools_b2_t12", (2, 12, 12, 8, 64), (12, 12), False, False),
    ("fusion_tools_b4_t10", (4, 10, 10, 8, 64), (10,) * 4, False, False),
    ("fusion_tools_b3_t16", (3, 16, 16, 8, 64), (16,) * 3, False, False),
])
def test_bf16_kernel_matches_plain_at_serving_and_edge_shapes(name, shape, lens, causal, strided):
    """bf16 K1 on its route (Hopper kernel at Dh 64/128, mma.sync at Dh 32)
    against the plain version: serving shapes, key and query tails that are
    no multiple of the 128-key tile, a single tile, strided views, causal
    with Tq != Tk, every head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    q, k, v = _cuda_qkv(shape, torch.bfloat16, strided)
    mask = _cuda_mask(lens, tk)
    before = fa.launches
    out = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
    torch.cuda.synchronize()
    assert fa.launches == before + 1
    assert out.dtype == torch.bfloat16 and out.shape == q.shape and out.is_contiguous()
    ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("consumers", [2, 3])
@pytest.mark.parametrize("shape,lens,causal,strided", [
    ((2, 400, 400, 8, 64), (400, 0), False, False),
    ((2, 130, 130, 4, 64), None, False, True),
    ((2, 130, 400, 2, 64), (400, 300), True, False),
    ((2, 400, 130, 2, 64), None, True, False),
    ((1, 27, 27, 2, 64), (27,), False, False),
])
def test_bf16_hopper_kernel_matches_plain_with_each_block_size(consumers, shape, lens, causal,
                                                                strided):
    """Dh 64 takes 2 or 3 consumer warpgroups per block by shape; both are
    held against the plain version, masks and causal offsets included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    q, k, v = _cuda_qkv(shape, torch.bfloat16, strided)
    mask = _cuda_mask(lens, tk)
    out = fa._launch(q, k, v, fa._mask_bytes(mask, b, tk, q.device), d ** -0.5, causal,
                     consumers=consumers)
    torch.cuda.synchronize()
    ref = fa.plain_flash_attention(q, k, v, kv_valid=mask, causal=causal)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2
    for i, n in enumerate(lens or ()):
        if n == 0:
            assert bool((out[i] == 0).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 128])
def test_bf16_row_without_valid_key_is_exact_zero(d):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _cuda_qkv((3, 200, 300, 2, d), torch.bfloat16)
    out = fa.flash_attention(q, k, v, kv_valid=_cuda_mask((300, 0, 129), 300))
    torch.cuda.synchronize()
    assert bool((out[1] == 0).all())
    assert bool(out[0].abs().sum() > 0) and bool(out[2].abs().sum() > 0)


@pytest.mark.cuda
def test_causal_rows_before_the_first_key_are_zero():
    """Tq > Tk with causal offset Tk - Tq < 0: the first Tq - Tk rows see no
    key and return 0, on the Hopper kernel as in the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _cuda_qkv((2, 300, 100, 2, 64), torch.bfloat16)
    out = fa.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert bool((out[:, :200] == 0).all())
    ref = fa.plain_flash_attention(q, k, v, causal=True)
    assert (out.float() - ref.float()).abs().max().item() <= 2e-2


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 3e-2)])
@pytest.mark.parametrize("shape,lens,causal", [
    ((4, 400, 400, 8, 64), (400, 317, 64, 1), False),
    ((2, 130, 400, 2, 64), (400, 300), True),
    ((2, 70, 90, 3, 32), None, False),
])
def test_autograd_wrapper_on_the_card(shape, lens, causal, dtype, tol):
    """Through the autograd wrapper the forward is the kernel's, bit for
    bit, one launch; dq, dk, dv (recompute in torch ops, from a
    non-contiguous cotangent) agree with autograd through the plain version
    within ``tol`` of the largest reference gradient (or of 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, tq, tk, h, d = shape
    q, k, v = _cuda_qkv(shape, dtype)
    mask = _cuda_mask(lens, tk)
    cot = torch.randn((b, h, tq, d), generator=torch.Generator().manual_seed(1)).to("cuda", dtype)
    direct = fa.flash_attention(q, k, v, kv_valid=mask, causal=causal)
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    before = fa.launches
    out = fa.flash_attention(*leaves, kv_valid=mask, causal=causal)
    assert fa.launches == before + 1 and torch.equal(out, direct)
    grads = torch.autograd.grad(out.transpose(1, 2), leaves, cot)
    assert fa.launches == before + 1  # the backward launches no kernel of the port
    ref_leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    ref = fa.plain_flash_attention(*ref_leaves, kv_valid=mask, causal=causal)
    for g, r in zip(grads, torch.autograd.grad(ref, ref_leaves, cot.transpose(1, 2))):
        assert g.dtype == dtype
        scale = max(1.0, r.float().abs().max().item())
        assert (g.float() - r.float()).abs().max().item() <= tol * scale


@pytest.mark.cuda
def test_cuda_call_without_a_gradient_builds_no_graph():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    q, k, v = _cuda_qkv((2, 130, 130, 4, 64), torch.bfloat16)
    assert fa.flash_attention(q, k, v).grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert fa.flash_attention(q, k, v).grad_fn is None
    assert fa.flash_attention(q, k, v).grad_fn is not None


# -- the request server on the card ---------------------------------------------------


def _tiny_asr(device, precision, seed=0):
    import numpy as np

    from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_asr_params
    from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig

    cfg = WhisperConfig(n_mels=80, d_model=128, encoder_layers=2, decoder_layers=2, n_heads=2,
                        d_ff=256, vocab_size=96, max_source_positions=50,
                        max_target_positions=32)
    asr = WhisperASR(config=cfg, precision=precision, device=device)
    tree = random_asr_params(asr, seed)
    rng = np.random.default_rng(seed)
    tree["decoder"]["pos_embed"] = 4.0 * rng.standard_normal(
        tree["decoder"]["pos_embed"].shape).astype(np.float32)
    return load_jax_params(asr, tree).eval()


@pytest.mark.cuda
def test_log_mel_on_the_card_matches_the_cpu_and_refuses_tf32():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.ops import mel

    wav = 0.1 * torch.randn((2, 48_000), generator=torch.Generator().manual_seed(0))
    for method in ("matmul", "fft"):
        card = mel.whisper_log_mel(wav.cuda(), pad_to=64_000, method=method).cpu()
        assert (card - mel.whisper_log_mel(wav, pad_to=64_000, method=method)).abs().max() <= 2e-4
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            mel.whisper_log_mel(wav.cuda())
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


@pytest.mark.cuda
def test_teacher_forced_decoder_on_the_card_launches_causal_and_cross_kernels():
    """fp32, tiny: the card's logits (K1's causal and masked cross
    instantiations) against the CPU's (the plain version)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.models import layers as L

    gen = torch.Generator().manual_seed(1)
    enc = torch.randn((3, 50, 128), generator=gen)
    tokens = torch.randint(0, 96, (3, 20), generator=gen)
    valid = torch.arange(50)[None, :] < torch.tensor([50, 31, 1])[:, None]
    outs = {}
    for device in ("cuda", "cpu"):
        dec = _tiny_asr(device, L.FP32).decoder
        fa.reset_launches()
        with torch.no_grad():
            outs[device] = dec(tokens.to(device), enc.to(device), valid.to(device)).cpu()
        if device == "cuda":
            assert dict(fa.launches_by_kernel) == {"fma_f32<64, 0, false, true>": 2,
                                                   "fma_f32<64, 0, true, false>": 2}
    assert (outs["cuda"] - outs["cpu"]).abs().max() <= 1e-3 * outs["cpu"].abs().max()


@pytest.mark.cuda
def test_long_form_quality_transcription_on_the_card_matches_the_cpu():
    """fp32, tiny, 1 s windows: ``WhisperASR.transcribe`` in quality mode with
    a sampled rung (one noise, made on the CPU) and word times gives the
    same tokens, segments and words on the card as on the CPU; the
    alignment forward launches K1's causal kernel once per decoder layer."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from mocov2_whisper_flamingo_torch.decode.sampling import GumbelDraws
    from mocov2_whisper_flamingo_torch.models import layers as L

    audio = 0.1 * np.random.default_rng(2).standard_normal(40_000).astype(np.float32)
    got = {}
    for device in ("cuda", "cpu"):
        fa.reset_launches()
        got[device] = _tiny_asr(device, L.FP32).transcribe(
            audio, [1, 2], beam_size=2, best_of=2, max_len=16, eos_id=3, chunk_seconds=1.0,
            temperatures=(0.0, 0.6), logprob_threshold=10.0, word_times=True,
            group_fn=lambda ids: [(f" {t}", 1) for t in ids],
            draws=GumbelDraws(0, generate_on="cpu"))
        if device == "cuda":
            windows = len(got["cuda"]["segments"])
            assert windows == 3
            assert fa.launches_by_kernel["fma_f32<64, 0, false, true>"] == 2 * windows
    card, cpu = got["cuda"], got["cpu"]
    assert card["tokens"] == cpu["tokens"]
    for a, b in zip(card["segments"], cpu["segments"]):
        assert a["tokens"] == b["tokens"] and a["temperature"] == b["temperature"] == 0.6
        assert abs(a["avg_logprob"] - b["avg_logprob"]) <= 1e-4
    assert [(w.word, w.start, w.end) for w in card["words"]] == \
        [(w.word, w.start, w.end) for w in cpu["words"]]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_audio_engine_round_trip_on_the_card(precision):
    """The engine on the card: warm-up on the engine's stream, co-batched
    requests whose rows equal a direct decode of the same padded bucket,
    rows handed over as CUDA tensors, and K1 launched by every batch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.serving import (
        canonical_wav, make_audio_engine, pad_rows, trim_at_eos)

    asr = _tiny_asr("cuda", L.BF16 if precision == "bf16" else L.FP32)
    seconds, prefix, eos = 1.0, [1, 2], 3
    rng = np.random.default_rng(0)
    wavs = [canonical_wav(0.1 * rng.standard_normal(12_000 + 1000 * i), seconds=seconds)
            for i in range(3)]
    kw = dict(beam_size=3, max_len=12, eos_id=eos)

    def direct(rows, bucket):
        (wav,) = pad_rows([(w,) for w in rows], bucket)
        toks = asr.transcribe_tokens(wav, prefix, pad_to=16_000, **kw).cpu().numpy()
        return [trim_at_eos(t, eos, len(prefix)) for t in toks[:len(rows)]]

    with make_audio_engine(asr, prefix, seconds=seconds, buckets=(1, 4), max_wait_s=0.3,
                           **kw) as eng:
        assert eng.device.type == "cuda"
        eng.warmup((wavs[0],))
        reserved = torch.cuda.memory_reserved()
        fa.reset_launches()
        results = [f.result(timeout=120) for f in [eng.submit(w) for w in wavs]]
        assert fa.launches == 2  # one batch, two encoder layers
        # warm-up and traffic share the engine's stream and so its allocator pools
        assert torch.cuda.memory_reserved() <= reserved + 32 * 2**20
        for got, want in zip(results, direct(wavs, 4)):
            assert got.bucket == 4 and np.array_equal(got.tokens, want)
        on_card = eng.transcribe(torch.from_numpy(wavs[1]).cuda(), timeout=120)
        assert on_card.bucket == 1 and np.array_equal(on_card.tokens, direct(wavs[1:2], 1)[0])
        stats = eng.stats()
        log = list(eng.batch_log)
    assert stats["compiled_buckets"] == [1, 4] and stats["requests"] == 4
    assert all(entry["h2d_device_ms"] >= 0 for entry in log)


def _card_features(asr, b, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    t = asr.config.max_source_positions
    feats = torch.randn((b, t, asr.config.d_model), generator=gen, device="cuda")
    lens = torch.tensor([t, t - 7], device="cuda")[:b]
    valid = torch.arange(t, device="cuda")[None, :] < lens[:, None]
    return feats.to(asr.precision.compute_dtype), valid


PROGRAM_CASES = {
    "beam_rules": dict(loop="beam", rules=True),
    "beam_c8": dict(loop="beam", cache_quant="int8"),
    "beam_w8": dict(loop="beam", weight_quant="int8"),
    "greedy": dict(loop="greedy", rules=True),
}


def _eager_and_program(asr, case, feats, valid, rules):
    """(eager loop over a fresh prepared decoder, the program) on the
    caller's stream, as lists of CPU tensors."""
    from mocov2_whisper_flamingo_torch.decode.beam import beam_search
    from mocov2_whisper_flamingo_torch.decode.greedy import greedy_decode

    wq, cq = case.get("weight_quant"), case.get("cache_quant")
    prefix, kw = [1, 2], dict(max_len=12, eos_id=3, logit_rules=rules, cache_quant=cq)
    dec = asr.decoder.prepare_decode_params(wq)
    if case["loop"] == "beam":
        want = beam_search(dec, feats, prefix, beam_size=3, encoder_valid=valid, **kw)
        got = asr.decode_programs.beam(feats, valid, prefix, beam_size=3, weight_quant=wq, **kw)
        pairs = [(got.sequences, want.sequences), (got.scores, want.scores)]
    else:
        want = greedy_decode(dec, feats, prefix, encoder_valid=valid, **kw)
        pairs = [(asr.decode_programs.greedy(feats, valid, prefix, weight_quant=wq, **kw), want)]
    return [(g.cpu(), w.cpu()) for g, w in pairs]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(PROGRAM_CASES))
def test_decode_program_replays_the_eager_loop_bit_for_bit(case, precision):
    """A captured decode against the eager loop on the same stream: tokens
    and scores bit-equal, at its capture and at a replay on other inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules
    from mocov2_whisper_flamingo_torch.models import layers as L

    asr = _tiny_asr("cuda", L.BF16 if precision == "bf16" else L.FP32)
    cfg = PROGRAM_CASES[case]
    rules = LogitRules(vocab_size=96, suppress=(5, 7), begin_suppress=(3,),
                       timestamp_begin=80, no_timestamps_id=79, eos_id=3) \
        if cfg.get("rules") else None
    for seed in (0, 1):
        for got, want in _eager_and_program(asr, cfg, *_card_features(asr, 2, seed), rules):
            assert torch.equal(got, want), (case, seed)
    assert len(asr.decode_programs.captures) == 1  # the second input replayed
    assert asr.decode_programs.captures[0]["instantiate_s"] > 0


@pytest.mark.cuda
def test_decode_program_reads_updates_and_recaptures_a_replaced_parameter():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.models import layers as L

    asr = _tiny_asr("cuda", L.BF16)
    feats, valid = _card_features(asr, 2, 0)
    case = PROGRAM_CASES["beam_rules"]
    before = _eager_and_program(asr, case, feats, valid, None)
    with torch.no_grad():  # as an optimizer step writes
        asr.decoder.pos_embed.mul_(-1.0)
    after = _eager_and_program(asr, case, feats, valid, None)
    assert len(asr.decode_programs.captures) == 1
    assert all(torch.equal(g, w) for g, w in after)
    assert not torch.equal(after[0][0], before[0][0])
    asr.decoder.pos_embed.data = asr.decoder.pos_embed.data.clone()
    assert all(torch.equal(g, w) for g, w in _eager_and_program(asr, case, feats, valid, None))
    assert len(asr.decode_programs.captures) == 2 and len(asr.decode_programs.programs) == 1


@pytest.mark.cuda
def test_decode_program_capture_error_raises():
    """A loop that reads back to the host cannot be captured: the call
    raises, and the object decodes again afterwards."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.models import layers as L

    asr = _tiny_asr("cuda", L.FP32)
    feats, valid = _card_features(asr, 2, 0)

    def reads_back(logp, tokens, pos, begin_index):
        float(logp.max())
        return logp

    with pytest.raises(RuntimeError):
        asr.decode_programs.greedy(feats, valid, [1, 2], max_len=8, eos_id=3,
                                   logit_rules=reads_back)
    assert asr.decode_programs.programs == {}
    assert all(torch.equal(g, w) for g, w in
               _eager_and_program(asr, PROGRAM_CASES["greedy"], feats, valid, None))


@pytest.mark.cuda
def test_graph_pool_counts_a_capture_s_k1_launches_once_per_replay():
    """A graph whose eager run and capture both launch K1 twice: the counts
    take neither run's launches, and two at every replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.decode.programs import GraphPool

    q, k, v = _cuda_qkv((2, 130, 130, 2, 64), torch.bfloat16)
    mask = _cuda_mask((130, 17), 130)
    pool = GraphPool()
    fa.reset_launches()
    graph, out = pool.capture_graph(
        lambda: (fa.flash_attention(q, k, v), fa.flash_attention(q, k, v, kv_valid=mask)),
        torch.cuda.current_stream())
    torch.cuda.synchronize()
    assert fa.launches == 0 and not fa.launches_by_kernel
    assert pool.captures[0]["k1_launches"] == 2
    for n in (1, 2):
        pool.replay(graph)
        assert fa.launches == 2 * n and sum(fa.launches_by_kernel.values()) == 2 * n
    torch.cuda.synchronize()
    assert torch.equal(out[0], fa.flash_attention(q, k, v))
    assert torch.equal(out[1], fa.flash_attention(q, k, v, kv_valid=mask))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_encode_graph_replays_the_eager_encode_and_counts_k1_per_replay(precision):
    """``WhisperASR.encode`` (K1 in each of its 2 layers) against the eager
    encoder, bit for bit, at its capture and at a replay on another input;
    each call counts the 2 launches its replay sent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.models import layers as L

    asr = _tiny_asr("cuda", L.BF16 if precision == "bf16" else L.FP32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(2):
        mel = torch.randn((2, 80, 100), generator=gen, device="cuda")
        with torch.no_grad():
            want = asr.encoder(mel)
        fa.reset_launches()
        got = asr.encode(mel)
        torch.cuda.synchronize()
        assert fa.launches == 2 and torch.equal(got, want)
    assert len(asr.encode_program.captures) == 1 and asr.encode_program.replays == 2
    assert asr.encode_program.captures[0]["k1_launches"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_sample_and_probe_programs_replay_the_eager_functions(precision):
    """The sampler's graph against ``sample_decode`` with the same noise,
    captured at the first draw and replayed with another; the no-speech
    probe's graph against ``no_speech_probability``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.decode.sampling import (
        GumbelDraws, no_speech_probability, sample_decode)
    from mocov2_whisper_flamingo_torch.models import layers as L

    asr = _tiny_asr("cuda", L.BF16 if precision == "bf16" else L.FP32)
    dec = asr.decoder.prepare_decode_params()
    kw = dict(temperature=0.7, num_samples=3, max_len=12, eos_id=3)
    rows = []
    for seed in (0, 1):
        feats, valid = _card_features(asr, 2, seed)
        want = sample_decode(dec, feats, [1, 2], encoder_valid=valid, draws=GumbelDraws(seed),
                             **kw)
        got = asr.decode_programs.sample(feats, valid, [1, 2], draws=GumbelDraws(seed), **kw)
        for name in ("sequences", "sum_logprob", "avg_logprob"):
            assert torch.equal(getattr(got, name), getattr(want, name)), (name, seed)
        rows.append(got.sequences)
        prob = asr.decode_programs.no_speech(feats, valid, [1, 2], 5, sot_index=1)
        assert torch.equal(prob, no_speech_probability(dec, feats, [1, 2], 5, sot_index=1,
                                                       encoder_valid=valid))
    assert not torch.equal(rows[0], rows[1])
    assert [c["loop"] for c in asr.decode_programs.captures] == ["sample", "no_speech"]


@pytest.mark.cuda
def test_engine_warmup_captures_each_bucket_and_rows_equal_the_eager_loop():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from mocov2_whisper_flamingo_torch.decode.beam import beam_search
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.serving import (
        canonical_wav, make_audio_engine, pad_rows, trim_at_eos)

    asr = _tiny_asr("cuda", L.BF16)
    rng = np.random.default_rng(0)
    wavs = [canonical_wav(0.1 * rng.standard_normal(12_000 + 1000 * i), seconds=1.0)
            for i in range(3)]
    prefix, kw = [1, 2], dict(beam_size=3, max_len=12, eos_id=3)
    with make_audio_engine(asr, prefix, seconds=1.0, buckets=(1, 4), max_wait_s=0.3,
                           **kw) as eng:
        eng.warmup((wavs[0],))
        assert [c["shape"][0] for c in asr.decode_programs.captures] == [1, 4]
        results = [f.result(timeout=120) for f in [eng.submit(w) for w in wavs]]
        assert eng.stats()["compiled_buckets"] == [1, 4]
    assert len(asr.decode_programs.captures) == 2  # traffic replayed
    (wav,) = pad_rows([(w,) for w in wavs], 4)
    enc = asr.encode(asr.features(wav, pad_to=16_000))
    eager = beam_search(asr.decoder.prepare_decode_params(), enc, prefix, **kw)
    for i, got in enumerate(results):
        want = trim_at_eos(eager.sequences[i, 0].cpu().numpy(), 3, len(prefix))
        assert got.bucket == 4 and np.array_equal(got.tokens, want)


# -- the continuous segment and the streaming chunk as graphs ---------------------------


def _segment_pair(asr, capacity=3, beam=3, seg_steps=3, n_segments=4):
    """A ``SegmentProgram`` and the eager segment over two states with the
    same admissions (rows 0 and 2 now, row 1 at the next tick)."""
    from mocov2_whisper_flamingo_torch.serving import continuous

    dec = asr.decoder.prepare_decode_params()
    kw = dict(beam_size=beam, seg_steps=seg_steps, n_segments=n_segments, n_prefix=2, eos_id=3)
    feats, valid = _card_features(asr, 2, 0)
    states = []
    for _ in range(2):
        state = continuous.init_state(dec, capacity=capacity, beam_size=beam,
                                      seg_steps=seg_steps, n_segments=n_segments,
                                      enc_len=feats.shape[1], eos_id=3)
        continuous.make_admit_fn(dec, [1, 2], 3, beam, seg_steps * n_segments)(
            state, feats, valid, [0, 2])
        states.append(state)
    admit = continuous.make_admit_fn(dec, [1, 2], 3, beam, seg_steps * n_segments)
    return (continuous.SegmentProgram(dec, **kw), continuous.make_segment_fn(dec, **kw),
            states, admit, feats, valid)


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_segment_graph_replays_the_eager_segment_bit_for_bit(precision):
    """Odd 3-step segments with a mid-flight admission: after every segment
    each state tensor of the replayed graph equals the eager segment's, and
    keeps its address; one capture, one replay a segment."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.models import layers as L

    asr = _tiny_asr("cuda", L.BF16 if precision == "bf16" else L.FP32)
    program, eager, (graphed, plain), admit, feats, valid = _segment_pair(asr)
    homes = {n: v.data_ptr() for n, v in graphed.items() if isinstance(v, torch.Tensor)}
    for tick in range(5):
        if tick == 1:
            for state in (graphed, plain):
                admit(state, feats[:1], valid[:1], 1)
        program(graphed)
        eager(plain)
        for name, v in graphed.items():
            if isinstance(v, torch.Tensor) and "spare" not in name:
                assert torch.equal(v, plain[name]), (tick, name)
                assert v.data_ptr() == homes[name], (tick, name)
    assert len(program.captures) == 1 and program.replays == 5
    assert graphed["tick"] == plain["tick"] == 5
    assert not torch.equal(graphed["pool_scores"][0], graphed["pool_scores"][2])


def _eager_streaming_decoder():
    from mocov2_whisper_flamingo_torch.decode.streaming import StreamingDecoder

    class EagerChunks(StreamingDecoder):
        """The streaming decoder with its plain chunk on the card."""

        def _run_chunk(self, encoder_out, encoder_valid, i0, n_prime, begin_index):
            return self._chunk(encoder_out, encoder_valid,
                               torch.tensor(i0, device=self.device), n_prime, begin_index)

    return StreamingDecoder, EagerChunks


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_chunk_graph_replays_the_eager_chunk_bit_for_bit(precision):
    """Beam 3 under timestamp rules, windows that roll over with 4 tokens of
    context: after each chunk the replayed decoder's buffers and position
    equal the eager chunk's, and every chunk was a replay (one capture per
    key: each window's first chunk and its steady chunks)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.decode.logit_rules import LogitRules
    from mocov2_whisper_flamingo_torch.models import layers as L

    asr = _tiny_asr("cuda", L.BF16 if precision == "bf16" else L.FP32)
    dec = asr.decoder.prepare_decode_params()
    rules = LogitRules(vocab_size=96, suppress=(3, 5), timestamp_begin=80, no_timestamps_id=79,
                       eos_id=3)
    graphed_cls, eager_cls = _eager_streaming_decoder()
    kw = dict(max_len=24, eos_id=3, max_tokens_per_chunk=6, beam_size=3, context_tokens=4,
              sot_prev_id=4, logit_rules=rules)
    graphed, plain = graphed_cls(dec, [1, 2], **kw), eager_cls(dec, [1, 2], **kw)
    for i in range(7):
        feats, valid = _card_features(asr, 1, i % 3)
        assert graphed.process_chunk(feats, valid) == plain.process_chunk(feats, valid), i
        for a, b in zip(graphed._state, plain._state):
            assert (a == b) if isinstance(a, int) else torch.equal(a, b), i
    assert graphed._window_prefix[0] == 4  # a window rolled over
    assert graphed.graphs.replays == 7
    assert len(graphed.graphs.captures) == len(graphed._programs) >= 3
    assert plain.graphs.replays == 0


@pytest.mark.cuda
def test_loop_graph_capture_error_raises_and_nothing_runs_eagerly():
    """A segment or a chunk that reads back to the host cannot be captured:
    the call raises, the state is as it was, and no eager result stands in
    for the graph; in the engine the error fails the request."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.serving import ContinuousEngine

    def reading_back(body):
        def segment_body(st, pos0):
            float(st["run_scores"].max())
            body(st, pos0)
        return segment_body

    asr = _tiny_asr("cuda", L.FP32)
    program, _, (state, _), _, feats, valid = _segment_pair(asr)
    program._body = reading_back(program._body)
    before = {n: v.clone() for n, v in state.items()
              if isinstance(v, torch.Tensor) and "spare" not in n}  # the spares are scratch
    with pytest.raises(RuntimeError):
        program(state)
    assert program.graph is None and program.replays == 0 and state["tick"] == 0
    assert all(torch.equal(state[n], v) for n, v in before.items())

    graphed_cls, _ = _eager_streaming_decoder()

    def rules(logp, tokens, pos, begin_index):
        float(logp.max())
        return logp

    stream = graphed_cls(asr.decoder.prepare_decode_params(), [1, 2], max_len=24, eos_id=3,
                         max_tokens_per_chunk=4, beam_size=3, logit_rules=rules)
    with pytest.raises(RuntimeError):
        stream.process_chunk(feats[:1], valid[:1])
    assert stream._programs == {} and stream.graphs.replays == 0
    assert stream.graphs.captures == [] and stream._state[3] == 1

    eng = ContinuousEngine(asr.decoder.prepare_decode_params(), lambda p: (feats[:1], valid[:1]),
                           prefix_ids=[1, 2], eos_id=3, enc_len=feats.shape[1], capacity=2,
                           beam_size=3, seg_steps=3, n_segments=4)
    with eng:
        eng.segment_program._body = reading_back(eng.segment_program._body)
        with pytest.raises(RuntimeError):
            eng.transcribe(None, timeout=120)
        assert eng.segment_program.replays == 0


@pytest.mark.cuda
def test_serve_tool_on_the_card_answers_health_a_transcript_and_metrics():
    """``python -m mocov2_whisper_flamingo_torch.tools.serve --random-init
    --model whisper-small`` as a process of its own: it warms its buckets,
    listens, and answers the three routes; it is stopped at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import http.client
    import json
    import socket
    import subprocess
    import sys
    import time

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    proc = subprocess.Popen(
        [sys.executable, "-m", "mocov2_whisper_flamingo_torch.tools.serve", "--random-init",
         "--model", "whisper-small", "--precision", "bf16", "--port", str(port),
         "--buckets", "1,2", "--max-len", "32"],
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)

    def call(method, path, body=None):
        conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
        try:
            conn.request(method, path, None if body is None else json.dumps(body))
            resp = conn.getresponse()
            return resp.status, json.loads(resp.read())
        finally:
            conn.close()

    try:
        deadline = time.monotonic() + 240
        while True:
            try:
                assert call("GET", "/healthz") == (200, {"ok": True})
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "the server did not come up"
                time.sleep(1.0)
        status, body = call("POST", "/v1/transcribe",
                            {"audio": [0.01 * (i % 100) for i in range(32_000)]})
        assert status == 200, body
        assert body["tokens"][:4] == [1, 2, 3, 4] and body["bucket"] == 1
        assert len(body["tokens"]) <= 32 and body["decode_ms"] > 0
        status, metrics = call("GET", "/metrics")
        assert status == 200 and metrics["requests"] == 1
        assert metrics["compiled_buckets"] == [1, 2]
    finally:
        proc.terminate()
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait(timeout=30)


# -- the train program (training/programs.py) -------------------------------------------------

TRAIN_VOCAB = 48
TRAIN_CASES = {  # dropout, rematerialize, on-device augmentation, loss mode, K1 per step
    "dropout": (0.1, False, False, "ctc_ce", 1),
    "remat_dropout": (0.1, True, False, "ctc_ce", 1),
    "remat_flash": (0.0, True, False, "ctc_ce", 5),
    "augment": (0.1, False, True, "ctc_ce", 1),
    "feature_mse": (0.1, False, False, "feature_mse", 1),
}


def _train_twins(precision, dropout, remat, augment, loss_mode, accum=1, seed=0):
    """Two tasks and optimizers over twin tiny AV nets on the card (a 1-layer
    d_model 64 Whisper encoder over 3000 mel frames, MoCo ResNet-50, 2
    fusion blocks at Dh 32, fusion gates 0.5), each with a generator seeded
    alike."""
    import numpy as np

    from mocov2_whisper_flamingo_torch.config import get_config
    from mocov2_whisper_flamingo_torch.models import layers as L
    from mocov2_whisper_flamingo_torch.models.av_net import AVNet
    from mocov2_whisper_flamingo_torch.models.convert import load_jax_params, random_avnet_params
    from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig
    from mocov2_whisper_flamingo_torch.ops.augment import make_batch_augment
    from mocov2_whisper_flamingo_torch.training.optim import make_optimizer
    from mocov2_whisper_flamingo_torch.training.task import AVSRTask

    cfg = WhisperConfig(n_mels=80, d_model=64, encoder_layers=1, decoder_layers=1, n_heads=2,
                        d_ff=128, vocab_size=TRAIN_VOCAB, max_source_positions=1500,
                        max_target_positions=32)
    tree, twins = None, []
    for _ in range(2):
        net = AVNet("audiovisual", None, 96, (64, 2, 4, 3000, 128, dropout), TRAIN_VOCAB,
                    device="cuda", whisper_config=cfg, remat=remat,
                    precision=L.BF16 if precision == "bf16" else L.FP32)
        if tree is None:
            tree = random_avnet_params(net, seed)
            for layer in tree["fusion"]["layers"]:
                layer["attn_gate"] = layer["ff_gate"] = np.float32(0.5)
        load_jax_params(net, tree)
        augment_fn = (make_batch_augment(get_config({"augmentation.on_device": True}), "cuda")
                      if augment else None)
        task = AVSRTask(net, loss_mode=loss_mode, augment_fn=augment_fn)
        opt, _ = make_optimizer({"max_lr": 1e-3, "warmup_ratio": 0.3, "weight_decay": 0.01,
                                 "gradient_clip_val": 1.0, "accumulate_grad_batches": accum},
                                6, net.trainable_parameters())
        twins.append((task, opt, torch.Generator(device="cuda").manual_seed(seed + 5)))
    return twins


def _train_batch(rng, augmentable, b=2, tv=8, n_target=5):
    """A batch on the card. Each row repeats a label, next to itself and two
    places on, as real transcripts do: the CTC kernel sums a repeated
    label's terms in a fixed order, so the steps still repeat bit for bit."""
    import numpy as np

    video = rng.integers(0, 256, (b, tv, 3, 32, 32))
    ids = rng.integers(1, TRAIN_VOCAB, (b, n_target))
    ids[:, 1] = ids[:, 3] = ids[:, 0]
    batch = {
        "audio": torch.from_numpy(rng.standard_normal((b, 3000, 80)).astype(np.float32)),
        "audio_mask": torch.ones((b, 3000), dtype=torch.bool),
        "video": (torch.from_numpy(video.astype(np.uint8)) if augmentable else
                  torch.from_numpy((video / 255.0 - 0.4).astype(np.float32))),
        "video_mask": torch.ones((b, tv), dtype=torch.bool),
        "video_lengths": torch.tensor([tv, tv - 2], dtype=torch.int32),
        "target_ids": torch.from_numpy(ids),
        "audio_lengths": torch.full((b,), 1500, dtype=torch.int32),
        "target_lengths": torch.tensor([n_target, n_target - 1], dtype=torch.int32)}
    return {k: v.cuda() for k, v in batch.items()}


def _same_state(a, b) -> bool:
    (ta, oa, ga), (tb, ob, gb) = a, b
    return (all(torch.equal(x, y) for x, y in zip(oa.params, ob.params))
            and all(torch.equal(x, y) for x, y in zip(oa.state_tensors(), ob.state_tensors()))
            and torch.equal(ga.get_state(), gb.get_state()))


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
def test_train_program_replays_the_eager_step_bit_for_bit(case, precision):
    """Three micro-batches through ``TrainProgram.train_step`` (a capture of
    the whole step, then replays) and through ``AVSRTask.train_step`` on a
    twin: losses, parameters, moments, counts and the generator bit for bit,
    K1 and the CTC kernels counted per step as the eager step launches them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from mocov2_whisper_flamingo_torch.training.programs import TrainProgram

    dropout, remat, augment, loss_mode, k1 = TRAIN_CASES[case]
    program_side, eager_side = _train_twins(precision, dropout, remat, augment, loss_mode)
    program = TrainProgram(*program_side, {"case": case})
    ctc = {"ctc_forward": 1, "ctc_backward": 1} if loss_mode == "ctc_ce" else {}
    rng = np.random.default_rng(1)
    for step in range(3):
        batch = _train_batch(rng, augment)
        results = []
        for run in (lambda: program.train_step(batch),
                    lambda: eager_side[0].train_step(eager_side[1], batch, eager_side[2])):
            fa.reset_launches()
            TL.reset_launches()
            results.append(run())
            torch.cuda.synchronize()
            assert fa.launches == k1 and dict(TL.launches_by_kernel) == ctc, step
        got, want = results
        assert sorted(got) == sorted(want)
        assert all(torch.equal(got[k], want[k]) for k in got), (step, got, want)
        assert _same_state(program_side, eager_side), step
    assert len(program.captures) == 1 and program.replays == 3 and len(program.steps) == 1
    assert program_side[1].count == 3


@pytest.mark.cuda
def test_train_program_poisoned_micro_batch_changes_nothing_at_accum_2():
    """``accumulate_grad_batches`` 2, a NaN micro-batch between the two
    halves of an update: it changes no state in the replayed step, and the
    program and the eager step stay bit-equal through it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from mocov2_whisper_flamingo_torch.training.programs import TrainProgram

    program_side, eager_side = _train_twins("fp32", 0.1, False, False, "ctc_ce", accum=2)
    program = TrainProgram(*program_side, {})
    rng = np.random.default_rng(2)
    for step in range(5):
        batch = _train_batch(rng, False)
        if step == 3:
            batch["audio"] = torch.full_like(batch["audio"], float("nan"))
            before = [t.clone() for t in (*program_side[1].params,
                                          *program_side[1].state_tensors())]
        got = program.train_step(batch)
        want = eager_side[0].train_step(eager_side[1], batch, eager_side[2])
        assert float(got["skipped"]) == float(want["skipped"]) == float(step == 3)
        if step == 3:
            after = (*program_side[1].params, *program_side[1].state_tensors())
            assert all(torch.equal(x, y) for x, y in zip(after, before))
        assert _same_state(program_side, eager_side), step
    assert program_side[1].count == 2 and program_side[1].mini_step == 0


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_eval_graph_equals_the_eager_eval_step(precision):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from mocov2_whisper_flamingo_torch.training.programs import TrainProgram

    (task, opt, gen), _ = _train_twins(precision, 0.0, False, False, "ctc_ce")
    program = TrainProgram(task, opt, gen, {})
    rng = np.random.default_rng(3)
    for _ in range(2):
        batch = _train_batch(rng, False)
        fa.reset_launches()
        TL.reset_launches()
        losses, preds = program.eval_step(batch)
        torch.cuda.synchronize()
        assert fa.launches == 3  # 1 encoder layer + 2 fusion blocks
        assert dict(TL.launches_by_kernel) == {"ctc_forward": 1}  # inside the eval graph
        want_losses, want_preds = task.eval_step(batch)
        assert torch.equal(preds, want_preds)
        assert all(torch.equal(losses[k], want_losses[k]) for k in losses)
    assert len(program.eval_program.captures) == 1 and program.eval_program.replays == 2


@pytest.mark.cuda
def test_replayed_train_step_reads_nothing_back_outside_the_losses():
    """A replayed step under ``set_sync_debug_mode("error")``, nothing
    exempted: the batch's copies, the replay (the CTC kernels inside), the
    guard and the update never wait for the device."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np

    from mocov2_whisper_flamingo_torch.training.programs import TrainProgram

    side, _ = _train_twins("bf16", 0.1, False, False, "ctc_ce")
    program = TrainProgram(*side, {})
    rng = np.random.default_rng(4)
    program.train_step(_train_batch(rng, False))  # the capture
    batch = _train_batch(rng, False)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = program.train_step(batch)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert program.replays == 2 and np.isfinite(float(losses["loss"]))


SPAN_ORDER = ("train_step", "frozen_audio", "frozen_video", "trainable_forward", "losses",
              "backward", "optimizer")


def _replay_markers(prof_path) -> list[tuple[float, str]]:
    """The span markers of a ``torch.profiler`` Chrome trace, ``(start us,
    name)`` in device order."""
    import json

    with open(prof_path) as f:
        events = json.load(f)["traceEvents"]
    return sorted((float(e["ts"]), e["name"]) for e in events
                  if e.get("ph") == "X" and e.get("cat") == "kernel"
                  and e["name"].startswith(("span_open_", "span_close_")))


@pytest.mark.cuda
def test_replayed_train_step_puts_its_span_markers_on_the_device_trace(tmp_path, monkeypatch):
    """Each replay of a captured ``TrainProgram`` step leaves its 14 markers
    on the device trace in order, the six phases inside ``train_step``; and
    the markers change no number: losses, parameters, moments and the
    generator bit-equal to a twin captured with the marker launcher
    stubbed out."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from mocov2_whisper_flamingo_torch.training.programs import TrainProgram
    from mocov2_whisper_flamingo_torch.utils import profiling

    marked_side, bare_side = _train_twins("bf16", 0.1, False, False, "ctc_ce")
    marked, bare = TrainProgram(*marked_side, {}), TrainProgram(*bare_side, {})
    rng = np.random.default_rng(6)
    batches = [_train_batch(rng, False) for _ in range(3)]
    launch = profiling._launch_marker
    monkeypatch.setattr(profiling, "_launch_marker", lambda *args: None)
    want = [bare.train_step(batch) for batch in batches]  # its capture holds no marker
    monkeypatch.setattr(profiling, "_launch_marker", launch)
    got = [marked.train_step(batches[0])]  # the capture
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got += [marked.train_step(batch) for batch in batches[1:]]
        torch.cuda.synchronize()
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    one_step = (*(f"span_open_{s}" for s in SPAN_ORDER[:1]),
                *(f"span_{edge}_{s}" for s in SPAN_ORDER[1:] for edge in ("open", "close")),
                "span_close_train_step")
    markers = _replay_markers(tmp_path / "trace.json")
    assert [name for _, name in markers] == list(one_step) * 2
    assert len({t for t, _ in markers}) == 28  # one after another on the device's clock
    assert len(marked.captures) == len(bare.captures) == 1 and marked.replays == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w) and all(torch.equal(g[k], w[k]) for k in g)
    assert _same_state(marked_side, bare_side)


# -- the CTC kernels (csrc/ctc.cu) -----------------------------------------------------------

CTC_KERNEL_CASES = {  # B, T, V, label width L, label lengths, input lengths
    # the train path's shape: 64 labels, one row with none
    "train_shape": (4, 400, 51865, 64, (64, 55, 17, 0), (400, 400, 400, 400)),
    # Whisper's longest target: S = 2 * 448 + 1 = 897 lattice positions
    "longest_target": (2, 600, 512, 448, (448, 301), (600, 560)),
    # a row whose input is shorter than its target, and a short input
    "infeasible_row": (3, 40, 64, 16, (16, 16, 5), (40, 12, 9)),
}


def _ctc_labels(gen, b, l, v):
    """Labels with repeats, as transcripts have them: every fourth label
    next to itself, and again two places on."""
    labels = torch.randint(1, v, (b, l), generator=gen)
    labels[:, 1::4] = labels[:, 0::4][:, :labels[:, 1::4].shape[1]]
    labels[:, 3::4] = labels[:, 0::4][:, :labels[:, 3::4].shape[1]]
    return labels


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CTC_KERNEL_CASES))
def test_ctc_kernels_match_the_recursion_and_repeat_bit_for_bit(case):
    """The kernel pair through ``ctc_nll`` against autograd through the
    recursion (``ctc_forward_log_probs``) on the card, the NLL masked as
    ``zero_infinity`` masks it: the NLL, and the logits' gradient through
    the log-softmax. Two kernel runs give the same bits (repeated labels);
    an infeasible row's gradient is exactly 0. The NLL is thousands in fp32
    (ulp ~4e-4 at 4000), and an occupancy of size 1 carries alpha's and
    beta's rounding into the gradient: NLL within 2e-2 + 1e-5 of its size,
    the gradient within 1e-2."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    b, t, v, l, lab_lens, in_lens = CTC_KERNEL_CASES[case]
    gen = torch.Generator().manual_seed(0)
    logits = torch.randn((b, t, v), generator=gen).cuda()
    labels = _ctc_labels(gen, b, l, v).cuda()
    in_len = torch.tensor(in_lens, dtype=torch.int32).cuda()
    lab_len = torch.tensor(lab_lens, dtype=torch.int32).cuda()

    def run(fn):
        x = logits.clone().requires_grad_()
        nll = fn(torch.log_softmax(x, dim=-1), labels, in_len, lab_len)
        (grad,) = torch.autograd.grad(torch.where(nll >= TL.INFEASIBLE, 0.0, nll).sum(), x)
        return nll.detach(), grad

    TL.reset_launches()
    nll, grad = run(TL.ctc_nll)
    torch.cuda.synchronize()
    assert dict(TL.launches_by_kernel) == {"ctc_forward": 1, "ctc_backward": 1}
    again = run(TL.ctc_nll)
    assert torch.equal(nll, again[0]) and torch.equal(grad, again[1])
    want_nll, want_grad = run(TL.ctc_forward_log_probs)
    feasible = want_nll < TL.INFEASIBLE
    assert torch.equal(nll < TL.INFEASIBLE, feasible)
    if case == "infeasible_row":
        assert not feasible[1] and feasible[0] and feasible[2]
    torch.testing.assert_close(nll[feasible], want_nll[feasible], rtol=1e-5, atol=2e-2)
    assert (grad - want_grad).abs().max().item() <= 1e-2
    assert not grad[~feasible].any()


@pytest.mark.cuda
def test_ctc_on_the_card_raises_on_what_the_kernels_do_not_take():
    """A CUDA tensor's CTC launches the kernel or raises: no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lp = torch.log_softmax(torch.randn((2, 8, 5), device="cuda"), dim=-1)
    labels = torch.ones((2, 3), dtype=torch.long, device="cuda")
    lengths = torch.full((2,), 3, device="cuda")
    before = TL.launches
    with pytest.raises(ValueError, match="on the card"):
        TL.ctc_nll(lp, labels.cpu(), lengths, lengths)
    with pytest.raises(TypeError):
        TL.ctc_nll(lp.double(), labels, lengths, lengths)
    with pytest.raises(ValueError, match="labels"):
        TL.ctc_nll(lp, torch.ones((2, TL.MAX_LABELS + 1), dtype=torch.long, device="cuda"),
                   lengths, lengths)
    assert TL.launches == before


MULTIRANK_PROGRAM_MESHES = [(2, 1), (1, 2), (2, 2)]
MULTIRANK_PROGRAM_LIMIT_S = 900  # one torchrun at full width, every rank's building included


@pytest.mark.cuda
@pytest.mark.parametrize("data,model", MULTIRANK_PROGRAM_MESHES)
def test_multirank_program_equals_the_eager_step(data, model, tmp_path):
    """``torchrun`` with one process per card on a ``(data, model)`` mesh of
    NCCL groups (tests/torch_multirank_program_worker.py): at full width the
    train program, its graphs holding the step's NCCL collectives, equals
    the eager step on the same mesh bit for bit in fp32 over 2 updates at
    accumulation 2 (losses, parameters, optimizer state, generator, one eval
    step), at dropout 0 and at dropout 0.1 with the fusion rematerialised; a
    NaN row on one data index skips the micro-batch on every rank, in the
    graph as in the eager step; a replayed step makes no synchronising call
    and no host-side collective call; at model=2 K1 runs at each rank's
    heads. In bf16 both step in turns, timed, with equal losses and state.
    Prints each rank's report. Needs ``data * model`` cards."""
    import json
    import os
    import subprocess
    import sys

    if not torch.cuda.is_available() or torch.cuda.device_count() < data * model:
        pytest.skip(f"needs {data * model} CUDA cards")
    from mocov2_whisper_flamingo_torch.ops import kernels

    kernels.build_all()  # once, before the ranks load them
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    worker = os.path.join(root, "tests", "torch_multirank_program_worker.py")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(data * model), worker, "--data", str(data), "--model",
         str(model), "--out", str(tmp_path)],
        cwd=root, env=dict(os.environ, PYTHONPATH=root, OMP_NUM_THREADS="4"),
        capture_output=True, text=True, timeout=MULTIRANK_PROGRAM_LIMIT_S)
    assert proc.returncode == 0, proc.stderr[-6000:]
    ranks = [json.load(open(tmp_path / f"rank{r}.json")) for r in range(data * model)]
    for rank in ranks:
        print(f"multirank program {data}x{model}: " + json.dumps(rank))
        for fp32 in (rank["fp32"], rank["fp32_dropout"]):  # dropout 0; dropout 0.1, remat
            assert fp32["step_kind"] == "program" and fp32["twin_step_kind"] == "eager"
            assert all(fp32["losses_equal"]) and fp32["state_after"]["equal"]
            assert fp32["eval_equal"] and fp32["count"] == [2, 2]
            assert fp32["nan_skipped"] == [1.0, 1.0] and fp32["nan_losses_equal"]
            assert fp32["nan_state_unchanged"]
            assert fp32["syncs_per_replayed_step"] == []
            assert fp32["collective_calls_per_replay"] == 0
        fp32 = rank["fp32"]
        assert fp32["k1_launches_per_replay"] == 15
        rows = 4 // data  # a data index's rows, a model index's heads (encoder, fusion)
        assert fp32["k1_shapes_per_capture"] == {str([rows, 1500, 1500, 12 // model, 64]): 12,
                                                 str([rows, 400, 400, 8 // model, 64]): 3}
        bf16 = rank["bf16_ms_per_step"]
        assert all(bf16["losses_equal"]) and bf16["state_after"]["equal"]
