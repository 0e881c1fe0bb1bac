"""The port's CUDA kernels against their plain PyTorch versions on the card.

Imports neither JAX nor the JAX package, so it runs where only PyTorch is
installed: ``python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py``.
Skipped on hosts without a CUDA card.
"""

import pytest
import torch

from mocov2_whisper_flamingo_torch.ops import flash_attention as fa


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
