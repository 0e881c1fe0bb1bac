"""Whisper encoder and KV-cached decoder (counterpart of ``models/whisper.py``).

Pre-LN transformer with HF ``WhisperModel`` structure. The encoder's
self-attention runs the hand-written flash-attention kernel
(``ops/flash_attention.py``), and so do the causal self-attention and the
rectangular cross-attention of the decoder's teacher-forced ``forward``; the
decoder's single-query step uses the plain attention, as the JAX package
forces its XLA path there.

Decode cache (``init_cache``): the self K/V of all layers are two stacked
tensors ``[layers, rows, max_len, H, Dh]`` written in place at the step
index; the cross K/V are ``[layers, B, T_enc, H, Dh]``, computed once per
example and kept B-major however many beams share them. Beam search reorders
the self cache physically (one ``index_select`` per step) instead of the JAX
package's ancestry-mask attention, which exists to avoid TPU relayouts.

int8 (``prepare_decode_params(weight_quant="int8")``,
``init_cache(quant="int8" | "int8-cross")``, ``quantize_encoder_params``):
weights with per-output-channel scales (``layers.QuantLinear``), caches with
per-(position, head) scales (``quantize_kv``). A quantized self cache is read
in one of the JAX package's two forms, chosen by ``decode_step(fold_scales=)``:
dequantized in the compute dtype before the attention (its row-aligned read)
or with the fp32 scales folded into the scores and probabilities (its
ancestry read, which beam search's loop steps take).
"""

from __future__ import annotations

import copy
import dataclasses

import torch
from torch import nn

from mocov2_whisper_flamingo_torch.models import layers as L
from mocov2_whisper_flamingo_torch.ops.attention import NEG_INF, multi_head_attention


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    n_mels: int = 80
    d_model: int = 768
    encoder_layers: int = 12
    decoder_layers: int = 12
    n_heads: int = 12
    d_ff: int = 3072
    vocab_size: int = 51865
    max_source_positions: int = 1500
    max_target_positions: int = 448
    activation: str = "gelu"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


WHISPER_SIZES = {
    "whisper-tiny": WhisperConfig(d_model=384, encoder_layers=4, decoder_layers=4, n_heads=6, d_ff=1536),
    "whisper-base": WhisperConfig(d_model=512, encoder_layers=6, decoder_layers=6, n_heads=8, d_ff=2048),
    "whisper-small": WhisperConfig(d_model=768, encoder_layers=12, decoder_layers=12, n_heads=12, d_ff=3072),
    "whisper-medium": WhisperConfig(d_model=1024, encoder_layers=24, decoder_layers=24, n_heads=16, d_ff=4096),
    "whisper-large-v2": WhisperConfig(d_model=1280, encoder_layers=32, decoder_layers=32, n_heads=20, d_ff=5120),
}


def config_for(name: str) -> WhisperConfig:
    key = name.split("/")[-1]
    if key not in WHISPER_SIZES:
        raise ValueError(f"Unknown whisper size {name!r}; known: {sorted(WHISPER_SIZES)}")
    return WHISPER_SIZES[key]


class Attention(nn.Module):
    """q/k/v/out projections (K has no bias in Whisper)."""

    def __init__(self, d_model: int, precision: L.Precision, device=None):
        super().__init__()
        self.q = L.Linear(d_model, d_model, True, precision, device)
        self.k = L.Linear(d_model, d_model, False, precision, device)
        self.v = L.Linear(d_model, d_model, True, precision, device)
        self.out = L.Linear(d_model, d_model, True, precision, device)
        self.qkv: L.Linear | None = None  # fused by prepare_decode_params


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, precision: L.Precision, device=None):
        super().__init__()
        self.fc1 = L.Linear(d_model, d_ff, True, precision, device)
        self.fc2 = L.Linear(d_ff, d_model, True, precision, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(L.gelu(self.fc1(x)))


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _split_head_dim(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """``[B, T, H * head_dim] -> [B, T, H, head_dim]`` for however many
    heads ``x`` holds (all of them, or a tensor-parallel rank's share)."""
    b, t, _ = x.shape
    return x.reshape(b, t, -1, head_dim)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per (position, head): ``x [..., H, Dh]`` -> (int8
    values, fp32 scales ``[..., H]``), ``scale = max|x| / 127`` over Dh,
    floored at 1e-8."""
    return L.quantize_int8(x, -1, 1e-8)


def _quantize_linears(pairs) -> None:
    """Replace each ``(module, name)`` float linear by its int8 form."""
    for owner, name in pairs:
        lin = getattr(owner, name)
        if isinstance(lin, L.Linear):
            setattr(owner, name, L.QuantLinear.from_linear(lin))


CACHE_QUANTS = (None, "int8", "int8-cross")


def _folded_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      k_scale: torch.Tensor, v_scale: torch.Tensor,
                      kv_valid: torch.Tensor | None) -> torch.Tensor:
    """Attention over an int8 cache ``k, v [B, T, H, Dh]`` with scales
    ``[B, T, H]`` folded in fp32: ``k_scale`` times the scores after the QK
    dot and before ``* Dh**-0.5``, ``v_scale`` times the probabilities
    before their cast for the PV dot (the JAX ``_ancestry_attention``)."""
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    s = s * k_scale.transpose(1, 2)[:, :, None] * (q.shape[-1] ** -0.5)
    if kv_valid is not None:
        s = s.masked_fill(~kv_valid[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1) * v_scale.transpose(1, 2)[:, :, None]
    return torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v.to(q.dtype))


class EncoderLayer(nn.Module):
    """Under tensor parallelism (``parallel/mesh.py::shard_module``) the
    projections hold this rank's heads, ``n_heads / M`` of them, and the
    attention kernel runs on ``[B, T, n_heads / M, Dh]``."""

    def __init__(self, cfg: WhisperConfig, precision: L.Precision, device=None):
        super().__init__()
        self.n_heads = cfg.n_heads
        self.head_dim = cfg.head_dim
        self.backend = "flash"
        self.self_attn = Attention(cfg.d_model, precision, device)
        self.self_attn_ln = L.LayerNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, precision, device)
        self.mlp_ln = L.LayerNorm(cfg.d_model, device=device)

    def tensor_parallel_units(self) -> list:
        """q/k/v column-parallel and ``out`` row-parallel, ``fc1`` / ``fc2``
        likewise (``parallel/mesh.py``)."""
        a, m = self.self_attn, self.mlp
        return [(self.n_heads, [(a.q, "column"), (a.k, "column"), (a.v, "column"),
                                (a.out, "row")]),
                (None, [(m.fc1, "column"), (m.fc2, "row")])]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, dh = self.self_attn, self.head_dim
        y = self.self_attn_ln(x)
        out = multi_head_attention(_split_head_dim(a.q(y), dh), _split_head_dim(a.k(y), dh),
                                   _split_head_dim(a.v(y), dh), backend=self.backend)
        x = x + a.out(_merge_heads(out))
        return x + self.mlp(self.mlp_ln(x))


class WhisperEncoder(nn.Module):
    """``forward(mel [B, n_mels, T]) -> [B, T // 2, D]``."""

    def __init__(self, config: WhisperConfig, precision: L.Precision = L.FP32,
                 device=None):
        super().__init__()
        cfg = self.config = config
        self.precision = precision
        self.conv1 = L.Conv1d(cfg.n_mels, cfg.d_model, 3, 1, 1, precision, device)
        self.conv2 = L.Conv1d(cfg.d_model, cfg.d_model, 3, 2, 1, precision, device)
        self.pos_embed = L.zeros_param((cfg.max_source_positions, cfg.d_model), device)
        self.layers = nn.ModuleList(EncoderLayer(cfg, precision, device)
                                    for _ in range(cfg.encoder_layers))
        self.ln_post = L.LayerNorm(cfg.d_model, device=device)

    def forward(self, mel: torch.Tensor) -> torch.Tensor:
        x = mel.transpose(-1, -2)
        x = L.gelu(self.conv1(x))
        x = L.gelu(self.conv2(x))
        x = x + self.precision.cast(self.pos_embed[: x.shape[1]])
        for layer in self.layers:
            x = layer(x)
        return self.ln_post(x)

    def quantize_encoder_params(self) -> "WhisperEncoder":
        """Weight-only int8 of every layer's q/k/v/out and fc1/fc2, in place
        (``layers.QuantLinear``, quantized from the weights as they are);
        conv1/conv2, ``pos_embed`` and the LayerNorms stay as they are.
        Layers already quantized are left alone."""
        for layer in self.layers:
            a, m = layer.self_attn, layer.mlp
            _quantize_linears([(a, "q"), (a, "k"), (a, "v"), (a, "out"), (m, "fc1"), (m, "fc2")])
        return self


class DecoderLayer(nn.Module):
    def __init__(self, cfg: WhisperConfig, precision: L.Precision, device=None):
        super().__init__()
        self.self_attn = Attention(cfg.d_model, precision, device)
        self.self_attn_ln = L.LayerNorm(cfg.d_model, device=device)
        self.cross_attn = Attention(cfg.d_model, precision, device)
        self.cross_attn_ln = L.LayerNorm(cfg.d_model, device=device)
        self.mlp = MLP(cfg.d_model, cfg.d_ff, precision, device)
        self.mlp_ln = L.LayerNorm(cfg.d_model, device=device)


class WhisperDecoder(nn.Module):
    """Whisper decoder with an explicit KV cache for incremental decoding.

    Call ``prepare_decode_params`` once per decode: it returns a copy with
    fused self-attention QKV weights and every weight cast to the compute
    dtype (or the decode-hot ones quantized to int8), which is the module
    ``init_cache``/``decode_step`` run on.
    """

    def __init__(self, config: WhisperConfig, precision: L.Precision = L.FP32,
                 device=None):
        super().__init__()
        cfg = self.config = config
        self.precision = precision
        self.embed_tokens = L.Embedding(cfg.vocab_size, cfg.d_model, device)
        self.pos_embed = L.zeros_param((cfg.max_target_positions, cfg.d_model), device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, precision, device)
                                    for _ in range(cfg.decoder_layers))
        self.ln_post = L.LayerNorm(cfg.d_model, device=device)
        self.vocab_table: torch.Tensor | None = None  # set by prepare_decode_params
        self.backend = "flash"  # the teacher-forced forward's attention

    # -- full-sequence (teacher forcing) ------------------------------------------

    def _cross_attention_probs(self, layer: DecoderLayer, x: torch.Tensor, enc: torch.Tensor,
                               encoder_valid: torch.Tensor | None
                               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Cross-attention that materialises its probabilities: ``(output
        [B, Tq, D], probs [B, H, Tq, Tk] fp32)``, an fp32 softmax over fp32
        scores, for callers that need the weights themselves."""
        ca, h = layer.cross_attn, self.config.n_heads
        q, k, v = _split_heads(ca.q(x), h), _split_heads(ca.k(enc), h), _split_heads(ca.v(enc), h)
        s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (q.shape[-1] ** -0.5)
        if encoder_valid is not None:
            s = s.masked_fill(~encoder_valid[:, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", p.to(q.dtype), v)
        return ca.out(_merge_heads(a)), p

    def forward(self, tokens: torch.Tensor, encoder_out: torch.Tensor,
                encoder_valid: torch.Tensor | None = None,
                return_cross_weights: bool = False):
        """Teacher-forced pass: ``tokens [B, T]`` -> fp32 logits ``[B, T, V]``
        (causal, no cache). The causal self-attention and the cross-attention
        over ``encoder_out [B, Tk, D]`` (``encoder_valid [B, Tk]`` masks its
        keys) both go through the flash-attention kernel.

        ``return_cross_weights``: also return every layer's cross-attention
        probabilities as ``[layers, B, heads, T, Tk]`` (fp32), the alignment
        signal for word timestamps; that pass takes the explicit cross path,
        whose output is the kernel path's up to rounding. Works on a decoder
        with or without ``fuse_decode_params`` / ``prepare_decode_params``;
        on an int8 decoder the self-attention runs its quantized ``qkv``, as
        the JAX package's ``apply`` does on a quantized tree."""
        cfg, prec = self.config, self.precision
        x = self.embed_tokens(tokens) + self.pos_embed[: tokens.shape[1]]
        x = prec.cast(x)
        enc = prec.cast(encoder_out)
        cross_ws = []
        for layer in self.layers:
            sa, ca = layer.self_attn, layer.cross_attn
            y = layer.self_attn_ln(x)
            q, k, v = sa.qkv(y).chunk(3, dim=-1) if sa.qkv is not None \
                else (sa.q(y), sa.k(y), sa.v(y))
            out = multi_head_attention(*(_split_heads(t, cfg.n_heads) for t in (q, k, v)),
                                       causal=True, backend=self.backend)
            x = x + sa.out(_merge_heads(out))
            y = layer.cross_attn_ln(x)
            if return_cross_weights:
                h, w = self._cross_attention_probs(layer, y, enc, encoder_valid)
                cross_ws.append(w)
            else:
                out = multi_head_attention(
                    _split_heads(ca.q(y), cfg.n_heads), _split_heads(ca.k(enc), cfg.n_heads),
                    _split_heads(ca.v(enc), cfg.n_heads), kv_valid=encoder_valid,
                    backend=self.backend)
                h = ca.out(_merge_heads(out))
            x = x + h
            x = x + layer.mlp(layer.mlp_ln(x))
        logits = self._vocab_logits(self.ln_post(x))
        if return_cross_weights:
            return logits, torch.stack(cross_ws)
        return logits

    # -- decode preparation ---------------------------------------------------

    def fuse_decode_params(self) -> "WhisperDecoder":
        """A copy whose self-attention layers carry one fused ``[D, 3D]``
        QKV projection (zero bias block for K, which has none)."""
        dec = copy.deepcopy(self)
        for layer in dec.layers:
            sa = layer.self_attn
            d_in, d = sa.q.kernel.shape
            fused = L.Linear(d_in, 3 * d, True, sa.q.precision, sa.q.kernel.device)
            with torch.no_grad():
                fused.kernel.copy_(torch.cat([sa.q.kernel, sa.k.kernel, sa.v.kernel], dim=1))
                fused.bias.copy_(torch.cat([sa.q.bias, torch.zeros_like(sa.q.bias),
                                            sa.v.bias]))
            sa.qkv = fused
        return dec

    def quantize_decode_params(self) -> "WhisperDecoder":
        """A copy with exactly the weights the decode step reads quantized to
        int8 (``layers.QuantLinear`` / ``QuantEmbedding``): the fused self
        ``qkv`` (call ``fuse_decode_params`` first) and ``out``, the cross
        ``q`` and ``out``, ``fc1``, ``fc2`` and the tied embedding table
        (per-row scales). The self q/k/v and the cross k/v (read once per
        utterance by ``cross_caches``) stay float."""
        dec = copy.deepcopy(self)
        for layer in dec.layers:
            sa, ca, m = layer.self_attn, layer.cross_attn, layer.mlp
            _quantize_linears([(sa, "qkv"), (sa, "out"), (ca, "q"), (ca, "out"),
                               (m, "fc1"), (m, "fc2")])
        dec.embed_tokens = L.QuantEmbedding.from_embedding(dec.embed_tokens)
        dec.vocab_table = None
        return dec

    def prepare_decode_params(self, weight_quant: str | None = None) -> "WhisperDecoder":
        """Fused QKV, then every float parameter cast to the compute dtype
        (LayerNorm parameters included, as in the JAX package). The vocab
        projection keeps an fp32 copy of the cast table so that logits are
        fp32 products of compute-dtype operands.

        ``weight_quant="int8"``: fused QKV, then ``quantize_decode_params``
        from the fp32 weights, then every float parameter cast except those
        named ``scale``: the quantization scales and the LayerNorm scales
        stay fp32, as in the JAX package. No fp32 copy of the int8 table is
        kept; the logits cast it at use."""
        if weight_quant not in (None, "int8"):
            raise ValueError(f"unknown weight_quant {weight_quant!r}; expected None or 'int8'")
        dec = self.fuse_decode_params()
        dt = self.precision.compute_dtype
        if weight_quant == "int8":
            dec = dec.quantize_decode_params()
        with torch.no_grad():
            for name, p in dec.named_parameters():
                if p.is_floating_point() and not (weight_quant and name.split(".")[-1] == "scale"):
                    p.data = p.data.to(dt)
        if weight_quant is None:
            dec.vocab_table = dec.embed_tokens.embedding.float()
        return dec

    # -- incremental decode ---------------------------------------------------

    def cross_caches(self, encoder_out: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """Every layer's cross-attention K and V of ``encoder_out [B, T, D]``,
        stacked as ``[layers, B, T, H, Dh]`` in the compute dtype."""
        cfg = self.config
        enc = self.precision.cast(encoder_out)
        dtype = self.precision.compute_dtype
        cross_k = torch.stack([_split_heads(lyr.cross_attn.k(enc), cfg.n_heads)
                               for lyr in self.layers]).to(dtype)
        cross_v = torch.stack([_split_heads(lyr.cross_attn.v(enc), cfg.n_heads)
                               for lyr in self.layers]).to(dtype)
        return cross_k, cross_v

    def init_cache(self, encoder_out: torch.Tensor, max_len: int | None = None,
                   beam_groups: int = 1, quant: str | None = None) -> dict:
        """Allocate the self caches (compute dtype) for ``B * beam_groups``
        rows and compute the cross K/V once per example from the un-repeated
        encoder output.

        ``quant="int8"``: both caches int8, with fp32 per-(position, head)
        scales beside them (``self_k_scale [layers, rows, max_len, H]``,
        ``cross_k_scale [layers, B, T, H]``, the same for V); the cross K/V
        are quantized here from their compute-dtype projections, the self
        rows at write time. ``"int8-cross"``: only the cross cache."""
        if quant not in CACHE_QUANTS:
            raise ValueError(f"unknown cache quant {quant!r}; expected one of {CACHE_QUANTS}")
        cfg = self.config
        b = encoder_out.shape[0]
        max_len = max_len or cfg.max_target_positions
        dtype = self.precision.compute_dtype
        dev = encoder_out.device
        shape = (len(self.layers), b * beam_groups, max_len, cfg.n_heads, cfg.head_dim)
        cache = {}
        for name, kv in zip(("cross_k", "cross_v"), self.cross_caches(encoder_out)):
            if quant is None:
                cache[name] = kv
            else:
                cache[name], cache[name + "_scale"] = quantize_kv(kv)
        for name in ("self_k", "self_v"):
            if quant == "int8":
                cache[name] = torch.zeros(shape, dtype=torch.int8, device=dev)
                cache[name + "_scale"] = torch.zeros(shape[:-1], dtype=torch.float32, device=dev)
            else:
                cache[name] = torch.zeros(shape, dtype=dtype, device=dev)
        return cache

    def _self_step(self, li: int, layer: DecoderLayer, x: torch.Tensor, cache: dict,
                   index: int, where: tuple, write: bool = True,
                   fold_scales: bool = False) -> torch.Tensor:
        """``where``: the cache entries the step's K/V go to, and the key mask
        over ``0 .. index`` (None: every row stands at ``index``)."""
        cfg, sa = self.config, layer.self_attn
        y = layer.self_attn_ln(x)
        if sa.qkv is not None:
            q, k, v = sa.qkv(y).chunk(3, dim=-1)
        else:
            q, k, v = sa.q(y), sa.k(y), sa.v(y)
        q = _split_heads(q, cfg.n_heads)
        ck, cv = cache["self_k"][li], cache["self_v"][li]
        quant = "self_k_scale" in cache
        write_at, valid = where
        if write:
            k, v = _split_heads(k, cfg.n_heads)[:, 0], _split_heads(v, cfg.n_heads)[:, 0]
            if quant:
                ck[write_at], cache["self_k_scale"][li][write_at] = quantize_kv(k)
                cv[write_at], cache["self_v_scale"][li][write_at] = quantize_kv(v)
            else:
                ck[write_at] = k.to(ck.dtype)
                cv[write_at] = v.to(cv.dtype)
        # Positions past ``index`` are masked to exact zeros in the JAX
        # package; here they are simply not read.
        ck, cv = ck[:, : index + 1], cv[:, : index + 1]
        if not quant:
            out = multi_head_attention(q, ck.to(q.dtype), cv.to(q.dtype), kv_valid=valid)
        else:
            ks = cache["self_k_scale"][li][:, : index + 1]
            vs = cache["self_v_scale"][li][:, : index + 1]
            if fold_scales:
                out = _folded_attention(q, ck, cv, ks, vs, valid)
            else:  # dequantize at the consumer, in the compute dtype
                out = multi_head_attention(q, ck.to(q.dtype) * ks[..., None].to(q.dtype),
                                           cv.to(q.dtype) * vs[..., None].to(q.dtype),
                                           kv_valid=valid)
        return sa.out(_merge_heads(out))

    def _cross_step(self, layer: DecoderLayer, x: torch.Tensor, cross_k: torch.Tensor,
                    cross_v: torch.Tensor, encoder_valid: torch.Tensor | None,
                    k_scale: torch.Tensor | None = None,
                    v_scale: torch.Tensor | None = None) -> torch.Tensor:
        """Single-query cross-attention; the ``rows = B * groups`` queries
        are grouped per example so each example's K/V is read once. An int8
        cross cache folds ``k_scale`` (``[B, T, H]``) into the fp32 scores
        after the dot and ``v_scale`` into the probabilities before the cast
        for the PV dot."""
        cfg = self.config
        h, dh = cfg.n_heads, cfg.head_dim
        rows = x.shape[0]
        b_enc = cross_k.shape[0]
        groups = rows // b_enc
        q = layer.cross_attn.q(layer.cross_attn_ln(x))[:, 0]
        q = q.reshape(b_enc, groups, h, dh)
        s = torch.einsum("bghd,bthd->bght", q.float(), cross_k.float()) * (dh ** -0.5)
        if k_scale is not None:
            s = s * k_scale.transpose(1, 2)[:, None]
        if encoder_valid is not None:
            ev = encoder_valid if encoder_valid.shape[0] == b_enc else encoder_valid[::groups]
            s = s.masked_fill(~ev[:, None, None, :], NEG_INF)
        p = torch.softmax(s, dim=-1)
        if v_scale is not None:
            p = p * v_scale.transpose(1, 2)[:, None]
        a = torch.einsum("bght,bthd->bghd", p.to(q.dtype), cross_v.to(q.dtype))
        return layer.cross_attn.out(a.reshape(rows, 1, h * dh))

    def _vocab_logits(self, x: torch.Tensor) -> torch.Tensor:
        """Tied-embedding projection to fp32 logits: fp32 products of
        compute-dtype operands (the JAX dot's fp32 accumulation). An int8
        table is cast at use and its row scales multiply the output columns."""
        emb = self.embed_tokens
        if isinstance(emb, L.QuantEmbedding):
            return torch.matmul(x.float(), emb.embedding_q.float().T) * emb.scale.float()
        table = self.vocab_table if self.vocab_table is not None else emb.embedding.float()
        return torch.matmul(x.float(), table.T)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, cache: dict, index: int,
                    encoder_valid: torch.Tensor | None = None,
                    positions: torch.Tensor | None = None, write: bool = True,
                    fold_scales: bool = False) -> tuple[torch.Tensor, dict]:
        """One step. ``tokens [rows, 1]``; ``index`` is the (Python int)
        position. Writes the step's K/V into ``cache`` in place and returns
        ``(logits [rows, V] fp32, cache)``.

        ``positions`` (``[rows]`` int64 on the cache's device): rows that
        stand at different positions, as in continuous batching. Each row
        takes the position embedding of, writes its K/V at and attends up to
        its own position; ``index`` is then the largest of them, which the
        caller knows on the host, and every row reads the keys ``0 ..
        index`` through one mask. ``write=False`` leaves the cache as it was
        (the JAX package's ``write_gate``: the streaming decode's steps past
        the end of its token buffer).

        ``fold_scales`` (int8 self cache only): False dequantizes the cached
        K/V in the compute dtype before the attention, True folds their fp32
        scales into the scores and probabilities (see the module doc)."""
        prec = self.precision
        if positions is None:
            pe = self.pos_embed[index]
            where = ((slice(None), index), None)
        else:
            pe = self.pos_embed[positions][:, None]
            keys = torch.arange(index + 1, device=positions.device)
            rows = torch.arange(positions.shape[0], device=positions.device)
            where = ((rows, positions), keys[None, :] <= positions[:, None])
        x = prec.cast(self.embed_tokens(tokens) + pe)
        cks, cvs = cache.get("cross_k_scale"), cache.get("cross_v_scale")
        for li, layer in enumerate(self.layers):
            x = x + self._self_step(li, layer, x, cache, index, where, write, fold_scales)
            x = x + self._cross_step(layer, x, cache["cross_k"][li], cache["cross_v"][li],
                                     encoder_valid, None if cks is None else cks[li],
                                     None if cvs is None else cvs[li])
            x = x + layer.mlp(layer.mlp_ln(x))
        x = self.ln_post(x)
        logits = self._vocab_logits(prec.cast(x))
        return logits[:, 0], cache
