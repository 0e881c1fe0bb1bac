#!/usr/bin/env python
"""Export the inference graphs with ``torch.export`` and verify the round trip.

    python -m mocov2_whisper_flamingo_torch.tools.export_model [--tiny] \\
        [--output avsr_model.pt2] [--beam-output beam.pt2] [--device cpu]

Counterpart of the JAX package's ``tools/export_model.py`` (StableHLO through
``jax.export``); here the artifact is a ``.pt2`` file written by
``torch.export.save`` and read back by ``torch.export.load``:

- ``export_forward`` exports the AVNet forward with a symbolic batch axis
  (``Dim("b")``) and, with ``symbolic_time=True``, a symbolic video time axis
  (``Dim("tv", max=1500)``, the JAX scope's ``tv <= 1500``: the trunk cuts
  both streams to the shorter, and the audio stream has 1500 frames). The
  mel axis stays 3000 by the Whisper front end's contract. The CLI exports
  at B=2 (``torch.export`` specialises an example size of 0 or 1) and
  verifies at B=3, so the batch axis is shown to be symbolic; the artifact
  runs at B=1 as well.
- ``export_beam`` exports the serving program, the AV encode and the beam
  search, at one (batch, beam, max_len) bucket. The prefix is one
  ``while_loop`` over its teacher-forced step and the search another over
  the beam step (``BeamProgram``), as the JAX artifact's are two
  ``lax.scan`` calls: the artifact's size and the export's time grow neither
  with ``max_len`` nor with the prefix. The decoder is prepared for decoding
  (``prepare_decode_params``) once, before tracing, and the artifact holds
  the prepared copy. The CLI holds the artifact against the same program
  run eagerly.
- ``verify_export`` reloads the artifact, runs it and compares it with the
  live model; ``verify_export_fresh_process`` does the same in a fresh
  interpreter that never traced it.

**The artifact holds plain attention.** The flash-attention kernel is a
``ctypes`` call that ``torch.export`` cannot trace, so the export runs with
``set_attention_backend("plain")``, the twin of the JAX package's
``_xla_attention``, as the JAX tool exports through XLA attention, and then
restores the backend. The ResNet's 1x1 convolutions take their plain version
under ``torch.export`` by themselves (``ops/bottleneck_gemm.py``); the live
reference an artifact is held against runs inside ``as_traced``, which puts
both on their plain versions. **The artifact runs on the device it was exported
on:** the tensors the model makes (masks, position indices, the search's
buffers) carry that device in the graph; the fresh-process check runs the
child on it.

``--checkpoint`` takes a ``torch.save``'d state dict under the port's
names (``tools/evaluate.py::restore_params``); an orbax directory of the JAX
package is refused.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import logging
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch
from torch import nn

from mocov2_whisper_flamingo_torch.models.visual_frontend import Bottleneck

logger = logging.getLogger("export_model")

VIDEO_TIME_MAX = 1500  # the audio stream's frames: the trunk cuts video to it


def _batch_dims(symbolic_time: bool) -> tuple:
    """``dynamic_shapes`` for the AVNet input tuple (audio [b,3000,80], audio
    mask [b,3000], video [b,tv,3,H,W], video mask [b,tv], lengths [b]):
    one symbolic batch axis, and the video time axis when asked."""
    b = torch.export.Dim("b")
    tv = torch.export.Dim("tv", max=VIDEO_TIME_MAX) if symbolic_time else None
    video = {0: b, 1: tv} if tv is not None else {0: b}
    return ({0: b}, {0: b}, video, dict(video), {0: b})


@contextlib.contextmanager
def plain_attention(net):
    """Run ``net``'s attention on the plain backend inside the block (what an
    export traces), restoring each module's own backend after it."""
    owners = [m for m in net.modules() if hasattr(m, "backend")]
    old = [m.backend for m in owners]
    net.set_attention_backend("plain")
    try:
        yield
    finally:
        for m, backend in zip(owners, old):
            m.backend = backend


@contextlib.contextmanager
def as_traced(net):
    """Run ``net`` inside the block as an export traces it: its attention on
    the plain backend and the ResNet's 1x1 convolutions on their plain
    version (on the card in bf16 the live net runs kernels in their place),
    restoring each block's own choice after it."""
    blocks = [m for m in net.modules() if isinstance(m, Bottleneck)]
    old = [m.plain_gemm for m in blocks]
    with plain_attention(net):
        for m in blocks:
            m.plain_gemm = True
        try:
            yield
        finally:
            for m, plain in zip(blocks, old):
                m.plain_gemm = plain


def _save(exported, path: str) -> bytes:
    buf = io.BytesIO()
    torch.export.save(exported, buf)
    blob = buf.getvalue()
    with open(path, "wb") as f:
        f.write(blob)
    return blob


def export_forward(net, example_batch, path: str, symbolic_batch: bool = True,
                   symbolic_time: bool = False) -> bytes:
    """Export ``net``'s forward (an ``AVNet``) on ``example_batch`` to
    ``path``; returns the bytes written. ``symbolic_batch``: one artifact
    for any batch size (export from an example of 2 or more);
    ``symbolic_time``: any video length up to 1500 frames too."""
    if symbolic_time and not symbolic_batch:
        raise ValueError("symbolic_time requires symbolic_batch")
    dims = (_batch_dims(symbolic_time),) if symbolic_batch else None
    with plain_attention(net), torch.no_grad():
        exported = torch.export.export(net, (tuple(example_batch),), dynamic_shapes=dims,
                                       strict=False)
    blob = _save(exported, path)
    logger.info("exported forward (%s batch): %d bytes to %s",
                "symbolic" if symbolic_batch else "concrete", len(blob), path)
    return blob


class BeamProgram(nn.Module):
    """The serving program of an ``AVWhisperNet``: ``AVWhisperNet.beam``'s
    encode and beam search, on a decoder prepared once. Holds the trunk, the
    bridge and the prepared decoder (not the unprepared one).

    The search is ``decode/beam.py::BeamLoop`` in its device form, two
    ``torch._higher_order_ops.while_loop`` calls, as the JAX beam is two
    ``lax.scan`` calls: ``BeamLoop``'s constructor teacher-forces the
    prefix in one (``n_prefix - 1`` steps; no loop for a one-token prefix,
    as in JAX), then a loop over the search step runs ``max_len -
    n_prefix`` times. Both bodies read the whole cache window under the
    ``<= position`` mask: a traced body has one shape at every index.
    ``torch.export`` traces each body once, so the artifact and the export's
    time grow neither with ``max_len`` nor with the prefix. Called eagerly
    (the CLI's reference), torch runs the same loops through dynamo. Not
    the net's CUDA graph
    (``decode/programs.py``): ``torch.export`` cannot trace a replay."""

    def __init__(self, net, prefix_ids, beam_size: int, max_len: int, eos_id: int,
                 length_penalty: float):
        super().__init__()
        self.trunk, self.bridge = net.trunk, net.bridge
        self.decoder = net.decoder.prepare_decode_params()
        if self.decoder.vocab_table is self.decoder.embed_tokens.embedding:
            # fp32: the vocab table is the embedding itself, and the loop's
            # body may not take two inputs that alias; the logits read the
            # embedding then, the same values.
            self.decoder.vocab_table = None
        self.prefix = [int(t) for t in prefix_ids]
        self.search = dict(beam_size=beam_size, max_len=max_len, eos_id=eos_id,
                           length_penalty=length_penalty)

    def forward(self, input_batch: tuple) -> tuple[torch.Tensor, torch.Tensor]:
        from torch._higher_order_ops import while_loop

        from mocov2_whisper_flamingo_torch.decode.beam import BeamLoop

        features, valid = self.trunk.fused_features(input_batch)  # AVWhisperNet.encode
        loop = BeamLoop(self.decoder, self.bridge(features), self.prefix, encoder_valid=valid,
                        device_steps=True, **self.search)
        last = loop.max_len - 1
        start = torch.full((), loop.n_prefix - 1, dtype=torch.long, device=features.device)
        _, *state = while_loop(lambda i, *_: i < last,
                               lambda i, *state: (i + 1, *loop.step(state, i)),
                               (start, *loop.state))
        return state[2], state[3]  # pool tokens [B, K, max_len], pool scores [B, K]


def export_beam(net, example_batch, prefix_ids, path: str, beam_size: int = 5,
                max_len: int = 64, eos_id: int = 0, length_penalty: float = 1.0) -> bytes:
    """Export the serving program of ``net`` (an ``AVWhisperNet``): AV encode
    -> beam search -> (sequences [B, K, L], scores [B, K]) at the example's
    shapes, the prefix and the search a ``while_loop`` each (one loop for a
    one-token prefix; ``BeamProgram``). Raises where a loop cannot be
    exported: no unrolled form stands behind it. Returns the bytes
    written."""
    program = BeamProgram(net, prefix_ids, beam_size, max_len, eos_id, length_penalty)
    with plain_attention(net), torch.no_grad():
        exported = torch.export.export(program, (tuple(example_batch),), strict=False)
    # Each node of a loop's body carries, as its stack trace, the text of
    # the traced while_loop call, which names every weight the body reads:
    # ~90 MB of a whisper-small artifact. The traces are debug text only.
    for module in exported.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                node.meta.pop("stack_trace", None)
    blob = _save(exported, path)
    logger.info("exported beam decode (B=%d K=%d L=%d): %d bytes to %s",
                example_batch[0].shape[0], beam_size, max_len, len(blob), path)
    return blob


def _outputs(out) -> list[np.ndarray]:
    return [x.detach().cpu().numpy() for x in (out if isinstance(out, tuple) else (out,))]


def _compare(path: str, leaves: list[np.ndarray], reference_out, atol: float,
             exact: bool, where: str) -> bool:
    ok = all(np.all(np.isfinite(x)) for x in leaves if np.issubdtype(x.dtype, np.floating))
    if reference_out is not None:
        for got, ref in zip(leaves, _outputs(reference_out)):
            ok = ok and got.shape == ref.shape and (
                np.array_equal(got, ref) if exact else np.allclose(got, ref, atol=atol))
    logger.info("%s %s: out shapes %s ok=%s", where, path, [x.shape for x in leaves], bool(ok))
    return bool(ok)


def verify_export(path: str, example_batch, reference_out=None, atol: float = 1e-4,
                  exact: bool = False) -> bool:
    """Reload the artifact, run it on ``example_batch``, check that every
    float output is finite and, given ``reference_out``, that the outputs
    are close to it (``exact`` for token ids). A shorter ``reference_out``
    is held against the first outputs only."""
    program = torch.export.load(path).module()
    with torch.no_grad():
        out = program(tuple(example_batch))
    return _compare(path, _outputs(out), reference_out, atol, exact, "reloaded graph")


_FRESH_VERIFY_SCRIPT = """
import sys
import torch
batch = torch.load(sys.argv[2], map_location=sys.argv[4], weights_only=True)
program = torch.export.load(sys.argv[1]).module()
with torch.no_grad():
    out = program(tuple(batch))
out = out if isinstance(out, tuple) else (out,)
torch.save([x.cpu() for x in out], sys.argv[3])
"""


def verify_export_fresh_process(path: str, example_batch, reference_out=None,
                                atol: float = 1e-4, exact: bool = False) -> bool:
    """``verify_export`` in a fresh interpreter that never traced the
    artifact: the child loads it, runs it on the batch on the batch's own
    device (the artifact's, see the module doc) and sends the outputs back
    for the comparison here."""
    device = str(example_batch[0].device)
    with tempfile.TemporaryDirectory() as td:
        batch_path, out_path = os.path.join(td, "batch.pt"), os.path.join(td, "out.pt")
        torch.save([x.cpu() for x in example_batch], batch_path)
        proc = subprocess.run(
            [sys.executable, "-c", _FRESH_VERIFY_SCRIPT, os.path.abspath(path), batch_path,
             out_path, device], capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            logger.error("fresh-process verify failed (rc=%d):\n%s", proc.returncode,
                         proc.stderr[-2000:])
            return False
        leaves = [x.numpy() for x in torch.load(out_path, weights_only=True)]
    return _compare(path, leaves, reference_out, atol, exact, f"fresh-process ({device}) verify")


def _example_batch(b: int, t_video: int = 16, hw: int = 64, device="cpu") -> tuple:
    """The JAX tool's example batch, from the same draws: mel ``[b, 3000,
    80]``, video ``[b, t_video, 3, hw, hw]``, every frame valid."""
    rng = np.random.default_rng(0)
    audio = np.asarray(rng.standard_normal((b, 3000, 80)), np.float32)
    video = np.asarray(rng.standard_normal((b, t_video, 3, hw, hw)), np.float32)
    return (torch.from_numpy(audio).to(device),
            torch.ones((b, 3000), dtype=torch.bool, device=device),
            torch.from_numpy(video).to(device),
            torch.ones((b, t_video), dtype=torch.bool, device=device),
            torch.full((b,), t_video, dtype=torch.int32, device=device))


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    from mocov2_whisper_flamingo_torch.config import add_config_flags, config_from_args

    add_config_flags(parser)
    parser.add_argument("--output", default="avsr_model.pt2")
    parser.add_argument("--beam-output", default=None,
                        help="also export the beam-decode serving program to this path "
                             "(B from --beam-batch)")
    parser.add_argument("--beam-batch", type=int, default=1)
    parser.add_argument("--beam-size", type=int, default=5)
    parser.add_argument("--max-len", type=int, default=64)
    parser.add_argument("--checkpoint", default=None,
                        help="torch.save'd state dict to export (default: random init)")
    parser.add_argument("--tiny", action="store_true")
    parser.add_argument("--device", default="cuda",
                        help="'cuda' (default; fails without a card) or 'cpu'")
    args = parser.parse_args(argv)
    config = config_from_args(args)
    logging.basicConfig(level=logging.INFO)

    from mocov2_whisper_flamingo_torch.tools.evaluate import restore_params
    from mocov2_whisper_flamingo_torch.tools.verify_model import apply_tiny
    from mocov2_whisper_flamingo_torch.train import build_net

    if args.tiny:
        apply_tiny(config)
    net = build_net(config, vocab_size=51865, device=args.device)
    if args.checkpoint:
        restore_params(net, args.checkpoint)
    device = next(net.parameters()).device

    export_forward(net, _example_batch(2, device=device), args.output, symbolic_batch=True)
    # Verify at a batch size the export never saw. The live reference runs
    # the plain attention and convolutions the artifact was traced with; the tolerance is the
    # JAX tool's for bf16 compute (two differently fused bf16 programs).
    batch3 = _example_batch(3, device=device)
    with as_traced(net), torch.no_grad():
        live3 = net(batch3)
    ok = verify_export(args.output, batch3, reference_out=live3, atol=0.1)

    if args.beam_output:
        from mocov2_whisper_flamingo_torch.models import layers as L
        from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet
        from mocov2_whisper_flamingo_torch.models.convert import (
            load_jax_params, random_jax_params)

        model = config["model"]
        dnet = AVWhisperNet(
            modelargs=(model["d_model"], model["n_heads"], model["n_layers"],
                       model["pe_max_len"], model["fc_hidden_size"], 0.0),
            vocab_size=51865, whisper_name=config["whisper"]["model_name"],
            precision=L.BF16, device=device)
        load_jax_params(dnet, random_jax_params(dnet, 0))
        bb = _example_batch(args.beam_batch, device=device)
        bb = (bb[0].transpose(1, 2).contiguous(),) + bb[1:]  # mel as [B, 80, T]
        prefix = [1, 2]
        # The artifact is held against the same program run eagerly (its loop
        # runs the same body): token ids exact, scores within 1e-4. Beside it,
        # agreement with the net's own beam, which reads the keys 0 .. i where
        # the loop reads the whole window under the position mask: in bf16
        # the two may round apart.
        program = BeamProgram(dnet, prefix, args.beam_size, args.max_len, 0, 1.0)
        with as_traced(dnet), torch.no_grad():
            eager = program(bb)
            res = dnet.beam(bb, prefix, beam_size=args.beam_size, max_len=args.max_len,
                            eos_id=0)
        export_beam(dnet, bb, prefix, args.beam_output, beam_size=args.beam_size,
                    max_len=args.max_len, eos_id=0)
        ok = ok and verify_export(args.beam_output, bb, reference_out=eager)
        logger.info("eager beam program vs the net's beam: tokens %s, largest score "
                    "difference %.3e", "equal" if torch.equal(eager[0], res.sequences)
                    else "differ", (eager[1] - res.scores).abs().max().item())

    ok = ok and verify_export_fresh_process(args.output, batch3, reference_out=live3, atol=0.1)
    print("EXPORT:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
