"""The port's evaluation tool (``tools/evaluate.py``) and tracing helpers
(``utils/profiling.py``).

``evaluate_ctc_greedy`` and ``evaluate_beam`` run on a tiny dataset that the
test writes (tests/test_torch_datamodule.py's), through each package's data
module, with the same weights: the WER, the row count and every hypothesis
equal the JAX tool's (the JAX side on one device, as the data module tests
take it). The command line run by two gloo processes prints the report that
one process prints. The trace and the spans: a train step's spans in order
and nesting on the CPU, their markers with the launcher stubbed; and
``train.py --profile`` under torchrun at model=2."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mocov2_whisper_flamingo_torch.config import get_config as t_get_config
from mocov2_whisper_flamingo_torch.datamodule.data_module import DataModule as TDataModule
from mocov2_whisper_flamingo_torch.models.av_net import AVNet as TNet
from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet as TWhisperNet
from mocov2_whisper_flamingo_torch.models.convert import (
    load_jax_params, random_avnet_params, random_jax_params)
from mocov2_whisper_flamingo_torch.models.whisper import WhisperConfig as TConfig
from mocov2_whisper_flamingo_torch.tools import evaluate as T
from mocov2_whisper_flamingo_torch.utils import profiling
from mocov2_whisper_flamingo_tpu.config import get_config as j_get_config
from mocov2_whisper_flamingo_tpu.datamodule.data_module import DataModule as JDataModule
from mocov2_whisper_flamingo_tpu.models.av_net import AVNet as JNet
from mocov2_whisper_flamingo_tpu.models.av_whisper import AVWhisperNet as JWhisperNet
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperConfig as JConfig
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperDecoder as JDecoder
from mocov2_whisper_flamingo_tpu.models.whisper import WhisperEncoder as JEncoder
from mocov2_whisper_flamingo_tpu.tools import evaluate as J

from test_torch_datamodule import _one_jax_device, _overrides, _write_dataset
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
VOCAB = 262  # ByteTokenizer
MODELARGS = (32, 4, 2, 3000, 128, 0.0)
TINY = dict(n_mels=80, d_model=32, encoder_layers=1, decoder_layers=1, n_heads=4, d_ff=64,
            vocab_size=VOCAB, max_source_positions=1500, max_target_positions=32)
MAX_LEN = 12
RANKS_LIMIT_S = 120  # the two-rank command line, both ranks together
CLI_FLAGS = ["--set", "model.d_model=32", "--set", "model.n_heads=4",
             "--set", "model.fc_hidden_size=128", "--set", "whisper.model_name=whisper-tiny",
             "--set", "data.test_batch_size=1", "--set", "precision.compute_dtype=float32",
             "--set", "data.max_frames=16", "--set", "data.max_frames_val=16",
             "--device", "cpu", "--seed", "3"]


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = _write_dataset(tmp_path_factory.mktemp("avsr_eval"), odd_clips=False)
    overrides = _overrides(root, "host")
    tdm = TDataModule(t_get_config(overrides))
    tdm.setup("test")
    with _one_jax_device():
        jdm = JDataModule(j_get_config(overrides))
        jdm.setup("test")
    return root, tdm, jdm


def _two_rank_cli(root, tmp_path):
    """``evaluate.main`` in two gloo processes (the port only); returns them."""
    script = ("import sys\n"
              "from mocov2_whisper_flamingo_torch.parallel import initialize_distributed\n"
              "from mocov2_whisper_flamingo_torch.tools import evaluate\n"
              f"initialize_distributed('file://{tmp_path}/store', 2, int(sys.argv[1]), "
              "backend='gloo', timeout_s=60)\n"
              "sys.exit(evaluate.main(sys.argv[2:]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    return [subprocess.Popen([sys.executable, "-c", script, str(rank), "--set",
                              f"data.root_dir={root}", *CLI_FLAGS], cwd=ROOT, env=env,
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in range(2)]


def test_ctc_greedy_matches_the_jax_tool(data):
    _, tdm, jdm = data
    probe = TNet("audiovisual", None, 96, MODELARGS, VOCAB, device="cpu",
                 whisper_config=TConfig(**TINY))
    tree = random_avnet_params(probe, 0)
    for layer in tree["fusion"]["layers"]:
        layer["attn_gate"] = np.float32(0.5)
        layer["ff_gate"] = np.float32(0.5)
    net = load_jax_params(probe, tree).eval()
    ours = T.evaluate_ctc_greedy(net, tdm, tdm.tokenizer, "test")

    jnet = JNet("audiovisual", None, 96, MODELARGS, VOCAB, whisper_name="whisper-tiny",
                backend="xla")
    cfg = JConfig(**TINY)
    jnet.whisper_config = cfg
    jnet.whisper_encoder = JEncoder(cfg, jnet.precision, "xla")
    with _one_jax_device():
        ref = J.evaluate_ctc_greedy(jnet, jax.tree.map(jnp.asarray, tree), jdm, jdm.tokenizer,
                                    "test")
    assert ours["n"] == ref["n"] == 2 and ours["refs"] == ref["refs"]
    assert ours["hyps"] == ref["hyps"] and any(ours["hyps"])
    assert ours["wer"] == pytest.approx(ref["wer"], abs=1e-12)


def test_beam_matches_the_jax_tool(data):
    _, tdm, jdm = data
    net = TWhisperNet(modelargs=MODELARGS, vocab_size=VOCAB, device="cpu",
                      whisper_config=TConfig(**TINY))
    tree = random_jax_params(net, 0)
    # Position embeddings larger than the token embeddings keep the random
    # decoder from copying its input token (tests/test_torch_av_whisper.py).
    rng = np.random.default_rng(7)
    dec = tree["decoder"]
    dec["pos_embed"] = 4.0 * rng.standard_normal(dec["pos_embed"].shape).astype(np.float32)
    dec["embed_tokens"]["embedding"] *= np.float32(0.5)
    load_jax_params(net, tree)
    ours = T.evaluate_beam(net, tdm, tdm.tokenizer, beam_size=3, max_len=MAX_LEN)

    jnet = JWhisperNet(modelargs=MODELARGS, vocab_size=VOCAB, whisper_name="whisper-tiny",
                       backend="xla")
    cfg = JConfig(**TINY)
    jnet.whisper_config = jnet.trunk.whisper_config = cfg
    jnet.trunk.whisper_encoder = JEncoder(cfg, jnet.trunk.precision, "xla")
    jnet.decoder = JDecoder(cfg, jnet.precision, "xla")
    with _one_jax_device():
        ref = J.evaluate_beam(jnet, jax.tree.map(jnp.asarray, tree), jdm, jdm.tokenizer,
                              beam_size=3, max_len=MAX_LEN)
    assert ours["n"] == ref["n"] == 2 and ours["refs"] == ref["refs"]
    assert ours["hyps"] == ref["hyps"] and any(ours["hyps"])
    assert ours["wer"] == pytest.approx(ref["wer"], abs=1e-12)


def test_two_ranks_report_what_one_reports(data, tmp_path, capsys):
    root = data[0]
    procs = _two_rank_cli(root, tmp_path)  # while one process runs here
    preds = tmp_path / "one.txt"
    assert T.main(["--set", f"data.root_dir={root}", *CLI_FLAGS,
                   "--predictions-out", str(preds)]) == 0
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert one["mode"] == "ctc-greedy" and one["split"] == "test" and one["n"] == 2
    assert open(preds).read().count("Pred: ") == 2
    outs = []
    deadline = time.monotonic() + RANKS_LIMIT_S  # one limit for both ranks
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=max(deadline - time.monotonic(), 1))
            assert proc.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    assert json.loads(outs[0].strip().splitlines()[-1]) == one
    assert outs[1].strip() == ""  # rank 1 reports nothing


def test_checkpoint_flag_reads_a_trainer_checkpoint_and_refuses_a_directory(tmp_path):
    net = TNet("audiovisual", None, 96, MODELARGS, VOCAB, device="cpu",
               whisper_config=TConfig(**TINY))
    state = {k: torch.full_like(v, 0.25) if v.is_floating_point() else v
             for k, v in net.state_dict().items()}
    torch.save({"params": state, "opt_state": {}, "step": 3}, tmp_path / "step_3.pt")
    T.restore_params(net, str(tmp_path / "step_3.pt"))
    assert all(torch.equal(v, state[k]) for k, v in net.state_dict().items())
    torch.save(state, tmp_path / "bare.pt")
    T.restore_params(net, str(tmp_path / "bare.pt"))
    with pytest.raises(SystemExit, match="orbax"):
        T.restore_params(net, str(tmp_path))


def test_train_entry_point_under_torchrun_at_model_2(tmp_path):
    """``torchrun --standalone --nproc_per_node 2 -m ...train --smoke --device
    cpu --set mesh.model=2 --profile DIR``: two gloo processes with the
    smoke config's bf16 compute (the byte vocabulary of 262 splits, so the
    head's bf16 outputs are gathered), rank 0's whole checkpoint, one trace
    per rank."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "mocov2_whisper_flamingo_torch.train", "--smoke", "--device", "cpu",
         "--set", "mesh.model=2", "--profile", "prof"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-3000:]
    state = torch.load(tmp_path / "checkpoints" / "step_2.pt", weights_only=True)
    assert tuple(state["params"]["decoder.kernel"].shape) == (64, 262)
    assert sorted(os.listdir(tmp_path / "prof")) == ["rank0.pt.trace.json", "rank1.pt.trace.json"]
    assert os.listdir(tmp_path / "logs" / "avsr_logs") == ["version_0"]


# -- profiling ---------------------------------------------------------------------------------

# The train step's spans with device markers, in the order a step opens them.
STEP_SPANS = ("train_step", "frozen_audio", "frozen_video", "trainable_forward", "losses",
              "backward", "optimizer")


def test_trace_writes_a_trace_holding_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("avsr_step"):
            torch.ones(8) @ torch.ones(8)
    path = tmp_path / "prof" / "rank0.pt.trace.json"
    events = json.load(open(path))["traceEvents"]
    assert any(ev.get("name") == "avsr_step" for ev in events)


def _host_spans(path) -> list[tuple[str, float, float]]:
    """The trace's ``record_function`` ranges, ``(name, start, end)`` in
    trace us, outer before inner."""
    events = json.load(open(path))["traceEvents"]
    spans = [(e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return sorted(spans, key=lambda s: (s[1], -s[2]))


@pytest.fixture
def launched(monkeypatch):
    """The markers ``span`` launches, as ``(name, close, device)``; none
    reaches a card."""
    out = []
    monkeypatch.setattr(profiling, "_launch_marker",
                        lambda name, close, device: out.append((name, close, str(device))))
    return out


def test_cpu_train_step_spans_open_and_close_in_order_and_nesting(tmp_path, launched):
    """A step through ``TrainProgram`` on the CPU: ``train_program.step``
    holds ``train_step``, which holds the six phases, in turn and none
    inside another; on the CPU every span is a host range and launches no
    marker."""
    from mocov2_whisper_flamingo_torch.training.optim import make_optimizer
    from mocov2_whisper_flamingo_torch.training.programs import TrainProgram
    from mocov2_whisper_flamingo_torch.training.task import AVSRTask

    from test_torch_train_programs import TINY as PROGRAM_TINY
    from test_torch_train_programs import TRAINING, VOCAB as PROGRAM_VOCAB, _batches, _t

    net = TNet("audiovisual", None, 96, MODELARGS, PROGRAM_VOCAB, device="cpu",
               whisper_config=TConfig(**PROGRAM_TINY))
    opt, _ = make_optimizer(dict(TRAINING), 6, net.trainable_parameters())
    program = TrainProgram(AVSRTask(net), opt, None, {})
    with profiling.trace(str(tmp_path / "prof")):
        program.train_step(_t(_batches(1)[0]))
    spans = _host_spans(tmp_path / "prof" / "rank0.pt.trace.json")
    assert [name for name, _, _ in spans] == ["train_program.step", *STEP_SPANS]
    (_, p0, p1), (_, s0, s1), *phases = spans
    assert p0 <= s0 and s1 <= p1
    assert all(s0 <= a and b <= s1 for _, a, b in phases)
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    assert launched == []


def test_span_on_a_cuda_device_launches_open_and_close_in_order(launched):
    cuda = torch.device("cuda", 0)
    with profiling.span("train_step", cuda):
        with profiling.span("losses", cuda):
            pass
        with profiling.span("train_program.key"):  # no device: a host range only
            pass
        with profiling.span("backward", torch.device("cpu")):
            pass
    assert launched == [("train_step", False, "cuda:0"), ("losses", False, "cuda:0"),
                        ("losses", True, "cuda:0"), ("train_step", True, "cuda:0")]


def test_span_that_raises_launches_no_close_marker(launched):
    with pytest.raises(ValueError):
        with profiling.span("optimizer", torch.device("cuda")):
            raise ValueError("step failed")
    assert launched == [("optimizer", False, "cuda")]


def test_span_launches_nothing_while_compiling(tmp_path, launched, monkeypatch):
    """Under ``torch.compile`` or ``torch.export`` a span is no host range
    and no marker, so a traced program holds neither."""
    monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.span("frozen_video", torch.device("cuda")):
            torch.ones(8) @ torch.ones(8)
    assert launched == []
    assert _host_spans(tmp_path / "prof" / "rank0.pt.trace.json") == []


@pytest.mark.parametrize("rc", [0, -1, 700])
def test_marker_launcher_passes_name_edge_and_stream_and_raises_on_failure(rc, monkeypatch):
    """``_launch_marker`` hands ``csrc/spans.cu``'s ``span_mark`` the span's
    name, the edge and the device's current stream, and raises where the
    launch failed (-1: no markers of that name; else a CUDA error)."""
    from mocov2_whisper_flamingo_torch.ops import kernels

    calls = []

    class SpanMark:
        argtypes = restype = None

        def __call__(self, name, close, stream):
            calls.append((name, close, stream))
            return rc

    lib = type("Lib", (), {"span_mark": SpanMark()})()
    monkeypatch.setattr(kernels, "load", lambda name: lib if name == "spans" else None)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("Stream", (), {"cuda_stream": 1234})())
    if rc == 0:
        profiling._launch_marker("losses", True, torch.device("cuda"))
    else:
        with pytest.raises(RuntimeError, match="losses"):
            profiling._launch_marker("losses", True, torch.device("cuda"))
    assert calls == [(b"losses", 1, 1234)]
    assert lib.span_mark.restype is not None and len(lib.span_mark.argtypes) == 3
