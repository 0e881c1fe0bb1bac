"""The port's evaluation tool (``tools/evaluate.py``) and profiling helpers
(``utils/profiling.py``).

``evaluate_ctc_greedy`` and ``evaluate_beam`` run on a tiny dataset that the
test writes (tests/test_torch_datamodule.py's), through each package's data
module, with the same weights: the WER, the row count and every hypothesis
equal the JAX tool's (the JAX side on one device, as the data module tests
take it). The command line run by two gloo processes prints the report that
one process prints. The profiling helpers, and ``train.py --profile`` under
torchrun at model=2."""

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


def test_trace_writes_a_trace_holding_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path / "prof")):
        with profiling.annotate("avsr_step"):
            torch.ones(8) @ torch.ones(8)
    path = tmp_path / "prof" / "rank0.pt.trace.json"
    events = json.load(open(path))["traceEvents"]
    assert any(ev.get("name") == "avsr_step" for ev in events)


def test_step_timer_keeps_a_moving_average():
    timer = profiling.StepTimer(alpha=0.5)
    assert timer.seconds == 0.0
    for _ in range(2):
        with timer:
            pass
    assert 0.0 < timer.seconds < 1.0


def test_device_memory_report_keeps_the_jax_keys(monkeypatch):
    assert profiling.device_memory_report() == {}  # no card here
    stats = {"allocated_bytes.all.current": 5, "allocated_bytes.all.peak": 9}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "memory_stats", lambda index: stats)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda index: type("Props", (), {"total_memory": 80})())
    assert profiling.device_memory_report() == {
        "cuda:0": {"bytes_in_use": 5, "peak_bytes_in_use": 9, "bytes_limit": 80}}
