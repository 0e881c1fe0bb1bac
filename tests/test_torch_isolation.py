"""The port stands alone: no file of ``mocov2_whisper_flamingo_torch`` (nor
``chip_smoke.py``, ``k1_ablation.py``, ``export_beam_times.py``, the card-only
kernel tests, the rank worker of the multi-process tests, nor the port's
examples) imports JAX or the JAX package, and its entry points default to the
CUDA card, refusing to fall back to the CPU silently."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "mocov2_whisper_flamingo_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "k1_ablation.py", ROOT / "export_beam_times.py",
    ROOT / "tests" / "test_torch_kernels_cuda.py", ROOT / "tests" / "torch_multicard_worker.py",
    ROOT / "examples" / "torch_end_to_end.py", ROOT / "examples" / "torch_serving_demo.py",
    ROOT / "examples" / "torch_transcribe_demo.py"]
FORBIDDEN = ("jax", "jaxlib", "mocov2_whisper_flamingo_tpu")


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.append(node.module)
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.append(str(node.args[0].value))
    return names


def test_port_has_files():
    assert len(PORT_FILES) > 10


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_imports(path):
    bad = [m for m in _imported_modules(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.name} imports {bad}"


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from mocov2_whisper_flamingo_torch import resolve_device
    from mocov2_whisper_flamingo_torch.models.av_whisper import AVWhisperNet

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        AVWhisperNet(modelargs=(32, 4, 2, 3000, 128, 0.0), vocab_size=64,
                     whisper_name="whisper-tiny")
    assert resolve_device("cpu").type == "cpu"


def test_asr_and_serve_tool_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from mocov2_whisper_flamingo_torch.models.asr import WhisperASR
    from mocov2_whisper_flamingo_torch.tools import serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WhisperASR("whisper-tiny")
    assert WhisperASR("whisper-tiny", device="cpu").device.type == "cpu"
    args = serve.parse_args(["--random-init", "--model", "whisper-tiny", "--no-warmup"])
    assert args.device == "cuda"
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.build_engine(args)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--random-init", "--model", "whisper-tiny", "--no-warmup"])


def test_serving_modules_are_among_the_checked_files():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    pkg = "mocov2_whisper_flamingo_torch/"
    assert {pkg + "serving/engine.py", pkg + "serving/batcher.py", pkg + "serving/server.py",
            pkg + "serving/__init__.py", pkg + "tools/serve.py", pkg + "models/asr.py",
            pkg + "ops/mel.py", pkg + "decode/logit_rules.py",
            pkg + "decode/language.py"} <= names


def test_trainer_defaults_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    from mocov2_whisper_flamingo_torch.config import get_config
    from mocov2_whisper_flamingo_torch.models.av_net import AVNet
    from mocov2_whisper_flamingo_torch.training.trainer import Trainer
    from mocov2_whisper_flamingo_torch.utils.tokenizer import ByteTokenizer

    net = AVNet("audiovisual", None, 96, (32, 4, 2, 3000, 128, 0.0), 64,
                whisper_name="whisper-tiny", device="cpu")
    config = get_config({"output.checkpoint_dir": str(tmp_path / "ckpt"),
                         "output.log_dir": str(tmp_path / "logs")})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(config, net, ByteTokenizer())
    assert not (tmp_path / "logs").exists()  # refused before anything was written
    assert Trainer(config, net, ByteTokenizer(), device="cpu").device.type == "cpu"
