"""The port's transcript writers (``utils/writers.py``) against the JAX
package's on the same result dicts, byte for byte (tolerance 0), and the
``transcribe`` command line (``tools/transcribe.py``) on the CPU: every
output format written, audio read through the port's native library."""

import io
import json
import os
import wave

import numpy as np
import pytest

from mocov2_whisper_flamingo_torch.datamodule import native
from mocov2_whisper_flamingo_torch.decode.timestamps import WordTiming as TWord
from mocov2_whisper_flamingo_torch.tools import transcribe as cli
from mocov2_whisper_flamingo_torch.utils import writers as T
from mocov2_whisper_flamingo_tpu.decode.timestamps import WordTiming as JWord
from mocov2_whisper_flamingo_tpu.utils import writers as J
from torch_threads import capped_torch_threads  # noqa: F401  (autouse)


def _result(word_cls, hours: float = 0.0) -> dict:
    """Segments with text and tokens, words that partition them (one word
    straddles the boundary), an arrow and a tab in the text."""
    h = hours * 3600.0
    return {
        "text": " xin chào --> bạn\ttốt lắm",
        "segments": [
            {"id": 0, "start": h + 0.0, "end": h + 2.5, "text": " xin chào --> bạn",
             "tokens": [1, 2, 3, 4], "temperature": 0.0, "avg_logprob": -0.25},
            {"id": 1, "start": h + 2.5, "end": h + 5.004, "text": "\ttốt lắm",
             "tokens": [5, 6]},
        ],
        "words": [word_cls(" xin", h + 0.0, h + 0.8, [1]),
                  word_cls(" chào", h + 0.8, h + 1.6, [2]),
                  word_cls(" -->", h + 1.6, h + 1.7, [3]),
                  word_cls(" bạn", h + 1.7, h + 2.6, [4, 5]),
                  word_cls(" lắm", h + 2.6, h + 5.0, [6])],
    }


RESULTS = {
    "words": lambda w: _result(w),
    "hours": lambda w: _result(w, hours=1.0),
    "no_words": lambda w: {**_result(w), "words": None},
    "no_segments": lambda w: {**_result(w), "segments": []},
    "empty": lambda w: {"text": "", "segments": [], "words": None},
}
OPTIONS = {"plain": {}, "highlight": {"highlight_words": True},
           "lines_2": {"max_words_per_line": 2}}


def _render(writers, fmt, result, **kw):
    buf = io.StringIO()
    writers.get_writer(fmt)(result, buf, **kw)
    return buf.getvalue().encode("utf-8")


@pytest.mark.parametrize("fmt", J.WRITER_FORMATS)
@pytest.mark.parametrize("name", RESULTS)
def test_writers_match_jax_byte_for_byte(fmt, name):
    for option, kw in OPTIONS.items():
        if kw and fmt not in ("srt", "vtt"):
            continue
        got = _render(T, fmt, RESULTS[name](TWord), **kw)
        assert got == _render(J, fmt, RESULTS[name](JWord), **kw), option


def test_format_timestamp_and_get_writer_match_jax():
    for s in (0.0, 0.0004, 0.0005, 1.9995, 59.9999, 3599.9996, 3600.0, 7322.1234, 36000.5):
        for hours in (False, True):
            for marker in (".", ","):
                assert T.format_timestamp(s, hours, marker) == J.format_timestamp(s, hours, marker)
    assert T.WRITER_FORMATS == J.WRITER_FORMATS == ("json", "srt", "tsv", "txt", "vtt")
    with pytest.raises(ValueError, match="non-negative"):
        T.format_timestamp(-1.0)
    with pytest.raises(ValueError, match="unknown output format"):
        T.get_writer("docx")


# -- the command line ---------------------------------------------------------------------


def _write_wav(path, samples: np.ndarray, rate: int) -> None:
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes((np.clip(samples, -1, 1) * 32767).astype("<i2").tobytes())


def test_load_audio_reads_wav_and_npy(tmp_path):
    rng = np.random.default_rng(0)
    x = (0.3 * rng.standard_normal(8000)).astype(np.float32)
    _write_wav(tmp_path / "a.wav", x, 8000)
    got = cli.load_audio(str(tmp_path / "a.wav"))
    wav, sr = native.read_wav_mono(str(tmp_path / "a.wav"))
    assert sr == 8000 and got.dtype == np.float32 and len(got) == 16000
    np.testing.assert_array_equal(got, native.resample(wav, 8000, 16000))
    np.save(tmp_path / "b.npy", x[None, :])
    np.testing.assert_array_equal(cli.load_audio(str(tmp_path / "b.npy")), x)


def test_cli_writes_every_format_on_the_cpu(tmp_path, capsys):
    """whisper-tiny's width with random weights, one short window: all five
    files, and the txt and json hold the text the command printed."""
    rng = np.random.default_rng(1)
    _write_wav(tmp_path / "clip.wav", 0.2 * rng.standard_normal(24_000), 24_000)
    out = tmp_path / "out"
    argv = [str(tmp_path / "clip.wav"), "--device", "cpu", "--random-init", "--seed", "2",
            "--model", "whisper-tiny", "--output-format", "all", "--output-dir", str(out),
            "--max-len", "12", "--beam-size", "2", "--temperature", "0.0", "0.5",
            "--word-timestamps", "--max-words-per-line", "3"]
    assert cli.main(argv) == 0
    printed = capsys.readouterr().out.splitlines()[-1]
    for fmt in T.WRITER_FORMATS:
        assert os.path.getsize(out / f"clip.{fmt}") > 0, fmt
    doc = json.loads((out / "clip.json").read_text(encoding="utf-8"))
    assert doc["text"] == printed
    assert (out / "clip.txt").read_text(encoding="utf-8") == \
        "".join(s["text"].strip() + "\n" for s in doc["segments"])
    assert (out / "clip.vtt").read_text(encoding="utf-8").startswith("WEBVTT\n")
    assert doc["segments"] and doc["segments"][0]["temperature"] in (0.0, 0.5)


def test_cli_refuses_missing_weights_and_orbax_dirs(tmp_path):
    with pytest.raises(SystemExit):
        cli.parse_args(["a.wav"])
    with pytest.raises(SystemExit):
        cli.parse_args(["a.wav", "--random-init", "--timestamps"])
    with pytest.raises(SystemExit, match="item 14"):
        cli.main(["a.wav", "--device", "cpu", "--model", "whisper-tiny",
                  "--checkpoint", str(tmp_path)])
