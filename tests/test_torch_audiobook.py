"""The port's audiobook front end against the JAX package's, exactly.

``stylish_tts_torch/textproc/audiobook.py`` (``vad_split``,
``prepare_dataset``) and the two commands, ``dataset-from-audiobook``
(training CLI) and ``prepare-book`` (synthesis CLI), against the JAX ones:
the same segment boundaries and the same samples (bitwise), and the same
files byte for byte (tolerance: none). Both g2p modules are pinned to the
rule fallback (``_ESPEAK = None``), so the comparison does not depend on
what ``PATH`` holds.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from click.testing import CliRunner

from formant_speech import random_phrase, synth_utterance
from stylish_tts_tpu import cli as jcli
from stylish_tts_tpu.data.wav import write_wav
from stylish_tts_tpu.textproc import audiobook as jab
from stylish_tts_tpu.textproc import g2p as jg2p
from stylish_tts_torch import cli as pcli
from stylish_tts_torch.textproc import audiobook as pab
from stylish_tts_torch.textproc import g2p as pg2p

ROOT = Path(__file__).resolve().parent.parent
SR = 24000
# ordinary prose: 16 sentences of 54-74 phoneme characters
_PROSE_BODY = (
    "The morning was cold and the road was wet from the rain. "
    "She walked along the river until she found the old stone bridge. "
    "Nobody had crossed it for years, and the moss grew thick on every rail. "
    "A small boat drifted past, its single lamp still burning. "
    "Her brother had told her to wait there until the bells rang. "
    "When the bells did ring, the sound rolled over the water like thunder. "
    "She counted each stroke, and at the twelfth she turned for home. "
    "The house was quiet, and the fire in the kitchen had gone out. "
)
PROSE = "Chapter 1\n" + _PROSE_BODY + _PROSE_BODY.replace("She", "He").strip() + "\n"
VOCABULARY = _PROSE_BODY.lower().replace(",", "").replace(".", "").split()


@pytest.fixture(autouse=True)
def rules_backend(monkeypatch):
    monkeypatch.setattr(jg2p, "_ESPEAK", None)
    monkeypatch.setattr(pg2p, "_ESPEAK", None)


def formant_narration(n: int, seconds: float, pause: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    chunks = []
    for i in range(n):
        audio, _, _ = synth_utterance(random_phrase(rng, (6, 9)), SR, seed=seed + i,
                                      target_s=seconds)
        chunks += [audio, np.zeros(int(pause * SR), np.float32)]
    return np.concatenate(chunks)


def noise_narration(seed: int) -> np.ndarray:
    """Noise bursts of 0.3-13 s (some past the 10 s cap) between silences
    of 0.05-1.2 s (some shorter than a cut's 200 ms), over a noise floor."""
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(14):
        burst = rng.uniform(0.3, 13.0)
        env = 0.05 + 0.3 * rng.random()
        chunks.append((env * rng.standard_normal(int(burst * SR))).astype(np.float32))
        chunks.append((1e-4 * rng.standard_normal(int(rng.uniform(0.05, 1.2) * SR)))
                      .astype(np.float32))
    return np.concatenate(chunks)


@pytest.mark.parametrize("kind", ["formant", "noise"])
@pytest.mark.parametrize("kwargs", [{}, {"min_s": 1.0, "max_s": 4.0}])
def test_vad_split_matches_jax_bitwise(kind, kwargs):
    audio = formant_narration(5, 1.6, 0.5, 3) if kind == "formant" else noise_narration(4)
    ours, ref = pab.vad_split(audio, SR, **kwargs), jab.vad_split(audio, SR, **kwargs)
    assert len(ours) == len(ref) >= 2
    for a, b in zip(ours, ref):
        assert (a.start_s, a.end_s) == (b.start_s, b.end_s)
        assert a.audio.dtype == b.audio.dtype and np.array_equal(a.audio, b.audio)


def long_sentences(n: int, seed: int) -> list:
    """``n`` sentences of 260-380 phoneme characters under the rule g2p:
    two of them pass the packer's 510 budget, so each packs alone."""
    rng = np.random.default_rng(seed)
    out = []
    while len(out) < n:
        words = []
        while len(pg2p.phonemize(" ".join(words))) < 260:
            words.append(str(rng.choice(VOCABULARY)))
        sentence = " ".join(words).capitalize() + "."
        if len(pg2p.phonemize(sentence)) <= 380:
            out.append(sentence)
    return out


def _tree(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_prepare_dataset_writes_the_jax_files(tmp_path):
    """One long sentence per narrated segment, so that the pairing is one
    to one: the lists and the wavs byte for byte, and the counts."""
    narration = formant_narration(4, 2.0, 0.7, 11)
    book = "Chapter 1\n" + " ".join(long_sentences(4, 12)) + "\n"
    out = {}
    for name, mod in (("port", pab), ("jax", jab)):
        out[name] = mod.prepare_dataset([_wav(tmp_path / "narration.wav", narration)], book,
                                        str(tmp_path / name), SR, val_fraction=0.3)
    assert out["port"] == out["jax"] == (3, 1)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def _wav(path: Path, audio: np.ndarray) -> str:
    if not path.exists():
        write_wav(str(path), audio, SR)
    return str(path)


def test_packing_mismatch_is_the_references(tmp_path, capsys):
    """The reference's own behaviour, kept on both sides (ROADMAP Queue 3):
    the book packs to 510 phoneme characters while a segment stops at 10 s
    and a pause ends one, so ordinary prose (16 sentences of 54-74
    phonemes, 3-4 s of speech each) packs into 2 utterances against 8
    narrated segments: both sides warn and pair the first 2 in order."""
    wav = _wav(tmp_path / "narration.wav", formant_narration(8, 3.0, 0.8, 21))
    counts = {}
    for name, mod in (("port", pab), ("jax", jab)):
        counts[name] = mod.prepare_dataset([wav], PROSE, str(tmp_path / name), SR)
        warning = capsys.readouterr().out
        assert "WARNING: 8 audio segments vs 2 text utterances; pairing the first 2" \
            in warning, warning
    assert counts["port"] == counts["jax"] == (1, 1)
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_commands_write_the_jax_files(tmp_path):
    """``dataset-from-audiobook`` (a directory of two narration files) and
    ``prepare-book`` with and without ``--phonemize``, through click on
    both packages: the same files."""
    audio_dir = tmp_path / "audio"
    audio_dir.mkdir()
    _wav(audio_dir / "b.wav", formant_narration(2, 2.0, 0.7, 31))
    _wav(audio_dir / "a.wav", formant_narration(3, 2.0, 0.7, 32))
    (tmp_path / "book.txt").write_text(PROSE + "Chapter 2\n" + PROSE.split("\n", 1)[1]
                                       + "Dr. Smith paid $3.50 on the 2nd of May 1999.\n",
                                       encoding="utf-8")
    runner = CliRunner()
    for name, mod in (("port", pcli), ("jax", jcli)):
        res = runner.invoke(mod.train_cli, [
            "dataset-from-audiobook", "--audio", str(audio_dir), "--book",
            str(tmp_path / "book.txt"), "--out", str(tmp_path / name / "ds")])
        assert res.exit_code == 0, res.output
        for flag in ([], ["--phonemize"]):
            res = runner.invoke(mod.tts_cli, [
                "prepare-book", "--text", str(tmp_path / "book.txt"), "--out",
                str(tmp_path / name / f"book{''.join(flag)}.txt"), *flag])
            assert res.exit_code == 0, res.output
    files = _tree(tmp_path / "port")
    assert files == _tree(tmp_path / "jax")
    assert {"ds/train-list.txt", "ds/val-list.txt", "ds/wav-dir/seg00000.wav", "book.txt",
            "book--phonemize.txt"} <= set(files)


def test_prepare_book_runs_as_a_module(tmp_path):
    """``python -m stylish_tts_torch.cli_tts prepare-book`` (no g2p, so
    nothing depends on PATH) writes what the JAX command writes."""
    book = tmp_path / "book.txt"
    book.write_text(PROSE, encoding="utf-8")
    proc = subprocess.run(
        [sys.executable, "-m", "stylish_tts_torch.cli_tts", "prepare-book", "--text",
         str(book), "--out", str(tmp_path / "port.txt")],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={**os.environ, "PYTHONPATH": str(ROOT)})
    assert proc.returncode == 0, proc.stdout + proc.stderr
    res = CliRunner().invoke(jcli.tts_cli, ["prepare-book", "--text", str(book), "--out",
                                            str(tmp_path / "jax.txt")])
    assert res.exit_code == 0, res.output
    assert (tmp_path / "port.txt").read_bytes() == (tmp_path / "jax.txt").read_bytes()
    assert "wrote 3 utterances" in proc.stdout  # packed by characters, to 480
