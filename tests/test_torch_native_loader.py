"""The port's native WAV loader (``native/``, built with g++ from its own
copy of ``stylish_io.cpp``) against the JAX package's (its committed
library, which builds nothing), and the prefetch loader's native path.

Tolerance: bitwise, on 16-bit and float WAVs, at the target rate and
resampled, mono and stereo; at 24 kHz the native batch also equals the
scipy path bitwise.
"""

import os.path as osp

import numpy as np
import pytest
from scipy.io import wavfile

from fixtures import make_micro_dataset
from stylish_tts_tpu import native as jax_native
from stylish_tts_torch import native
from stylish_tts_torch.config import ModelConfig
from stylish_tts_torch.data import loader as loader_mod
from stylish_tts_torch.data.dataset import FilePathDataset
from stylish_tts_torch.data.sampler import BatchSizeTable, DynamicBatchSampler
from stylish_tts_torch.text import TextCleaner


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(0)
    paths = []
    for name, sr, kind, channels in (("a", 24000, np.int16, 1), ("b", 22050, np.int16, 1),
                                     ("c", 48000, np.float32, 2), ("d", 24000, np.int32, 1)):
        n = int(0.7 * sr)
        x = 0.5 * rng.standard_normal((n, channels)).clip(-1, 1)
        if kind == np.int16:
            data = (x * 32767).astype(np.int16)
        elif kind == np.int32:
            data = (x * 2**31 * 0.99).astype(np.int32)
        else:
            data = x.astype(np.float32)
        path = str(root / f"{name}.wav")
        wavfile.write(path, sr, data[:, 0] if channels == 1 else data)
        paths.append(path)
    return root, paths


def test_native_build_matches_the_jax_library(wavs, tmp_path):
    root, paths = wavs
    assert osp.isfile(jax_native._LIB_PATH)  # the committed binary: no build
    lib = native.build(tmp_path / "build")
    built = list((tmp_path / "build").glob("libstylish_io_*.so"))
    assert len(built) == 1
    for target_len in (24000 * 7 // 10, 12000, 20000):  # exact, crop, pad
        ours = native.load_wav_batch(paths, 24000, target_len, lib=lib)
        ref = jax_native.load_wav_batch(paths, 24000, target_len)
        assert ours.dtype == np.float32 and ours.shape == (4, target_len)
        np.testing.assert_array_equal(ours, ref)
    for p in paths:
        assert native.wav_frames(p, 24000, lib=lib) == jax_native.wav_frames(p, 24000)
    with pytest.raises(IOError):
        native.load_wav_batch([str(root / "missing.wav")], 24000, 100, lib=lib)


def test_prefetch_loader_serves_batches_natively(tmp_path):
    data = make_micro_dataset(str(tmp_path / "data"), n_train=6, n_val=1,
                              with_caches=False)
    with open(f"{data}/train-list.txt", encoding="utf-8") as f:
        lines = f.readlines()
    ds = FilePathDataset(data_list=lines, root_path=f"{data}/wav-dir",
                         text_cleaner=TextCleaner(ModelConfig().symbol),
                         sample_rate=24000, coarse_hop_length=300)
    bins, _ = ds.time_bins()
    table = BatchSizeTable(probe_batch_max=2)
    table.plan(list(bins))
    sampler = DynamicBatchSampler(bins, table, drop_last=False, seed=3)

    before = dict(loader_mod.BATCHES)
    natively = list(loader_mod.PrefetchLoader(ds, sampler, 300, require_pitch=False))
    after_native = dict(loader_mod.BATCHES)
    plain = list(loader_mod.PrefetchLoader(ds, sampler, 300, require_pitch=False,
                                           use_native=False))
    n = len(sampler)
    assert after_native["native"] - before["native"] == n
    assert after_native["scipy"] == before["scipy"]
    assert loader_mod.BATCHES["scipy"] - after_native["scipy"] == n
    assert len(natively) == len(plain) == n
    for (b1, batch1, paths1), (b2, batch2, paths2) in zip(natively, plain):
        assert b1 == b2 and paths1 == paths2
        np.testing.assert_array_equal(batch1.audio_gt, batch2.audio_gt)
        np.testing.assert_array_equal(batch1.text, batch2.text)
