from . import mel, stft
from .mel import MelSpectrogram, mel_filterbank

__all__ = ["mel", "stft", "MelSpectrogram", "mel_filterbank"]
