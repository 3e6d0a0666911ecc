"""Audio features: wav IO, windows, spectrogram, mel filterbanks, Kaldi
fbank and whisper's log-mel features.

Counterpart of the JAX package's `audio/audio.py`, in torch ops that run on
the card unless the caller passes `device="cpu"`, or on the device of a
tensor given without a device. The FFT stays in
f32 (`torch.fft.rfft` of f32 frames), as the JAX package keeps
`jnp.fft.rfft`; the filterbanks are built in float64 numpy and handed over
as f32, as there. Wav IO is the standard library's (PCM).
"""

from __future__ import annotations

import math
import wave as _wave
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from mnn_tpu_torch.kernels.common import resolve_device


# -- IO ---------------------------------------------------------------------

def load_wav(path: str) -> Tuple[np.ndarray, int]:
    """-> (float32 samples in [-1, 1] shaped [n] or [n, ch], sample_rate)."""
    with _wave.open(path, "rb") as w:
        sr = w.getframerate()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(w.getnframes())
    if width == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif width == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif width == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if ch > 1:
        x = x.reshape(-1, ch)
    return x, sr


def save_wav(path: str, samples, sample_rate: int) -> None:
    """Write float samples ([n] or [n, ch], a tensor or an array) as 16-bit PCM."""
    if isinstance(samples, torch.Tensor):
        samples = samples.detach().cpu().numpy()
    x = np.asarray(samples)
    ch = 1 if x.ndim == 1 else x.shape[1]
    pcm = np.clip(x * 32768.0, -32768, 32767).astype(np.int16)
    with _wave.open(path, "wb") as w:
        w.setnchannels(ch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


# -- windows ----------------------------------------------------------------

def _phase(n: int, m: int, device) -> torch.Tensor:
    """2 pi i / m for i < n on `device` (None: the card)."""
    return 2 * math.pi * torch.arange(n, dtype=torch.float32,
                                      device=resolve_device(device)) / m


def hann_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    return 0.5 - 0.5 * torch.cos(_phase(n, n if periodic else n - 1, device))


def hamming_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    return 0.54 - 0.46 * torch.cos(_phase(n, n if periodic else n - 1, device))


def povey_window(n: int, device=None) -> torch.Tensor:
    return hann_window(n, periodic=False, device=device) ** 0.85


def blackman_window(n: int, periodic: bool = True, device=None) -> torch.Tensor:
    t = _phase(n, n if periodic else n - 1, device)
    return 0.42 - 0.5 * torch.cos(t) + 0.08 * torch.cos(2 * t)


WINDOWS = {
    "hann": hann_window,
    "hamming": hamming_window,
    "povey": povey_window,
    "blackman": blackman_window,
}


# -- spectrogram ------------------------------------------------------------

def _f32(x, device=None) -> torch.Tensor:
    """Samples as f32 on `device`. With device None a tensor stays on its
    own device and an array goes to the card (raises when there is none)."""
    if isinstance(x, torch.Tensor):
        return x.float() if device is None else x.float().to(device)
    return torch.as_tensor(np.asarray(x, np.float32), device=resolve_device(device))


def frame_signal(x: torch.Tensor, n_fft: int, hop: int, center: bool = True):
    """[n] -> overlapping frames [frames, n_fft] (reflect-padded by n_fft/2
    on each side when `center`)."""
    if center:
        x = F.pad(x[None, None], (n_fft // 2, n_fft // 2), mode="reflect")[0, 0]
    return x.unfold(0, n_fft, hop)


def spectrogram(x, n_fft: int = 400, hop_length: Optional[int] = None,
                window: str = "hann", power: float = 2.0,
                center: bool = True, device=None) -> torch.Tensor:
    """-> [frames, n_fft//2 + 1] magnitude^power, the FFT in f32, on
    `_f32`'s device."""
    hop = hop_length or n_fft // 4
    frames = frame_signal(_f32(x, device), n_fft, hop, center)
    win = WINDOWS[window](n_fft, device=frames.device)
    spec = torch.fft.rfft(frames * win, n=n_fft, dim=-1)
    return torch.abs(spec) ** power


# -- mel --------------------------------------------------------------------

def _hz_to_mel(f, htk=False):
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # slaney
    f = np.asarray(f, np.float64)
    mel = f / (200.0 / 3)
    log_region = f >= 1000.0
    mel = np.where(
        log_region, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel
    )
    return mel


def _mel_to_hz(m, htk=False):
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    m = np.asarray(m, np.float64)
    f = m * (200.0 / 3)
    log_region = m >= 15.0
    f = np.where(log_region, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


def mel_filterbank(n_mels: int, n_fft: int, sample_rate: int, fmin: float = 0.0,
                   fmax: Optional[float] = None, htk: bool = False,
                   norm: Optional[str] = None, device=None) -> torch.Tensor:
    """Triangular mel filters [n_fft//2+1, n_mels] f32 on `device` (None:
    the card); slaney or htk scale, `norm="slaney"` scales each filter to
    unit area."""
    fmax = fmax or sample_rate / 2
    mels = np.linspace(_hz_to_mel(fmin, htk), _hz_to_mel(fmax, htk), n_mels + 2)
    freqs = _mel_to_hz(mels, htk)
    fft_freqs = np.linspace(0, sample_rate / 2, n_fft // 2 + 1)
    lower = (fft_freqs[:, None] - freqs[None, :-2]) / (freqs[1:-1] - freqs[:-2])
    upper = (freqs[None, 2:] - fft_freqs[:, None]) / (freqs[2:] - freqs[1:-1])
    fb = np.maximum(0.0, np.minimum(lower, upper))
    if norm == "slaney":
        enorm = 2.0 / (freqs[2:] - freqs[:-2])
        fb = fb * enorm[None, :]
    return torch.as_tensor(fb.astype(np.float32), device=resolve_device(device))


def fbank(x, sample_rate: int = 16000, n_mels: int = 80, n_fft: int = 400,
          hop_length: int = 160, window: str = "povey", dither: float = 0.0,
          preemphasis: float = 0.97, device=None) -> torch.Tensor:
    """Kaldi-style log-mel filterbank features [frames, n_mels] (no dither,
    as in the JAX package), on `_f32`'s device."""
    x = _f32(x, device)
    if preemphasis:
        x = torch.cat([x[:1] * (1 - preemphasis), x[1:] - preemphasis * x[:-1]])
    spec = spectrogram(x, n_fft, hop_length, window, power=2.0, center=False)
    fb = mel_filterbank(n_mels, n_fft, sample_rate, fmin=20.0, htk=True,
                        device=spec.device)
    return torch.log(torch.clamp(spec @ fb, min=1e-10))


def whisper_fbank(x, sample_rate: int = 16000, n_mels: int = 128, n_fft: int = 400,
                  hop_length: int = 160, device=None) -> torch.Tensor:
    """Whisper's log10-mel features [frames, n_mels], on `_f32`'s device:
    the last frame dropped, clamped to 8 below the global maximum, then
    (v + 4) / 4."""
    spec = spectrogram(x, n_fft, hop_length, window="hann", power=2.0, center=True,
                       device=device)
    spec = spec[:-1]
    fb = mel_filterbank(n_mels, n_fft, sample_rate, norm="slaney", device=spec.device)
    logspec = torch.log10(torch.clamp(spec @ fb, min=1e-10))
    logspec = torch.maximum(logspec, logspec.max() - 8.0)
    return (logspec + 4.0) / 4.0
