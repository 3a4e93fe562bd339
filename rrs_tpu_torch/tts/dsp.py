"""TTS spectral synthesis (tools/tts/tts.cpp embd_to_audio's analog).

Copied host code from ``rrs_tpu/tts/dsp.py``, NumPy in float64 as there, so
the waveform and the WAV are the same bits. The vocoder head emits per frame
[n_embd] = log-magnitudes (first half) and phases (second half) of an
n_fft = 1280 spectrum; the audio is the reference's one-sided inverse DFT,
Hann-windowed, overlap-added with hop 320 and divided by the folded squared
window envelope.
"""

from __future__ import annotations

import numpy as np

N_FFT = 1280
N_HOP = 320
N_WIN = 1280
SAMPLE_RATE = 24000


def hann_window(n: int, periodic: bool = True) -> np.ndarray:
    m = n if periodic else n - 1
    return 0.5 * (1.0 - np.cos(2.0 * np.pi * np.arange(n) / m))


def fold(frames: np.ndarray, n_out: int, n_win: int, n_hop: int, n_pad: int) -> np.ndarray:
    """Overlap-add of [n_codes, n_win] frames (tts.cpp fold)."""
    out = np.zeros(n_out, np.float64)
    for li in range(frames.shape[0]):
        start = li * n_hop - n_pad
        lo = max(start, 0)
        hi = min(start + n_win, n_out)
        if hi > lo:
            out[lo:hi] += frames[li, lo - start: hi - start]
    return out[: n_out - 2 * n_pad]


def embd_to_audio(embd: np.ndarray) -> np.ndarray:
    """[n_codes, n_embd] vocoder output -> waveform (float32, 24 kHz)."""
    embd = np.asarray(embd, np.float64)
    n_codes, n_embd = embd.shape
    half = n_embd // 2
    mag = np.minimum(np.exp(embd[:, :half]), 1e2)        # [n_codes, half]
    phi = embd[:, half:]
    spec = mag * (np.cos(phi) + 1j * np.sin(phi))
    # the reference's irfft (tts.cpp) sums ONLY the one-sided n_fft / 2 + 1
    # bins, with no conjugate mirror, and divides by N = half:
    # out[k] = Re((1 / N) sum_m X[m] e^{i 2 pi k m / n})
    padded = np.zeros((n_codes, N_FFT), np.complex128)
    padded[:, :half] = spec
    frames = np.real(np.fft.ifft(padded, axis=1)) * (N_FFT / half)
    hann = hann_window(N_FFT)
    frames = frames * hann[None, :]
    n_pad = (N_WIN - N_HOP) // 2
    n_out = (n_codes - 1) * N_HOP + N_WIN
    audio = fold(frames, n_out, N_WIN, N_HOP, n_pad)
    env = fold(np.broadcast_to(hann * hann, (n_codes, N_FFT)).copy(), n_out, N_WIN, N_HOP, n_pad)
    env = np.where(env == 0.0, 1.0, env)
    return (audio / env).astype(np.float32)


def save_wav16(path, audio: np.ndarray, sample_rate: int = SAMPLE_RATE):
    """16-bit mono PCM WAV through the standard library's ``wave``."""
    import wave

    pcm = (np.clip(audio, -1.0, 1.0) * 32767.0).astype(np.int16)
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())
    return path
