"""Kaldi-style mel filterbank matrix of the host fbank (:mod:`.fbank_np`).

The port's own copy of ``vipant_tpu/ops/mel.py`` (the same code).

Semantics follow Kaldi's ``MelBanks`` as exposed through
``torchaudio.compliance.kaldi.fbank`` — the frontend the reference data
pipeline is built on (`reference/cvap/data/audio/transform.py:29-33`):
triangular filters spaced uniformly on the 1127·ln(1+f/700) mel scale between
``low_freq`` and ``high_freq`` (0 → Nyquist), evaluated at FFT-bin centers of
the power-of-two padded window.
"""

from __future__ import annotations

import numpy as np


def mel_scale(freq):
    return 1127.0 * np.log1p(np.asarray(freq, dtype=np.float64) / 700.0)


def next_power_of_two(n: int) -> int:
    return 1 if n <= 1 else 2 ** (int(n - 1).bit_length())


def mel_banks(
    num_bins: int,
    padded_window_size: int,
    sample_rate: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Returns [num_bins, padded_window_size // 2 + 1] float32 (last FFT bin,
    the Nyquist bin, gets zero weight — Kaldi evaluates filters only on the
    first ``padded//2`` bins)."""
    assert num_bins >= 3, "mel bins must be >= 3"
    num_fft_bins = padded_window_size // 2
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = high_freq + nyquist
    assert 0.0 <= low_freq < high_freq <= nyquist, (low_freq, high_freq)

    fft_bin_width = sample_rate / padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bins = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bins * mel_delta
    center_mel = left_mel + mel_delta
    right_mel = center_mel + mel_delta

    mel = mel_scale(fft_bin_width * np.arange(num_fft_bins, dtype=np.float64))[None, :]
    up_slope = (mel - left_mel) / (center_mel - left_mel)
    down_slope = (right_mel - mel) / (right_mel - center_mel)
    weights = np.maximum(0.0, np.minimum(up_slope, down_slope))

    out = np.zeros((num_bins, num_fft_bins + 1), dtype=np.float32)
    out[:, :num_fft_bins] = weights
    return out


def feature_window(window_size: int, window_type: str = "hanning") -> np.ndarray:
    """Kaldi feature window functions (symmetric/periodic=False variants)."""
    n = np.arange(window_size, dtype=np.float64)
    a = 2.0 * np.pi / (window_size - 1)
    if window_type == "hanning":
        w = 0.5 - 0.5 * np.cos(a * n)
    elif window_type == "hamming":
        w = 0.54 - 0.46 * np.cos(a * n)
    elif window_type == "povey":  # Kaldi default: hann ** 0.85
        w = (0.5 - 0.5 * np.cos(a * n)) ** 0.85
    elif window_type == "rectangular":
        w = np.ones(window_size)
    elif window_type == "blackman":
        blackman_coeff = 0.42
        w = (
            blackman_coeff
            - 0.5 * np.cos(a * n)
            + (0.5 - blackman_coeff) * np.cos(2 * a * n)
        )
    else:
        raise ValueError(f"unknown window type {window_type!r}")
    return w.astype(np.float64)
