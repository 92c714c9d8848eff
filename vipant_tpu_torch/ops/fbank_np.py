"""NumPy log-mel fbank, bit-matching ``torchaudio.compliance.kaldi.fbank``.

The port's own copy of ``vipant_tpu/ops/fbank_np.py`` (the same code): the
host featuriser of the data loader's wav items. Parameter defaults
mirror the reference data pipeline's calls
(`reference/cvap/data/image_audio.py:119-126`): 25 ms frames, 10 ms
shift, 128 mel bins, hanning window, dither 0, htk_compat (no-op when
``use_energy`` is false).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .mel import feature_window, mel_banks, next_power_of_two

_EPSILON = float(np.finfo(np.float32).eps)


@dataclass(frozen=True)
class FbankParams:
    sample_rate: int = 16000
    frame_length_ms: float = 25.0
    frame_shift_ms: float = 10.0
    num_mel_bins: int = 128
    window_type: str = "hanning"
    preemphasis: float = 0.97
    remove_dc_offset: bool = True
    round_to_power_of_two: bool = True
    low_freq: float = 20.0
    high_freq: float = 0.0
    snip_edges: bool = True
    dither: float = 0.0
    htk_compat: bool = True
    use_energy: bool = False

    @property
    def window_size(self) -> int:
        return int(self.sample_rate * self.frame_length_ms * 0.001)

    @property
    def window_shift(self) -> int:
        return int(self.sample_rate * self.frame_shift_ms * 0.001)

    @property
    def padded_window_size(self) -> int:
        return (
            next_power_of_two(self.window_size)
            if self.round_to_power_of_two
            else self.window_size
        )

    def num_frames(self, num_samples: int) -> int:
        if self.snip_edges:
            if num_samples < self.window_size:
                return 0
            return 1 + (num_samples - self.window_size) // self.window_shift
        return (num_samples + self.window_shift // 2) // self.window_shift


def frame_signal(waveform: np.ndarray, params: FbankParams) -> np.ndarray:
    """[num_samples] → [num_frames, window_size] (snip_edges framing)."""
    assert params.snip_edges, "only snip_edges framing is supported"
    m = params.num_frames(waveform.shape[-1])
    shift, size = params.window_shift, params.window_size
    idx = np.arange(m)[:, None] * shift + np.arange(size)[None, :]
    return waveform[idx]


def fbank(waveform: np.ndarray, params: FbankParams = FbankParams()) -> np.ndarray:
    """[num_samples] float waveform (±1 range) → [num_frames, num_mel_bins]
    float32 log-mel features.

    Computed in float32 throughout — the same working precision torchaudio
    uses on float32 input, so this is the bit-level golden for the JAX and
    C++ paths."""
    waveform = np.asarray(waveform, dtype=np.float32).reshape(-1)
    frames = frame_signal(waveform, params)
    if params.dither != 0.0:
        frames = frames + params.dither * np.random.standard_normal(frames.shape)
    if params.remove_dc_offset:
        frames = frames - frames.mean(axis=1, keepdims=True)
    if params.preemphasis != 0.0:
        first = frames[:, :1]  # replicate-pad: x[-1] ≡ x[0]
        shifted = np.concatenate([first, frames[:, :-1]], axis=1)
        frames = frames - params.preemphasis * shifted
    frames = frames * feature_window(params.window_size, params.window_type).astype(
        np.float32
    )[None, :]

    pad = params.padded_window_size - params.window_size
    if pad > 0:
        frames = np.pad(frames, ((0, 0), (0, pad)))

    spec = np.fft.rfft(frames.astype(np.float32), axis=1)
    spectrum = (spec.real.astype(np.float32) ** 2 + spec.imag.astype(np.float32) ** 2)
    banks = mel_banks(
        params.num_mel_bins,
        params.padded_window_size,
        params.sample_rate,
        params.low_freq,
        params.high_freq,
    )
    mel_energies = spectrum @ banks.T
    return np.log(np.maximum(mel_energies, _EPSILON)).astype(np.float32)
