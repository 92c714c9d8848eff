"""On-device log-mel fbank: batched PyTorch ops on the waveform's device.

Counterpart of ``vipant_tpu/ops/fbank.py`` (``fbank``, ``fbank_fixed_len``)
with the Kaldi semantics of the host fbank :mod:`.fbank_np` (and so of
``torchaudio.compliance.kaldi.fbank`` as the reference's data pipeline
calls it, `reference/cvap/data/audio/transform.py:29-33`): snip-edges
framing, per-frame DC removal, pre-emphasis that repeats each frame's first
sample, the window of :mod:`.mel`, zero padding to the next power of two,
the power spectrum, the mel banks of :mod:`.mel` and
``log(max(mel, float32 eps))``. The frontend is no Pallas kernel in the JAX
package (plain XLA ops), so here it is plain PyTorch on the card: framing as
a strided view (``Tensor.unfold``), ``torch.fft.rfft`` and the mel product
as an fp32 ``torch.matmul``.

``use_dft=True`` takes the JAX package's DFT-as-matmul route instead of
the rFFT (two fp32 products with cos / sin matrices); the default is the
rFFT on every device (the JAX package chose the DFT only for the TPU's
matrix unit). Both routes need full fp32 products: PyTorch's default
(``torch.get_float32_matmul_precision() == "highest"``, no TF32), which
nothing in the port changes.

Not supported, and refused rather than computed otherwise than the host
fbank: ``dither != 0`` (the host fbank adds Gaussian noise to each frame;
the JAX package's device fbank silently leaves it out), ``use_energy`` and
``snip_edges=False``.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch

from .fbank_np import _EPSILON, FbankParams
from .mel import feature_window, mel_banks


def check_device_params(params: FbankParams) -> None:
    """Raise ``NotImplementedError`` for what the device fbank does not
    compute as the host fbank does."""
    if params.dither != 0.0:
        raise NotImplementedError(
            f"dither={params.dither}: the device fbank applies no dither, while the host fbank "
            "(ops/fbank_np.py) adds dither * N(0, 1) to every frame; the JAX package's device "
            "fbank (vipant_tpu/ops/fbank.py) ignores dither silently, so its on_device features "
            "differ from its host path's. Set running.audio.dither=0 or on_device=False")
    if params.use_energy:
        raise NotImplementedError("use_energy: the device fbank computes no energy term")
    if not params.snip_edges:
        raise NotImplementedError("snip_edges=False: only snip-edges framing is supported")


@functools.lru_cache(maxsize=16)
def _consts(params: FbankParams, device: str, use_dft: bool) -> Tuple[torch.Tensor, ...]:
    """(window [size], mel banks [padded//2 + 1, bins], and for the DFT
    route cos, sin [size, padded//2 + 1]) as fp32 on ``device``."""
    size, padded = params.window_size, params.padded_window_size
    window = torch.from_numpy(feature_window(size, params.window_type).astype(np.float32))
    banks = torch.from_numpy(mel_banks(params.num_mel_bins, padded, params.sample_rate,
                                       params.low_freq, params.high_freq).T.copy())
    out = [window, banks]
    if use_dft:
        # frames are not padded on this route: the zero rows past `size` never contribute
        n = np.arange(size)[:, None]
        k = np.arange(padded // 2 + 1)[None, :]
        ang = -2.0 * np.pi * n * k / padded
        out += [torch.from_numpy(np.cos(ang).astype(np.float32)),
                torch.from_numpy(np.sin(ang).astype(np.float32))]
    return tuple(t.to(device) for t in out)


def fbank(waveforms: torch.Tensor, params: FbankParams = FbankParams(),
          use_dft: Optional[bool] = None) -> torch.Tensor:
    """[B, num_samples] (or [num_samples]) -> [B, num_frames, num_mel_bins]
    fp32 log-mel, on the waveform's device."""
    check_device_params(params)
    squeeze = waveforms.dim() == 1
    x = (waveforms[None] if squeeze else waveforms).float()
    size, shift = params.window_size, params.window_shift
    if params.num_frames(x.shape[-1]) <= 0:
        raise ValueError(f"waveform too short: {x.shape[-1]} < window {size}")
    window, banks, *dft = _consts(params, str(x.device), bool(use_dft))

    frames = x.unfold(-1, size, shift)  # [B, F, size], a strided view
    if params.remove_dc_offset:
        frames = frames - frames.mean(dim=-1, keepdim=True)
    if params.preemphasis != 0.0:
        shifted = torch.cat([frames[..., :1], frames[..., :-1]], dim=-1)
        frames = frames - params.preemphasis * shifted
    frames = frames * window

    if use_dft:
        cos_m, sin_m = dft
        power = torch.matmul(frames, cos_m) ** 2 + torch.matmul(frames, sin_m) ** 2
    else:
        pad = params.padded_window_size - size
        if pad:
            frames = torch.nn.functional.pad(frames, (0, pad))
        spec = torch.fft.rfft(frames, dim=-1)
        power = spec.real ** 2 + spec.imag ** 2  # [B, F, padded//2 + 1]
    out = torch.log(torch.clamp_min(torch.matmul(power, banks), _EPSILON))
    return out[0] if squeeze else out


def fbank_fixed_len(waveforms: torch.Tensor, params: FbankParams, max_frames: int,
                    norms: Optional[Tuple[float, float]] = None,
                    use_dft: Optional[bool] = None,
                    num_samples: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fbank, truncated or zero-padded to ``max_frames``, then ``(x - mean) /
    std`` with ``norms = (mean, std)``: [B, max_frames, num_mel_bins], the
    per-clip frontend of the data pipeline
    (`reference/cvap/data/audio/transform.py:12-35` and the dataset's pad and
    normalisation).

    ``num_samples`` [B]: each waveform's true length before its zero
    padding. The frames past a clip's own frame count are zeroed before the
    normalisation, as the host path pads the fbank of the unpadded clip;
    without it the padding's frames are log(eps) and the frames across the
    clip's end mix in its zeros (the JAX package's device fbank)."""
    feats = fbank(waveforms, params, use_dft=use_dft)
    if feats.dim() == 2:
        feats = feats[None]
    F = feats.shape[1]
    if num_samples is not None:
        n = torch.as_tensor(num_samples, device=feats.device).reshape(-1, 1)
        frames = torch.where(n >= params.window_size,
                             torch.div(n - params.window_size, params.window_shift,
                                       rounding_mode="floor") + 1, 0)
        keep = torch.arange(F, device=feats.device)[None, :] < frames
        feats = torch.where(keep[..., None], feats, 0.0)
    if F >= max_frames:
        feats = feats[:, :max_frames]
    else:
        feats = torch.nn.functional.pad(feats, (0, 0, 0, max_frames - F))
    if norms is not None:
        mean, std = norms
        # a tensor on the device, not a Python scalar: CUDA divides by a
        # scalar as a product with its reciprocal, an ulp off the division
        std = torch.full((), float(std), dtype=feats.dtype, device=feats.device)
        feats = (feats - float(mean)) / std
    return feats
