"""Minimal RIFF/WAVE decoder → float32 [channels, samples] in ±1.

Replaces the reference's ``torchaudio.load``
(`reference/cvap/data/audio/transform.py:16`) for the formats the
VIP-ANT datasets actually ship (PCM 8/16/24/32 and IEEE float 32/64). The
port's own copy of ``vipant_tpu/data/wav.py`` (the same code).
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (waveform [channels, samples] float32 in ±1, sample_rate)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")

    pos = 12
    fmt = None
    fmt_body = None
    payload = None
    while pos + 8 <= len(data):
        cid = data[pos : pos + 4]
        size = struct.unpack("<I", data[pos + 4 : pos + 8])[0]
        body = data[pos + 8 : pos + 8 + size]
        if cid == b"fmt ":
            fmt = struct.unpack("<HHIIHH", body[:16])
            fmt_body = body
        elif cid == b"data":
            payload = body
        pos += 8 + size + (size & 1)  # chunks are word-aligned

    if fmt is None or payload is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_format, channels, sample_rate, _, _, bits = fmt
    if audio_format == 0xFFFE:  # WAVE_FORMAT_EXTENSIBLE: real code in SubFormat GUID
        if fmt_body is not None and len(fmt_body) >= 26:
            audio_format = fmt_body[24] | (fmt_body[25] << 8)
        else:
            audio_format = 1

    if audio_format == 1:  # PCM
        if bits == 8:
            x = np.frombuffer(payload, np.uint8).astype(np.float32)
            x = (x - 128.0) / 128.0
        elif bits == 16:
            x = np.frombuffer(payload, "<i2").astype(np.float32) / 32768.0
        elif bits == 24:
            raw = np.frombuffer(payload, np.uint8).reshape(-1, 3)
            as32 = (
                raw[:, 0].astype(np.int32)
                | (raw[:, 1].astype(np.int32) << 8)
                | (raw[:, 2].astype(np.int32) << 16)
            )
            as32 = (as32 ^ 0x800000) - 0x800000  # sign-extend
            x = as32.astype(np.float32) / 8388608.0
        elif bits == 32:
            x = np.frombuffer(payload, "<i4").astype(np.float32) / 2147483648.0
        else:
            raise ValueError(f"{path}: unsupported PCM bits {bits}")
    elif audio_format == 3:  # IEEE float
        x = np.frombuffer(payload, "<f4" if bits == 32 else "<f8").astype(np.float32)
    else:
        raise ValueError(f"{path}: unsupported format code {audio_format}")

    n = (len(x) // channels) * channels
    wav = x[:n].reshape(-1, channels).T.copy()
    return wav, int(sample_rate)


def write_wav(path: str, wav: np.ndarray, sample_rate: int) -> None:
    """PCM16 writer (tests + dataset fabrication)."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        wav = wav[None]
    pcm = np.clip(wav.T * 32767.0, -32768, 32767).astype("<i2").tobytes()
    channels = wav.shape[0]
    byte_rate = sample_rate * channels * 2
    hdr = b"RIFF" + struct.pack("<I", 36 + len(pcm)) + b"WAVE"
    hdr += b"fmt " + struct.pack("<IHHIIHH", 16, 1, channels, sample_rate, byte_rate, channels * 2, 16)
    hdr += b"data" + struct.pack("<I", len(pcm))
    with open(path, "wb") as f:
        f.write(hdr + pcm)
