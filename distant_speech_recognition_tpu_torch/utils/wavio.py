"""WAV audio I/O on the host.

Replaces the libsndfile-based ``SampleFeature`` reader of the reference
(feature/feature.cc:241-330).  int16 PCM is normalized to float by 1/32768,
matching libsndfile's float conversion used there, so energies printed by the
reference unit tests are directly comparable.
"""

from __future__ import annotations

import wave

import numpy as np

__all__ = ["read_wav", "write_wav"]

_INT16_SCALE = 32768.0


def read_wav(path: str, normalize: bool = True) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (samples ``[channels, T]`` float32, sample_rate).

    Handles PCM via the stdlib ``wave`` module plus IEEE-float (format
    tag 3) files like those the reference tools write
    (src/beamformerMLC.cc:290, SF_FORMAT_FLOAT)."""
    try:
        with wave.open(path, "rb") as w:
            nch = w.getnchannels()
            width = w.getsampwidth()
            rate = w.getframerate()
            raw = w.readframes(w.getnframes())
    except wave.Error:
        return _read_wav_float(path, normalize)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32)
        if normalize:
            data /= _INT16_SCALE
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32)
        if normalize:
            data /= 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0)
        if normalize:
            data /= 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    return data.reshape(-1, nch).T.copy(), rate


def _read_wav_float(path: str, normalize: bool) -> tuple[np.ndarray, int]:
    """Minimal RIFF walk for IEEE-float WAVs the stdlib refuses."""
    import struct

    with open(path, "rb") as f:
        riff, _, wave_id = struct.unpack("<4sI4s", f.read(12))
        if riff != b"RIFF" or wave_id != b"WAVE":
            raise ValueError(f"{path}: not a RIFF/WAVE file")
        fmt = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                raise ValueError(f"{path}: no data chunk")
            cid, size = struct.unpack("<4sI", hdr)
            if cid == b"fmt ":
                fmt = struct.unpack("<HHIIHH", f.read(16))
                f.seek(size - 16, 1)
            elif cid == b"data":
                raw = f.read(size)
                break
            else:
                f.seek(size + (size & 1), 1)
    tag, nch, rate, _, _, bits = fmt
    if tag != 3:
        raise ValueError(f"{path}: unsupported format tag {tag}")
    dt = "<f4" if bits == 32 else "<f8"
    data = np.frombuffer(raw, dtype=dt).astype(np.float32)
    if not normalize:
        data = data * np.float32(_INT16_SCALE)
    return data.reshape(-1, nch).T.copy(), rate


def write_wav(path: str, samples: np.ndarray, rate: int, normalized: bool = True,
              dtype: str = "int16") -> None:
    """Write float samples ``[T]`` or ``[channels, T]``.

    ``dtype='int16'`` writes 16-bit PCM; ``dtype='float32'`` writes an
    IEEE-float WAV (format tag 3) like the reference tools emit via
    libsndfile (``SF_FORMAT_FLOAT``, src/beamformerMLC.cc:290)."""
    samples = np.asarray(samples)
    if samples.ndim == 1:
        samples = samples[None]
    data = samples.T
    if dtype == "float32":
        if not normalized:
            data = data / _INT16_SCALE
        _write_wav_float(path, data.astype("<f4"), samples.shape[0], rate)
        return
    if normalized:
        data = data * _INT16_SCALE
    pcm = np.clip(np.round(data), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(samples.shape[0])
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(pcm.tobytes())


def _write_wav_float(path: str, data: np.ndarray, nch: int, rate: int) -> None:
    import struct

    payload = data.tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(payload), b"WAVE"))
        f.write(struct.pack("<4sI" + "HHIIHH", b"fmt ", 16,
                            3, nch, rate, rate * nch * 4, nch * 4, 32))
        f.write(struct.pack("<4sI", b"data", len(payload)))
        f.write(payload)
