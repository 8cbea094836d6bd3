"""Host-side audio I/O.

Reference parity: pyfasst/audioObject.py::AudioObject (UNVERIFIED symbol names;
mount empty at build time -- see SURVEY.md). The reference wraps the stdlib
`wave` module / scipy.io.wavfile and exposes `.data`, `.samplerate`,
`.channels`. Audio I/O stays on the host (numpy); device code receives arrays.

The decode itself runs through the native C++ codec (pyfasst_jax/native/
wavio.cpp) when the toolchain can build it: block/streaming reads, 24-bit
PCM, and the GIL released during file I/O. scipy.io.wavfile is the pure-
Python fallback (identical normalized output for the formats both support).
"""
from __future__ import annotations

import os
from typing import Optional, Union

import numpy as np
from scipy.io import wavfile as _wavfile

from pyfasst_jax.native import wavio as _native_wavio

_PCM_SCALE = {np.dtype(np.int16): 2.0 ** 15,
              np.dtype(np.int32): 2.0 ** 31,
              np.dtype(np.uint8): 2.0 ** 7}


class AudioObject:
    """A loaded (or to-be-written) audio signal.

    Attributes mirror the reference: ``data`` is a float array of shape
    (nsamples, channels) in [-1, 1], ``samplerate`` in Hz, ``channels`` the
    channel count. Construct from a filename (reads immediately, like the
    reference's ``_read``) or from raw data.
    """

    def __init__(self,
                 filename: Optional[Union[str, os.PathLike]] = None,
                 data: Optional[np.ndarray] = None,
                 samplerate: int = 44100):
        self.filename = os.fspath(filename) if filename is not None else None
        self.samplerate = int(samplerate)
        self.data: Optional[np.ndarray] = None
        if data is not None:
            self.data = self._as_2d_float(np.asarray(data))
        elif filename is not None:
            self._read()

    # -- reference API ------------------------------------------------------
    def _read(self) -> None:
        """Read the WAV file into float64 (nsamples, channels) in [-1, 1]."""
        native = _native_wavio()
        if native is not None:
            data, sr = native.read(self.filename)
            self.samplerate = int(sr)
            self.data = self._as_2d_float(data)
            return
        sr, raw = _wavfile.read(self.filename)
        self.samplerate = int(sr)
        raw = np.asarray(raw)
        if raw.dtype in _PCM_SCALE:
            scale = _PCM_SCALE[raw.dtype]
            data = raw.astype(np.float64)
            if raw.dtype == np.dtype(np.uint8):  # 8-bit WAV is unsigned
                data = data - 128.0
            data = data / scale
        else:  # float32/float64 WAV
            data = raw.astype(np.float64)
        self.data = self._as_2d_float(data)

    def _write(self, filename: Optional[str] = None, dtype=np.int16) -> str:
        """Write ``data`` to a WAV file (PCM16 by default, like the reference)."""
        path = filename or self.filename
        if path is None:
            raise ValueError("no filename to write to")
        if self.data is None:
            raise ValueError("no data to write")
        data = np.clip(self.data, -1.0, 1.0)
        native = _native_wavio()
        if native is not None and np.dtype(dtype) == np.dtype(np.int16):
            native.write(path, np.ascontiguousarray(data, np.float64),
                         self.samplerate, bits=16)
            return path
        if np.dtype(dtype) == np.dtype(np.int16):
            out = np.round(data * (2.0 ** 15 - 1)).astype(np.int16)
        else:
            out = data.astype(dtype)
        _wavfile.write(path, self.samplerate, out)
        return path

    # -- convenience --------------------------------------------------------
    @property
    def channels(self) -> int:
        return 0 if self.data is None else self.data.shape[1]

    @property
    def nsamples(self) -> int:
        return 0 if self.data is None else self.data.shape[0]

    @property
    def duration(self) -> float:
        return self.nsamples / float(self.samplerate)

    @staticmethod
    def _as_2d_float(data: np.ndarray) -> np.ndarray:
        data = np.asarray(data, dtype=np.float64)
        if data.ndim == 1:
            data = data[:, None]
        if data.ndim != 2:
            raise ValueError(f"audio data must be 1-D or 2-D, got {data.shape}")
        # (nsamples, channels): samples along axis 0
        if data.shape[0] < data.shape[1]:
            data = data.T
        return data


def wavread(filename) -> tuple[np.ndarray, int]:
    """Functional helper: returns (data[nsamples, channels], samplerate)."""
    obj = AudioObject(filename)
    return obj.data, obj.samplerate


def wavwrite(data: np.ndarray, samplerate: int, filename: str) -> str:
    """Functional helper: write float data in [-1,1] as PCM16 WAV."""
    return AudioObject(data=data, samplerate=samplerate)._write(filename)


def wavread_block(filename, offset: int, frames: int
                  ) -> tuple[np.ndarray, int]:
    """Read `frames` samples starting at `offset` without loading the file.

    The streaming loader for the online GEM path (ops/online.py): pages a
    long recording block by block. Served by the native codec when built
    (seek + bounded read); the scipy fallback reads the whole file and
    slices (correct, just not O(block)).
    """
    native = _native_wavio()
    if native is not None:
        data, sr = native.read(os.fspath(filename), offset=int(offset),
                               frames=int(frames))
        return data, int(sr)
    data, sr = wavread(filename)
    return data[offset:offset + frames], sr
