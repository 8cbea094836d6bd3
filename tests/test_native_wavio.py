"""Native WAV codec (pyfasst_jax/native/wavio.cpp) vs the scipy fallback.

SURVEY.md §5 data-loader row: the native codec must be a drop-in for the
pure-Python path — identical normalized output on shared formats — plus the
capabilities scipy lacks (block reads, 24-bit PCM).
"""
import numpy as np
import pytest
from scipy.io import wavfile

from pyfasst_jax.audio import AudioObject, wavread, wavread_block, wavwrite
from pyfasst_jax.native import wavio

native = wavio()
needs_native = pytest.mark.skipif(native is None,
                                  reason="native toolchain unavailable")


@pytest.fixture
def stereo(rng):
    return np.clip(0.4 * rng.standard_normal((500, 2)), -1, 1)


@needs_native
def test_pcm16_matches_scipy(tmp_path, stereo):
    p = str(tmp_path / "a.wav")
    wavfile.write(p, 16000, np.round(stereo * 32767).astype(np.int16))
    ours, sr = native.read(p)
    theirs = wavfile.read(p)[1] / 32768.0
    assert sr == 16000
    np.testing.assert_array_equal(ours, theirs)


@needs_native
@pytest.mark.parametrize("bits,tol", [(16, 2 ** -14), (24, 2 ** -22),
                                      (32, 1e-7)])
def test_write_read_roundtrip(tmp_path, stereo, bits, tol):
    p = str(tmp_path / "b.wav")
    native.write(p, stereo, 22050, bits=bits)
    y, sr = native.read(p)
    assert sr == 22050 and y.shape == stereo.shape
    assert np.abs(y - stereo).max() < tol
    info = native.info(p)
    assert info["frames"] == 500 and info["channels"] == 2
    assert info["bits"] == bits


@needs_native
def test_block_read(tmp_path, stereo):
    p = str(tmp_path / "c.wav")
    native.write(p, stereo, 8000, bits=32)
    full, _ = native.read(p)
    blk, _ = native.read(p, offset=123, frames=77)
    np.testing.assert_array_equal(blk, full[123:200])
    # past-the-end reads clamp instead of erroring
    tail, _ = native.read(p, offset=490, frames=100)
    assert tail.shape == (10, 2)
    empty, _ = native.read(p, offset=10_000, frames=4)
    assert empty.shape == (0, 2)


@needs_native
def test_extra_chunks_and_extensible(tmp_path, stereo):
    """Odd-sized junk chunk before fmt + WAVE_FORMAT_EXTENSIBLE header."""
    pcm = np.round(stereo * 32767).astype("<i2").tobytes()
    fmt = (np.array([0xFFFE, 2], "<u2").tobytes()
           + np.array([16000, 16000 * 4], "<u4").tobytes()
           + np.array([4, 16, 22, 16], "<u2").tobytes()
           + np.array([4], "<u4").tobytes()
           + np.array([1], "<u2").tobytes() + b"\x00" * 14)  # PCM GUID head
    junk = b"JUNK" + np.array([3], "<u4").tobytes() + b"odd\x00"  # padded
    body = (junk + b"fmt " + np.array([len(fmt)], "<u4").tobytes() + fmt
            + b"data" + np.array([len(pcm)], "<u4").tobytes() + pcm)
    blob = b"RIFF" + np.array([4 + len(body)], "<u4").tobytes() + b"WAVE" \
        + body
    p = str(tmp_path / "d.wav")
    with open(p, "wb") as fh:
        fh.write(blob)
    y, sr = native.read(p)
    assert sr == 16000
    np.testing.assert_allclose(y, np.round(stereo * 32767) / 32768.0)


@needs_native
def test_error_paths(tmp_path):
    with pytest.raises(OSError):
        native.read(str(tmp_path / "missing.wav"))
    bad = str(tmp_path / "bad.wav")
    with open(bad, "wb") as fh:
        fh.write(b"NOTAWAVFILE" * 8)
    with pytest.raises(ValueError, match="RIFF"):
        native.read(bad)
    with pytest.raises(ValueError, match="bits"):
        native.write(bad, np.zeros((4, 1)), 8000, bits=12)


def test_audioobject_uses_same_convention(tmp_path, stereo):
    """AudioObject round-trips identically whichever backend serves it."""
    p = str(tmp_path / "e.wav")
    wavwrite(stereo, 16000, p)
    obj = AudioObject(p)
    assert obj.samplerate == 16000 and obj.channels == 2
    assert np.abs(obj.data - stereo).max() < 2 ** -14
    data, sr = wavread(p)
    np.testing.assert_array_equal(data, obj.data)
    blk, sr2 = wavread_block(p, 50, 25)
    np.testing.assert_array_equal(blk, data[50:75])


@needs_native
def test_corrupt_block_align_ignored(tmp_path, stereo):
    """block_align is attacker-controlled and must never be trusted: a
    stereo 16-bit file claiming block_align=1 would otherwise report 4x
    the frame count and read out-of-bounds heap as samples."""
    p = str(tmp_path / "ba.wav")
    native.write(p, stereo, 16000, bits=16)
    blob = bytearray(open(p, "rb").read())
    # standard canonical header: fmt chunk data starts at byte 20;
    # block_align is at offset 12 within it (byte 32 of the file)
    assert blob[12:16] == b"fmt "
    assert int.from_bytes(blob[32:34], "little") == 4  # sanity: 2ch * 2B
    for bad in (1, 2, 8, 0xFFFF):
        blob[32:34] = int(bad).to_bytes(2, "little")
        with open(p, "wb") as fh:
            fh.write(blob)
        info = native.info(p)
        assert info["frames"] == 500 and info["channels"] == 2
        y, sr = native.read(p)
        assert y.shape == (500, 2)
        np.testing.assert_array_equal(
            y, np.round(stereo * 32767).astype(np.int16) / 32768.0)


@needs_native
def test_fuzzed_headers_never_crash(tmp_path, rng):
    """Mutated/truncated WAV headers must raise clean Python errors (the
    parser is native C++: robustness against malformed input is a safety
    property, not a nicety)."""
    base = str(tmp_path / "f.wav")
    native.write(base, np.zeros((64, 2)), 8000, bits=16)
    blob = bytearray(open(base, "rb").read())
    for trial in range(200):
        mutated = bytearray(blob)
        for _ in range(rng.integers(1, 6)):
            mutated[rng.integers(0, min(64, len(mutated)))] = \
                int(rng.integers(0, 256))
        if rng.random() < 0.3:
            mutated = mutated[:rng.integers(0, len(mutated))]
        p = str(tmp_path / "m.wav")
        with open(p, "wb") as fh:
            fh.write(mutated)
        try:
            native.read(p)
            native.info(p)
        except (ValueError, OSError):
            pass  # clean error is the contract; a crash would kill pytest
