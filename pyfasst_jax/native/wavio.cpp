// Native WAV reader/writer: the framework's host-side audio data loader.
//
// Reference parity: pyfasst/audioObject.py wraps scipy/wave for whole-file
// reads (UNVERIFIED symbol names; mount empty -- see SURVEY.md). This module
// is the native-runtime equivalent: a self-contained RIFF/WAVE codec with
//   * block reads (offset + frame count) so the streaming/online GEM path
//     (ops/online.py) can page long recordings without loading them whole,
//   * PCM u8/16/24/32 and IEEE float32/64 decode (scipy has no 24-bit),
//   * PCM 16/24/32 and float32 encode,
//   * the GIL released around all file I/O so a Python-side prefetch thread
//     overlaps decode with device compute.
// Built on demand by pyfasst_jax/native/__init__.py (g++ -O3 -shared);
// pyfasst_jax/audio.py falls back to scipy when the toolchain is absent.

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct WavInfo {
  uint16_t format = 0;       // 1 = PCM, 3 = IEEE float (post-EXTENSIBLE)
  uint16_t channels = 0;
  uint32_t samplerate = 0;
  uint16_t block_align = 0;
  uint16_t bits = 0;
  long data_offset = 0;      // byte offset of the sample data
  uint32_t data_bytes = 0;
};

bool read_exact(FILE* f, void* dst, size_t n) {
  return std::fread(dst, 1, n, f) == n;
}

uint32_t le32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t le16(const unsigned char* p) {
  return (uint16_t)((uint16_t)p[0] | ((uint16_t)p[1] << 8));
}

// Parse the RIFF chunk list. Returns empty string on success, else an error
// message (no Python calls here: runs without the GIL).
std::string parse_header(FILE* f, WavInfo* wi) {
  unsigned char hdr[12];
  if (!read_exact(f, hdr, 12)) return "not a WAV file (short header)";
  if (std::memcmp(hdr, "RIFF", 4) != 0 || std::memcmp(hdr + 8, "WAVE", 4) != 0)
    return "not a WAV file (missing RIFF/WAVE magic)";
  bool have_fmt = false, have_data = false;
  while (!have_data || !have_fmt) {
    unsigned char ch[8];
    if (!read_exact(f, ch, 8)) {
      if (have_fmt && have_data) break;
      return "truncated WAV: missing fmt or data chunk";
    }
    uint32_t size = le32(ch + 4);
    if (std::memcmp(ch, "fmt ", 4) == 0) {
      if (size < 16 || size > 1 << 20)  // corrupt sizes would be allocated
        return "malformed fmt chunk";
      std::vector<unsigned char> buf(size);
      if (!read_exact(f, buf.data(), size))
        return "malformed fmt chunk";
      wi->format = le16(&buf[0]);
      wi->channels = le16(&buf[2]);
      wi->samplerate = le32(&buf[4]);
      wi->block_align = le16(&buf[12]);
      wi->bits = le16(&buf[14]);
      if (wi->format == 0xFFFE) {  // WAVE_FORMAT_EXTENSIBLE
        if (size < 40) return "malformed extensible fmt chunk";
        wi->format = le16(&buf[24]);  // first 2 bytes of the SubFormat GUID
      }
      have_fmt = true;
    } else if (std::memcmp(ch, "data", 4) == 0) {
      wi->data_offset = std::ftell(f);
      wi->data_bytes = size;
      have_data = true;
      if (std::fseek(f, (long)size + (size & 1), SEEK_CUR) != 0) {
        // data chunk runs to EOF (common for streamed writers): tolerate
        std::fseek(f, 0, SEEK_END);
        long end = std::ftell(f);
        if (end > wi->data_offset)
          wi->data_bytes = (uint32_t)(end - wi->data_offset);
      }
    } else {
      if (std::fseek(f, (long)size + (size & 1), SEEK_CUR) != 0)
        return "truncated WAV chunk";
    }
  }
  if (wi->channels == 0 || wi->samplerate == 0)
    return "malformed fmt chunk (zero channels or samplerate)";
  // clamp the declared data size to what the file actually holds: fseek
  // past EOF succeeds on POSIX, so a corrupt size field would otherwise
  // survive parsing and demand a multi-GB buffer before the read fails
  // (std::bad_alloc aborts the process on memory-constrained hosts).
  std::fseek(f, 0, SEEK_END);
  long file_end = std::ftell(f);
  if (file_end >= wi->data_offset) {
    uint32_t avail = (uint32_t)(file_end - wi->data_offset);
    if (wi->data_bytes > avail) wi->data_bytes = avail;
  } else {
    wi->data_bytes = 0;
  }
  // block_align is attacker-controlled: decode() consumes
  // frames*channels*(bits/8) bytes, so a too-small declared block_align
  // would over-count frames and read past the raw buffer. Never trust it;
  // derive from channels/bits (the only layout decode() supports).
  wi->block_align = (uint16_t)(wi->channels * ((wi->bits + 7) / 8));
  if (wi->block_align == 0) return "malformed fmt chunk (zero block align)";
  if (wi->format == 1) {
    if (wi->bits != 8 && wi->bits != 16 && wi->bits != 24 && wi->bits != 32)
      return "unsupported PCM bit depth";
  } else if (wi->format == 3) {
    if (wi->bits != 32 && wi->bits != 64)
      return "unsupported float bit depth";
  } else {
    return "unsupported WAV format code (only PCM and IEEE float)";
  }
  return "";
}

// Decode `frames` frames of raw sample data into normalized float64.
void decode(const unsigned char* src, double* dst, long frames, int channels,
            uint16_t format, uint16_t bits) {
  const long n = frames * channels;
  if (format == 3 && bits == 32) {
    for (long i = 0; i < n; i++) {
      float v;
      std::memcpy(&v, src + 4 * i, 4);
      dst[i] = (double)v;
    }
  } else if (format == 3 && bits == 64) {
    for (long i = 0; i < n; i++) std::memcpy(&dst[i], src + 8 * i, 8);
  } else if (bits == 8) {  // PCM u8 is unsigned
    for (long i = 0; i < n; i++) dst[i] = ((int)src[i] - 128) / 128.0;
  } else if (bits == 16) {
    for (long i = 0; i < n; i++) {
      int16_t v = (int16_t)le16(src + 2 * i);
      dst[i] = v / 32768.0;
    }
  } else if (bits == 24) {
    for (long i = 0; i < n; i++) {
      const unsigned char* p = src + 3 * i;
      int32_t v = (int32_t)((uint32_t)p[0] | ((uint32_t)p[1] << 8) |
                            ((uint32_t)p[2] << 16));
      if (v & 0x800000) v |= ~0xFFFFFF;  // sign-extend
      dst[i] = v / 8388608.0;
    }
  } else {  // PCM 32
    for (long i = 0; i < n; i++) {
      int32_t v = (int32_t)le32(src + 4 * i);
      dst[i] = v / 2147483648.0;
    }
  }
}

PyObject* py_info(PyObject*, PyObject* args) {
  const char* path;
  if (!PyArg_ParseTuple(args, "s", &path)) return nullptr;
  WavInfo wi;
  std::string err;
  Py_BEGIN_ALLOW_THREADS
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = "cannot open file";
  } else {
    err = parse_header(f, &wi);
    std::fclose(f);
  }
  Py_END_ALLOW_THREADS
  if (err == "cannot open file")
    return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
  if (!err.empty()) {
    PyErr_Format(PyExc_ValueError, "%s: %s", path, err.c_str());
    return nullptr;
  }
  long frames = wi.data_bytes / wi.block_align;
  return Py_BuildValue("{s:i, s:i, s:l, s:i, s:s}", "samplerate",
                       (int)wi.samplerate, "channels", (int)wi.channels,
                       "frames", frames, "bits", (int)wi.bits, "format",
                       wi.format == 3 ? "float" : "pcm");
}

PyObject* py_read(PyObject*, PyObject* args, PyObject* kwargs) {
  const char* path;
  long offset = 0, want = -1;
  static const char* kwlist[] = {"path", "offset", "frames", nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "s|ll",
                                   const_cast<char**>(kwlist), &path, &offset,
                                   &want))
    return nullptr;
  if (offset < 0) {
    PyErr_SetString(PyExc_ValueError, "offset must be >= 0");
    return nullptr;
  }
  WavInfo wi;
  std::string err;
  std::vector<unsigned char> raw;
  long frames = 0;
  Py_BEGIN_ALLOW_THREADS
  FILE* f = std::fopen(path, "rb");
  if (!f) {
    err = "cannot open file";
  } else {
    err = parse_header(f, &wi);
    if (err.empty()) {
      long total = wi.data_bytes / wi.block_align;
      long start = offset < total ? offset : total;
      frames = total - start;
      if (want >= 0 && want < frames) frames = want;
      raw.resize((size_t)frames * wi.block_align);
      if (std::fseek(f, wi.data_offset + start * wi.block_align, SEEK_SET) !=
              0 ||
          !read_exact(f, raw.data(), raw.size()))
        err = "truncated sample data";
    }
    std::fclose(f);
  }
  Py_END_ALLOW_THREADS
  if (err == "cannot open file")
    return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
  if (!err.empty()) {
    PyErr_Format(PyExc_ValueError, "%s: %s", path, err.c_str());
    return nullptr;
  }
  npy_intp dims[2] = {frames, wi.channels};
  PyObject* arr = PyArray_SimpleNew(2, dims, NPY_FLOAT64);
  if (!arr) return nullptr;
  double* dst = (double*)PyArray_DATA((PyArrayObject*)arr);
  Py_BEGIN_ALLOW_THREADS
  decode(raw.data(), dst, frames, wi.channels, wi.format, wi.bits);
  Py_END_ALLOW_THREADS
  return Py_BuildValue("(Ni)", arr, (int)wi.samplerate);
}

void put_le32(std::vector<unsigned char>& v, uint32_t x) {
  v.push_back(x & 0xFF);
  v.push_back((x >> 8) & 0xFF);
  v.push_back((x >> 16) & 0xFF);
  v.push_back((x >> 24) & 0xFF);
}
void put_le16(std::vector<unsigned char>& v, uint16_t x) {
  v.push_back(x & 0xFF);
  v.push_back((x >> 8) & 0xFF);
}

PyObject* py_write(PyObject*, PyObject* args, PyObject* kwargs) {
  const char* path;
  PyObject* data_obj;
  int samplerate, bits = 16;
  static const char* kwlist[] = {"path", "data", "samplerate", "bits",
                                 nullptr};
  if (!PyArg_ParseTupleAndKeywords(args, kwargs, "sOi|i",
                                   const_cast<char**>(kwlist), &path,
                                   &data_obj, &samplerate, &bits))
    return nullptr;
  if (bits != 16 && bits != 24 && bits != 32) {
    PyErr_SetString(PyExc_ValueError, "bits must be 16, 24, or 32 (float32)");
    return nullptr;
  }
  PyArrayObject* arr = (PyArrayObject*)PyArray_FROMANY(
      data_obj, NPY_FLOAT64, 2, 2, NPY_ARRAY_C_CONTIGUOUS | NPY_ARRAY_ALIGNED);
  if (!arr) return nullptr;
  const long frames = (long)PyArray_DIM(arr, 0);
  const int channels = (int)PyArray_DIM(arr, 1);
  const double* src = (const double*)PyArray_DATA(arr);
  const long n = frames * channels;
  const int bytes_per = bits / 8;
  const uint32_t data_bytes = (uint32_t)(n * bytes_per);

  std::vector<unsigned char> out;
  out.reserve(44 + data_bytes);
  out.insert(out.end(), {'R', 'I', 'F', 'F'});
  put_le32(out, 36 + data_bytes);
  out.insert(out.end(), {'W', 'A', 'V', 'E', 'f', 'm', 't', ' '});
  put_le32(out, 16);
  put_le16(out, bits == 32 ? 3 : 1);  // float32 for bits=32
  put_le16(out, (uint16_t)channels);
  put_le32(out, (uint32_t)samplerate);
  put_le32(out, (uint32_t)(samplerate * channels * bytes_per));
  put_le16(out, (uint16_t)(channels * bytes_per));
  put_le16(out, (uint16_t)bits);
  out.insert(out.end(), {'d', 'a', 't', 'a'});
  put_le32(out, data_bytes);

  std::string err;
  Py_BEGIN_ALLOW_THREADS
  out.resize(44 + data_bytes);
  unsigned char* p = out.data() + 44;
  if (bits == 16) {
    for (long i = 0; i < n; i++) {
      double v = src[i];
      v = v < -1.0 ? -1.0 : (v > 1.0 ? 1.0 : v);
      int32_t q = (int32_t)std::lrint(v * 32767.0);
      p[2 * i] = q & 0xFF;
      p[2 * i + 1] = (q >> 8) & 0xFF;
    }
  } else if (bits == 24) {
    for (long i = 0; i < n; i++) {
      double v = src[i];
      v = v < -1.0 ? -1.0 : (v > 1.0 ? 1.0 : v);
      int32_t q = (int32_t)std::lrint(v * 8388607.0);
      p[3 * i] = q & 0xFF;
      p[3 * i + 1] = (q >> 8) & 0xFF;
      p[3 * i + 2] = (q >> 16) & 0xFF;
    }
  } else {  // float32
    for (long i = 0; i < n; i++) {
      float v = (float)src[i];
      std::memcpy(p + 4 * i, &v, 4);
    }
  }
  FILE* f = std::fopen(path, "wb");
  if (!f) {
    err = "cannot open file";
  } else {
    if (std::fwrite(out.data(), 1, out.size(), f) != out.size())
      err = "short write";
    if (std::fclose(f) != 0 && err.empty()) err = "close failed";
  }
  Py_END_ALLOW_THREADS
  Py_DECREF(arr);
  if (err == "cannot open file")
    return PyErr_SetFromErrnoWithFilename(PyExc_OSError, path);
  if (!err.empty()) {
    PyErr_Format(PyExc_OSError, "%s: %s", path, err.c_str());
    return nullptr;
  }
  Py_RETURN_NONE;
}

PyMethodDef methods[] = {
    {"info", py_info, METH_VARARGS,
     "info(path) -> dict(samplerate, channels, frames, bits, format)"},
    {"read", (PyCFunction)(void*)py_read, METH_VARARGS | METH_KEYWORDS,
     "read(path, offset=0, frames=-1) -> (float64 (n, ch) in [-1,1], "
     "samplerate). offset/frames select a block (streaming reads)."},
    {"write", (PyCFunction)(void*)py_write, METH_VARARGS | METH_KEYWORDS,
     "write(path, data (n, ch) float in [-1,1], samplerate, bits=16). "
     "bits: 16/24 (PCM) or 32 (IEEE float32)."},
    {nullptr, nullptr, 0, nullptr}};

PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_wavio",
                         "Native WAV codec (see wavio.cpp)", -1, methods};

}  // namespace

PyMODINIT_FUNC PyInit__wavio(void) {
  import_array();
  return PyModule_Create(&moduledef);
}
