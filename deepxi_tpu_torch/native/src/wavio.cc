// Native wav decode / encode / batch assembly for the deepxi_tpu_torch host
// runtime (the port's own copy of deepxi_tpu/native/src/wavio.cc; the code
// is the same, so both packages decode the same samples).
//
// The reference's host IO path is native already: soundfile/librosa ride
// libsndfile (C) and the training pipeline rides tf.data's C++ runtime
// (ref: deepxi/utils.py:18-50, deepxi/model.py:1953-2012).  This is the
// port's equivalent: a small compiled layer that decodes RIFF PCM wavs
// straight into the loader's preallocated int16 batch buffers with a real
// (GIL-free) thread pool.  Anything it cannot handle natively (resampling,
// float wavs) reports DXT_FALLBACK and the Python path takes over, so
// behaviour is a strict superset of deepxi_tpu_torch/data/wavio.py.
//
// Exported C ABI (consumed by deepxi_tpu_torch/native/__init__.py via ctypes):
//   dxt_read_wav_i16   decode one file (optionally from a sample offset)
//   dxt_wav_len        sample count at the target rate without decoding
//   dxt_save_wav_i16   write 16-bit PCM mono
//   dxt_load_batch     thread-pooled batch decode into [B, L] int16
//
// Error codes are negative and never abort the process: the Python side
// maps them to its fallback decoder.

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr int DXT_ERR = -1;       // unreadable / malformed file
constexpr int DXT_FALLBACK = -2;  // valid wav but needs the Python decoder

struct Mapped {
  const uint8_t* p = nullptr;
  size_t n = 0;
  int fd = -1;
  bool ok() const { return p != nullptr; }
  ~Mapped() {
    if (p) munmap(const_cast<uint8_t*>(p), n);
    if (fd >= 0) close(fd);
  }
};

bool map_file(const char* path, Mapped* m) {
  m->fd = open(path, O_RDONLY);
  if (m->fd < 0) return false;
  struct stat st;
  if (fstat(m->fd, &st) != 0 || st.st_size < 12) return false;
  void* p = mmap(nullptr, (size_t)st.st_size, PROT_READ, MAP_PRIVATE, m->fd, 0);
  if (p == MAP_FAILED) return false;
  m->p = static_cast<const uint8_t*>(p);
  m->n = (size_t)st.st_size;
  return true;
}

uint32_t rd_u32(const uint8_t* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}
uint16_t rd_u16(const uint8_t* p) { return (uint16_t)p[0] | ((uint16_t)p[1] << 8); }

struct WavInfo {
  uint16_t format = 0;   // 1 = PCM (0xFFFE resolved via subformat)
  uint16_t n_ch = 0;
  uint32_t rate = 0;
  uint16_t bits = 0;
  const uint8_t* data = nullptr;  // payload
  size_t data_len = 0;            // bytes
  long n_frames() const {
    size_t bpf = (size_t)n_ch * (bits / 8);
    return bpf ? (long)(data_len / bpf) : 0;
  }
};

// Parse the RIFF chunk list; returns 0 ok, DXT_ERR malformed.
int parse_wav(const Mapped& m, WavInfo* w) {
  const uint8_t* p = m.p;
  if (m.n < 12 || memcmp(p, "RIFF", 4) != 0 || memcmp(p + 8, "WAVE", 4) != 0)
    return DXT_ERR;
  size_t off = 12;
  bool have_fmt = false;
  while (off + 8 <= m.n) {
    const uint8_t* ck = p + off;
    uint32_t ck_len = rd_u32(ck + 4);
    size_t body = off + 8;
    if (body + ck_len > m.n) {
      // tolerate a truncated final data chunk the way stdlib `wave` does not:
      // clamp rather than reject, but only for data
      if (memcmp(ck, "data", 4) == 0) ck_len = (uint32_t)(m.n - body);
      else return DXT_ERR;
    }
    if (memcmp(ck, "fmt ", 4) == 0) {
      if (ck_len < 16) return DXT_ERR;
      w->format = rd_u16(ck + 8);
      w->n_ch = rd_u16(ck + 10);
      w->rate = rd_u32(ck + 12);
      w->bits = rd_u16(ck + 22);
      if (w->format == 0xFFFE && ck_len >= 40)
        w->format = rd_u16(ck + 8 + 24);  // extensible: first 2B of subformat
      have_fmt = true;
    } else if (memcmp(ck, "data", 4) == 0) {
      w->data = ck + 8;
      w->data_len = ck_len;
      if (have_fmt) return 0;  // fmt normally precedes data
    }
    off = body + ck_len + (ck_len & 1);  // chunks are 2-byte aligned
  }
  return (have_fmt && w->data) ? 0 : DXT_ERR;
}

// Decode up to max_out mono int16 samples starting at sample `offset`.
// Mirrors deepxi_tpu_torch/data/wavio.read_wav exactly for the supported cases:
// PCM 8/16/32-bit, any channel count (mean downmix), rate == f_s.
// Returns samples written (>= 0) with *total = full frame count, or an
// error code.
long decode(const WavInfo& w, int f_s, long offset, int16_t* out, long max_out,
            long* total) {
  if (w.format != 1) return DXT_FALLBACK;              // float/ADPCM -> Python
  if ((int)w.rate != f_s) return DXT_FALLBACK;         // resample -> Python
  if (w.bits != 16 && w.bits != 8 && w.bits != 32) return DXT_FALLBACK;
  if (w.n_ch == 0) return DXT_ERR;
  const long n = w.n_frames();
  *total = n;
  if (offset < 0) offset = 0;
  if (offset > n) offset = n;
  long count = n - offset;
  if (count > max_out) count = max_out;
  const int ch = w.n_ch;

  if (w.bits == 16 && ch == 1) {
    // identity fast path: clip(x/32768, -1, 1-1/32768)*32768 == x for all
    // int16, so this is a straight copy (little-endian host assumed)
    memcpy(out, w.data + 2 * offset, (size_t)count * 2);
    return count;
  }
  for (long i = 0; i < count; ++i) {
    const uint8_t* f = w.data + (size_t)(offset + i) * ch * (w.bits / 8);
    float acc = 0.f;
    for (int c = 0; c < ch; ++c) {
      const uint8_t* s = f + c * (w.bits / 8);
      if (w.bits == 16) {
        acc += (float)(int16_t)rd_u16(s) / 32768.0f;
      } else if (w.bits == 8) {
        acc += ((float)s[0] - 128.0f) / 128.0f;
      } else {  // 32
        acc += (float)(int32_t)rd_u32(s) / 2147483648.0f;
      }
    }
    float x = acc / (float)ch;
    if (x < -1.0f) x = -1.0f;
    const float hi = 1.0f - 1.0f / 32768.0f;
    if (x > hi) x = hi;
    out[i] = (int16_t)(x * 32768.0f);  // truncation toward zero, as numpy
  }
  return count;
}

}  // namespace

extern "C" {

// Decode `path` as int16 mono at f_s from sample `offset`; writes at most
// max_out samples into out. Returns samples written (>=0), DXT_ERR, or
// DXT_FALLBACK. *total_out (optional) receives the file's full frame count.
long dxt_read_wav_i16(const char* path, int f_s, long offset, int16_t* out,
                      long max_out, long* total_out) {
  Mapped m;
  if (!map_file(path, &m)) return DXT_ERR;
  WavInfo w;
  if (parse_wav(m, &w) != 0) return DXT_ERR;
  long total = 0;
  long r = decode(w, f_s, offset, out, max_out, &total);
  if (total_out) *total_out = total;
  return r;
}

// Sample count at the target rate without decoding. Handles rate mismatch
// (ceil(n*up/down), matching scipy.signal.resample_poly's output length and
// deepxi_tpu_torch/data/wavio.wav_length). Returns DXT_ERR on parse failure.
long dxt_wav_len(const char* path, int f_s) {
  Mapped m;
  if (!map_file(path, &m)) return DXT_ERR;
  WavInfo w;
  if (parse_wav(m, &w) != 0) return DXT_ERR;
  if (w.n_ch == 0 || w.bits < 8) return DXT_ERR;
  long n = w.n_frames();
  if ((int)w.rate == f_s) return n;
  if (w.rate == 0) return DXT_ERR;
  long g = f_s, b = w.rate;  // gcd
  while (b) { long t = g % b; g = b; b = t; }
  long up = f_s / g, down = w.rate / g;
  return (n * up + down - 1) / down;
}

// Write mono 16-bit PCM. Returns 0 ok, DXT_ERR on IO failure.
int dxt_save_wav_i16(const char* path, int f_s, const int16_t* data, long n) {
  FILE* fp = fopen(path, "wb");
  if (!fp) return DXT_ERR;
  uint32_t data_bytes = (uint32_t)(n * 2);
  uint8_t hdr[44];
  memcpy(hdr, "RIFF", 4);
  uint32_t riff = 36 + data_bytes;
  memcpy(hdr + 4, &riff, 4);
  memcpy(hdr + 8, "WAVEfmt ", 8);
  uint32_t fmt_len = 16; memcpy(hdr + 16, &fmt_len, 4);
  uint16_t fmt = 1, ch = 1; memcpy(hdr + 20, &fmt, 2); memcpy(hdr + 22, &ch, 2);
  uint32_t rate = (uint32_t)f_s; memcpy(hdr + 24, &rate, 4);
  uint32_t brate = rate * 2; memcpy(hdr + 28, &brate, 4);
  uint16_t align = 2, bits = 16;
  memcpy(hdr + 32, &align, 2); memcpy(hdr + 34, &bits, 2);
  memcpy(hdr + 36, "data", 4);
  memcpy(hdr + 40, &data_bytes, 4);
  bool ok = fwrite(hdr, 1, 44, fp) == 44 &&
            fwrite(data, 2, (size_t)n, fp) == (size_t)n;
  ok = (fclose(fp) == 0) && ok;
  return ok ? 0 : DXT_ERR;
}

// Thread-pooled batch decode: n files into out[n, L] (zero-padded), from
// per-file sample offsets. lens[i] <- samples written; status[i] <- 0 ok,
// DXT_ERR, or DXT_FALLBACK (row left zeroed; Python decodes it).
void dxt_load_batch(const char** paths, int n, int f_s, const long* offsets,
                    long L, int16_t* out, int* lens, int* status,
                    int n_threads) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads > 16) n_threads = 16;  // decode is IO/memcpy-bound
  if (n_threads > n) n_threads = n;
  if (n_threads < 1) n_threads = 1;
  std::atomic<int> next(0);
  auto work = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      int16_t* row = out + (size_t)i * L;
      long total = 0;
      long r = dxt_read_wav_i16(paths[i], f_s, offsets ? offsets[i] : 0,
                                row, L, &total);
      // zero only the undecoded tail (the buffer arrives uninitialised)
      long filled = r >= 0 ? r : 0;
      memset(row + filled, 0, (size_t)(L - filled) * 2);
      if (r >= 0) { lens[i] = (int)r; status[i] = 0; }
      else        { lens[i] = 0;      status[i] = (int)r; }
    }
  };
  std::vector<std::thread> ts;
  for (int t = 0; t < n_threads - 1; ++t) ts.emplace_back(work);
  work();
  for (auto& t : ts) t.join();
}

}  // extern "C"
