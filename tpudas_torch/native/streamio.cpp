// streamio: native ingest runtime for the tpudas edge path.
//
// The reference stack funnels every interrogator byte through
// libhdf5/pytables (reference lf_das.py:232 via DASCore's "dasdae"
// format). That is fine for archival, but the real-time loop's
// host-side hot cost is window assembly — read + merge of the
// overlap-save window before the device kernel runs (SURVEY.md §3.1
// hot loops #2/#3). This library provides the TPU-feed-rate
// alternative: a flat binary stream format ("tdas") an interrogator
// can append with O(1) framing, plus threaded range readers that
// convert (optionally int16-quantized) samples straight into the
// pinned float32 window buffer the device DMA consumes.
//
// Layout (little-endian):
//   0  : magic "TDAS"
//   4  : u32 version (=1)
//   8  : u64 t0_ns   epoch ns of first sample
//   16 : u64 dt_ns   sample interval ns
//   24 : u32 n_time
//   28 : u32 n_ch
//   32 : u32 dtype   0=float32, 1=int16 (scaled)
//   36 : f32 scale   physical = raw * scale (int16 only)
//   40 : f64 d0      first channel distance (m)
//   48 : f64 dx      channel spacing (m)
//   56 : u64 reserved
//   64 : payload, row-major (n_time, n_ch)
//
// All functions return 0 on success or a positive errno-style code.

#include <atomic>
#include <cerrno>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint32_t kMagic = 0x53414454;  // "TDAS" little-endian
constexpr uint32_t kVersion = 1;
constexpr size_t kHeaderSize = 64;

#pragma pack(push, 1)
struct TdasHeader {
  uint32_t magic;
  uint32_t version;
  uint64_t t0_ns;
  uint64_t dt_ns;
  uint32_t n_time;
  uint32_t n_ch;
  uint32_t dtype;  // 0=f32, 1=i16
  float scale;
  double d0;
  double dx;
  uint64_t reserved;
};
#pragma pack(pop)

static_assert(sizeof(TdasHeader) == kHeaderSize, "header must be 64 bytes");

size_t dtype_size(uint32_t dtype) { return dtype == 1 ? 2 : 4; }

int read_header_fd(int fd, TdasHeader* h) {
  ssize_t got = pread(fd, h, kHeaderSize, 0);
  if (got != static_cast<ssize_t>(kHeaderSize)) return EIO;
  if (h->magic != kMagic) return EINVAL;
  if (h->version != kVersion) return ENOTSUP;
  // known dtype codes only (0=f32, 1=i16): a corrupt/future file must
  // fail consistently with the python reader, not decode as f32 noise
  if (h->dtype != 0 && h->dtype != 1) return EINVAL;
  return 0;
}

int pread_full(int fd, void* dst, size_t bytes, off_t off) {
  size_t done = 0;
  while (done < bytes) {
    ssize_t got = pread(fd, static_cast<unsigned char*>(dst) + done,
                        bytes - done, off + static_cast<off_t>(done));
    if (got <= 0) return EIO;
    done += static_cast<size_t>(got);
  }
  return 0;
}

// Read rows [t_lo, t_hi) x channels [c_lo, c_hi) of one open file into
// out (row-major (t_hi-t_lo, c_hi-c_lo) f32), converting i16 if
// needed. IO is done in multi-MB contiguous preads (one syscall per
// ~8 MB, not per row); channel sub-spans are extracted from the
// chunk buffer in memory.
int read_rows(int fd, const TdasHeader& h, uint64_t t_lo, uint64_t t_hi,
              uint32_t c_lo, uint32_t c_hi, float* out) {
  const size_t es = dtype_size(h.dtype);
  const size_t row_bytes = static_cast<size_t>(h.n_ch) * es;
  const size_t span_ch = c_hi - c_lo;

  // fast path: full rows, already float32 — one contiguous read
  if (c_lo == 0 && c_hi == h.n_ch && h.dtype == 0) {
    return pread_full(fd, out, (t_hi - t_lo) * row_bytes,
                      static_cast<off_t>(kHeaderSize + t_lo * row_bytes));
  }

  const size_t rows_per_chunk =
      std::max<size_t>(1, (size_t{8} << 20) / row_bytes);
  std::vector<unsigned char> buf(rows_per_chunk * row_bytes);
  for (uint64_t t = t_lo; t < t_hi; t += rows_per_chunk) {
    const uint64_t n = std::min<uint64_t>(rows_per_chunk, t_hi - t);
    int rc = pread_full(fd, buf.data(), n * row_bytes,
                        static_cast<off_t>(kHeaderSize + t * row_bytes));
    if (rc != 0) return rc;
    for (uint64_t r = 0; r < n; ++r) {
      const unsigned char* src =
          buf.data() + r * row_bytes + static_cast<size_t>(c_lo) * es;
      float* orow = out + (t - t_lo + r) * span_ch;
      if (h.dtype == 1) {
        const int16_t* raw = reinterpret_cast<const int16_t*>(src);
        for (size_t c = 0; c < span_ch; ++c)
          orow[c] = static_cast<float>(raw[c]) * h.scale;
      } else {
        std::memcpy(orow, src, span_ch * es);
      }
    }
  }
  return 0;
}

// Raw variant of read_rows: channel-slice memcpy only, NO numeric
// conversion — feeds the device-decode ingest path, where quantized
// int16 samples cross PCIe at half the float32 byte count and the TPU
// does the (cast * scale) decode.
int read_rows_raw(int fd, const TdasHeader& h, uint64_t t_lo, uint64_t t_hi,
                  uint32_t c_lo, uint32_t c_hi, unsigned char* out) {
  const size_t es = dtype_size(h.dtype);
  const size_t row_bytes = static_cast<size_t>(h.n_ch) * es;
  const size_t span_ch = c_hi - c_lo;
  if (c_lo == 0 && c_hi == h.n_ch) {
    return pread_full(fd, out, (t_hi - t_lo) * row_bytes,
                      static_cast<off_t>(kHeaderSize + t_lo * row_bytes));
  }
  const size_t rows_per_chunk =
      std::max<size_t>(1, (size_t{8} << 20) / row_bytes);
  std::vector<unsigned char> buf(rows_per_chunk * row_bytes);
  for (uint64_t t = t_lo; t < t_hi; t += rows_per_chunk) {
    const uint64_t n = std::min<uint64_t>(rows_per_chunk, t_hi - t);
    int rc = pread_full(fd, buf.data(), n * row_bytes,
                        static_cast<off_t>(kHeaderSize + t * row_bytes));
    if (rc != 0) return rc;
    for (uint64_t r = 0; r < n; ++r) {
      std::memcpy(out + (t - t_lo + r) * span_ch * es,
                  buf.data() + r * row_bytes + static_cast<size_t>(c_lo) * es,
                  span_ch * es);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

int tdas_write(const char* path, uint64_t t0_ns, uint64_t dt_ns,
               uint32_t n_time, uint32_t n_ch, uint32_t dtype, float scale,
               double d0, double dx, const void* data) {
  TdasHeader h{};
  h.magic = kMagic;
  h.version = kVersion;
  h.t0_ns = t0_ns;
  h.dt_ns = dt_ns;
  h.n_time = n_time;
  h.n_ch = n_ch;
  h.dtype = dtype;
  h.scale = scale;
  h.d0 = d0;
  h.dx = dx;
  FILE* f = std::fopen(path, "wb");
  if (!f) return errno ? errno : EIO;
  const size_t payload =
      static_cast<size_t>(n_time) * n_ch * dtype_size(dtype);
  int rc = 0;
  if (std::fwrite(&h, 1, kHeaderSize, f) != kHeaderSize) rc = EIO;
  if (rc == 0 && std::fwrite(data, 1, payload, f) != payload) rc = EIO;
  if (std::fclose(f) != 0 && rc == 0) rc = EIO;
  return rc;
}

int tdas_read_header(const char* path, uint64_t* t0_ns, uint64_t* dt_ns,
                     uint32_t* n_time, uint32_t* n_ch, uint32_t* dtype,
                     float* scale, double* d0, double* dx) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return errno ? errno : EIO;
  TdasHeader h;
  int rc = read_header_fd(fd, &h);
  close(fd);
  if (rc != 0) return rc;
  *t0_ns = h.t0_ns;
  *dt_ns = h.dt_ns;
  *n_time = h.n_time;
  *n_ch = h.n_ch;
  *dtype = h.dtype;
  *scale = h.scale;
  *d0 = h.d0;
  *dx = h.dx;
  return 0;
}

// Threaded single-file block read: rows [t_lo, t_hi) x ch [c_lo, c_hi)
// into out (f32 row-major).
int tdas_read_block(const char* path, uint64_t t_lo, uint64_t t_hi,
                    uint32_t c_lo, uint32_t c_hi, float* out,
                    int n_threads) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return errno ? errno : EIO;
  TdasHeader h;
  int rc = read_header_fd(fd, &h);
  if (rc != 0) {
    close(fd);
    return rc;
  }
  if (t_hi > h.n_time || c_hi > h.n_ch || t_lo > t_hi || c_lo > c_hi) {
    close(fd);
    return ERANGE;
  }
  const uint64_t rows = t_hi - t_lo;
  const size_t span_ch = c_hi - c_lo;
  if (n_threads < 1) n_threads = 1;
  const uint64_t min_rows_per_thread = 2048;
  uint64_t want =
      rows / min_rows_per_thread ? rows / min_rows_per_thread : 1;
  if (static_cast<uint64_t>(n_threads) > want)
    n_threads = static_cast<int>(want);

  std::atomic<int> err{0};
  std::vector<std::thread> workers;
  const uint64_t chunk = (rows + n_threads - 1) / n_threads;
  for (int i = 0; i < n_threads; ++i) {
    const uint64_t lo = t_lo + static_cast<uint64_t>(i) * chunk;
    if (lo >= t_hi) break;
    const uint64_t hi = std::min(t_hi, lo + chunk);
    workers.emplace_back([&, lo, hi]() {
      int r = read_rows(fd, h, lo, hi, c_lo, c_hi,
                        out + (lo - t_lo) * span_ch);
      if (r != 0) err.store(r);
    });
  }
  for (auto& w : workers) w.join();
  close(fd);
  return err.load();
}

// Parallel multi-file window assembly: for file i, copy rows
// [row_lo[i], row_hi[i]) x ch [c_lo, c_hi) into out starting at output
// row out_row0[i]. Files are processed by a pool of n_threads workers
// pulling from an atomic queue — this is the host half of the
// overlap-save window pipeline.
int tdas_assemble_window(const char** paths, const uint64_t* row_lo,
                         const uint64_t* row_hi, const uint64_t* out_row0,
                         int n_files, uint32_t c_lo, uint32_t c_hi,
                         float* out, int n_threads) {
  if (n_files < 0) return EINVAL;
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  const size_t span_ch = c_hi - c_lo;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files || err.load() != 0) return;
      int rc = tdas_read_block(paths[i], row_lo[i], row_hi[i], c_lo, c_hi,
                               out + out_row0[i] * span_ch, 1);
      if (rc != 0) err.store(rc);
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files;
  std::vector<std::thread> workers;
  for (int i = 0; i < n_threads; ++i) workers.emplace_back(worker);
  for (auto& w : workers) w.join();
  return err.load();
}

// Raw (no-conversion) multi-file window assembly into a payload-dtype
// buffer: every file must carry `expect_dtype` or the call fails with
// EINVAL (the planner guarantees uniformity; this re-checks at the
// byte level). Same worker-pool structure as tdas_assemble_window.
int tdas_assemble_window_raw(const char** paths, const uint64_t* row_lo,
                             const uint64_t* row_hi,
                             const uint64_t* out_row0, int n_files,
                             uint32_t c_lo, uint32_t c_hi,
                             uint32_t expect_dtype, unsigned char* out,
                             int n_threads) {
  if (n_files < 0) return EINVAL;
  if (expect_dtype != 0 && expect_dtype != 1) return EINVAL;
  const size_t es = dtype_size(expect_dtype);
  std::atomic<int> next{0};
  std::atomic<int> err{0};
  const size_t span_ch = c_hi - c_lo;
  auto worker = [&]() {
    for (;;) {
      int i = next.fetch_add(1);
      if (i >= n_files || err.load() != 0) return;
      int fd = open(paths[i], O_RDONLY);
      if (fd < 0) {
        err.store(errno ? errno : EIO);
        return;
      }
      TdasHeader h;
      int rc = read_header_fd(fd, &h);
      if (rc == 0 && h.dtype != expect_dtype) rc = EINVAL;
      if (rc == 0 &&
          (row_hi[i] > h.n_time || c_hi > h.n_ch || row_lo[i] > row_hi[i] ||
           c_lo > c_hi))
        rc = ERANGE;
      if (rc == 0)
        rc = read_rows_raw(fd, h, row_lo[i], row_hi[i], c_lo, c_hi,
                           out + out_row0[i] * span_ch * es);
      close(fd);
      if (rc != 0) err.store(rc);
    }
  };
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_files) n_threads = n_files;
  std::vector<std::thread> workers;
  for (int i = 0; i < n_threads; ++i) workers.emplace_back(worker);
  for (auto& w : workers) w.join();
  return err.load();
}

}  // extern "C"
