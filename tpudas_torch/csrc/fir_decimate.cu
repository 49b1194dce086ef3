// Strided (decimating) causal FIR along the time axis, for Hopper (sm_90a).
//
//     y[k, c] = sum_{j < L} h[j] * x[row0 + k*R + j, c]      k in [0, n_out)
//
// x is a (T, C) row-major window (channels contiguous), float32 or raw
// int16; rows below 0 or at or past T read as zero (the implicit right
// pad of the TPU kernel; a negative first row row0 stands for the left
// pad that aligns a window's first output with its phase, so no padded
// copy of the window is made).  h is the frame-blocked tap matrix (B, R)
// flattened to L = B*R taps (zero-padded past the true tap count).  y is
// (n_out, C) float32.
//
// Replaces the TPU kernel fir_decimate_pallas (tpudas/ops/pallas_fir.py:324,
// and its v1 form _fir_decimate_pallas_v1 at :269, which computes the same
// function).  The TPU kernel ran the FIR as a banded bf16 MXU matmul with a
// 3-pass split because the TPU's vector unit was slow; on this card a plain
// float32 FMA kernel is the right design, since the work is bound by
// memory: 2L/R flops per input sample, i.e. L/(2R) per float32 byte read
// (3 to 12.5 for the flagship 1 kHz -> 1 Hz stages), under the card's
// 67 TFLOP/s f32 : 3.35 TB/s HBM balance of ~20 flop/byte (and TF32 tensor
// cores cannot hold an int16 sample's 16 significant bits).  Its bound is
//     (rows read * C * sizeof(in) + n_out * C * 4) / 3.35 TB/s.
//
// fir_decimate_{f32,i16} (namespace v2), the stage the port runs:
// - a block owns a channel stripe of one 128-byte row segment (64 int16 or
//   32 f32 channels: each lane reads one 32-bit word of a staged row, two
//   int16 or one f32) and walks a run of consecutive units, a unit being
//   one time tile of K = 32 outputs of a stripe; the grid is one wave of
//   resident blocks (3 an SM at the flagship stages, by shared memory);
// - a tile's rows (K + B - 1) * R are staged with cp.async copies of 16
//   bytes (8 or 4 where the row pitch or the address allows no wider;
//   element loads for odd-width int16) into a 2-slot ring, the next
//   unit's copies in flight while this one is computed.  The copies'
//   source-size operand zero-fills rows outside [0, T) and channels past
//   C, so neither a negative first row nor a ragged edge needs a padded
//   copy; int16 stays int16 in shared memory (half the bytes);
// - a thread keeps KPT = 8 consecutive outputs of its channel(s) in
//   registers and slides a window over the frames of one tap phase: each
//   staged value is read once and applied to every output whose window
//   holds it ((KPT + B - 1) / (KPT * B * CPT) shared loads an FMA: 0.14 for
//   int16 stage 0, against 1.1 when each thread stages one value a row);
// - the four flagship geometries (R, B) are compiled as such: loops
//   unrolled, taps in registers (B * R <= 64) or at fixed shared-memory
//   offsets; any other geometry runs the same template with runtime (R, B)
//   and tap frames in chunks (up to 4095 taps), one broadcast tap load per
//   KPT outputs;
// - int16 is converted exactly without the conversion unit (see Lane);
//   sums run in float32, per tap phase then frame, per chunk then across
//   chunks.
//
// The launches use the caller's stream, do not synchronise and allocate
// nothing; the C entry points return cudaGetLastError() or the error that
// refused the geometry.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxSmem = 232448;  // per-block opt-in limit on sm_90

namespace v2 {

constexpr int KPT = 8;          // consecutive outputs a thread keeps
constexpr int NW = 4;           // warps a block
constexpr int NT = 32 * NW;     // threads a block
constexpr int K = NW * KPT;     // outputs a time tile
constexpr int ROW_BYTES = 128;  // a staged row: one 128-byte segment
constexpr int NS = 2;           // ring depth (tiles in shared memory)
constexpr int kMinBlocks = 3;   // blocks an SM the register cap allows

// How a lane turns the 32-bit word it reads from a staged row into its
// channels' values: one float32, or two int16 converted exactly without
// the conversion unit (2^23 + (v + 2^15) as a float bit pattern, less
// 2^23 + 2^15), which issues at a quarter of the FMA rate on sm_90.
template <typename Tin>
struct Lane;

template <>
struct Lane<float> {
  static constexpr int CPT = 1;  // channels a thread
  static __device__ __forceinline__ void get(uint32_t w, float* v) {
    v[0] = __uint_as_float(w);
  }
};

template <>
struct Lane<int16_t> {
  static constexpr int CPT = 2;
  static __device__ __forceinline__ void get(uint32_t w, float* v) {
    w ^= 0x80008000u;
    v[0] = __uint_as_float(__byte_perm(w, 0x4B00u, 0x5410)) - 8421376.0f;
    v[1] = __uint_as_float(__byte_perm(w, 0x4B00u, 0x5432)) - 8421376.0f;
  }
};

// One copy of VEC bytes from device memory into shared memory, or VEC
// zero bytes where ``ok`` is false (rows outside [0, T), channels past
// C): cp.async's source-size operand reads 0 bytes and fills zeros.
// VEC = 2 (odd-width int16 rows) has no cp.async form: a plain load.
template <int VEC>
__device__ __forceinline__ void copy_chunk(unsigned char* dst,
                                           const void* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (VEC == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(ok ? 16 : 0)
                 : "memory");
  } else if constexpr (VEC == 8 || VEC == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(VEC), "r"(ok ? VEC : 0)
                 : "memory");
  } else {
    static_assert(VEC == 2, "copy width");
    *reinterpret_cast<uint16_t*>(dst) =
        ok ? *reinterpret_cast<const uint16_t*>(src) : uint16_t(0);
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_pending() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows g0 .. g0 + nrows - 1 of the channel stripe starting at c0 into
// one ring slot, ROW_BYTES a row, every thread issuing its copies
// without waiting.
template <typename Tin, int VEC>
__device__ __forceinline__ void stage_rows(unsigned char* slot,
                                           const Tin* __restrict__ x,
                                           long long T, int C, long long g0,
                                           int nrows, int c0) {
  constexpr int EPC = VEC / static_cast<int>(sizeof(Tin));
  constexpr int CPR = ROW_BYTES / VEC;
  for (int i = threadIdx.x; i < nrows * CPR; i += NT) {
    const int r = i / CPR;
    const int q = i % CPR;
    const long long g = g0 + r;
    const int c = c0 + q * EPC;
    const bool ok = g >= 0 && g < T && c < C;
    copy_chunk<VEC>(slot + r * ROW_BYTES + q * VEC, ok ? x + g * C + c : x,
                    ok);
  }
}

template <typename Tin>
__device__ __forceinline__ void read_row(const unsigned char* lane_base,
                                         int row, float* v) {
  Lane<Tin>::get(*reinterpret_cast<const uint32_t*>(lane_base +
                                                    row * ROW_BYTES), v);
}

// Geometry (RC, BC) > 0: the stage's (R, B) at compile time, one tap
// chunk, loops unrolled (the four flagship stages); taps in registers
// where RC * BC <= 64, else in shared memory at fixed offsets.
// RC = BC = 0: any geometry, tap frames in chunks of bch.
template <typename Tin, int VEC, int RC, int BC>
__global__ void __launch_bounds__(NT, kMinBlocks)
fir_v2_kernel(const Tin* __restrict__ x, const float* __restrict__ taps,
              float* __restrict__ y, long long T, int C, int R_, int B_,
              int bch_, long long n_out, long long row0, long long tiles,
              long long units) {
  constexpr int CPT = Lane<Tin>::CPT;
  constexpr int TC = ROW_BYTES / static_cast<int>(sizeof(Tin));
  constexpr bool FIXED = RC > 0;
  constexpr bool REG_TAPS = FIXED && RC * BC <= 64;
  const int R = FIXED ? RC : R_;
  const int B = FIXED ? BC : B_;
  const int bch = FIXED ? BC : bch_;
  const int nchunk = (B + bch - 1) / bch;
  const int slot_bytes = (K + bch - 1) * R * ROW_BYTES;

  extern __shared__ __align__(16) unsigned char smem[];
  float* s_taps = reinterpret_cast<float*>(smem + NS * slot_bytes);
  const int lane = threadIdx.x & 31;
  const int kt = (threadIdx.x >> 5) * KPT;  // this thread's first output

  // this block's run of units (a unit: one time tile of one stripe,
  // consecutive units are consecutive tiles of a stripe)
  const long long u0 = static_cast<long long>(blockIdx.x) * units / gridDim.x;
  const long long u1 =
      static_cast<long long>(blockIdx.x + 1) * units / gridDim.x;
  const long long items = (u1 - u0) * nchunk;

  float h_reg[REG_TAPS ? RC * BC : 1];
  if constexpr (REG_TAPS) {
#pragma unroll
    for (int j = 0; j < RC * BC; ++j) h_reg[j] = __ldg(taps + j);
  } else {
    for (int j = threadIdx.x; j < B * R; j += NT) s_taps[j] = taps[j];
  }

  auto issue = [&](long long it) {
    if (it < items) {
      const long long u = u0 + it / nchunk;
      const int b0 = static_cast<int>(it % nchunk) * bch;
      const int nb = min(bch, B - b0);
      const long long tile = u % tiles;
      stage_rows<Tin, VEC>(smem + static_cast<int>(it % NS) * slot_bytes, x,
                           T, C, row0 + (tile * K + b0) * R, (K + nb - 1) * R,
                           static_cast<int>(u / tiles) * TC);
    }
    commit();
  };

  float acc[KPT][CPT];
#pragma unroll
  for (int s = 0; s < NS - 1; ++s) issue(s);
  for (long long it = 0; it < items; ++it) {
    issue(it + NS - 1);  // into the slot item it - 1 used
    wait_pending<NS - 1>();
    __syncthreads();
    const unsigned char* base =
        smem + static_cast<int>(it % NS) * slot_bytes + lane * 4;
    const int ch = static_cast<int>(it % nchunk);
    if constexpr (FIXED) {
      // sliding window: frame f of phase p is read once and applied to
      // each of the KPT outputs whose window holds it
      base += kt * RC * ROW_BYTES;
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
#pragma unroll
      for (int p = 0; p < RC; ++p) {
        float win[KPT][CPT];
#pragma unroll
        for (int i = 0; i < KPT - 1; ++i)
          read_row<Tin>(base, i * RC + p, win[i]);
#pragma unroll
        for (int b = 0; b < BC; ++b) {
          read_row<Tin>(base, (KPT - 1 + b) * RC + p, win[KPT - 1]);
          float h;
          if constexpr (REG_TAPS) {
            h = h_reg[b * RC + p];
          } else {
            h = s_taps[b * RC + p];
          }
#pragma unroll
          for (int i = 0; i < KPT; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              acc[i][c] = fmaf(h, win[i][c], acc[i][c]);
#pragma unroll
          for (int i = 0; i < KPT - 1; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c) win[i][c] = win[i + 1][c];
        }
      }
    } else {
      const int b0 = ch * bch;
      const int nb = min(bch, B - b0);
      base += kt * R * ROW_BYTES;
      if (ch == 0) {
#pragma unroll
        for (int i = 0; i < KPT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
      }
      float part[KPT][CPT];
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) part[i][c] = 0.f;
      for (int p = 0; p < R; ++p) {
        float win[KPT][CPT];
#pragma unroll
        for (int i = 0; i < KPT - 1; ++i)
          read_row<Tin>(base, i * R + p, win[i]);
        for (int b = 0; b < nb; ++b) {
          read_row<Tin>(base, (KPT - 1 + b) * R + p, win[KPT - 1]);
          const float h = s_taps[(b0 + b) * R + p];
#pragma unroll
          for (int i = 0; i < KPT; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c)
              part[i][c] = fmaf(h, win[i][c], part[i][c]);
#pragma unroll
          for (int i = 0; i < KPT - 1; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c) win[i][c] = win[i + 1][c];
        }
      }
#pragma unroll
      for (int i = 0; i < KPT; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] += part[i][c];
    }
    if (ch == nchunk - 1) {
      const long long u = u0 + it / nchunk;
      const long long k0 = (u % tiles) * K + kt;
      const int c = static_cast<int>(u / tiles) * TC + lane * CPT;
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        if (k0 + i >= n_out) break;
        float* row = y + (k0 + i) * C;
        if (CPT == 2 && (C & 1) == 0 && c + 1 < C) {
          *reinterpret_cast<float2*>(row + c) =
              make_float2(acc[i][0], acc[i][CPT - 1]);
        } else {
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            if (c + j < C) row[c + j] = acc[i][j];
        }
      }
    }
    __syncthreads();  // the slot is read; the next issue may refill it
  }
  wait_pending<0>();
}

template <typename Tin, int VEC, int RC, int BC>
int launch_geometry(const Tin* x, const float* taps, float* y, long long T,
                    int C, int R, int B, int bch, long long n_out,
                    long long row0, cudaStream_t stream) {
  auto kern = fir_v2_kernel<Tin, VEC, RC, BC>;
  constexpr bool REG_TAPS = RC > 0 && RC * BC <= 64;
  const long long smem = static_cast<long long>(NS) * (K + bch - 1) * R *
                             ROW_BYTES +
                         (REG_TAPS ? 0 : 4LL * B * R);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  // the resident blocks of the last (device, shared memory) this kernel
  // was launched with, packed with its key into one word: the occupancy
  // query costs more host time than a small stage's kernel
  static std::atomic<long long> memo{-1};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long key = (static_cast<long long>(dev) << 20) | smem;
  long long resident = 0;
  const long long seen = memo.load(std::memory_order_relaxed);
  if (seen >= 0 && (seen >> 32) == key) {
    resident = seen & 0xffffffffLL;
  } else {
    // the cap on dynamic shared memory is set to the most a block may
    // have, so no launch of this kernel ever lowers it under another's
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kern, NT, static_cast<size_t>(smem));
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    resident = static_cast<long long>(per_sm) * sms;
    memo.store((key << 32) | resident, std::memory_order_relaxed);
  }
  constexpr int TC = ROW_BYTES / static_cast<int>(sizeof(Tin));
  const long long tiles = (n_out + K - 1) / K;
  const long long units = tiles * ((C + TC - 1) / TC);
  const long long grid = units < resident ? units : resident;
  kern<<<static_cast<unsigned>(grid), NT, static_cast<size_t>(smem),
         stream>>>(x, taps, y, T, C, R, B, bch, n_out, row0, tiles, units);
  return static_cast<int>(cudaGetLastError());
}

template <typename Tin, int VEC>
int launch_width(const Tin* x, const float* taps, float* y, long long T,
                 int C, int R, int B, int bch, long long n_out,
                 long long row0, cudaStream_t stream) {
  if constexpr (VEC == 16) {
    if (bch == B) {  // the flagship stages, compiled for their geometry
      if (R == 8 && B == 6)
        return launch_geometry<Tin, VEC, 8, 6>(x, taps, y, T, C, R, B, bch,
                                               n_out, row0, stream);
      if (R == 5 && B == 6)
        return launch_geometry<Tin, VEC, 5, 6>(x, taps, y, T, C, R, B, bch,
                                               n_out, row0, stream);
      if (R == 5 && B == 7)
        return launch_geometry<Tin, VEC, 5, 7>(x, taps, y, T, C, R, B, bch,
                                               n_out, row0, stream);
      if (R == 5 && B == 25)
        return launch_geometry<Tin, VEC, 5, 25>(x, taps, y, T, C, R, B, bch,
                                                n_out, row0, stream);
    }
  }
  return launch_geometry<Tin, VEC, 0, 0>(x, taps, y, T, C, R, B, bch, n_out,
                                         row0, stream);
}

template <typename Tin>
int launch(const Tin* x, const float* taps, float* y, long long T, int C,
           int R, int B, int bch, int vec, long long n_out, long long row0,
           void* stream_) {
  if (T < 0 || C < 1 || R < 1 || B < 1 || bch < 1 || bch > B || n_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uintptr_t pitch = static_cast<uintptr_t>(C) * sizeof(Tin);
  if (vec < static_cast<int>(sizeof(Tin)) ||
      reinterpret_cast<uintptr_t>(x) % vec != 0 || pitch % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto stream = static_cast<cudaStream_t>(stream_);
  switch (vec) {
    case 16:
      return launch_width<Tin, 16>(x, taps, y, T, C, R, B, bch, n_out, row0,
                                   stream);
    case 8:
      return launch_width<Tin, 8>(x, taps, y, T, C, R, B, bch, n_out, row0,
                                  stream);
    case 4:
      return launch_width<Tin, 4>(x, taps, y, T, C, R, B, bch, n_out, row0,
                                  stream);
    case 2:
      if constexpr (sizeof(Tin) == 2) {
        return launch_width<Tin, 2>(x, taps, y, T, C, R, B, bch, n_out, row0,
                                    stream);
      }
      break;
    default:
      break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace v2

}  // namespace

extern "C" {

int fir_decimate_f32(const float* x, const float* taps, float* y, long long T,
                     int C, int R, int B, int bch, int vec, long long n_out,
                     long long row0, void* stream) {
  return v2::launch<float>(x, taps, y, T, C, R, B, bch, vec, n_out, row0,
                           stream);
}

int fir_decimate_i16(const int16_t* x, const float* taps, float* y,
                     long long T, int C, int R, int B, int bch, int vec,
                     long long n_out, long long row0, void* stream) {
  return v2::launch<int16_t>(x, taps, y, T, C, R, B, bch, vec, n_out, row0,
                             stream);
}

}  // extern "C"
