// Strided (decimating) causal FIR along the time axis, for Hopper (sm_90a).
//
//     y[k, c] = sum_{j < L} h[j] * x[k*R + j, c]      k in [0, n_out)
//
// x is a (T, C) row-major window (channels contiguous), float32 or raw
// int16; rows at or past T read as zero (the implicit right pad of the
// TPU kernel).  h is the frame-blocked tap matrix (B, R) flattened to
// L = B*R taps (zero-padded past the true tap count).  y is (n_out, C)
// float32.
//
// Replaces the TPU kernel fir_decimate_pallas (tpudas/ops/pallas_fir.py:324,
// and its v1 form _fir_decimate_pallas_v1 at :269, which computes the same
// function).  The TPU kernel ran the FIR as a banded bf16 MXU matmul with a
// 3-pass split because the TPU's vector unit was slow; on this card a plain
// float32 FMA kernel is the right design, since the work is bound by
// memory: 2L/R flops per input sample, i.e. L/(2R) per float32 byte read
// (3 to 12.5 for the flagship 1 kHz -> 1 Hz stages), under the card's
// 67 TFLOP/s f32 : 3.35 TB/s HBM balance of ~20 flop/byte.  Its bound is
// therefore
//     (T*C*sizeof(in) + n_out*C*4) / 3.35 TB/s.
//
// Design (simple and right first; a TMA ring and a persistent grid are
// later work):
// - a block covers TC = 32 channels (one warp wide, so every row read by
//   the block is one coalesced 128-byte (f32) or 64-byte (int16) segment)
//   x K = 64 output frames; 8 warps, each thread accumulating KPT = 8
//   outputs of one channel;
// - taps are consumed in chunks of up to JC = 256: per chunk the block
//   stages its input rows [k0*R + j0, k0*R + j0 + (K-1)*R + jn) and the
//   chunk's taps in shared memory, so any tap length the design produces
//   (up to 4095 for the matched last stage) fits in at most 97 KB of
//   dynamic shared memory (R <= 8);
// - int16 is cast to float32 as it is staged (exact); the quantization
//   scale is the caller's (the FIR is linear);
// - sums run in float32 in tap order: a per-chunk partial sum, then added
//   to the running total (two-level, which keeps rounding growth ~sqrt);
// - the ragged channel edge and rows past T are masked, so no padded copy
//   of the input is ever made.
// The launch uses the caller's stream, does not synchronise and
// allocates nothing; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;        // channels per block (one warp)
constexpr int TY = 8;         // warps per block
constexpr int KPT = 8;        // outputs per thread
constexpr int K = TY * KPT;   // output frames per block
constexpr int JC = 256;       // taps per shared-memory chunk
constexpr int kMaxSmem = 232448;  // per-block opt-in limit on sm_90

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(int16_t v) { return static_cast<float>(v); }

template <typename Tin>
__global__ void __launch_bounds__(TC * TY)
fir_decimate_kernel(const Tin* __restrict__ x, const float* __restrict__ taps,
                    float* __restrict__ y, long long T, int C, int R, int L,
                    long long n_out) {
  extern __shared__ float smem[];
  float* s_taps = smem;       // [JC]
  float* s_x = smem + JC;     // [rows][TC]

  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TC + tx;
  const long long k0 = static_cast<long long>(blockIdx.x) * K;
  const int c = blockIdx.y * TC + tx;
  const bool c_ok = c < C;

  float acc[KPT];
#pragma unroll
  for (int i = 0; i < KPT; ++i) acc[i] = 0.f;

  for (int j0 = 0; j0 < L; j0 += JC) {
    const int jn = min(JC, L - j0);
    const int rows = (K - 1) * R + jn;
    const long long r0 = k0 * R + j0;
    __syncthreads();  // the previous chunk's readers are done
    for (int j = tid; j < jn; j += TC * TY) s_taps[j] = taps[j0 + j];
    for (int r = ty; r < rows; r += TY) {
      const long long row = r0 + r;
      float v = 0.f;
      if (c_ok && row < T) v = to_f32(x[row * C + c]);
      s_x[r * TC + tx] = v;
    }
    __syncthreads();

    float part[KPT];
#pragma unroll
    for (int i = 0; i < KPT; ++i) part[i] = 0.f;
    for (int j = 0; j < jn; ++j) {
      const float h = s_taps[j];
#pragma unroll
      for (int i = 0; i < KPT; ++i) {
        const int kk = ty + i * TY;
        part[i] = fmaf(h, s_x[(kk * R + j) * TC + tx], part[i]);
      }
    }
#pragma unroll
    for (int i = 0; i < KPT; ++i) acc[i] += part[i];
  }

  if (!c_ok) return;
#pragma unroll
  for (int i = 0; i < KPT; ++i) {
    const long long k = k0 + ty + i * TY;
    if (k < n_out) y[k * C + c] = acc[i];
  }
}

int smem_bytes(int R, int L) {
  const int jn = L < JC ? L : JC;
  return static_cast<int>(sizeof(float)) * (JC + ((K - 1) * R + jn) * TC);
}

template <typename Tin>
int launch(const Tin* x, const float* taps, float* y, long long T, int C,
           int R, int L, long long n_out, void* stream) {
  if (T < 0 || C < 1 || R < 1 || L < 1 || n_out < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long kblocks = (n_out + K - 1) / K;
  const int cblocks = (C + TC - 1) / TC;
  if (kblocks > 2147483647LL || cblocks > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  const int smem = smem_bytes(R, L);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fir_decimate_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(kblocks), static_cast<unsigned>(cblocks));
  const dim3 block(TC, TY);
  fir_decimate_kernel<Tin><<<grid, block, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      x, taps, y, T, C, R, L, n_out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int fir_decimate_f32(const float* x, const float* taps, float* y, long long T,
                     int C, int R, int L, long long n_out, void* stream) {
  return launch<float>(x, taps, y, T, C, R, L, n_out, stream);
}

int fir_decimate_i16(const int16_t* x, const float* taps, float* y,
                     long long T, int C, int R, int L, long long n_out,
                     void* stream) {
  return launch<int16_t>(x, taps, y, T, C, R, L, n_out, stream);
}

}  // extern "C"
