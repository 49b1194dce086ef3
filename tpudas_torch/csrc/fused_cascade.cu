// One stateful step of the whole decimating FIR cascade, for Hopper (sm_90a).
//
// For stages i = 0..S-1 with true taps h_i (length L_i), decimation R_i and
// carried rows p_i:
//
//     z_i      = concat(carry_i, u_i)         u_0 = the block, u_{i+1} = y_i
//     y_i[k]   = sum_{j < L_i} h_i[j] * z_i[k*R_i + j]      k < len(u_i)/R_i
//     carry_i' = z_i[len(z_i) - p_i :]
//     y        = y_{S-1}
//
// x is the (T, C) block (channels contiguous), float32 or raw int16; an
// int16 value is dequantized as it is read, float(v) * qscale in
// registers, bit-equal to the plain x.float() * qscale, so carry_0 holds
// the same dequantized float32 rows every engine carries.  T is a multiple
// of the ratio prod(R_i).  The new carry leaves are written to fresh
// buffers: nothing here aliases its input.
//
// Two kernels here make one step: kernel A (stage01_kernel, below) runs
// stages 0 and 1 in parallel over time tiles and writes the 1/(R_0 R_1)
// rate intermediate u_2 to device memory; kernel B (fused_cascade_kernel,
// the ring walk) runs the remaining stages on u_2.  Kernel B alone also
// takes the whole cascade (the single-kernel step, kept for comparison).
//
// Replaces the TPU kernel fused_cascade_pallas (tpudas/ops/pallas_fir.py:576,
// body _fused_kernel_body :515).  That kernel held a chunk of ~8k
// full-rate rows and every stage's tail in VMEM; at the flagship plan
// (1 kHz -> 1 Hz, R = 8,5,5,5, taps 43,29,33,125, carry 688,24,28,120) it
// did not fit, and the TPU ran the scan formulation instead.  This kernel
// is designed for that plan.  What bounds it on this card is bytes: the
// block is read once, the decimated output and the carry are written
// once, the carry is read once, and nothing at an intermediate rate
// reaches HBM; the arithmetic (2*sum_i L_i*n_i flops, ~6 per int16 byte
// read at the flagship) is under the card's ~20 flop/byte f32 balance.
//
// Kernel B's design (simple and right first; wgmma, TMA and a persistent
// grid are later work):
// - one block owns TC = 32 channels (one warp wide, so every row it reads
//   is one coalesced segment) and walks the block's time axis in chunks
//   of ONE final output (ratio full-rate rows); 8 warps split each
//   stage's outputs of the chunk;
// - stage 0 reads z_0 straight from global memory (the old carry for the
//   first p_0 rows, the block after them) in sub-steps of up to G0
//   outputs, staging only the (g-1)*R_0 + L_0 <= NW*RPT rows a sub-step
//   needs in shared memory; each thread loads the raw bits of its RPT
//   rows of the NEXT sub-step into registers before computing the
//   current one and converts them only when it stores them, so the load
//   latency overlaps the arithmetic (software pipelining); p_0
//   includes the alignment pad, so the first outputs read the oldest
//   carry rows;
// - every later stage keeps a ring of exactly H_i + N_i rows in shared
//   memory (H_i = L_i - R_i = p_i, N_i = its input rows per chunk), seeded
//   from its carry; the previous stage writes its chunk outputs into the
//   ring and the oldest rows are overwritten only after their last
//   reader; at the end the ring's newest H_i rows are the new carry;
// - sums run over the TRUE taps only, with fmaf into four interleaved
//   partial sums (for instruction-level parallelism): no padded tap slot
//   ever multiplies a sample, so a NaN reaches exactly the outputs whose
//   receptive field holds it (a subset of the per-stage chain's NaN set,
//   which multiplies zero-padded taps);
// - a plan whose rings and staging do not fit the 227 KB opt-in shared
//   memory is refused (the launcher returns an error; the wrapper
//   raises).
//
// Kernel A's design.  Kernel B walks its block's whole time axis one
// final output at a time, behind a barrier per stage: at the flagship a
// 60-output block is 60 chunks of 6 stage-0 sub-steps and 3 stage passes,
// one serial chain per 32 channels, so its time hardly depends on the
// width.  Stages 0 and 1 have no recurrence: stage-1 output m reads z_1
// rows [m R_1, m R_1 + L_1), and each stage-0 output reads L_0 rows of
// z_0, so K_1 consecutive stage-1 outputs depend on a bounded window of
// the block.  Kernel A's grid is (time tiles) x (channel tiles):
// - a block owns K_1 consecutive stage-1 outputs of 32 channels; it
//   computes the stage-0 outputs they read, H_1 = L_1 - R_1 of them the
//   previous tile computes too (the halo; 24 of 274 at the flagship,
//   K_1 = 50), into a linear buffer of z_1 rows in shared memory; z_1
//   rows below p_1 (the first tile's) come from carry_1;
// - stage 0 reads z_0 from global memory in sub-steps of up to G0
//   outputs; the next sub-step's rows are prefetched into registers as
//   16-byte vectors (several threads a row) while the current one
//   computes, and converted as they are stored (a per-channel prefetch
//   of 32 rows, as kernel B's, needs a 64-bit address a row and spills
//   under two blocks an SM); the dot products
//   read the taps four at a time (one shared-memory load for four
//   FMAs), which matters here: each stage-0 output of a warp reads L_0
//   rows of 128 bytes from shared memory, so at the flagship kernel A is
//   bounded by shared-memory bandwidth more than by device memory;
// - then one pass of stage 1 over the buffer writes the tile's outputs
//   to u_2 (or to y when the plan has at most two stages);
// - the last tile also writes carry_0' (z_0 rows [T, T + p_0)) and
//   carry_1' (z_1 rows [n_0, n_0 + p_1), the end of its buffer).
// Its serial chain is one tile (about 12 sub-steps at the flagship), and
// a 60-output block at 10,000 channels gives 30 x 313 blocks.  Sums run
// over the true taps, as in kernel B.
//
// The launches use the caller's stream, do not synchronise and allocate
// nothing; the C entry points return cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TC = 32;            // channels per block (one warp)
constexpr int NW = 8;             // warps per block
constexpr int G0 = 3 * NW;        // most stage-0 outputs per sub-step
constexpr int RPT = 32;           // staged stage-0 rows per thread
constexpr int kCopyBatch = 8;     // rows per thread in flight when copying
constexpr int kMaxStages = 8;
constexpr int kMaxSmem = 232448;  // per-block opt-in limit on sm_90

struct Params {
  const float* carry[kMaxStages];
  float* new_carry[kMaxStages];
  const float* taps;           // every stage's true taps, concatenated
  int R[kMaxStages];
  int L[kMaxStages];
  int p[kMaxStages];           // carried rows
  int H[kMaxStages];           // halo rows, max(L - R, 0)
  int N[kMaxStages + 1];       // input rows per chunk of stage i; N[S] = 1
  int cap[kMaxStages];         // ring rows of stage i >= 1: H + N
  int ring_off[kMaxStages];    // float offset of ring i in shared memory
  int tap_off[kMaxStages];     // float offset of stage i's taps
  int s0_off;                  // float offset of the stage-0 staging rows
  int g0;                      // stage-0 outputs per sub-step
  int S;
  int C;
  long long T;
  float qscale;
};

// z_0 = concat(carry_0, x) is read in two steps: the raw 32 bits of a row
// (float bits of a carry row, or the int16/float bits of a block row),
// then the float value.  Keeping the conversion out of the load lets
// every prefetched load be in flight at once.
__device__ __forceinline__ uint32_t raw_x(const float* __restrict__ x,
                                          long long i) {
  return __float_as_uint(x[i]);
}
__device__ __forceinline__ uint32_t raw_x(const int16_t* __restrict__ x,
                                          long long i) {
  return static_cast<uint16_t>(x[i]);
}
__device__ __forceinline__ float from_raw_x(uint32_t v, float,
                                            const float*) {
  return __uint_as_float(v);
}
__device__ __forceinline__ float from_raw_x(uint32_t v, float qs,
                                            const int16_t*) {
  return static_cast<float>(static_cast<int16_t>(v)) * qs;
}

// raw bits of row r of z_0 for channel c
template <typename Tin>
__device__ __forceinline__ uint32_t raw_z0(const Tin* __restrict__ x,
                                           const float* __restrict__ c0,
                                           long long r, int p0, int C,
                                           int c) {
  return r < p0 ? __float_as_uint(c0[r * C + c])
                : raw_x(x, (r - p0) * C + c);
}

// the float value of row r of z_0 from its raw bits
template <typename Tin>
__device__ __forceinline__ float val_z0(uint32_t v, long long r, int p0,
                                        float qs, const Tin* x) {
  return r < p0 ? __uint_as_float(v) : from_raw_x(v, qs, x);
}

// sum_{j < L} h[j] * buf[((start + j) mod cap) * TC], the ring read as
// its two contiguous runs; a linear buffer passes cap > start + L
__device__ __forceinline__ float dot_taps(const float* __restrict__ h,
                                          const float* __restrict__ buf,
                                          int start, int L, int cap) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const int n1 = min(L, cap - start);
  const float* p = buf + start * TC;
  int j = 0;
  for (; j + 4 <= n1; j += 4) {
    a0 = fmaf(h[j], p[j * TC], a0);
    a1 = fmaf(h[j + 1], p[(j + 1) * TC], a1);
    a2 = fmaf(h[j + 2], p[(j + 2) * TC], a2);
    a3 = fmaf(h[j + 3], p[(j + 3) * TC], a3);
  }
  for (; j < n1; ++j) a0 = fmaf(h[j], p[j * TC], a0);
  // past the wrap, tap j reads ring row j - n1
  for (; j + 4 <= L; j += 4) {
    a0 = fmaf(h[j], buf[(j - n1) * TC], a0);
    a1 = fmaf(h[j + 1], buf[(j + 1 - n1) * TC], a1);
    a2 = fmaf(h[j + 2], buf[(j + 2 - n1) * TC], a2);
    a3 = fmaf(h[j + 3], buf[(j + 3 - n1) * TC], a3);
  }
  for (; j < L; ++j) a0 = fmaf(h[j], buf[(j - n1) * TC], a0);
  return (a0 + a1) + (a2 + a3);
}

// this thread's rows of one stage-0 sub-step (first z_0 row r0), as raw
// bits in registers: every load is issued before any is used
template <typename Tin>
__device__ __forceinline__ void load_rows(uint32_t (&v)[RPT],
                                          const Tin* __restrict__ x,
                                          const float* __restrict__ c0,
                                          long long r0, int rows, int p0,
                                          int C, int c, bool c_ok, int ty) {
  if (r0 >= p0) {
    // (block-uniform) every row comes from the block
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * NW;
      v[i] = (c_ok && r < rows) ? raw_x(x, (r0 + r - p0) * C + c) : 0u;
    }
  } else {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * NW;
      v[i] = (c_ok && r < rows) ? raw_z0(x, c0, r0 + r, p0, C, c) : 0u;
    }
  }
}

template <typename Tin>
__global__ void __launch_bounds__(TC * NW, 3)
fused_cascade_kernel(const Tin* __restrict__ x, float* __restrict__ y,
                     const Params P) {
  extern __shared__ float smem[];
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TC + tx;
  const int C = P.C;
  const int S = P.S;
  const int c = blockIdx.x * TC + tx;
  const bool c_ok = c < C;
  const long long T = P.T;
  const float qs = P.qscale;
  const int p0 = P.p[0];

  const int n_taps = P.tap_off[S - 1] + P.L[S - 1];
  for (int j = tid; j < n_taps; j += TC * NW) smem[j] = P.taps[j];

  // stage 0's new carry is rows [T, T + p0) of z_0: a copy, kCopyBatch
  // rows per thread in flight
  if (c_ok) {
    for (int r = ty; r < p0; r += NW * kCopyBatch) {
      uint32_t v[kCopyBatch];
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        const int rr = r + b * NW;
        v[b] = rr < p0 ? raw_z0(x, P.carry[0], T + rr, p0, C, c) : 0u;
      }
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        const int rr = r + b * NW;
        if (rr < p0) {
          P.new_carry[0][static_cast<long long>(rr) * C + c] =
              val_z0(v[b], T + rr, p0, qs, x);
        }
      }
    }
  }
  // the rings of stages >= 1 start with their carry: z_i rows [0, H_i)
  for (int i = 1; i < S; ++i) {
    float* ring = smem + P.ring_off[i];
    for (int r = ty; r < P.H[i]; r += NW * kCopyBatch) {
      float v[kCopyBatch];
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        const int rr = r + b * NW;
        v[b] = (c_ok && rr < P.H[i])
                   ? P.carry[i][static_cast<long long>(rr) * C + c] : 0.f;
      }
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        const int rr = r + b * NW;
        if (rr < P.H[i]) ring[rr * TC + tx] = v[b];
      }
    }
  }

  const long long n_chunks = T / P.N[0];
  float* s0 = smem + P.s0_off;
  const float* h0 = smem + P.tap_off[0];
  const int R0 = P.R[0];
  const int L0 = P.L[0];
  const int n0 = P.N[1];  // stage-0 outputs per chunk
  const int G = P.g0;     // stage-0 outputs per sub-step

  // stage-0 sub-steps (m, s): chunk m, outputs [s, s + G) of the chunk;
  // each iteration stores the prefetched rows, prefetches the next
  // sub-step's rows, computes, and closes a chunk with stages 1..S-1
  uint32_t pre[RPT];
  long long m = 0;
  int s = 0;
  if (n_chunks > 0) {
    load_rows(pre, x, P.carry[0], 0, (min(G, n0) - 1) * R0 + L0, p0, C, c,
              c_ok, ty);
  }
  __syncthreads();
  while (m < n_chunks) {
    const int g = min(G, n0 - s);
    const long long k0 = m * n0 + s;  // first global stage-0 output
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + i * NW;
      s0[r * TC + tx] = val_z0(pre[i], k0 * R0 + r, p0, qs, x);
    }
    __syncthreads();
    int s2 = s + G;
    long long m2 = m;
    if (s2 >= n0) {
      s2 = 0;
      m2 = m + 1;
    }
    if (m2 < n_chunks) {
      const int g2 = min(G, n0 - s2);
      load_rows(pre, x, P.carry[0], (m2 * n0 + s2) * R0,
                (g2 - 1) * R0 + L0, p0, C, c, c_ok, ty);
    }
    // ring 1's slot for its row H_1 + (chunk m's first output)
    const int base1 = S > 1 ? static_cast<int>((m * n0) % P.cap[1]) : 0;
    for (int kk = ty; kk < g; kk += NW) {
      const float acc = dot_taps(h0, s0 + tx, kk * R0, L0, 1 << 30);
      if (S == 1) {
        if (c_ok) y[(k0 + kk) * C + c] = acc;
      } else {
        int slot = base1 + P.H[1] + s + kk;
        if (slot >= P.cap[1]) slot -= P.cap[1];
        smem[P.ring_off[1] + slot * TC + tx] = acc;
      }
    }
    __syncthreads();
    if (s2 == 0) {
      // chunk m is complete in ring 1: stages 1..S-1 over their rings
      for (int i = 1; i < S; ++i) {
        const int Ri = P.R[i];
        const int cap = P.cap[i];
        const int ni = P.N[i + 1];  // stage-i outputs per chunk
        const int base = static_cast<int>((m * P.N[i]) % cap);
        const int nbase =
            i + 1 < S ? static_cast<int>((m * ni) % P.cap[i + 1]) : 0;
        for (int kk = ty; kk < ni; kk += NW) {
          int start = base + kk * Ri;
          if (start >= cap) start -= cap;
          const float acc = dot_taps(smem + P.tap_off[i],
                                     smem + P.ring_off[i] + tx, start,
                                     P.L[i], cap);
          if (i == S - 1) {
            if (c_ok) y[(m * ni + kk) * C + c] = acc;
          } else {
            int dst = nbase + P.H[i + 1] + kk;
            if (dst >= P.cap[i + 1]) dst -= P.cap[i + 1];
            smem[P.ring_off[i + 1] + dst * TC + tx] = acc;
          }
        }
        __syncthreads();
      }
    }
    m = m2;
    s = s2;
  }

  // the new carry of stages >= 1: z_i rows [n_chunks * N_i, + H_i)
  if (c_ok) {
    for (int i = 1; i < S; ++i) {
      const float* ring = smem + P.ring_off[i];
      const int base = static_cast<int>((n_chunks * P.N[i]) % P.cap[i]);
      for (int r = ty; r < P.H[i]; r += NW) {
        int slot = base + r;
        if (slot >= P.cap[i]) slot -= P.cap[i];
        P.new_carry[i][static_cast<long long>(r) * C + c] =
            ring[slot * TC + tx];
      }
    }
  }
}

// Fill the derived geometry; returns the dynamic shared-memory bytes, or
// -1 when the plan is not one this kernel takes.
long long plan_geometry(Params& P, const int* R, const int* L, const int* p,
                        int S) {
  if (S < 1 || S > kMaxStages) return -1;
  int off = 0;
  for (int i = 0; i < S; ++i) {
    if (R[i] < 1 || L[i] < 1 || p[i] < 0) return -1;
    P.R[i] = R[i];
    P.L[i] = L[i];
    P.p[i] = p[i];
    P.H[i] = L[i] > R[i] ? L[i] - R[i] : 0;
    // stages after the first carry exactly their halo; the first may
    // carry more (the alignment pad), never less
    if (i > 0 && p[i] != P.H[i]) return -1;
    if (i == 0 && p[i] < P.H[i]) return -1;
    P.tap_off[i] = off;
    off += L[i];
  }
  long long n = 1;
  P.N[S] = 1;
  for (int i = S - 1; i >= 0; --i) {
    n *= R[i];
    if (n > (1LL << 30)) return -1;
    P.N[i] = static_cast<int>(n);
  }
  // stage-0 outputs per sub-step: at most G0, and few enough that the
  // sub-step's rows fit the NW * RPT staged rows
  if (L[0] > NW * RPT) return -1;
  int g = (NW * RPT - L[0]) / R[0] + 1;
  g = g < G0 ? g : G0;
  P.g0 = g < P.N[1] ? g : P.N[1];
  long long floats = (off + 3) / 4 * 4;
  P.s0_off = static_cast<int>(floats);
  floats += static_cast<long long>(NW * RPT) * TC;
  for (int i = 1; i < S; ++i) {
    P.cap[i] = P.H[i] + P.N[i];
    P.ring_off[i] = static_cast<int>(floats);
    floats += static_cast<long long>(P.cap[i]) * TC;
  }
  return floats * static_cast<long long>(sizeof(float));
}

template <typename Tin>
int launch(const Tin* x, float* y, const float* const* carry,
           float* const* new_carry, const float* taps, const int* R,
           const int* L, const int* p, int S, long long T, int C,
           float qscale, void* stream) {
  Params P;
  const long long smem = plan_geometry(P, R, L, p, S);
  if (smem < 0 || T < 0 || C < 1 || T % P.N[0] != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < S; ++i) {
    P.carry[i] = carry[i];
    P.new_carry[i] = new_carry[i];
  }
  P.taps = taps;
  P.S = S;
  P.C = C;
  P.T = T;
  P.qscale = qscale;
  const long long cblocks = (C + TC - 1) / TC;
  if (cblocks > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_cascade_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(cblocks));
  const dim3 block(TC, NW);
  fused_cascade_kernel<Tin><<<grid, block, static_cast<size_t>(smem),
                              static_cast<cudaStream_t>(stream)>>>(x, y, P);
  return static_cast<int>(cudaGetLastError());
}

// sum_{j < L} h[j] * buf[(start + j) * TC] over a linear buffer, the taps
// read four at a time (h is 16-byte aligned in shared memory); the same
// products and partial sums, in the same order, as dot_taps
__device__ __forceinline__ float dot_taps4(const float* __restrict__ h,
                                           const float* __restrict__ buf,
                                           int start, int L) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  const float* p = buf + start * TC;
  int j = 0;
  for (; j + 4 <= L; j += 4) {
    const float4 hv = *reinterpret_cast<const float4*>(h + j);
    a0 = fmaf(hv.x, p[j * TC], a0);
    a1 = fmaf(hv.y, p[(j + 1) * TC], a1);
    a2 = fmaf(hv.z, p[(j + 2) * TC], a2);
    a3 = fmaf(hv.w, p[(j + 3) * TC], a3);
  }
  for (; j < L; ++j) a0 = fmaf(h[j], p[j * TC], a0);
  return (a0 + a1) + (a2 + a3);
}

// Kernel A stages z_0 rows of the block with 16-byte vector loads: a row
// of the block's 32 channels is kLanes threads of kPerVec channels, so a
// thread holds kVecs vectors (16 of its registers for int16, 32 for
// float32) for the NW * RPT staged rows, and needs one 64-bit address
// per 16 bytes where a per-channel load needs one per 2 or 4 bytes.
template <typename Tin>
struct RowVec {
  static constexpr int kPerVec = 16 / static_cast<int>(sizeof(Tin));
  static constexpr int kLanes = TC / kPerVec;
  static constexpr int kRowsPerPass = TC * NW / kLanes;
  static constexpr int kVecs = NW * RPT / kRowsPerPass;
};

// this thread's vectors of staged rows [0, rows) of the block (x row
// xrow0 is staged row 0), channels from cb; all rows lie in the block
template <typename Tin>
__device__ __forceinline__ void load_vecs(uint4 (&v)[RowVec<Tin>::kVecs],
                                          const Tin* __restrict__ x,
                                          long long xrow0, int rows, int C,
                                          int cb, int tid) {
  using V = RowVec<Tin>;
  const int lr = tid / V::kLanes;
  const int ch = cb + (tid % V::kLanes) * V::kPerVec;
  const bool ok = ch < C;
  const Tin* p = x + (xrow0 + lr) * C + ch;
  const long long step = static_cast<long long>(V::kRowsPerPass) * C;
#pragma unroll
  for (int i = 0; i < V::kVecs; ++i) {
    v[i] = (ok && lr + i * V::kRowsPerPass < rows)
               ? __ldg(reinterpret_cast<const uint4*>(p + i * step))
               : make_uint4(0u, 0u, 0u, 0u);
  }
}

// one vector into its staged row as float32: 4 floats, or 8 int16
// dequantized as float(v) * qs (bit-equal to the per-channel path)
__device__ __forceinline__ void store_vec(float* dst, uint4 v, float,
                                          const float*) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(v.x), __uint_as_float(v.y),
                  __uint_as_float(v.z), __uint_as_float(v.w));
}
__device__ __forceinline__ float lo16(uint32_t w, float qs) {
  return static_cast<float>(static_cast<int16_t>(w & 0xffffu)) * qs;
}
__device__ __forceinline__ float hi16(uint32_t w, float qs) {
  return static_cast<float>(static_cast<int16_t>(w >> 16)) * qs;
}
__device__ __forceinline__ void store_vec(float* dst, uint4 v, float qs,
                                          const int16_t*) {
  reinterpret_cast<float4*>(dst)[0] = make_float4(
      lo16(v.x, qs), hi16(v.x, qs), lo16(v.y, qs), hi16(v.y, qs));
  reinterpret_cast<float4*>(dst)[1] = make_float4(
      lo16(v.z, qs), hi16(v.z, qs), lo16(v.w, qs), hi16(v.w, qs));
}

template <typename Tin>
__device__ __forceinline__ void store_vecs(float* s0,
                                           const uint4 (&v)[RowVec<Tin>::kVecs],
                                           float qs, const Tin* x, int tid) {
  using V = RowVec<Tin>;
  const int lr = tid / V::kLanes;
  float* dst = s0 + lr * TC + (tid % V::kLanes) * V::kPerVec;
#pragma unroll
  for (int i = 0; i < V::kVecs; ++i) {
    store_vec(dst + i * V::kRowsPerPass * TC, v[i], qs, x);
  }
}

struct Stage01Params {
  const float* carry0;  // (p0, C): z_0's first rows
  const float* carry1;  // (p1, C): z_1's first rows
  float* new_carry0;
  float* new_carry1;
  const float* taps;    // h_0 (L0) then h_1 (L1)
  int R0, L0, p0;
  int R1, L1, p1;       // p1 = max(L1 - R1, 0)
  int K1;               // stage-1 outputs per time tile
  int g0;               // stage-0 outputs per sub-step
  int tap1_off;         // float offset of h_1 in shared memory
  int s0_off;           // float offset of the stage-0 staging rows
  int z1_off;           // float offset of the tile's z_1 rows
  int C;
  long long T;
  long long n0;         // stage-0 outputs of the block, T / R0
  long long n1;         // stage-1 outputs of the block, n0 / R1
  float qscale;
  int vec;              // 1: 16-byte row loads (C and x aligned for them)
};

template <typename Tin>
__global__ void __launch_bounds__(TC * NW, 2)
stage01_kernel(const Tin* __restrict__ x, float* __restrict__ out,
               const Stage01Params P) {
  // float4 declaration: the taps at offsets of 4 floats are 16-byte
  // aligned for dot_taps4
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TC + tx;
  const int C = P.C;
  const int c = blockIdx.y * TC + tx;
  const bool c_ok = c < C;
  const float qs = P.qscale;
  const int R0 = P.R0;
  const int L0 = P.L0;
  const int p0 = P.p0;
  const int R1 = P.R1;
  const int p1 = P.p1;

  // this tile: stage-1 outputs [m0, m1), which read z_1 rows
  // [r_lo, r_hi); z_1 row r >= p1 is stage-0 output r - p1
  const long long m0 = static_cast<long long>(blockIdx.x) * P.K1;
  const long long m1 = min(m0 + P.K1, P.n1);
  const long long r_lo = m0 * R1;
  const long long r_hi = (m1 - 1) * R1 + P.L1;
  const long long k_lo = max(r_lo - p1, 0LL);
  const long long k_hi = r_hi - p1;

  for (int j = tid; j < L0; j += TC * NW) smem[j] = P.taps[j];
  for (int j = tid; j < P.L1; j += TC * NW) {
    smem[P.tap1_off + j] = P.taps[L0 + j];
  }
  float* z1 = smem + P.z1_off;
  // z_1 rows below p1 are carry_1's
  const long long c_end = min(r_hi, static_cast<long long>(p1));
  for (long long r = r_lo + ty; r < c_end; r += NW) {
    z1[(r - r_lo) * TC + tx] = c_ok ? P.carry1[r * C + c] : 0.f;
  }

  // stage 0 in sub-steps of up to g0 outputs.  A sub-step whose rows all
  // lie in the block (every one but the first few of the first tile)
  // is staged from 16-byte vectors prefetched into registers while the
  // previous sub-step computes; one that reaches into carry_0, or any
  // sub-step when the width does not allow 16-byte loads, is staged
  // row by row, per channel, without a prefetch.
  float* s0 = smem + P.s0_off;
  const float* h0 = smem;
  const int cb = blockIdx.y * TC;
  uint4 pre[RowVec<Tin>::kVecs];
  long long k0 = k_lo;
  int g = static_cast<int>(min(static_cast<long long>(P.g0), k_hi - k0));
  bool vec = P.vec && k0 * R0 >= p0;
  if (g > 0 && vec) {
    load_vecs(pre, x, k0 * R0 - p0, (g - 1) * R0 + L0, C, cb, tid);
  }
  while (g > 0) {
    if (vec) {
      store_vecs(s0, pre, qs, x, tid);
    } else {
      const int rows = (g - 1) * R0 + L0;
#pragma unroll 8
      for (int r = ty; r < rows; r += NW) {
        const long long zr = k0 * R0 + r;
        s0[r * TC + tx] =
            c_ok ? val_z0(raw_z0(x, P.carry0, zr, p0, C, c), zr, p0, qs, x)
                 : 0.f;
      }
    }
    __syncthreads();
    const long long k2 = k0 + g;
    const int g2 =
        static_cast<int>(min(static_cast<long long>(P.g0), k_hi - k2));
    const bool vec2 = P.vec && k2 * R0 >= p0;
    if (g2 > 0 && vec2) {
      load_vecs(pre, x, k2 * R0 - p0, (g2 - 1) * R0 + L0, C, cb, tid);
    }
    float* dst = z1 + (k0 + p1 - r_lo) * TC + tx;
    for (int kk = ty; kk < g; kk += NW) {
      dst[kk * TC] = dot_taps4(h0, s0 + tx, kk * R0, L0);
    }
    __syncthreads();
    k0 = k2;
    g = g2;
    vec = vec2;
  }
  __syncthreads();

  // stage 1 over the tile's z_1 rows
  const float* h1 = smem + P.tap1_off;
  const int nm = static_cast<int>(m1 - m0);
  for (int mm = ty; mm < nm; mm += NW) {
    const float acc = dot_taps4(h1, z1 + tx, mm * R1, P.L1);
    if (c_ok) out[(m0 + mm) * C + c] = acc;
  }

  if (blockIdx.x == gridDim.x - 1 && c_ok) {
    // carry_1' = z_1 rows [n0, n0 + p1): the end of this tile's rows
    for (int j = ty; j < p1; j += NW) {
      P.new_carry1[static_cast<long long>(j) * C + c] =
          z1[(P.n0 + j - r_lo) * TC + tx];
    }
    // carry_0' = z_0 rows [T, T + p0): a copy, kCopyBatch rows per
    // thread in flight
    for (int r = ty; r < p0; r += NW * kCopyBatch) {
      uint32_t v[kCopyBatch];
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        const int rr = r + b * NW;
        v[b] = rr < p0 ? raw_z0(x, P.carry0, P.T + rr, p0, C, c) : 0u;
      }
#pragma unroll
      for (int b = 0; b < kCopyBatch; ++b) {
        const int rr = r + b * NW;
        if (rr < p0) {
          P.new_carry0[static_cast<long long>(rr) * C + c] =
              val_z0(v[b], P.T + rr, p0, qs, x);
        }
      }
    }
  }
}

// Kernel A's geometry; returns the dynamic shared-memory bytes, or -1
// when the stage pair is not one it takes.
long long stage01_geometry(Stage01Params& P, int R0, int L0, int p0, int R1,
                           int L1, int p1, int K1) {
  if (R0 < 1 || L0 < 1 || R1 < 1 || L1 < 1 || K1 < 1) return -1;
  const int H0 = L0 > R0 ? L0 - R0 : 0;
  const int H1 = L1 > R1 ? L1 - R1 : 0;
  // stage 0 may carry more than its halo (the alignment pad); stage 1
  // carries exactly its halo, so the last tile's rows end at its carry
  if (p0 < H0 || p1 != H1) return -1;
  if (L0 > NW * RPT) return -1;
  P.R0 = R0;
  P.L0 = L0;
  P.p0 = p0;
  P.R1 = R1;
  P.L1 = L1;
  P.p1 = p1;
  P.K1 = K1;
  const int g = (NW * RPT - L0) / R0 + 1;
  P.g0 = g < G0 ? g : G0;
  long long floats = (L0 + 3) / 4 * 4;
  P.tap1_off = static_cast<int>(floats);
  floats += (L1 + 3) / 4 * 4;
  P.s0_off = static_cast<int>(floats);
  floats += static_cast<long long>(NW * RPT) * TC;
  P.z1_off = static_cast<int>(floats);
  floats += (static_cast<long long>(K1 - 1) * R1 + L1) * TC;
  return floats * static_cast<long long>(sizeof(float));
}

template <typename Tin>
int launch_stage01(const Tin* x, float* out, const float* carry0,
                   const float* carry1, float* new_carry0, float* new_carry1,
                   const float* taps, int R0, int L0, int p0, int R1, int L1,
                   int p1, int K1, long long T, int C, float qscale,
                   void* stream) {
  Stage01Params P;
  const long long smem = stage01_geometry(P, R0, L0, p0, R1, L1, p1, K1);
  const long long ratio = static_cast<long long>(R0) * R1;
  if (smem < 0 || smem > kMaxSmem || T < 1 || C < 1 || T % ratio != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  P.carry0 = carry0;
  P.carry1 = carry1;
  P.new_carry0 = new_carry0;
  P.new_carry1 = new_carry1;
  P.taps = taps;
  P.C = C;
  P.T = T;
  P.n0 = T / R0;
  P.n1 = P.n0 / R1;
  P.qscale = qscale;
  // 16-byte row loads need every row start 16-byte aligned
  P.vec = (C % RowVec<Tin>::kPerVec == 0 &&
           reinterpret_cast<uintptr_t>(x) % 16 == 0) ? 1 : 0;
  const long long tiles = (P.n1 + K1 - 1) / K1;
  const long long cblocks = (C + TC - 1) / TC;
  if (tiles > 2147483647LL || cblocks > 65535) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  cudaError_t err = cudaFuncSetAttribute(
      stage01_kernel<Tin>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>(cblocks));
  const dim3 block(TC, NW);
  stage01_kernel<Tin><<<grid, block, static_cast<size_t>(smem),
                        static_cast<cudaStream_t>(stream)>>>(x, out, P);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int stage01_f32(const float* x, float* out, const float* carry0,
                const float* carry1, float* new_carry0, float* new_carry1,
                const float* taps, int R0, int L0, int p0, int R1, int L1,
                int p1, int K1, long long T, int C, float qscale,
                void* stream) {
  return launch_stage01<float>(x, out, carry0, carry1, new_carry0,
                               new_carry1, taps, R0, L0, p0, R1, L1, p1, K1,
                               T, C, qscale, stream);
}

int stage01_i16(const int16_t* x, float* out, const float* carry0,
                const float* carry1, float* new_carry0, float* new_carry1,
                const float* taps, int R0, int L0, int p0, int R1, int L1,
                int p1, int K1, long long T, int C, float qscale,
                void* stream) {
  return launch_stage01<int16_t>(x, out, carry0, carry1, new_carry0,
                                 new_carry1, taps, R0, L0, p0, R1, L1, p1,
                                 K1, T, C, qscale, stream);
}

// Kernel A's dynamic shared memory (bytes) for a stage pair and tile,
// or -1 when it does not take the pair — the wrapper's fit check.
long long stage01_smem_bytes(int R0, int L0, int p0, int R1, int L1, int p1,
                             int K1) {
  Stage01Params P;
  return stage01_geometry(P, R0, L0, p0, R1, L1, p1, K1);
}


int fused_cascade_f32(const float* x, float* y, const float* const* carry,
                      float* const* new_carry, const float* taps,
                      const int* R, const int* L, const int* p, int S,
                      long long T, int C, float qscale, void* stream) {
  return launch<float>(x, y, carry, new_carry, taps, R, L, p, S, T, C,
                       qscale, stream);
}

int fused_cascade_i16(const int16_t* x, float* y, const float* const* carry,
                      float* const* new_carry, const float* taps,
                      const int* R, const int* L, const int* p, int S,
                      long long T, int C, float qscale, void* stream) {
  return launch<int16_t>(x, y, carry, new_carry, taps, R, L, p, S, T, C,
                         qscale, stream);
}

// Dynamic shared memory (bytes) the kernel needs for a plan, or -1 when
// the plan is not one it takes — the wrapper's fit check.
long long fused_cascade_smem_bytes(const int* R, const int* L, const int* p,
                                   int S) {
  Params P;
  return plan_geometry(P, R, L, p, S);
}

}  // extern "C"
