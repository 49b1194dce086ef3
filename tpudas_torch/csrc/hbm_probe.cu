// HBM read probes for Hopper (sm_90a): the card's counterparts of the TPU
// diagnostics P1-P3, which measure the device-memory read rate that every
// kernel bound in this repository is held against.
//
// Replaces
//   P1 copy_kernel(rows, cb, k_fastest)   tools/probe_pipeline.py:32
//   P2 copy_kernel_pstream(P, rows, cb)   tools/probe_pipeline.py:70
//   P3 manual_reader(rows, nbuf)          tools/probe_dma.py:45
//
// What they compute, on a (T, C) row-major float32 array x:
//   copy_heads (P1, and P2 with P tiles in flight): every (rows, cb) tile
//     of the first t_eff rows is read, and the tile's first rows/8 rows are
//     written out:  out[k*rows/8 + r, c] = x[k*rows + r, c],  r < rows/8,
//     so out is (t_eff/8, C).  t_eff = (T / (rows*P)) * rows*P.
//   ring_reader (P3): every (rows, C) chunk i < T/rows is read, and the
//     result is sum_i sum_c x[i*rows, c] as a (1, 1) float32.
//
// The point of a probe is that it really reads every byte it credits.  On
// the TPU the block DMA moved each whole block into VMEM.  Here every byte
// of every tile lands in shared memory through cp.async.bulk (the 1-D bulk
// copy of the Tensor Memory Accelerator, completion counted in bytes on an
// mbarrier) before the head rows are written from shared memory.  A kernel
// that loaded only the head rows would read 1/8 of the bytes and measure
// nothing.
//
// The TPU geometry does not fit the card (a (1024, 2048) f32 block is 8 MB
// of VMEM; an SM has at most 227 KB of shared memory, and there are 132 SMs
// instead of one core), so each knob keeps its meaning, not its size:
//   cb*4 bytes   the contiguous segment read per row (one bulk copy each);
//   rows x cb    the tile one thread block owns, streamed through a ring of
//                shared-memory slots of at most 16 KB (slot_rows rows);
//   k_fastest    the order in which consecutive blocks walk the tiles;
//   P            the number of tiles a block streams at once: its items
//                (tile j, stage s) interleave j-fastest, and P copies are
//                kept in flight ahead of the one being consumed (a ring of
//                P + 1 slots; P = 1 is P1's double buffer);
//   nbuf         P3's ring depth: nbuf slots, nbuf - 1 copies in flight.
// P3 runs a persistent grid, one block per SM; block b takes chunks b,
// b + G, b + 2G, ... and streams each contiguous (rows, C) chunk in slots
// of 128 KB / nbuf (a chunk row wider than a slot is split across slots).
// Each block writes a float64 partial sum of the row-0 elements it saw; a
// second, one-thread pass adds the partials in block order, so the result
// does not depend on scheduling.
//
// Bound: the bytes read plus the bytes written, over the HBM rate; the
// probes do no arithmetic worth counting.  The design keeps many copies in
// flight (several blocks per SM for P1/P2, nbuf - 1 slots for P3) so the
// memory system, not the issue rate, is the limit.
//
// Every mbarrier expects exactly the bytes of the copies issued against it
// in that phase: a count that never completes would hang the card, so the
// wait gives up after 5 s of global time and traps (the launch then fails
// with an error instead of hanging).  Launches use the caller's stream, do
// not synchronise and allocate nothing; the C entry points return
// cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlotBytes = 16384;       // P1/P2 ring slot
constexpr int kP3RingBytes = 131072;    // P3 ring, all slots
constexpr int kMaxPiece = 16384;        // largest single bulk copy issued
constexpr int kBarRegion = 256;         // mbarriers, ahead of the ring
constexpr int kMaxSmem = 232448;        // per-block opt-in limit on sm_90
constexpr unsigned long long kWaitTimeoutNs = 5000000000ull;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// one arrival that also adds `bytes` to the phase's expected transactions
__device__ __forceinline__ void mbar_arrive_expect(uint64_t* bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(smem_u32(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// wait for the completion of the slot's phase with this parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitTimeoutNs) __trap();
  }
}

__device__ __forceinline__ void init_barriers(uint64_t* bars, int n) {
  if (threadIdx.x == 0) {
    for (int i = 0; i < n; ++i) mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// P1 / P2: head copies

struct HeadGeom {
  const float* x;
  float* out;
  long long C;
  int rows;        // tile rows
  int cb;          // tile columns
  int P;           // tiles streamed at once by one block
  long long nkg;   // tile groups along time (T / (rows * P))
  int nc;          // tiles along channels (C / cb)
  int k_fastest;
  int slot_rows;   // tile rows per ring slot
};

__global__ void __launch_bounds__(kThreads)
copy_heads_kernel(HeadGeom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* ring = reinterpret_cast<float*>(smem + kBarRegion);
  const int nslot = g.P + 1;
  const int slot_floats = g.slot_rows * g.cb;

  const long long b = blockIdx.x;
  long long kg;
  int c;
  if (g.k_fastest) {
    c = static_cast<int>(b / g.nkg);
    kg = b % g.nkg;
  } else {
    kg = b / g.nc;
    c = static_cast<int>(b % g.nc);
  }
  const int head = g.rows / 8;
  const int n_stage = (g.rows + g.slot_rows - 1) / g.slot_rows;
  const int n_items = g.P * n_stage;
  const long long col0 = static_cast<long long>(c) * g.cb;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x < 32;

  init_barriers(bars, nslot);

  // item i: tile j = i % P of the group, stage s = i / P of that tile
  auto issue = [&](int i) {
    const int slot = i % nslot;
    const long long tile = kg * g.P + (i % g.P);
    const int r0 = (i / g.P) * g.slot_rows;
    const int nr = min(g.slot_rows, g.rows - r0);
    if (lane == 0) {
      mbar_arrive_expect(bars + slot,
                         static_cast<uint32_t>(nr) * g.cb * sizeof(float));
    }
    __syncwarp();
    const float* src = g.x + (tile * g.rows + r0) * g.C + col0;
    float* dst = ring + static_cast<long long>(slot) * slot_floats;
    for (int r = lane; r < nr; r += 32) {
      bulk_load(dst + r * g.cb, src + r * g.C,
                static_cast<uint32_t>(g.cb * sizeof(float)), bars + slot);
    }
  };

  if (producer) {
    for (int i = 0; i < min(nslot - 1, n_items); ++i) issue(i);
  }
  const int vec_per_row = g.cb / 4;
  for (int i = 0; i < n_items; ++i) {
    // the slot of item i + nslot - 1 held item i - 1, which every thread
    // finished reading before the previous iteration's barrier
    if (producer && i + nslot - 1 < n_items) issue(i + nslot - 1);
    const int slot = i % nslot;
    mbar_wait(bars + slot, static_cast<uint32_t>((i / nslot) & 1));
    const int r0 = (i / g.P) * g.slot_rows;
    if (r0 < head) {
      const long long tile = kg * g.P + (i % g.P);
      const int nh = min(g.slot_rows, head - r0);
      const float4* s4 = reinterpret_cast<const float4*>(
          ring + static_cast<long long>(slot) * slot_floats);
      for (int e = threadIdx.x; e < nh * vec_per_row; e += kThreads) {
        const int r = e / vec_per_row;
        const int q = e - r * vec_per_row;
        float4* d4 = reinterpret_cast<float4*>(
            g.out + (tile * head + r0 + r) * g.C + col0);
        d4[q] = s4[r * vec_per_row + q];
      }
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------------------
// P3: the ring reader

struct RingGeom {
  const float* x;
  double* partials;
  long long C;
  int rows;
  long long n_chunks;  // T / rows
  int nbuf;
  int slot_bytes;
};

__global__ void __launch_bounds__(kThreads)
ring_reader_kernel(RingGeom g) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kBarRegion;
  __shared__ double warp_sums[kThreads / 32];

  const long long G = gridDim.x;
  const long long b = blockIdx.x;
  const long long chunk_bytes =
      static_cast<long long>(g.rows) * g.C * static_cast<long long>(sizeof(float));
  const long long row_bytes = g.C * static_cast<long long>(sizeof(float));
  const long long n_stage = (chunk_bytes + g.slot_bytes - 1) / g.slot_bytes;
  const long long my_chunks = b < g.n_chunks ? (g.n_chunks - b + G - 1) / G : 0;
  const long long n_items = my_chunks * n_stage;
  const int lane = threadIdx.x & 31;
  const bool producer = threadIdx.x < 32;

  init_barriers(bars, g.nbuf);

  auto issue = [&](long long it) {
    const int slot = static_cast<int>(it % g.nbuf);
    const long long chunk = b + (it / n_stage) * G;
    const long long byte0 = (it % n_stage) * g.slot_bytes;
    const long long nb = min(static_cast<long long>(g.slot_bytes), chunk_bytes - byte0);
    if (lane == 0) mbar_arrive_expect(bars + slot, static_cast<uint32_t>(nb));
    __syncwarp();
    const unsigned char* src =
        reinterpret_cast<const unsigned char*>(g.x) + chunk * chunk_bytes + byte0;
    unsigned char* dst = ring + static_cast<long long>(slot) * g.slot_bytes;
    for (long long off = static_cast<long long>(lane) * kMaxPiece; off < nb;
         off += 32LL * kMaxPiece) {
      const long long n = min(static_cast<long long>(kMaxPiece), nb - off);
      bulk_load(dst + off, src + off, static_cast<uint32_t>(n), bars + slot);
    }
  };

  if (producer) {
    for (long long i = 0; i < min(static_cast<long long>(g.nbuf - 1), n_items); ++i)
      issue(i);
  }
  double acc = 0.0;
  for (long long i = 0; i < n_items; ++i) {
    if (producer && i + g.nbuf - 1 < n_items) issue(i + g.nbuf - 1);
    const int slot = static_cast<int>(i % g.nbuf);
    mbar_wait(bars + slot, static_cast<uint32_t>((i / g.nbuf) & 1));
    // the chunk's row 0 is its first C floats
    const long long byte0 = (i % n_stage) * g.slot_bytes;
    if (byte0 < row_bytes) {
      const long long nb = min(static_cast<long long>(g.slot_bytes), chunk_bytes - byte0);
      const int n_el = static_cast<int>((min(byte0 + nb, row_bytes) - byte0) / 4);
      const float* s = reinterpret_cast<const float*>(
          ring + static_cast<long long>(slot) * g.slot_bytes);
      for (int e = threadIdx.x; e < n_el; e += kThreads) acc += s[e];
    }
    __syncthreads();
  }
  // fixed-order block reduction: warp tree, then the warps in order
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) warp_sums[threadIdx.x / 32] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
    g.partials[b] = s;
  }
}

__global__ void sum_partials_kernel(const double* partials, int n, float* out) {
  double s = 0.0;
  for (int i = 0; i < n; ++i) s += partials[i];
  out[0] = static_cast<float>(s);
}

int set_smem(const void* fn, int bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace

extern "C" {

// P1 (P = 1) and P2: out is (t_eff / 8, C), t_eff = (T / (rows * P)) * rows * P.
int copy_heads_f32(const float* x, float* out, long long T, long long C,
                   int rows, int cb, int P, int k_fastest, void* stream) {
  if (T < 0 || C < 4 || rows < 8 || rows % 8 != 0 || cb < 4 || cb % 4 != 0 ||
      C % cb != 0 || C % 4 != 0 || P < 1 || P > 16 || !aligned16(x) ||
      !aligned16(out)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nkg = T / (static_cast<long long>(rows) * P);
  const int nc = static_cast<int>(C / cb);
  if (nkg == 0) return static_cast<int>(cudaSuccess);
  const long long blocks = nkg * nc;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int row_bytes = cb * static_cast<int>(sizeof(float));
  int slot_rows = kSlotBytes / row_bytes;
  if (slot_rows < 1) slot_rows = 1;
  if (slot_rows > rows) slot_rows = rows;
  const int nslot = P + 1;
  const long long smem =
      kBarRegion + static_cast<long long>(nslot) * slot_rows * row_bytes;
  if (nslot * 8 > kBarRegion || smem > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int err = set_smem(reinterpret_cast<const void*>(copy_heads_kernel),
                     static_cast<int>(smem));
  if (err != 0) return err;
  HeadGeom g{x, out, C, rows, cb, P, nkg, nc, k_fastest, slot_rows};
  copy_heads_kernel<<<static_cast<unsigned>(blocks), kThreads,
                      static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// P3: partials is float64 [>= min(T / rows, n_blocks)], out is float32 [1].
int ring_reader_f32(const float* x, double* partials, float* out, long long T,
                    long long C, int rows, int nbuf, int n_blocks,
                    void* stream) {
  if (T < 0 || C < 4 || C % 4 != 0 || rows < 1 || nbuf < 1 ||
      nbuf * 8 > kBarRegion || n_blocks < 1 || !aligned16(x)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long n_chunks = T / rows;
  const long long chunk_bytes =
      static_cast<long long>(rows) * C * static_cast<long long>(sizeof(float));
  long long slot = (kP3RingBytes / nbuf) & ~15LL;
  if (slot > chunk_bytes) slot = chunk_bytes;
  if (slot < 16) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = static_cast<int>(n_chunks < n_blocks ? (n_chunks > 0 ? n_chunks : 1)
                                                        : n_blocks);
  const long long smem = kBarRegion + nbuf * slot;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  int err = set_smem(reinterpret_cast<const void*>(ring_reader_kernel),
                     static_cast<int>(smem));
  if (err != 0) return err;
  RingGeom g{x, partials, C, rows, n_chunks, nbuf, static_cast<int>(slot)};
  ring_reader_kernel<<<grid, kThreads, static_cast<size_t>(smem),
                       static_cast<cudaStream_t>(stream)>>>(g);
  err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  sum_partials_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      partials, grid, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
