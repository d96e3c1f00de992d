// Mamba selective scan (K4) for Hopper, sm_90a: the state split over lanes.
//
// Replaces src/repro/kernels/mamba/kernel.py::_mamba_kernel, the Pallas TPU
// kernel behind mamba_scan().  Per (batch row, channel c), over t = 0 ..
// T-1, with the (DS,) f32 state h carried from h0:
//
//     da_s = exp(dt_t * a_s)
//     h_s <- da_s * h_s + (dt_t * x_t) * b_ts
//     y_t  = sum_s h_s * c_ts              (added from s = 0 up)
//
// in that order (the order of ref.py and of the model's _scan_chunk), all
// in f32.  dt and x are (B, T, DI), b_t and c_t (B, T, DS), a (DI, DS)
// (already negative: the caller passes -exp(A_log)), h0 and hT (B, DI, DS),
// y (B, T, DI); all contiguous.  x, b_t and c_t are f32 or bf16 (one
// type); dt, a, h0, y and hT are f32 (the Pallas contract).  The D-skip is
// the caller's.
//
// Every multiply and add is a separately rounded __fmul_rn / __fadd_rn,
// which nvcc never contracts into a fused multiply-add, and y is summed
// over s from 0 up, as ref.py does.  The build leaves -fmad at its default,
// so that expf compiles as it does in PyTorch's own exp kernel, which
// ref.py's torch.exp runs: the kernel then agrees with its plain version
// bit for bit.  chip_smoke.py checks that exp on its own, and every case.
//
// Bound: on paper, bytes.  At the serve path's prefill (B 4, T 512, DI
// 16384, DS 16, f32) the kernel reads dt, x, b_t, c_t, a, h0 and writes y
// and hT once, 412 MB (0.123 ms at 3.35 TB/s); its 3.2 GFLOP take 0.049 ms
// at 67 TFLOP/s.  In fact instruction issue bounds it: each of the 537 M
// state updates is dt*a, an expf (8 SASS instructions, one of them on the
// special-function unit) and 5 rounded multiplies and adds, ~7.5 G thread
// instructions in all, 0.22 ms at 4 warp instructions a clock on 132 SMs
// at 1.98 GHz, before any load, address or hand-off.  At a decode step
// (T = 1) the state dominates: 8.4 MB of h0 and hT of 10.2 MB.
//
// Design: G = DS/8 neighbouring lanes share one (batch row, channel); lane
// q owns states 8q .. 8q+7 and their entries of a, loaded and stored as
// two float4s, so neighbouring lanes touch neighbouring bytes of h0, a and
// hT and a decode step's state traffic is coalesced.  y_t's sum still runs
// over s from 0 up, so it passes from lane to lane: lane q continues the
// partial sum that lane q-1 hands it through __shfl_up_sync, adds its own
// 8 products in order, and hands it on; the last lane's sum is y_t.
// Summing each lane's products from 0 and combining the lane sums would
// round otherwise.  The lanes are skewed by one step each (lane q takes
// step i - q at iteration i), so a hand-off is one shuffle an iteration and
// never waits on the other lanes' adds.  A lane's every step also reads
// dt, x and its b_t, c_t from shared memory and finds its skewed row: 4
// states a lane (G = DS/4) spend ~15 such instructions on every 4 updates
// and measured slower than one thread a channel (PERF.md); 8 states a lane
// halve that share.  dt, x, b_t and c_t are staged kSteps steps at a time
// in a ring of kRing stages in shared memory by the Tensor Memory
// Accelerator: one bulk copy a row of dt and of x and one for the stage's
// b_t and c_t, issued by the lanes of warp 0, their bytes counted by the
// stage's shared-memory barrier, a stage ahead of the first lane.  The
// lanes wait on that barrier, and one __syncthreads a stage frees the
// stage two behind.  Rows of dt and x are padded so that the skewed lanes
// of one channel read other banks.  The last lane of a channel, the last
// to read its dt of a step, writes the step's y over it, and the lanes of
// warp 1 store a stage's y rows with bulk copies once its last lane is
// past it.  A stage whose every lane has a step runs without a branch.
// Nothing is padded in device memory: a ragged last block of channels
// copies only its channels below DI, and T is bounded by the loop (the
// Pallas kernel's time padding, an identity step at dt = 0, has no
// counterpart).  Where DI is not a multiple of 16 bytes of x, or a pointer
// is not 16-byte aligned, a second instance of the kernel fills and drains
// the same ring a value a thread, reading past DI from the last channel.
// The constants (kStates 8, 4 blocks an SM at 64 registers, stages of 8
// steps one ahead) were chosen by measurement on the card (PERF.md).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kStates = 8;     // states a lane
constexpr int kMinBlocks = 4;  // blocks an SM: 32 warps, 64 registers
constexpr int kSteps = 8;      // steps a stage, one barrier
constexpr int kRing = 4;       // stages in shared memory
constexpr int kAhead = 1;      // stages loaded ahead of the first lane's
constexpr int kRows = kRing * kSteps;
// a stage's rows are loaded again once its y is out: every lane is past it
// two stages on, and its y leaves in the stage after
static_assert(kAhead + 3 <= kRing, "the ring must outrun the skew");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// 4 consecutive values in shared memory (16 bytes of f32, 8 of bf16,
// aligned) as f32; bf16 -> f32 is exact, the 16 bits become the top half
__device__ __forceinline__ void load4(const float* p, float* v) {
  const float4 e = *reinterpret_cast<const float4*>(p);
  v[0] = e.x;
  v[1] = e.y;
  v[2] = e.z;
  v[3] = e.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* v) {
  const uint2 e = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(e.x << 16);
  v[1] = __uint_as_float(e.x & 0xffff0000u);
  v[2] = __uint_as_float(e.y << 16);
  v[3] = __uint_as_float(e.y & 0xffff0000u);
}

// a lane's kStates f32 of a state row in device memory: float4s where
// aligned
template <bool kVec>
__device__ __forceinline__ void load_state(const float* p,
                                           float (&v)[kStates]) {
#pragma unroll
  for (int j = 0; j < kStates; j += 4) {
    if constexpr (kVec) {
      load4(p + j, v + j);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) v[j + e] = p[j + e];
    }
  }
}
template <bool kVec>
__device__ __forceinline__ void store_state(float* p,
                                            const float (&v)[kStates]) {
#pragma unroll
  for (int j = 0; j < kStates; j += 4) {
    if constexpr (kVec) {
      *reinterpret_cast<float4*>(p + j) =
          make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) p[j + e] = v[j + e];
    }
  }
}

// The Tensor Memory Accelerator's bulk copies (16-byte aligned addresses,
// sizes a multiple of 16) and the shared-memory barriers that count the
// bytes of a load.
__device__ __forceinline__ unsigned smem(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(1u)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
}
__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void bulk_store(void* dst, unsigned src,
                                           unsigned bytes) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(
          dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// this thread's bulk stores have read their shared memory
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// ... and written device memory
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// this thread's shared-memory writes, ordered before later bulk copies
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The block's ring in shared memory: kRing stages of kSteps steps, one row
// a step; step t is in row t mod kRows, so lane q's row at iteration i is
// (i - q) mod kRows.  The last lane of a channel, the last to read its dt
// of a step, writes the step's y over it.
template <typename T, int DS>
struct Ring {
  static constexpr int kLanes = DS / kStates;      // G
  static constexpr int kCh = kThreads / kLanes;    // channels a block
  static constexpr int kXE = 16 / (int)sizeof(T);  // x in 16 bytes
  // the G lanes of a channel read G rows at once (the skew): a pad of 32/G
  // words a row puts them on distinct banks; rows stay 16-byte multiples
  static constexpr int kStrideF = kCh + 32 / kLanes;
  static constexpr int kStrideX = kCh + (32 / kLanes > kXE ? 32 / kLanes : kXE);
  unsigned long long full[kRing];  // a stage's loads have landed
  float dt[kRows][kStrideF];       // dt in, y out
  T x[kRows][kStrideX];
  T b[kRows][DS];
  T c[kRows][DS];
};

template <typename T, int DS, bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    mamba_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ bt, const T* __restrict__ ct,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int steps, int di) {
  using R = Ring<T, DS>;
  constexpr int G = R::kLanes;
  static_assert(DS % kStates == 0 && 32 % G == 0, "whole lanes a warp");
  static_assert(G - 1 <= kSteps, "the last lane lags at most one stage");
  static_assert((kRows & (kRows - 1)) == 0, "a power of two of rows");
  static_assert(2 * kSteps + 2 <= 32, "a stage's loads, one a lane of warp 0");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  R& ring = *reinterpret_cast<R*>(smem_raw);

  const int q = threadIdx.x % G;   // lane: kStates states from kStates q
  const int cl = threadIdx.x / G;  // channel in the block
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * R::kCh;
  const int ch = c0 + cl;
  const int cols = min(R::kCh, di - c0);  // channels of the block below di
  const long long row0 = (long long)b * steps;  // this batch row's step 0
  const int stages = (steps + kSteps - 1) / kSteps;
  const int iters = steps + G - 1;  // lane q takes step i - q at iteration i
  const int rounds = (iters + kSteps - 1) / kSteps;  // stages + 0 or 1
  auto rows_of = [&](int s) { return min(kSteps, steps - s * kSteps); };

  // Stage s of the inputs into its rows.  kVec: one bulk copy a row of dt
  // and of x and one for the stage's b_t and c_t, by the lanes of warp 0,
  // counted by the stage's barrier; else every thread, a value at a time
  // (the columns past di read from the last channel).
  auto fetch = [&](int s) {
    const int n = rows_of(s), r0 = s % kRing * kSteps;
    const long long t0 = row0 + (long long)s * kSteps;
    if constexpr (kVec) {
      const int j = threadIdx.x;
      const unsigned bar = smem(&ring.full[s % kRing]);
      const unsigned row_f = cols * 4, row_x = cols * sizeof(T);
      const unsigned bc = n * DS * sizeof(T);
      if (j == 0) mbar_expect(bar, n * (row_f + row_x) + 2 * bc);
      __syncwarp();
      if (j < n)
        bulk_load(smem(&ring.dt[r0 + j][0]), dt + (t0 + j) * di + c0, row_f,
                  bar);
      else if (j < 2 * n)
        bulk_load(smem(&ring.x[r0 + j - n][0]), x + (t0 + j - n) * di + c0,
                  row_x, bar);
      else if (j == 2 * n)
        bulk_load(smem(&ring.b[r0][0]), bt + t0 * DS, bc, bar);
      else if (j == 2 * n + 1)
        bulk_load(smem(&ring.c[r0][0]), ct + t0 * DS, bc, bar);
    } else {
      for (int i = threadIdx.x; i < n * R::kCh; i += kThreads) {
        const int r = i / R::kCh, k = i % R::kCh;
        const long long off = (t0 + r) * di + c0 + min(k, cols - 1);
        ring.dt[r0 + r][k] = dt[off];
        ring.x[r0 + r][k] = x[off];
      }
      for (int i = threadIdx.x; i < n * DS; i += kThreads) {
        const int r = i / DS, k = i % DS;
        ring.b[r0 + r][k] = bt[(t0 + r) * DS + k];
        ring.c[r0 + r][k] = ct[(t0 + r) * DS + k];
      }
    }
  };
  // Stage s's y out of its rows: kVec, one bulk store a row by the lanes
  // of warp 1; else every thread, a value at a time.
  auto drain = [&](int s) {
    const int n = rows_of(s), r0 = s % kRing * kSteps;
    float* out = y + (row0 + (long long)s * kSteps) * di + c0;
    if constexpr (kVec) {
      const int j = threadIdx.x - 32;
      if (j >= 0 && j < n)
        bulk_store(out + (long long)j * di, smem(&ring.dt[r0 + j][0]),
                   cols * 4);
    } else {
      for (int i = threadIdx.x; i < n * R::kCh; i += kThreads) {
        const int r = i / R::kCh, k = i % R::kCh;
        if (k < cols) out[(long long)r * di + k] = ring.dt[r0 + r][k];
      }
    }
  };

  if constexpr (kVec) {
    if (threadIdx.x == 0) {
      for (int s = 0; s < kRing; ++s) mbar_init(smem(&ring.full[s]));
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (threadIdx.x < 32)
      for (int s = 0; s < kAhead && s < stages; ++s) fetch(s);
  } else {
    for (int s = 0; s < kAhead && s < stages; ++s) fetch(s);
  }

  const int c = min(ch, di - 1);
  float av[kStates], h[kStates];
  load_state<kVec>(a + (long long)c * DS + kStates * q, av);
  load_state<kVec>(h0 + ((long long)b * di + c) * DS + kStates * q, h);
  float carry = 0.f;  // lane q - 1's partial sum of this lane's next step

#pragma unroll 1
  for (int k = 0; k < rounds; ++k) {
    if constexpr (kVec) {
      fence_async();  // the y written so far, before the bulk stores
      if (threadIdx.x >= 32 && threadIdx.x < 64) bulk_wait_read();
    }
    // every lane is past stage k - 2, and stage k - 3's y is out: its rows
    // take stage k + kAhead
    __syncthreads();
    if (k + kAhead < stages && (!kVec || threadIdx.x < 32))
      fetch(k + kAhead);
    if (k >= 2) drain(k - 2);
    if (kVec && k < stages)
      mbar_wait(smem(&ring.full[k % kRing]), k / kRing & 1);

    const int i0 = k * kSteps;
    // one iteration: this lane's step i0 + u - q, then the hand-off
    auto step = [&](int u, bool valid) {
      const int r = (i0 + u - q) & (kRows - 1);
      float part = q == 0 ? 0.f : carry;
      if (valid) {
        const float d = ring.dt[r][cl];
        const float dx = __fmul_rn(d, to_f32(ring.x[r][cl]));
        float bb[kStates], cc[kStates];
#pragma unroll
        for (int j = 0; j < kStates; j += 4) {
          load4(&ring.b[r][kStates * q + j], bb + j);
          load4(&ring.c[r][kStates * q + j], cc + j);
        }
#pragma unroll
        for (int s = 0; s < kStates; ++s) {
          const float da = expf(__fmul_rn(d, av[s]));
          h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(dx, bb[s]));
          part = __fadd_rn(part, __fmul_rn(h[s], cc[s]));
        }
        if (q == G - 1) ring.dt[r][cl] = part;
      }
      carry = __shfl_up_sync(0xffffffffu, part, 1, G);
    };
    if (k >= 1 && i0 + kSteps <= steps) {
      // every lane has a step at every iteration of this stage
#pragma unroll
      for (int u = 0; u < kSteps; ++u) step(u, true);
    } else {
      const int n = min(kSteps, iters - i0);
      for (int u = 0; u < n; ++u)
        step(u, (unsigned)(i0 + u - q) < (unsigned)steps);
    }
  }
  if constexpr (kVec) fence_async();
  __syncthreads();  // every step is done
  for (int s = max(rounds - 2, 0); s < stages; ++s) drain(s);
  if constexpr (kVec) {
    if (threadIdx.x >= 32 && threadIdx.x < 64) bulk_wait();
  }
  if (ch < di)
    store_state<kVec>(hT + ((long long)b * di + ch) * DS + kStates * q, h);
}

template <typename T, int DS, bool kVec>
int launch_kernel(const void* dt, const void* x, const void* bt,
                  const void* ct, const void* a, const void* h0, void* y,
                  void* hT, int b, int steps, int di, cudaStream_t stream) {
  using R = Ring<T, DS>;
  constexpr size_t bytes = sizeof(R);
  const auto kernel = mamba_scan_kernel<T, DS, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((di + R::kCh - 1) / R::kCh, b);
  kernel<<<grid, kThreads, bytes, stream>>>(
      (const float*)dt, (const T*)x, (const T*)bt, (const T*)ct,
      (const float*)a, (const float*)h0, (float*)y, (float*)hT, steps, di);
  return (int)cudaGetLastError();
}

template <typename T, int DS>
int launch_ds(const void* dt, const void* x, const void* bt, const void* ct,
              const void* a, const void* h0, void* y, void* hT, int b,
              int steps, int di, bool vec, cudaStream_t stream) {
  return vec ? launch_kernel<T, DS, true>(dt, x, bt, ct, a, h0, y, hT, b,
                                          steps, di, stream)
             : launch_kernel<T, DS, false>(dt, x, bt, ct, a, h0, y, hT, b,
                                           steps, di, stream);
}

template <typename T>
int launch(int ds, const void* dt, const void* x, const void* bt,
           const void* ct, const void* a, const void* h0, void* y, void* hT,
           int b, int steps, int di, cudaStream_t stream) {
  // 16-byte accesses need every pointer 16-byte aligned and rows of dt, x
  // and y that are whole 16-byte chunks of x
  const uintptr_t any = (uintptr_t)dt | (uintptr_t)x | (uintptr_t)bt |
                        (uintptr_t)ct | (uintptr_t)a | (uintptr_t)h0 |
                        (uintptr_t)y | (uintptr_t)hT;
  const bool vec = (any & 15) == 0 && di % (16 / (int)sizeof(T)) == 0;
  switch (ds) {
    case 8:
      return launch_ds<T, 8>(dt, x, bt, ct, a, h0, y, hT, b, steps, di, vec,
                             stream);
    case 16:
      return launch_ds<T, 16>(dt, x, bt, ct, a, h0, y, hT, b, steps, di, vec,
                              stream);
    case 32:
      return launch_ds<T, 32>(dt, x, bt, ct, a, h0, y, hT, b, steps, di, vec,
                              stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dt, y: (b, steps, di) f32; x: (b, steps, di) and bt, ct: (b, steps, ds)
// in f32 (dtype 0) or bf16 (dtype 1); a: (di, ds) f32; h0, hT: (b, di, ds)
// f32; contiguous, on the current device; ds in {8, 16, 32}.  Returns the
// CUDA error of the launch (0 on success).
int repro_mamba_scan(const void* dt, const void* x, const void* bt,
                     const void* ct, const void* a, const void* h0, void* y,
                     void* hT, int b, int steps, int di, int ds, int dtype,
                     void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch<float>(ds, dt, x, bt, ct, a, h0, y, hT, b, steps, di, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(ds, dt, x, bt, ct, a, h0, y, hT, b, steps,
                                 di, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
