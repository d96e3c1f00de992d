// RWKV-6 WKV recurrence (K5) for Hopper, sm_90a: a row-split wavefront.
//
// Replaces src/repro/kernels/rwkv6/kernel.py::_wkv_kernel, the Pallas TPU
// kernel behind wkv().  Per (batch row, head), over t = 0 .. T-1, with the
// (HD x HD) f32 state S carried from s0:
//
//     kv_ij  = k_i * v_j
//     att_ij = S_ij + u_i * kv_ij
//     y_j    = sum_i r_i * att_ij         (added from i = 0 up)
//     S_ij  <- w_i * S_ij + kv_ij
//
// in that order (the order of ref.py and of the model's _wkv_chunk), all in
// f32; y goes out in r's dtype and the final S as sT in f32 (the prefill ->
// decode handoff).  r, k, v, y are (B, T, H, HD) in f32 or bf16, w is
// (B, T, H, HD) f32 (the model makes the decay in f32), u (H, HD) f32,
// s0 and sT (B, H, HD, HD) f32, S_ij at [i][j]; all contiguous, and r, k,
// v, w 16-byte aligned (cp.async).
//
// Every multiply and add is a separately rounded __fmul_rn / __fadd_rn
// (and the build passes -fmad=false), and y_j is summed over i from 0 up,
// as ref.py does: so the kernel is bit-equal to its plain version on the
// card.  The state is a long f32 recurrence whose terms cancel (with decay
// near 1 it sums ~100 outer products), and an FMA or another summation
// order moves y by more than the 3e-5 the port holds its kernels to at the
// model's activations; bit-equality removes that question.
//
// Bound: on paper, bytes.  At the serve path's prefill (B 4, T 512, H 32,
// HD 64, f32) the kernel reads r, k, v, w and s0 and writes y and sT
// once, 88 MB (0.026 ms at 3.35 TB/s).  The function needs 5 operations
// per state element per step, 1.36 GFLOP (0.020 ms at 67 TFLOP/s); this
// kernel does 7, to round as ref.py does, and with one block per (b, h)
// the 128 heads of the prefill fill 128 of the 132 SMs: the f32 pipes then
// need about 0.058 ms.  In fact it is bound by its T sequential steps:
// each step needs the last one's S, y_j is a chain of HD dependent adds,
// and a step shared between warps costs a barrier.  At a decode step
// (T = 1) the state dominates: 4.2 MB of s0 and sT, and the kernel takes
// about as long as a copy of those bytes (PERF.md).
//
// Design: one block per (b, h) of G x HD threads (G = 4 row groups: 8 warps
// at HD 64).  Thread (g, j) keeps rows i in [g HD/G, (g+1) HD/G) of column
// j of S in registers, so the state never leaves the SM between steps and
// S's update is local to the group.  y_j's sum still runs over i from 0
// up, so it passes through the groups in order: group 0 starts at 0.f,
// adds its HD/G terms and hands the partial sum to group 1 through shared
// memory; the last group writes y.  The steps go through in blocks of
// U = 4: at loop iteration it, group g works on block it - g, so one
// barrier serves U steps of a skewed wavefront of T/U + G - 1 iterations,
// and each step's dependent chain is HD/G adds, not HD.  Each step's r, k,
// v and w (1 KB at HD 64, f32) are staged by cp.async in a ring of 8
// blocks, fetched 8 - G - 1 blocks ahead of the block that group 0 works
// on.  A full block of U steps runs without a branch: group 0 reads its
// partial sums from a slot that stays 0.f, and every group writes its
// own.  State reads and writes are coalesced along j.  T is bounded by the
// loop: the Pallas kernel's padding with w = 1 has no counterpart.  G and U
// were chosen by measurement on the card (PERF.md): G = 4 over 2 (and 8,
// one step a barrier), U = 4 over 1, 2 and 8.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kGroups = 4;  // row groups of a block
constexpr int kUnroll = 4;  // steps a group takes between two barriers
constexpr int kRing = 8;    // blocks of kUnroll steps in shared memory
// blocks fetched ahead: a slot is refilled one barrier after its last reader
constexpr int kAhead = kRing - kGroups - 1;
static_assert(kAhead >= 1, "the ring must outrun the wavefront");

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// n consecutive values of a staged step, 16-byte aligned, as f32
template <int N>
__device__ __forceinline__ void load_rows(const float* p, float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 e = *reinterpret_cast<const float4*>(p + i);
    x[i] = e.x;
    x[i + 1] = e.y;
    x[i + 2] = e.z;
    x[i + 3] = e.w;
  }
}
template <int N>
__device__ __forceinline__ void load_rows(const __nv_bfloat16* p,
                                          float (&x)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const float2 e = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(p + i));
    x[i] = e.x;
    x[i + 1] = e.y;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One step of one head's inputs, as they lie in device memory.
template <typename T, int HD>
struct Step {
  T r[HD], k[HD], v[HD];
  float w[HD];
};

// Stage steps t0 .. t0 + kUnroll - 1 (those before steps) of one head,
// whose step t starts at element base + t * stride of r, k, v and w.
template <typename T, int HD>
__device__ __forceinline__ void fetch(Step<T, HD>* dst, const T* r,
                                      const T* k, const T* v, const float* w,
                                      long long base, long long stride,
                                      int t0, int steps) {
  constexpr int kEl = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int kC = HD / kEl;               // chunks of r, k or v
  constexpr int kStep = 3 * kC + HD / 4;     // chunks of a step (w: f32)
  for (int c = threadIdx.x; c < kUnroll * kStep; c += blockDim.x) {
    const int q = c / kStep, e = c % kStep;
    if (t0 + q >= steps) break;
    const long long off = base + (t0 + q) * stride;
    Step<T, HD>& d = dst[q];
    if (e < kC)
      cp_async16(d.r + e * kEl, r + off + e * kEl);
    else if (e < 2 * kC)
      cp_async16(d.k + (e - kC) * kEl, k + off + (e - kC) * kEl);
    else if (e < 3 * kC)
      cp_async16(d.v + (e - 2 * kC) * kEl, v + off + (e - 2 * kC) * kEl);
    else
      cp_async16(d.w + (e - 3 * kC) * 4, w + off + (e - 3 * kC) * 4);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kGroups * HD)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ sT, int steps,
               int heads) {
  constexpr int kRows = HD / kGroups;  // rows of S a thread keeps
  static_assert(HD % kGroups == 0 && kRows % 4 == 0, "whole float4 rows");
  __shared__ __align__(16) unsigned char
      ring_raw[kRing * kUnroll * sizeof(Step<T, HD>)];
  // partial sums of y_j: group g reads slot g and writes slot g + 1; slot
  // 0 stays 0.f, where group 0 starts (the last slot is never read)
  __shared__ float part[2][kGroups + 1][kUnroll][HD];
  Step<T, HD>* ring = reinterpret_cast<Step<T, HD>*>(ring_raw);

  const int j = threadIdx.x % HD;
  const int g = threadIdx.x / HD;  // one group per HD / 32 warps
  const int i0 = g * kRows;
  const int bh = blockIdx.x;  // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const float* s_in = s0 + (long long)bh * HD * HD;

  float s[kRows], uu[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    s[i] = s_in[(i0 + i) * HD + j];
    uu[i] = u[h * HD + i0 + i];
  }
  if (g == 0)
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) part[0][0][q][j] = part[1][0][q][j] = 0;

  const long long stride = (long long)heads * HD;  // one step
  const long long base = ((long long)b * steps * heads + h) * HD;
  const int blocks = (steps + kUnroll - 1) / kUnroll;  // of kUnroll steps
#pragma unroll 1
  for (int n = 0; n < kAhead; ++n) {
    if (n < blocks)
      fetch(ring + (n % kRing) * kUnroll, r, k, v, w, base, stride,
            n * kUnroll, steps);
    cp_async_commit();  // one group a block of steps, empty or not
  }

#pragma unroll 1
  for (int it = 0; it < blocks + kGroups - 1; ++it) {
    const int ahead = it + kAhead;
    if (ahead < blocks)
      fetch(ring + (ahead % kRing) * kUnroll, r, k, v, w, base, stride,
            ahead * kUnroll, steps);
    cp_async_commit();
    cp_async_wait<kAhead>();  // block it has landed
    __syncthreads();          // ... for every thread; part of it - 1 too

    const int n = it - g;  // this group's block of steps
    if (n < 0 || n >= blocks) continue;
    const Step<T, HD>* in = ring + (n % kRing) * kUnroll;
    const float* y_in = &part[(it - 1) & 1][g][0][j];
    float* y_out = &part[it & 1][g + 1][0][j];
    T* y_t = y + base + (long long)n * kUnroll * stride + j;
    // one step; the same operations for every step, so that a full block
    // of steps runs without a branch
    auto step = [&](int q) {
      float y_j = y_in[q * HD];
      const float v_j = to_f32(in[q].v[j]);
      float rr[kRows], kk[kRows], ww[kRows];
      load_rows(in[q].r + i0, rr);
      load_rows(in[q].k + i0, kk);
      load_rows(in[q].w + i0, ww);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float kv = __fmul_rn(kk[i], v_j);
        const float att = __fadd_rn(s[i], __fmul_rn(uu[i], kv));
        y_j = __fadd_rn(y_j, __fmul_rn(rr[i], att));
        s[i] = __fadd_rn(__fmul_rn(ww[i], s[i]), kv);
      }
      y_out[q * HD] = y_j;
      if (g == kGroups - 1) store(&y_t[q * stride], y_j);
    };
    if ((n + 1) * kUnroll <= steps) {
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) step(q);
    } else {
      for (int q = 0; n * kUnroll + q < steps; ++q) step(q);
    }
  }
  cp_async_wait<0>();

  float* s_out = sT + (long long)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < kRows; ++i) s_out[(i0 + i) * HD + j] = s[i];
}

template <typename T, int HD>
void launch_hd(const void* r, const void* k, const void* v, const void* w,
               const void* u, const void* s0, void* y, void* sT, int b,
               int steps, int heads, cudaStream_t stream) {
  wkv_kernel<T, HD><<<b * heads, kGroups * HD, 0, stream>>>(
      (const T*)r, (const T*)k, (const T*)v, (const float*)w,
      (const float*)u, (const float*)s0, (T*)y, (float*)sT, steps, heads);
}

template <typename T>
int launch(int hd, const void* r, const void* k, const void* v,
           const void* w, const void* u, const void* s0, void* y, void* sT,
           int b, int steps, int heads, cudaStream_t stream) {
  switch (hd) {
    case 32:
      launch_hd<T, 32>(r, k, v, w, u, s0, y, sT, b, steps, heads, stream);
      break;
    case 64:
      launch_hd<T, 64>(r, k, v, w, u, s0, y, sT, b, steps, heads, stream);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, v, y: (b, steps, heads, hd) f32 (dtype 0) or bf16 (dtype 1);
// w: (b, steps, heads, hd) f32; u: (heads, hd) f32; s0, sT:
// (b, heads, hd, hd) f32; contiguous, on the current device; hd in
// {32, 64}; r, k, v and w 16-byte aligned, else
// cudaErrorMisalignedAddress.  Returns the CUDA error of the launch (0 on
// success).
int repro_wkv(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sT, int b,
              int steps, int heads, int hd, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)r | (uintptr_t)k | (uintptr_t)v | (uintptr_t)w) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 0)
    return launch<float>(hd, r, k, v, w, u, s0, y, sT, b, steps, heads, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(hd, r, k, v, w, u, s0, y, sT, b, steps,
                                 heads, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
