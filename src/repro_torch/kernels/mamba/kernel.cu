// Mamba selective scan (K4) for Hopper, sm_90a.
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
// Bound: bytes.  At the serve path's prefill (B 4, T 512, DI 16384, DS 16,
// f32) the kernel reads dt, x, b_t, c_t, a, h0 and writes y and hT once,
// 412 MB (0.123 ms at 3.35 TB/s).  The function needs 6 operations per
// state element a step (3 multiplies and 2 adds beside the product dt*a)
// and one (dt*x) per channel a step, 3.2 GFLOP (0.049 ms at 67 TFLOP/s);
// its 537 M exps, on the special-function unit at 16 a clock per SM, take
// about as long as the bytes (~0.13 ms at 1.98 GHz).  At a decode step
// (T = 1) the state dominates: 8.4 MB of h0 and hT of 10.2 MB.
//
// Design, simple first: one thread per (b, c) owns that channel's DS state
// values and DS entries of a in registers (templated on DS in {8, 16, 32}),
// 128 channels a block, one block row per batch row: 512 blocks at the
// prefill.  It walks T in order.  dt and x are read coalesced across the
// block's channels, the next step's loaded before this step's work so that
// their latency hides behind it.  b_t and c_t are the same for every
// channel of a batch row, so each block stages them in shared memory,
// kSteps steps at a time (the threads read the same address: a broadcast).
// Nothing is padded: a ragged last block of channels clamps its reads to
// the last channel and writes nothing, and T is bounded by the loop (the
// Pallas kernel's time padding, an identity step at dt = 0, has no
// counterpart).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // channels a block
constexpr int kSteps = 64;     // steps of b_t, c_t staged at once

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T, int DS>
__global__ void __launch_bounds__(kThreads)
    mamba_scan_kernel(const float* __restrict__ dt, const T* __restrict__ x,
                      const T* __restrict__ bt, const T* __restrict__ ct,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, float* __restrict__ y,
                      float* __restrict__ hT, int steps, int di) {
  __shared__ float sb[kSteps][DS];
  __shared__ float sc[kSteps][DS];

  const int b = blockIdx.y;
  const int ch = blockIdx.x * kThreads + threadIdx.x;
  const bool live = ch < di;
  const int c = live ? ch : di - 1;

  float a_r[DS], h[DS];
  const float* a_c = a + (long long)c * DS;
  const float* h_in = h0 + ((long long)b * di + c) * DS;
#pragma unroll
  for (int s = 0; s < DS; ++s) {
    a_r[s] = a_c[s];
    h[s] = h_in[s];
  }

  const long long row = (long long)b * steps;  // this batch row's step 0
  const float* dt_p = dt + row * di + c;
  const T* x_p = x + row * di + c;
  float* y_p = y + row * di + c;
  const T* b_row = bt + row * DS;
  const T* c_row = ct + row * DS;

  float dt_n = dt_p[0], x_n = to_f32(x_p[0]);
  for (int t0 = 0; t0 < steps; t0 += kSteps) {
    const int n = min(kSteps, steps - t0);
    __syncthreads();  // every thread is done with the last staged block
    for (int i = threadIdx.x; i < n * DS; i += kThreads) {
      (&sb[0][0])[i] = to_f32(b_row[(long long)t0 * DS + i]);
      (&sc[0][0])[i] = to_f32(c_row[(long long)t0 * DS + i]);
    }
    __syncthreads();
    for (int i = 0; i < n; ++i) {
      const int t = t0 + i;
      const float dt_v = dt_n, x_v = x_n;
      if (t + 1 < steps) {
        dt_n = dt_p[(long long)(t + 1) * di];
        x_n = to_f32(x_p[(long long)(t + 1) * di]);
      }
      const float dx = __fmul_rn(dt_v, x_v);
      float y_v = 0.f;
#pragma unroll
      for (int s = 0; s < DS; ++s) {
        const float da = expf(__fmul_rn(dt_v, a_r[s]));
        h[s] = __fadd_rn(__fmul_rn(da, h[s]), __fmul_rn(dx, sb[i][s]));
        y_v = __fadd_rn(y_v, __fmul_rn(h[s], sc[i][s]));
      }
      if (live) y_p[(long long)t * di] = y_v;
    }
  }

  if (live) {
    float* h_out = hT + ((long long)b * di + ch) * DS;
#pragma unroll
    for (int s = 0; s < DS; ++s) h_out[s] = h[s];
  }
}

template <typename T>
int launch(int ds, const void* dt, const void* x, const void* bt,
           const void* ct, const void* a, const void* h0, void* y, void* hT,
           int b, int steps, int di, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, b);
#define REPRO_MAMBA_CASE(DS)                                              \
  case DS:                                                                \
    mamba_scan_kernel<T, DS><<<grid, kThreads, 0, stream>>>(              \
        (const float*)dt, (const T*)x, (const T*)bt, (const T*)ct,        \
        (const float*)a, (const float*)h0, (float*)y, (float*)hT, steps, \
        di);                                                              \
    break;
  switch (ds) {
    REPRO_MAMBA_CASE(8)
    REPRO_MAMBA_CASE(16)
    REPRO_MAMBA_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_MAMBA_CASE
  return (int)cudaGetLastError();
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
