// RWKV-6 WKV recurrence (K5) for Hopper, sm_90a.
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
// s0 and sT (B, H, HD, HD) f32, S_ij at [i][j]; all contiguous.
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
// per state element per step (y_j = sum_i r_i S_ij + v_j sum_i r_i u_i k_i
// is 2, S' = w S + k v is 3), 1.36 GFLOP (0.020 ms at 67 TFLOP/s); this
// kernel does 7, to round as ref.py does.  In fact it is bound by its T
// sequential steps: each step needs the last one's S, and y_j is a chain
// of HD dependent adds.  At a decode step (T = 1) the state dominates:
// 4.2 MB of s0 and sT.
//
// Design, simple first: one block per (b, h) with HD threads; thread j owns
// column j of S in HD registers, so the state never leaves the SM between
// steps.  Each step's r_i, k_i, w_i (with u_i) are broadcast to the block
// through shared memory as one float4 per i, double-buffered so that one
// barrier a step suffices; the next step's inputs are loaded into
// registers before this step's work, so their latency hides behind it.
// T is bounded by the loop: the Pallas kernel's padding with w = 1 has no
// counterpart.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

template <typename T, int HD>
__global__ void __launch_bounds__(HD)
    wkv_kernel(const T* __restrict__ r, const T* __restrict__ k,
               const T* __restrict__ v, const float* __restrict__ w,
               const float* __restrict__ u, const float* __restrict__ s0,
               T* __restrict__ y, float* __restrict__ sT, int steps,
               int heads) {
  __shared__ float4 rkwu[2][HD];  // (r_i, k_i, w_i, u_i) of one step

  const int j = threadIdx.x;
  const int bh = blockIdx.x;  // b * heads + h
  const int b = bh / heads, h = bh % heads;
  const float u_j = u[h * HD + j];
  const float* s_in = s0 + (long long)bh * HD * HD;

  float s[HD];
#pragma unroll
  for (int i = 0; i < HD; ++i) s[i] = s_in[i * HD + j];

  const long long stride = (long long)heads * HD;  // one step
  long long off = ((long long)b * steps * heads + h) * HD + j;
  float r_n = 0.f, k_n = 0.f, v_n = 0.f, w_n = 0.f;
  if (steps > 0) {
    r_n = to_f32(r[off]);
    k_n = to_f32(k[off]);
    v_n = to_f32(v[off]);
    w_n = w[off];
  }
  for (int t = 0; t < steps; ++t) {
    const float r_j = r_n, k_j = k_n, v_j = v_n, w_j = w_n;
    const long long here = off;
    if (t + 1 < steps) {
      off += stride;
      r_n = to_f32(r[off]);
      k_n = to_f32(k[off]);
      v_n = to_f32(v[off]);
      w_n = w[off];
    }
    float4* buf = rkwu[t & 1];
    buf[j] = make_float4(r_j, k_j, w_j, u_j);
    __syncthreads();
    float y_j = 0.f;
#pragma unroll
    for (int i = 0; i < HD; ++i) {
      const float4 e = buf[i];
      const float kv = __fmul_rn(e.y, v_j);
      const float att = __fadd_rn(s[i], __fmul_rn(e.w, kv));
      y_j = __fadd_rn(y_j, __fmul_rn(e.x, att));
      s[i] = __fadd_rn(__fmul_rn(e.z, s[i]), kv);
    }
    store(&y[here], y_j);
  }

  float* s_out = sT + (long long)bh * HD * HD;
#pragma unroll
  for (int i = 0; i < HD; ++i) s_out[i * HD + j] = s[i];
}

template <typename T>
int launch(int hd, const void* r, const void* k, const void* v,
           const void* w, const void* u, const void* s0, void* y, void* sT,
           int b, int steps, int heads, cudaStream_t stream) {
  const dim3 grid(b * heads);
  switch (hd) {
    case 32:
      wkv_kernel<T, 32><<<grid, 32, 0, stream>>>(
          (const T*)r, (const T*)k, (const T*)v, (const float*)w,
          (const float*)u, (const float*)s0, (T*)y, (float*)sT, steps,
          heads);
      break;
    case 64:
      wkv_kernel<T, 64><<<grid, 64, 0, stream>>>(
          (const T*)r, (const T*)k, (const T*)v, (const float*)w,
          (const float*)u, (const float*)s0, (T*)y, (float*)sT, steps,
          heads);
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
// {32, 64}.  Returns the CUDA error of the launch (0 on success).
int repro_wkv(const void* r, const void* k, const void* v, const void* w,
              const void* u, const void* s0, void* y, void* sT, int b,
              int steps, int heads, int hd, int dtype, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
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
