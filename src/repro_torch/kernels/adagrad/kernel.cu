// Fused modified-AdaGrad leaf step (K2) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/adagrad/kernel.py::_adagrad_kernel, the Pallas
// TPU kernel behind repro.optim.adagrad(use_kernel=True):
//
//     g'   = g + wd*p                      (only if wd != 0)
//     acc' = acc + g'*g'
//     p'   = p - (lr*g') * rsqrt(beta + acc')
//
// in f32 whatever the dtype of p and g (f32 or bf16); acc is f32 and p' is
// written in p's dtype.
//
// Bound: memory per launch, launch latency per step.  Per element it reads
// p, g, acc and writes p', acc' (20 B in f32) for about 7 flops.  But the
// optimizer launches once per leaf, as the JAX package does, and the paper's
// FIG2 net has 22,466 params in 8 leaves: a whole step moves 0.45 MB, which
// the card streams in about 0.13 us, far less than the few microseconds it
// takes to launch 8 kernels.  A multi-tensor launch is later work.
//
// Design, simple first: a grid-stride loop, one element per thread per trip,
// the ragged tail masked by the loop bound; no (8, 1024) tile padding.  Every
// multiply and add is a separately rounded __fmul_rn/__fadd_rn (and the build
// passes -fmad=false), and the reciprocal square root is rsqrtf, which eager
// torch.rsqrt uses on CUDA: the result is bit-equal to
// repro_torch.optim.adagrad_math.adagrad_leaf_update run eagerly on the card.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132 * 8;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename TP, typename TG>
__global__ void adagrad_kernel(const TP* __restrict__ p,
                               const TG* __restrict__ g,
                               const float* __restrict__ acc,
                               TP* __restrict__ p_out,
                               float* __restrict__ acc_out, long long n,
                               float lr, float beta, int use_wd, float wd) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float pf = to_f32(p[i]);
    float gf = to_f32(g[i]);
    if (use_wd) gf = __fadd_rn(gf, __fmul_rn(wd, pf));
    const float a = __fadd_rn(acc[i], __fmul_rn(gf, gf));
    const float step = __fmul_rn(__fmul_rn(lr, gf), rsqrtf(__fadd_rn(beta, a)));
    p_out[i] = from_f32<TP>(__fsub_rn(pf, step));
    acc_out[i] = a;
  }
}

template <typename TP, typename TG>
void launch(const void* p, const void* g, const void* acc, void* p_out,
            void* acc_out, long long n, float lr, float beta, int use_wd,
            float wd, cudaStream_t stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  adagrad_kernel<TP, TG><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const TP*)p, (const TG*)g, (const float*)acc, (TP*)p_out,
      (float*)acc_out, n, lr, beta, use_wd, wd);
}

}  // namespace

extern "C" {

// p, p_out: [n] in f32 (p_bf16 == 0) or bf16 (p_bf16 == 1); g: [n] in p's
// dtype or, for bf16 p, f32 (g_bf16 says which); acc, acc_out: f32 [n]; all
// on the current device.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for f32 p with bf16 g, which no caller
// makes.
int repro_adagrad_update(const void* p, const void* g, const void* acc,
                         void* p_out, void* acc_out, long long n, int p_bf16,
                         int g_bf16, float lr, float beta, int use_wd,
                         float wd, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (p_bf16 && g_bf16)
    launch<__nv_bfloat16, __nv_bfloat16>(p, g, acc, p_out, acc_out, n, lr,
                                         beta, use_wd, wd, s);
  else if (p_bf16)
    launch<__nv_bfloat16, float>(p, g, acc, p_out, acc_out, n, lr, beta,
                                 use_wd, wd, s);
  else if (g_bf16)
    return (int)cudaErrorInvalidValue;
  else
    launch<float, float>(p, g, acc, p_out, acc_out, n, lr, beta, use_wd, wd,
                         s);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
