// Fused federated server step (K1) for Hopper, sm_90a.
//
// Replaces src/repro/kernels/server_step/kernel.py::_server_step_kernel, the
// Pallas TPU kernel behind FusedServerStep.  One pass over the round's flat
// f32 parameter buffer does the whole server side of a federated round:
//
//     g    = c_0*g_0 + c_1*g_1 + ... + c_{M-1}*g_{M-1}   (left to right)
//     g   += wd*p                                         (only if wd != 0)
//     acc' = acc + g*g
//     p'   = p - (lr*g) * rsqrt(beta + acc')
//
// where c_m is member m's clip scale times its normalised work weight.
//
// Bound: memory.  Per element it reads p, acc and M gradients and writes p'
// and acc': (M+4)*4 bytes for about 2M+7 flops, far below the card's balance
// point.  At the FIG4 net with M = 4 that is 609,258 * 32 B = 19.5 MB, so
// 5.8 us at 3.35 TB/s.
//
// Design, simple first: a grid-stride loop, one element per thread per trip,
// the ragged tail masked by the loop bound.  The TPU kernel's (8, 1024) tile
// padding is not carried over: the buffer is used as it is.  The M
// coefficients are read once per block into shared memory.  Every multiply
// and add is a separately rounded __fmul_rn/__fadd_rn (and the build passes
// -fmad=false), and the reciprocal square root is rsqrtf, which eager
// torch.rsqrt uses on CUDA: so the result is bit-equal to ref.py's eager
// PyTorch on the card, and FusedServerStep stays bit-equal to TreeServerStep.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
// 132 SMs x 8 resident blocks of 256 threads: enough to fill the card; the
// grid-stride loop covers the rest.
constexpr long long kMaxBlocks = 132 * 8;

__global__ void server_step_kernel(const float* __restrict__ p,
                                   const float* __restrict__ g,
                                   const float* __restrict__ acc,
                                   const float* __restrict__ coeffs,
                                   float* __restrict__ p_out,
                                   float* __restrict__ acc_out,
                                   long long n, int members, float lr,
                                   float beta, int use_wd, float wd) {
  extern __shared__ float c[];
  for (int m = threadIdx.x; m < members; m += blockDim.x) c[m] = coeffs[m];
  __syncthreads();
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    float gs = __fmul_rn(c[0], g[i]);
    for (int m = 1; m < members; ++m)
      gs = __fadd_rn(gs, __fmul_rn(c[m], g[(long long)m * n + i]));
    const float pi = p[i];
    if (use_wd) gs = __fadd_rn(gs, __fmul_rn(wd, pi));
    const float a = __fadd_rn(acc[i], __fmul_rn(gs, gs));
    const float step = __fmul_rn(__fmul_rn(lr, gs), rsqrtf(__fadd_rn(beta, a)));
    p_out[i] = __fsub_rn(pi, step);
    acc_out[i] = a;
  }
}

}  // namespace

extern "C" {

// p, acc, p_out, acc_out: f32 [n]; g: f32 [members, n]; coeffs: f32
// [members], all on the current device.  Returns cudaGetLastError() after
// the launch (0 on success).
int repro_server_step(const void* p, const void* g, const void* acc,
                      const void* coeffs, void* p_out, void* acc_out,
                      long long n, int members, float lr, float beta,
                      int use_wd, float wd, void* stream) {
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  server_step_kernel<<<(unsigned)blocks, kThreads, members * sizeof(float),
                       (cudaStream_t)stream>>>(
      (const float*)p, (const float*)g, (const float*)acc,
      (const float*)coeffs, (float*)p_out, (float*)acc_out, n, members, lr,
      beta, use_wd, wd);
  return (int)cudaGetLastError();
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
