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
// where c_m is member m's clip scale times its normalised work weight.  The
// M member gradients are the rows of a stack whose rows lie ld >= n
// elements apart (FusedServerStep pads each row to a 128-byte line, as the
// TPU kernel pads its buffers to (8, 1024) tiles); pad columns are never
// read.
//
// Bound: memory.  Per element it reads p, acc and M gradients and writes p'
// and acc': (M+4)*4 bytes for about 2M+7 flops, far below the card's balance
// point.  At the FIG4 net with M = 4 that is 609,258 * 32 B = 19.5 MB, so
// 5.8 us at 3.35 TB/s.
//
// Design:
//   * 16-byte streams.  Where the five base pointers are 16-byte aligned and
//     ld is a multiple of 4 (so every row starts aligned; a stack of one row
//     needs no ld), each thread moves 4 elements of p, acc, p', acc' and of
//     every gradient row an access, as float4s.  No byte is read twice: the
//     gradient rows are loaded and the outputs stored evict-first
//     (__ldcs/__stcs); p and acc go through the read-only path (__ldg),
//     which the card ran 4% faster at 537 MB and no slower at the FIG4 step
//     than __ldcs (PERF.md).  The ragged tail
//     (n mod 4 elements), and any stack or view that misses those
//     conditions (a contiguous stack at n mod 4 != 0, a view at an odd
//     offset), take a scalar path: one element a thread an access,
//     neighbouring threads on neighbouring addresses.  Nothing is padded.
//   * M a template parameter, 1..8, and a generic loop beyond: with M known
//     every load of an access (M gradients, p and acc) is issued before the
//     first add.  The coefficients are read once a thread from device
//     memory (uniform loads); the generic loop reads each as it adds.
//   * One wave: the grid is the card's SMs times the blocks one SM holds
//     (queried, not assumed), or fewer for a small n; each thread takes
//     kUnroll 16-byte accesses a trip (4 x kUnroll on the scalar path), all
//     loaded before any is computed: at M = 4, 96 bytes in flight a thread.
//     kUnroll 1 and 256 threads a block were the fastest at the FIG4 step
//     of those tried (PERF.md).
//
// Every multiply and add is a separately rounded __fmul_rn/__fadd_rn (and
// the build passes -fmad=false), in ref.py's order, and the reciprocal
// square root is rsqrtf, which eager torch.rsqrt uses on CUDA: so the result
// is bit-equal to ref.py's eager PyTorch on the card whichever path runs,
// and FusedServerStep stays bit-equal to TreeServerStep.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 1;  // 16-byte accesses a thread a trip
constexpr int kMaxM = 8;            // M of the largest instantiation
constexpr int kMaxDevices = 64;

struct Step {
  const float* p;
  const float* g;  // row m at g + m*ld
  const float* acc;
  const float* coeffs;
  float* p_out;
  float* acc_out;
  long long n, ld;
  int members, use_wd;
  float lr, beta, wd;
};

// W consecutive floats (W = 4: one 16-byte access); Stream: marked
// evict-first (__ldcs), else through the read-only path (__ldg)
template <int W, bool Stream>
__device__ __forceinline__ void load(const float* src, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4* a = reinterpret_cast<const float4*>(src);
    const float4 e = Stream ? __ldcs(a) : __ldg(a);
    v[0] = e.x;
    v[1] = e.y;
    v[2] = e.z;
    v[3] = e.w;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j)
      v[j] = Stream ? __ldcs(src + j) : __ldg(src + j);
  }
}
template <int W>
__device__ __forceinline__ void store(float* dst, const float (&v)[W]) {
  if constexpr (W == 4) {
    __stcs(reinterpret_cast<float4*>(dst),
           make_float4(v[0], v[1], v[2], v[3]));
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) __stcs(dst + j, v[j]);
  }
}

// one element from its member sum g, in ref.py's order
__device__ __forceinline__ void update(const Step& s, float g, float& p,
                                       float& a) {
  if (s.use_wd) g = __fadd_rn(g, __fmul_rn(s.wd, p));
  a = __fadd_rn(a, __fmul_rn(g, g));
  const float step =
      __fmul_rn(__fmul_rn(s.lr, g), rsqrtf(__fadd_rn(s.beta, a)));
  p = __fsub_rn(p, step);
}

// U accesses of W elements, access u at element (k0 + u*stride)*W, those
// below `units` accesses; all loads first, then the arithmetic and stores.
// M > 0: the stack has M rows and c holds their coefficients; M == 0: the
// generic loop over s.members rows.
template <int M, int W, int U>
__device__ __forceinline__ void trip(const Step& s,
                                     const float (&c)[M > 0 ? M : 1],
                                     long long k0, long long stride,
                                     long long units) {
  constexpr int kRows = M > 0 ? M : 1;
  float pv[U][W], av[U][W], gv[U][kRows][W];
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long k = k0 + u * stride;
    if (k < units) {
      const long long e = k * W;
#pragma unroll
      for (int m = 0; m < kRows; ++m)
        load<W, true>(s.g + m * s.ld + e, gv[u][m]);
      load<W, false>(s.p + e, pv[u]);
      load<W, false>(s.acc + e, av[u]);
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const long long k = k0 + u * stride;
    if (k < units) {
      const long long e = k * W;
      float gs[W];
#pragma unroll
      for (int j = 0; j < W; ++j) gs[j] = __fmul_rn(c[0], gv[u][0][j]);
      if constexpr (M > 0) {
#pragma unroll
        for (int m = 1; m < M; ++m)
#pragma unroll
          for (int j = 0; j < W; ++j)
            gs[j] = __fadd_rn(gs[j], __fmul_rn(c[m], gv[u][m][j]));
      } else {
        for (int m = 1; m < s.members; ++m) {
          const float cm = __ldg(s.coeffs + m);
          float gm[W];
          load<W, true>(s.g + m * s.ld + e, gm);
#pragma unroll
          for (int j = 0; j < W; ++j)
            gs[j] = __fadd_rn(gs[j], __fmul_rn(cm, gm[j]));
        }
      }
#pragma unroll
      for (int j = 0; j < W; ++j) update(s, gs[j], pv[u][j], av[u][j]);
      store<W>(s.p_out + e, pv[u]);
      store<W>(s.acc_out + e, av[u]);
    }
  }
}

// W = 4: the 16-byte path (aligned pointers, ld a multiple of 4) and its
// scalar tail; W = 1: the scalar path, 4*kUnroll accesses a trip.
template <int M, int W>
__global__ void __launch_bounds__(kThreads)
    server_step_kernel(const __grid_constant__ Step s) {
  constexpr int kU = W == 4 ? kUnroll : 4 * kUnroll;
  float c[M > 0 ? M : 1];
#pragma unroll
  for (int m = 0; m < (M > 0 ? M : 1); ++m) c[m] = __ldg(s.coeffs + m);
  const long long units = s.n / W;
  const long long threads = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  for (long long k0 = tid; k0 < units; k0 += threads * kU)
    trip<M, W, kU>(s, c, k0, threads, units);
  if constexpr (W == 4) {
    // the ragged tail: n mod 4 elements, one a thread
    if (tid < s.n - units * 4) trip<M, 1, 1>(s, c, units * 4 + tid, 0, s.n);
  }
}

// blocks of kernel<M, W> one SM holds, per device (queried once)
template <int M, int W>
int blocks_per_sm(int device) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 1;
  if (!cached[device]) {
    int nb = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &nb, server_step_kernel<M, W>, kThreads, 0);
    cached[device] = nb > 0 ? nb : 1;
  }
  return cached[device];
}

int sm_count(int device) {
  static int cached[kMaxDevices];
  if (device < 0 || device >= kMaxDevices) return 1;
  if (!cached[device]) {
    int sms = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    cached[device] = sms > 0 ? sms : 1;
  }
  return cached[device];
}

template <int M, int W>
int launch(const Step& s, cudaStream_t stream) {
  int device = 0;
  cudaGetDevice(&device);
  const long long wave =
      (long long)sm_count(device) * blocks_per_sm<M, W>(device);
  const long long per_block = (long long)kThreads * (W == 4 ? kUnroll
                                                            : 4 * kUnroll);
  long long blocks = (s.n / W + per_block - 1) / per_block;
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;  // the tail alone
  server_step_kernel<M, W><<<(unsigned)blocks, kThreads, 0, stream>>>(s);
  return (int)cudaGetLastError();
}

template <int W>
int dispatch(const Step& s, cudaStream_t stream) {
  switch (s.members) {
    case 1: return launch<1, W>(s, stream);
    case 2: return launch<2, W>(s, stream);
    case 3: return launch<3, W>(s, stream);
    case 4: return launch<4, W>(s, stream);
    case 5: return launch<5, W>(s, stream);
    case 6: return launch<6, W>(s, stream);
    case 7: return launch<7, W>(s, stream);
    case 8: return launch<8, W>(s, stream);
    default: return launch<0, W>(s, stream);
  }
}
static_assert(kMaxM == 8, "dispatch instantiates M = 1..8");

}  // namespace

extern "C" {

// p, acc, p_out, acc_out: f32 [n]; g: f32 [members rows, ld apart, n each];
// coeffs: f32 [members]; all on the current device.  One launch.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for n < 1, members < 1 or ld < n.
int repro_server_step_pitched(const void* p, const void* g, const void* acc,
                              const void* coeffs, void* p_out, void* acc_out,
                              long long n, long long ld, int members,
                              float lr, float beta, int use_wd, float wd,
                              void* stream) {
  if (n < 1 || members < 1 || ld < n) return (int)cudaErrorInvalidValue;
  const Step s{(const float*)p, (const float*)g,     (const float*)acc,
               (const float*)coeffs, (float*)p_out, (float*)acc_out,
               n, ld, members, use_wd, lr, beta, wd};
  const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(acc) |
                         reinterpret_cast<uintptr_t>(p_out) |
                         reinterpret_cast<uintptr_t>(acc_out)) & 15) == 0 &&
                       (members == 1 || ld % 4 == 0);
  const cudaStream_t st = (cudaStream_t)stream;
  return aligned ? dispatch<4>(s, st) : dispatch<1>(s, st);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
