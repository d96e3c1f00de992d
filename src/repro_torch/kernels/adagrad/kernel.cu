// Fused modified-AdaGrad step (K2) over a list of leaves, for Hopper, sm_90a.
//
// Replaces src/repro/kernels/adagrad/kernel.py::_adagrad_kernel, the Pallas
// TPU kernel behind repro.optim.adagrad(use_kernel=True).  Per element of
// every leaf:
//
//     g'   = g + wd*p                      (only if wd != 0)
//     acc' = acc + g'*g'
//     p'   = p - (lr*g') * rsqrt(beta + acc')
//
// in f32 whatever the dtype of p and g (f32 or bf16); acc is f32 and p' is
// written in p's dtype.
//
// Bound: launches, then bytes.  Per element the step reads p, g, acc and
// writes p', acc' (20 B in f32) for about 7 flops.  The paper's FIG2 net
// has 22,466 params in 8 leaves: a whole step moves 0.45 MB, which the card
// streams in about 0.13 us, while one launch alone costs a few microseconds
// of card time.  The JAX package launches once a leaf; the first version
// of this kernel did too, and a FIG2 step paid 8 launches.  At a million
// f32 elements the bytes bound it (20 MB, 6 us at 3.35 TB/s).
//
// Design: one launch updates a list of up to kMaxLeaves leaves of one
// (p dtype, g dtype) pair; the wrapper cuts a longer list, and launches
// once for each pair present.  The leaves' pointers, element counts and
// first block index travel by value in a __grid_constant__ parameter
// struct (3.6 KB), so the launch needs no upload.  Each block finds its
// (leaf, chunk) by walking the leaves' first block indices, then updates
// a chunk of kThreads x 16 bytes of p: every thread moves 16 bytes of each
// array an access (4 f32, or 8 bf16, through 16-byte loads and stores),
// neighbouring threads on neighbouring addresses.  A leaf whose five
// pointers are not all 16-byte aligned (a view at an odd offset) takes a
// scalar path, one element a thread an access, coalesced; so does the
// ragged tail of an aligned leaf.  Nothing is padded.
//
// Every multiply and add is a separately rounded __fmul_rn/__fadd_rn (and
// the build passes -fmad=false), in the plain version's order, and the
// reciprocal square root is rsqrtf, which eager torch.rsqrt uses on CUDA:
// each leaf's p' and acc' are bit-equal to
// repro_torch.optim.adagrad_math.adagrad_leaf_update run eagerly on the
// card, whichever path the leaf takes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLeaves = 64;  // ops.py's MAX_LEAVES

struct Leaf {
  const void* p;
  const void* g;
  const float* acc;
  void* p_out;
  float* acc_out;
  long long n;       // elements
  long long block0;  // the launch's first block on this leaf
};

struct Leaves {
  Leaf leaf[kMaxLeaves];
  int count;
  int use_wd;
  float lr, beta, wd;
};

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

// 16 bytes of T as f32 values, and back; the address is 16-byte aligned.
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* src, float* v) {
    const float4 e = *reinterpret_cast<const float4*>(src);
    v[0] = e.x;
    v[1] = e.y;
    v[2] = e.z;
    v[3] = e.w;
  }
  static __device__ __forceinline__ void store(float* dst, const float* v) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  // bf16 -> f32 is exact: the 16 bits become the top half of the f32
  static __device__ __forceinline__ void load(const __nv_bfloat16* src,
                                              float* v) {
    const uint4 e = *reinterpret_cast<const uint4*>(src);
    const unsigned w[4] = {e.x, e.y, e.z, e.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* dst,
                                               const float* v) {
    unsigned w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = (unsigned)__bfloat16_as_ushort(__float2bfloat16_rn(v[2 * j])) |
             ((unsigned)__bfloat16_as_ushort(
                  __float2bfloat16_rn(v[2 * j + 1]))
              << 16);
    *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// N consecutive values of T (N a multiple of Vec16<T>::N), 16-byte aligned
template <typename T, int N>
__device__ __forceinline__ void load_n(const T* src, float (&v)[N]) {
#pragma unroll
  for (int u = 0; u < N; u += Vec16<T>::N) Vec16<T>::load(src + u, v + u);
}
template <typename T, int N>
__device__ __forceinline__ void store_n(T* dst, const float (&v)[N]) {
#pragma unroll
  for (int u = 0; u < N; u += Vec16<T>::N) Vec16<T>::store(dst + u, v + u);
}

// one element, in the plain version's order: (p, g, acc) -> (p', acc')
__device__ __forceinline__ void adagrad_one(const Leaves& ls, float& p,
                                            float g, float& acc) {
  if (ls.use_wd) g = __fadd_rn(g, __fmul_rn(ls.wd, p));
  acc = __fadd_rn(acc, __fmul_rn(g, g));
  const float step =
      __fmul_rn(__fmul_rn(ls.lr, g), rsqrtf(__fadd_rn(ls.beta, acc)));
  p = __fsub_rn(p, step);
}

template <typename TP, typename TG>
__global__ void __launch_bounds__(kThreads)
    adagrad_kernel(const __grid_constant__ Leaves ls) {
  constexpr int kVec = 16 / (int)sizeof(TP);  // elements a thread a chunk
  constexpr long long kChunk = (long long)kThreads * kVec;

  const long long bid = blockIdx.x;
  int i = 0;
  while (i + 1 < ls.count && bid >= ls.leaf[i + 1].block0) ++i;
  const Leaf& leaf = ls.leaf[i];
  const TP* p = static_cast<const TP*>(leaf.p);
  const TG* g = static_cast<const TG*>(leaf.g);
  const float* acc = leaf.acc;
  TP* p_out = static_cast<TP*>(leaf.p_out);
  float* acc_out = leaf.acc_out;
  const long long n = leaf.n;
  const long long start = (bid - leaf.block0) * kChunk;

  const bool aligned = ((reinterpret_cast<uintptr_t>(p) |
                         reinterpret_cast<uintptr_t>(g) |
                         reinterpret_cast<uintptr_t>(acc) |
                         reinterpret_cast<uintptr_t>(p_out) |
                         reinterpret_cast<uintptr_t>(acc_out)) &
                        15) == 0;
  if (aligned) {
    const long long e0 = start + (long long)threadIdx.x * kVec;
    if (e0 + kVec <= n) {
      float pv[kVec], gv[kVec], av[kVec];
      load_n(p + e0, pv);
      load_n(g + e0, gv);
      load_n(acc + e0, av);
#pragma unroll
      for (int j = 0; j < kVec; ++j) adagrad_one(ls, pv[j], gv[j], av[j]);
      store_n(p_out + e0, pv);
      store_n(acc_out + e0, av);
      return;
    }
    // the ragged tail: this thread's elements below n, one at a time
    for (long long e = e0; e < n && e < e0 + kVec; ++e) {
      float pf = to_f32(p[e]), af = acc[e];
      adagrad_one(ls, pf, to_f32(g[e]), af);
      p_out[e] = from_f32<TP>(pf);
      acc_out[e] = af;
    }
    return;
  }
  // unaligned: the same chunk, one element a thread an access, coalesced
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const long long e = start + (long long)j * kThreads + threadIdx.x;
    if (e < n) {
      float pf = to_f32(p[e]), af = acc[e];
      adagrad_one(ls, pf, to_f32(g[e]), af);
      p_out[e] = from_f32<TP>(pf);
      acc_out[e] = af;
    }
  }
}

template <typename TP, typename TG>
int launch(const void* const* p, const void* const* g,
           const void* const* acc, void* const* p_out,
           void* const* acc_out, const long long* n, int count, float lr,
           float beta, int use_wd, float wd, cudaStream_t stream) {
  const long long chunk = (long long)kThreads * (16 / (int)sizeof(TP));
  Leaves ls;
  long long blocks = 0;
  for (int i = 0; i < count; ++i) {
    if (n[i] < 0) return (int)cudaErrorInvalidValue;
    ls.leaf[i] = Leaf{p[i],
                      g[i],
                      static_cast<const float*>(acc[i]),
                      p_out[i],
                      static_cast<float*>(acc_out[i]),
                      n[i],
                      blocks};
    blocks += (n[i] + chunk - 1) / chunk;
  }
  if (blocks == 0 || blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  ls.count = count;
  ls.use_wd = use_wd;
  ls.lr = lr;
  ls.beta = beta;
  ls.wd = wd;
  adagrad_kernel<TP, TG><<<(unsigned)blocks, kThreads, 0, stream>>>(ls);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// count leaves (1 <= count <= kMaxLeaves), leaf i being p[i], p_out[i]: [n[i]]
// in f32 (p_bf16 == 0) or bf16 (p_bf16 == 1); g[i]: [n[i]] in p's dtype
// or, for bf16 p, f32 (g_bf16 says which); acc[i], acc_out[i]: f32 [n[i]];
// all on the current device, the arrays of pointers and counts on the
// host.  One launch.  Returns cudaGetLastError() after the launch (0 on
// success), or cudaErrorInvalidValue for a count out of range, no element
// in all, or f32 p with bf16 g, which no caller makes.
int repro_adagrad_update_leaves(const void* const* p, const void* const* g,
                                const void* const* acc, void* const* p_out,
                                void* const* acc_out, const long long* n,
                                int count, int p_bf16, int g_bf16, float lr,
                                float beta, int use_wd, float wd,
                                void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (count < 1 || count > kMaxLeaves) return (int)cudaErrorInvalidValue;
  if (p_bf16 && g_bf16)
    return launch<__nv_bfloat16, __nv_bfloat16>(p, g, acc, p_out, acc_out, n,
                                                count, lr, beta, use_wd, wd,
                                                s);
  if (p_bf16)
    return launch<__nv_bfloat16, float>(p, g, acc, p_out, acc_out, n, count,
                                        lr, beta, use_wd, wd, s);
  if (g_bf16) return (int)cudaErrorInvalidValue;
  return launch<float, float>(p, g, acc, p_out, acc_out, n, count, lr, beta,
                              use_wd, wd, s);
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
