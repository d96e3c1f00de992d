// Causal / sliding-window flash attention, forward only (K3), for Hopper,
// sm_90a: both products on the tensor cores at f32 accuracy.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::_flash_kernel, the
// Pallas TPU kernel behind flash_attention().  For every query row it
// computes softmax(q.K^T * scale) V over the keys the masks let it see,
// online over tiles of keys with a running max m, sum l and accumulator in
// f32, so the (Sq, Skv) score matrix never reaches device memory:
//
//     s     = (q . k) * scale            (scaled after the dot)
//     s     = visible ? s : -1e30
//     m'    = max(m, max_k s)
//     alpha = exp(m - m'),  p = visible ? exp(s - m') : 0
//     l'    = l * alpha + sum_k p,  acc' = acc * alpha + p V
//     out   = acc / max(l, 1e-30)        (in q's dtype)
//
// A key is visible when kpos < Skv, kpos <= qpos (causal) and
// kpos > qpos - window (window > 0), with both positions counted from 0 (the
// top-left alignment of the Pallas kernel).  A row that sees no key writes
// 0; the Pallas kernel's output for such a row depends on its block size.
//
// Layout: q (B, Sq, Hq, HD), k and v (B, Skv, Hkv, HD), out (B, Sq, Hq, HD),
// all contiguous and 16-byte aligned: the model's own layout, read through
// its strides, so nothing is transposed.  GQA: q head h reads kv head
// h / (Hq / Hkv), as the Pallas index map does; the repeat is never
// materialised.  Ragged Sq and Skv are bounded by the loops and masked:
// nothing is padded.
//
// Products: 3xTF32 on the tensor cores (mma.sync m16n8k8, f32 accumulate).
// Each f32 operand x is split as hi = tf32(x), lo = tf32(x - hi), both
// rounded as cvt.rna.tf32.f32 rounds (to nearest, ties away from zero),
// and a product is lo*hi + hi*lo + hi*hi, small terms first.  A product of
// two TF32 values is exact in f32, so only the dropped lo*lo (about 2^-22
// of the product) and the order of the sums differ from an f32 product:
// the kernel stays within the 3e-5 f32 bar of its plain version, where one
// TF32 pass misses it by about 40x.  bf16 inputs are exact in TF32 (lo =
// 0): q.K^T takes one pass and P V two (P is f32).
//
// Bound: operations.  At the serve path's prefill (B 4, S 512, Hq 32,
// Hkv 8, HD 128, causal, f32) the two products are 4*B*Hq*HD*S(S+1)/2 =
// 8.6 GFLOP; as three TF32 passes they take 0.052 ms at the card's 495
// TFLOP/s of dense TF32, against 0.025 ms for the 84 MB of q, k, v and out
// (the f32 CUDA cores would take 0.128 ms).  What holds it back is the
// warps' instruction rate: mma.sync takes 384 tensor-core instructions
// (three passes) per warp and 32-key tile at f32 HD 128, beside the split
// and the softmax; wgmma would take the products off the warps' own
// instruction stream (PERF.md).
//
// Design (FlashAttention-2 style): one block of 4 warps per (64-row query
// tile, q head, batch row); each warp owns 16 query rows.  The query tile
// and double-buffered key and value tiles are staged in shared memory by
// cp.async, so the next tile's copy overlaps this tile's products; each
// row is padded by 16 bytes, so that the fragment reads of q, K^T and V
// hit 32 distinct banks.  The hi/lo split is done as a fragment is read
// from shared memory, each rounding in two integer instructions (the PTX
// cvt.rna.tf32.f32 compiles to four, guarding inf and NaN, and the kernel
// took 1.19x as long with it).  Splitting once per tile into hi/lo arrays
// would need twice the shared memory of the key and value tiles and cost
// the second block on each SM; q stays in shared memory because its split
// fragments would not fit the registers at HD 128.  The score tile's C
// fragment is reused as the A fragment of P V without a shuffle: within
// each 8-key step the keys are taken in the order 0, 2, 4, 6, 1, 3, 5, 7,
// for P and V alike, which leaves the sum unchanged.  The online softmax
// stays in f32 registers, in base 2 (the scale folded with log2(e), exp as
// ex2.approx, relative error about 2^-22); a row's max and sum reduce over
// the 4 lanes of an mma quad.  Key tiles hold 64 keys, or 32 at f32 HD
// 128, so that two blocks (8 warps) fit an SM.  Tiles wholly above the
// causal diagonal or below the window are skipped, as in the Pallas
// kernel; only tiles that cross an edge compute the mask.  The grid runs
// the heaviest (last) query tiles first, so that the last wave is not the
// longest.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBQ = 16 * kWarps;  // query rows per block
constexpr float kNegInf = -1e30f;

// Keys per tile: 64, or 32 where 64 would keep a second block off the SM.
template <typename T, int HD>
__host__ __device__ constexpr int tile_keys() {
  return HD * (int)sizeof(T) > 256 ? 32 : 64;
}

// A staged row: HD elements and 16 bytes of padding.
template <typename T, int HD>
__host__ __device__ constexpr int row_stride() {
  return HD + 16 / (int)sizeof(T);
}

template <typename T, int HD>
constexpr size_t smem_bytes() {
  // q tile, then 2 key tiles, then 2 value tiles
  return sizeof(T) * row_stride<T, HD>() * (kBQ + 4 * tile_keys<T, HD>());
}

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  // round to nearest even, as torch's .to()
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// 2^x (ex2.approx: relative error about 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // 16 bytes, or 16 zero bytes when !valid (src-size 0 reads nothing)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows pos0 .. pos0 + ROWS - 1 of a (pos, HD) slice with row stride
// gstride (elements) into a staged tile; rows at or past npos are zeros.
template <typename T, int HD, int ROWS>
__device__ __forceinline__ void stage(T* dst, const T* src,
                                      long long gstride, int pos0,
                                      int npos) {
  constexpr int kEl = 16 / (int)sizeof(T);  // elements per 16 bytes
  constexpr int kChunks = HD / kEl;          // 16-byte chunks per row
  static_assert(ROWS * kChunks % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int i = 0; i < ROWS * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks, e = (c % kChunks) * kEl;
    const bool ok = pos0 + r < npos;
    const T* from = ok ? src + (long long)(pos0 + r) * gstride + e : src;
    cp_async16(dst + r * row_stride<T, HD>() + e, from, ok);
  }
}

// x rounded to TF32 as cvt.rna.tf32.f32 rounds every finite x (to nearest,
// ties away from zero: add half of the 13 dropped bits to the magnitude,
// then clear them), in two integer instructions.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo to about 2^-22 of x.  Without SPLIT, x is already a TF32
// value (a bf16 input) and lo is never read.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if (SPLIT) {
    hi = tf32(x);
    lo = tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);
    lo = 0u;
  }
}

// c += a b for one 16x8x8 step (A row-major, B column-major, TF32 in,
// f32 accumulate).
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b from split operands: lo*hi + hi*lo first, then hi*hi; a pass
// whose lo is 0 is left out.
template <bool SPLIT_A, bool SPLIT_B>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4],
                                     const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  if (SPLIT_A) mma(c, al, bh);
  if (SPLIT_B) mma(c, ah, bl);
  mma(c, ah, bh);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int hq, int hkv, int causal, int window,
                 float scale) {
  static_assert(HD % 32 == 0, "HD must be a multiple of 32");
  constexpr bool kSplit = sizeof(T) == 4;  // f32 inputs need their lo part
  constexpr int kS = row_stride<T, HD>();
  constexpr int kBK = tile_keys<T, HD>();
  constexpr int kNT = kBK / 8;  // 8-key column tiles of a warp's scores
  constexpr int kNO = HD / 8;   // 8-column tiles of a warp's accumulator

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);  // [kBQ][kS]
  T* ks = qs + kBQ * kS;                   // [2][kBK][kS]
  T* vs = ks + 2 * kBK * kS;               // [2][kBK][kS]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2;  // fragment row (A, C) / column (B)
  const int t = lane & 3;   // fragment column (A) / row (B) in the quad
  const int h = blockIdx.x, b = blockIdx.y;
  const int q_start = (gridDim.z - 1 - blockIdx.z) * kBQ;  // last first
  const int hk = h / (hq / hkv);
  const long long q_row = (long long)hq * HD;  // stride of one position
  const long long kv_row = (long long)hkv * HD;
  const T* qb = q + (long long)b * sq * q_row + (long long)h * HD;
  const T* kb = k + (long long)b * skv * kv_row + (long long)hk * HD;
  const T* vb = v + (long long)b * skv * kv_row + (long long)hk * HD;

  // the key tiles any row of this query tile can see
  int t_lo = 0, t_hi = (skv + kBK - 1) / kBK;
  if (window && q_start - window + 1 > 0) t_lo = (q_start - window + 1) / kBK;
  if (causal) t_hi = min(t_hi, (min(q_start + kBQ, sq) - 1) / kBK + 1);

  stage<T, HD, kBQ>(qs, qb, q_row, q_start, sq);
  if (t_lo < t_hi) {
    stage<T, HD, kBK>(ks, kb, kv_row, t_lo * kBK, skv);
    stage<T, HD, kBK>(vs, vb, kv_row, t_lo * kBK, skv);
  }
  cp_async_commit();

  float o[kNO][4];
#pragma unroll
  for (int n = 0; n < kNO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  // scores in the base-2 domain: exp(s - m) = 2^(s log2(e) - m log2(e))
  const float scale_log2 = scale * 1.4426950408889634f;
  // rows g and g + 8 of the warp's 16 (m in the base-2 domain)
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const int qpos[2] = {q_start + 16 * warp + g, q_start + 16 * warp + g + 8};
  const T* qf = qs + (16 * warp + g) * kS + t;

  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int buf = (tile - t_lo) & 1;
    __syncthreads();  // every warp is done with the other buffer
    if (tile + 1 < t_hi) {
      stage<T, HD, kBK>(ks + (buf ^ 1) * kBK * kS, kb, kv_row,
                        (tile + 1) * kBK, skv);
      stage<T, HD, kBK>(vs + (buf ^ 1) * kBK * kS, vb, kv_row,
                        (tile + 1) * kBK, skv);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this tile (and q) has landed
    __syncthreads();

    // s = q K^T: a warp's 16 rows x kBK keys
    const T* kf = ks + buf * kBK * kS + g * kS + t;
    float s[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int d = 0; d < HD; d += 8) {
      uint32_t ah[4], al[4];
      split<kSplit>(to_f32(qf[d]), ah[0], al[0]);
      split<kSplit>(to_f32(qf[8 * kS + d]), ah[1], al[1]);
      split<kSplit>(to_f32(qf[d + 4]), ah[2], al[2]);
      split<kSplit>(to_f32(qf[8 * kS + d + 4]), ah[3], al[3]);
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        uint32_t bh[2], bl[2];
        split<kSplit>(to_f32(kf[n * 8 * kS + d]), bh[0], bl[0]);
        split<kSplit>(to_f32(kf[n * 8 * kS + d + 4]), bh[1], bl[1]);
        mma3<kSplit, kSplit>(s[n], ah, al, bh, bl);
      }
    }

    // scale and mask; s[n][e] is row qpos[e >> 1], key
    // k_start + 8 n + 2 t + (e & 1)
    const int k_start = tile * kBK;
    const bool full = k_start + kBK <= skv &&
                      (!causal || k_start + kBK - 1 <= q_start) &&
                      (!window || k_start >= q_start + kBQ - window);
    unsigned seen = ~0u;  // bit 4 n + e
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] *= scale_log2;
        if (!full) {
          const int kpos = k_start + 8 * n + 2 * t + (e & 1);
          const int qp = qpos[e >> 1];
          bool ok = kpos < skv;
          if (causal) ok = ok && kpos <= qp;
          if (window) ok = ok && kpos > qp - window;
          if (!ok) {
            s[n][e] = kNegInf;
            seen &= ~(1u << (4 * n + e));
          }
        }
      }

    // online softmax, per row over the quad
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * r], s[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = exp2_approx(m[r] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < kNT; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float x = exp2_approx(s[n][e] - m_new);
          const float p = (seen >> (4 * n + e)) & 1u ? x : 0.f;
          s[n][e] = p;
          sum += p;
        }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      l[r] = l[r] * alpha[r] + sum;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < kNO; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }

    // o += P V, 8 keys a step.  The C fragment of s holds keys 2t and
    // 2t + 1 of each row; as an A fragment, column t stands for key 2t
    // and column t + 4 for key 2t + 1, and V's B fragment is read in the
    // same order (rows 2t and 2t + 1).
    const T* vf = vs + buf * kBK * kS + 2 * t * kS + g;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      uint32_t ph[4], pl[4];
      split<true>(s[j][0], ph[0], pl[0]);
      split<true>(s[j][2], ph[1], pl[1]);
      split<true>(s[j][1], ph[2], pl[2]);
      split<true>(s[j][3], ph[3], pl[3]);
#pragma unroll
      for (int n = 0; n < kNO; ++n) {
        uint32_t bh[2], bl[2];
        split<kSplit>(to_f32(vf[8 * j * kS + 8 * n]), bh[0], bl[0]);
        split<kSplit>(to_f32(vf[(8 * j + 1) * kS + 8 * n]), bh[1], bl[1]);
        mma3<true, kSplit>(o[n], ph, pl, bh, bl);
      }
    }
  }
  cp_async_wait<0>();

  T* ob = out + (long long)b * sq * q_row + (long long)h * HD + 2 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (qpos[r] >= sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int n = 0; n < kNO; ++n)
      store2(&ob[qpos[r] * q_row + 8 * n], o[n][2 * r] / denom,
             o[n][2 * r + 1] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<T, HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(flash_kernel<T, HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(hq, b, (sq + kBQ - 1) / kBQ);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, skv, hq, hkv,
      causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              void* out, int b, int sq, int skv, int hq, int hkv,
              int causal, int window, float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                           window, scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                           window, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, sq, skv, hq, hkv, causal,
                            window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// q, out: (b, sq, hq, hd); k, v: (b, skv, hkv, hd); contiguous, on the
// current device, f32 (dtype 0) or bf16 (dtype 1); hd in {32, 64, 128};
// hq a multiple of hkv.  Returns the CUDA error of the launch (0 on
// success); q, k, v and out must be 16-byte aligned (cp.async), else
// cudaErrorMisalignedAddress.
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int b, int sq, int skv, int hq, int hkv,
                          int hd, int dtype, int causal, int window,
                          float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (dtype == 0)
    return launch_hd<float>(hd, q, k, v, out, b, sq, skv, hq, hkv, causal,
                            window, scale, s);
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(hd, q, k, v, out, b, sq, skv, hq, hkv,
                                    causal, window, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
