// Causal / sliding-window flash attention, forward only (K3), for Hopper,
// sm_90a.
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
// all contiguous: the model's own layout, read through its strides, so
// nothing is transposed.  GQA: q head h reads kv head h / (Hq / Hkv), as the
// Pallas index map does; the repeat is never materialised.  Ragged Sq and
// Skv are bounded by the loops and masked: nothing is padded.
//
// Bound: operations.  At the serve path's prefill (B 4, S 512, Hq 32,
// Hkv 8, HD 128, causal) the two products are 4*B*Hq*HD*S(S+1)/2 = 8.6
// GFLOP against 84 MB of q, k, v and out, so 0.13 ms at the card's 67
// TFLOP/s of f32 outside the tensor cores against 0.025 ms of bytes.  The
// products run in f32 on the CUDA cores (TF32 would keep about three
// digits; the kernel is held to its f32 plain version at 3e-5), so that
// rate is the ceiling.
//
// Design, simple first: one block of 256 threads per (64-row query tile,
// q head, batch row), looping over 64-key tiles.  The query tile, the key
// tile (transposed, so that neighbouring threads read neighbouring
// columns) and the value tile are staged in shared memory as f32; each
// thread owns a 4 x 4 patch of the score tile and 4 rows x HD/16 columns of
// the accumulator.  A row's 16 owners sit in one half-warp and reduce its
// max and sum with shuffles.  Tiles wholly above the causal diagonal or
// wholly below the window are skipped, as in the Pallas kernel.  The
// probabilities reuse the key tile's shared memory once the scores are
// done, which keeps HD = 128 at 99 KB, two blocks to an SM.  No wgmma, no
// TMA yet: that is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per tile
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);  // round to nearest even, as torch's .to()
}

// Rows of the region that holds k^T [HD][kBK+1] and then p [kBQ][kBK+1].
template <int HD>
__host__ __device__ constexpr int kt_rows() {
  return HD > kBQ ? HD : kBQ;
}

template <int HD>
constexpr size_t smem_bytes() {
  // q tile [kBQ][HD+1] + (k^T, then p) + v tile [kBK][HD]; the +1 columns
  // keep the strided reads off one bank
  return sizeof(float) *
         (kBQ * (HD + 1) + kt_rows<HD>() * (kBK + 1) + kBK * HD);
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int sq,
                 int skv, int hq, int hkv, int causal, int window,
                 float scale) {
  static_assert(HD % 16 == 0, "HD must be a multiple of 16");
  constexpr int kCols = HD / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                    // [kBQ][HD + 1]
  float* kt = qs + kBQ * (HD + 1);     // [HD][kBK + 1], k transposed
  float* ps = kt;                      // [kBQ][kBK + 1], after the scores
  float* vs = kt + kt_rows<HD>() * (kBK + 1);  // [kBK][HD]

  const int tid = threadIdx.x;
  const int tx = tid & 15;  // score columns tx + 16j, acc columns tx + 16j
  const int ty = tid >> 4;  // rows 4 ty .. 4 ty + 3
  const int q_start = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (hq / hkv);
  const long long q_row = (long long)hq * HD;   // stride of one position
  const long long kv_row = (long long)hkv * HD;
  const T* qb = q + (long long)b * sq * q_row + (long long)h * HD;
  const T* kb = k + (long long)b * skv * kv_row + (long long)hk * HD;
  const T* vb = v + (long long)b * skv * kv_row + (long long)hk * HD;

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qpos = q_start + r;
    qs[r * (HD + 1) + d] = qpos < sq ? to_f32(qb[qpos * q_row + d]) : 0.f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
  }

  const int n_tiles = (skv + kBK - 1) / kBK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k_start = tile * kBK;
    // every later tile lies above the diagonal too
    if (causal && k_start > q_start + kBQ - 1) break;
    if (window && k_start + kBK <= q_start - window + 1) continue;

    __syncthreads();  // the last tile's p and v reads are done
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int c = idx / HD, d = idx % HD;
      const int kpos = k_start + c;
      float kx = 0.f, vx = 0.f;
      if (kpos < skv) {
        kx = to_f32(kb[kpos * kv_row + d]);
        vx = to_f32(vb[kpos * kv_row + d]);
      }
      kt[d * (kBK + 1) + c] = kx;
      vs[c * HD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(4 * ty + i) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * (kBK + 1) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
    __syncthreads();  // every thread is done with k^T: ps may overwrite it

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_start + 4 * ty + i;
      bool seen[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k_start + tx + 16 * j;
        bool ok = kpos < skv;
        if (causal) ok = ok && kpos <= qpos;
        if (window) ok = ok && kpos > qpos - window;
        seen[j] = ok;
        s[i][j] = ok ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = seen[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(4 * ty + i) * (kBK + 1) + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(4 * ty + i) * (kBK + 1) + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * HD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

  T* ob = out + (long long)b * sq * q_row + (long long)h * HD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q_start + 4 * ty + i;
    if (qpos >= sq) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      store(&ob[qpos * q_row + tx + 16 * j], acc[i][j] / denom);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int sq, int skv, int hq, int hkv, int causal, int window,
           float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((sq + kBQ - 1) / kBQ, hq, b);
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
// success).
int repro_flash_attention(const void* q, const void* k, const void* v,
                          void* out, int b, int sq, int skv, int hq, int hkv,
                          int hd, int dtype, int causal, int window,
                          float scale, void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
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
