// Causal flash attention, forward and backward, for Hopper (sm_90a), bound
// through a plain C interface.
//
// Replaces the TPU kernels of gnn_rag_tpu/llm_tpu/flash_attention.py:
//   _flash_kernel (:47)   forward: o and the row logsumexp lse
//   _dq_kernel    (:132)  backward: dq
//   _dkv_kernel   (:170)  backward: dk and dv
// For one (batch, head) with q [L, D], k and v [S, D], scale = 1/sqrt(D) and
// the causal mask key <= query:
//   s = q k^T * scale (masked entries -1e30), lse = m + log(max(l, 1e-30)),
//   o = (sum_k T(exp(s - m)) v) / l        (p rounded to v's type T before PV)
//   p = exp(s - lse), dp = dO v^T, ds = p * (dp - delta) * scale,
//   dq = ds k, dk = ds^T q, dv = p^T dO,   delta = rowsum(dO * o) (given).
// Tensors keep the model's [B, N, H, D] layout (D = 128); lse and delta are
// [B*H, L] float, stored once per row (the TPU kernel replicated them over
// 128 lanes for its block shapes). All sums are float; every product is the
// float product of the (widened) inputs, as in the TPU kernels
// (flash_attention.py:79, :144-147), except p in the forward, which is
// rounded to T before it multiplies v.
//
// Two families, chosen by the input type:
//
// float32 (flash_{fwd,dq,dkv}_kernel<float>): IEEE float on the CUDA cores.
// Every kernel keeps one 64-row tile resident in shared memory (q rows for
// the forward and dq, k/v rows for dk/dv) and streams the other side in
// 32-row tiles through a loop inside the block (the TPU's sequential inner
// grid axis). 256 threads as 16 x 16: thread (ty, tx) computes the score
// entries of rows ty + 16i and columns tx + 16j and owns output columns
// tx + 16jj of its rows; rows of the online softmax are reduced with warp
// shuffles over the 16 threads that share ty; shared-memory rows are padded
// to D + 1 floats so that column walks hit distinct banks.
//
// bfloat16 (flash_{fwd,dq,dkv}_mma_kernel): the tensor cores, mma.sync
// m16n8k16 with float accumulators in FlashAttention-2's register layout. A
// block of 4 warps owns 64 rows, 16 a warp (query rows for the forward and
// dq, key rows for dk/dv), and walks 64-row tiles of the other side staged
// in shared memory (bf16 rows padded to 136 so that ldmatrix's eight row
// addresses hit distinct banks). s and dp take bf16 operands, whose
// products are exact in float; the backward's float p and ds enter the
// tensor cores as the exact sum of three bf16 terms (split3), three mma per
// product, so the backward still multiplies in float.
//
// Both: every sum runs in a fixed order (no atomics), so two launches repeat
// bit for bit. Ragged edges (L or S not a multiple of the tile) are masked
// in the kernel, not padded by the caller. Work per block grows with the
// query index (causal), so the forward and dq start the last query tiles
// first, and dk/dv the first key tiles.
//
// What bounds it on an H100: at B8 L2048 H32 D128 the forward does 2.75e11
// causal FLOP against 2.1e8 bytes of q/k/v/o, so the arithmetic bounds it
// (0.28 ms at the 989 TFLOP/s bf16 tensor-core rate, 4.1 ms at 67 TFLOP/s
// float); dq and dk/dv do 1.5x and 2x the forward's products. The float
// kernels read both operands of every product from shared memory, so
// shared-memory load bandwidth sets their rate. The bf16 kernels issue
// mma.sync from one warp per 16 rows with synchronous tile loads (no
// cp.async pipeline, no wgmma/TMA) and the backward pays 3 mma per float
// operand: those are the next steps.
//
// ptxas -v (CUDA 12.8, sm_90a; chip_smoke.py prints it on its build line):
// flash_fwd_mma_kernel 182 registers, flash_dq_mma_kernel 209,
// flash_dkv_mma_kernel 227; flash_fwd_kernel<float> 76, flash_dq_kernel<float>
// 80, flash_dkv_kernel<float> 127; no spills, no stack frames.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int D = 128;        // head dim; the wrapper raises on any other
constexpr int DP = D + 1;     // padded shared-memory row, in floats
constexpr int NT = 256;       // threads per block, 16 x 16
constexpr int TILE = 64;      // resident rows per block
constexpr int STREAM = 32;    // streamed rows per loop step
constexpr int SP = STREAM + 1;
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16
from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float row_max16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float row_sum16(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ int64_t offset(int b, int row, int h, int N,
                                          int H) {
  return ((static_cast<int64_t>(b) * N + row) * H + h) * D;
}

// rows [row0, row0 + nrows) of head h of a [B, N, H, D] tensor into float
// shared memory [nrows][DP]; rows past N read as 0
template <typename T>
__device__ void load_rows(float* dst, const T* src, int b, int h, int N,
                          int H, int row0, int nrows) {
  for (int e = threadIdx.x; e < nrows * D; e += NT) {
    const int r = e / D, c = e % D, row = row0 + r;
    dst[r * DP + c] = row < N ? to_f(src[offset(b, row, h, N, H) + c]) : 0.f;
  }
}

// per-row statistics (lse or delta, [B*H, L] float) of rows row0.. into dst
__device__ void load_stat(float* dst, const float* src, int bh, int L,
                          int row0, int nrows) {
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    dst[r] = row0 + r < L ? src[static_cast<int64_t>(bh) * L + row0 + r] : 0.f;
}

// ---------------------------------------------------------------- forward
// grid (ceil(L / TILE), B*H), float inputs (bf16 runs flash_fwd_mma_kernel)
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int H, int L, int S,
                     float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [TILE][DP]
  float* Ks = Qs + TILE * DP;       // [STREAM][DP]
  float* Vs = Ks + STREAM * DP;     // [STREAM][DP]
  float* Ps = Vs + STREAM * DP;     // [TILE][SP]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows(Qs, q, b, h, L, H, q0, TILE);
  float m[4], l[4], acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) acc[i][jj] = 0.f;
  }
  // keys at or past q0 + TILE are masked for every row of the block
  const int k_end = min(S, q0 + TILE);
  for (int k0 = 0; k0 < k_end; k0 += STREAM) {
    __syncthreads();
    load_rows(Ks, k, b, h, S, H, k0, STREAM);
    load_rows(Vs, v, b, h, S, H, k0, STREAM);
    __syncthreads();
    float s[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], c[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty + 16 * i) * DP + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) c[j] = Ks[(tx + 16 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(a[i], c[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = q0 + ty + 16 * i;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + tx + 16 * j;
        s[i][j] = (kc <= qr && kc < S) ? s[i][j] * scale : NEG_INF;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max16(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float p = expf(s[i][j] - m_new);
        rs += p;
        Ps[(ty + 16 * i) * SP + tx + 16 * j] = to_f(from_f<T>(p));
      }
      l[i] = l[i] * alpha + row_sum16(rs);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) acc[i][jj] *= alpha;
    }
    __syncthreads();
    for (int c = 0; c < STREAM; ++c) {
      float p[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) w[jj] = Vs[c * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[i][jj] = fmaf(p[i], w[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= L) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + offset(b, qr, h, L, H);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
      orow[tx + 16 * jj] = from_f<T>(acc[i][jj] / li);
    if (tx == 0) lse[static_cast<int64_t>(bh) * L + qr] = m[i] + logf(li);
  }
}

// --------------------------------------------------------------------- dq
// grid (ceil(L / TILE), B*H)
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int H, int L, int S, float scale) {
  extern __shared__ float smem[];
  float* Qs = smem;                 // [TILE][DP]
  float* Gs = Qs + TILE * DP;       // [TILE][DP]   dO
  float* Ks = Gs + TILE * DP;       // [STREAM][DP]
  float* Vs = Ks + STREAM * DP;     // [STREAM][DP]
  float* Ds = Vs + STREAM * DP;     // [TILE][SP]   ds
  float* lse_s = Ds + TILE * SP;    // [TILE]
  float* delta_s = lse_s + TILE;    // [TILE]
  const int q0 = (gridDim.x - 1 - blockIdx.x) * TILE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows(Qs, q, b, h, L, H, q0, TILE);
  load_rows(Gs, dout, b, h, L, H, q0, TILE);
  load_stat(lse_s, lse, bh, L, q0, TILE);
  load_stat(delta_s, delta, bh, L, q0, TILE);
  float acc[4][8] = {};
  const int k_end = min(S, q0 + TILE);
  for (int k0 = 0; k0 < k_end; k0 += STREAM) {
    __syncthreads();
    load_rows(Ks, k, b, h, S, H, k0, STREAM);
    load_rows(Vs, v, b, h, S, H, k0, STREAM);
    __syncthreads();
    float s[4][2] = {}, dp[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float a[4], g[4], c[2], w[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = Qs[(ty + 16 * i) * DP + d];
        g[i] = Gs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        c[j] = Ks[(tx + 16 * j) * DP + d];
        w[j] = Vs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(a[i], c[j], s[i][j]);
          dp[i][j] = fmaf(g[i], w[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i, qr = q0 + r;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int kc = k0 + tx + 16 * j;
        const float sv = (kc <= qr && kc < S) ? s[i][j] * scale : NEG_INF;
        const float p = expf(sv - lse_s[r]);
        Ds[r * SP + tx + 16 * j] = p * (dp[i][j] - delta_s[r]) * scale;
      }
    }
    __syncthreads();
    for (int c = 0; c < STREAM; ++c) {
      float ds[4], w[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ds[(ty + 16 * i) * SP + c];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) w[jj] = Ks[c * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          acc[i][jj] = fmaf(ds[i], w[jj], acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qr = q0 + ty + 16 * i;
    if (qr >= L) continue;
    T* row = dq + offset(b, qr, h, L, H);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) row[tx + 16 * jj] = from_f<T>(acc[i][jj]);
  }
}

// -------------------------------------------------------------------- dkv
// grid (ceil(S / TILE), B*H); the block owns keys k0 .. k0 + TILE and walks
// the query tiles that can see them (rows >= k0)
template <typename T>
__global__ void __launch_bounds__(NT)
    flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const T* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk,
                     T* __restrict__ dv, int H, int L, int S, float scale) {
  extern __shared__ float smem[];
  float* Ks = smem;                 // [TILE][DP]
  float* Vs = Ks + TILE * DP;       // [TILE][DP]
  float* Qs = Vs + TILE * DP;       // [STREAM][DP]
  float* Gs = Qs + STREAM * DP;     // [STREAM][DP]  dO
  float* Ts = Gs + STREAM * DP;     // [TILE][SP]    p^T, then ds^T
  float* lse_s = Ts + TILE * SP;    // [STREAM]
  float* delta_s = lse_s + STREAM;  // [STREAM]
  const int k0 = blockIdx.x * TILE;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  load_rows(Ks, k, b, h, S, H, k0, TILE);
  load_rows(Vs, v, b, h, S, H, k0, TILE);
  float dk_acc[4][8] = {}, dv_acc[4][8] = {};
  for (int q0 = k0; q0 < L; q0 += STREAM) {
    __syncthreads();
    load_rows(Qs, q, b, h, L, H, q0, STREAM);
    load_rows(Gs, dout, b, h, L, H, q0, STREAM);
    load_stat(lse_s, lse, bh, L, q0, STREAM);
    load_stat(delta_s, delta, bh, L, q0, STREAM);
    __syncthreads();
    // rows of this thread: keys ty + 16i; columns: queries tx + 16j
    float s[4][2] = {}, dp[4][2] = {};
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float c[4], w[4], a[2], g[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[i] = Ks[(ty + 16 * i) * DP + d];
        w[i] = Vs[(ty + 16 * i) * DP + d];
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        a[j] = Qs[(tx + 16 * j) * DP + d];
        g[j] = Gs[(tx + 16 * j) * DP + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          s[i][j] = fmaf(a[j], c[i], s[i][j]);
          dp[i][j] = fmaf(g[j], w[i], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kc = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int r = tx + 16 * j, qr = q0 + r;
        const float sv = (kc <= qr && kc < S) ? s[i][j] * scale : NEG_INF;
        const float p = expf(sv - lse_s[r]);
        s[i][j] = p;                                          // keep p
        dp[i][j] = p * (dp[i][j] - delta_s[r]) * scale;       // ds
        Ts[(ty + 16 * i) * SP + r] = p;
      }
    }
    __syncthreads();
    for (int r = 0; r < STREAM; ++r) {        // dv += p^T dO
      float p[4], g[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ts[(ty + 16 * i) * SP + r];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) g[jj] = Gs[r * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          dv_acc[i][jj] = fmaf(p[i], g[jj], dv_acc[i][jj]);
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) Ts[(ty + 16 * i) * SP + tx + 16 * j] = dp[i][j];
    __syncthreads();
    for (int r = 0; r < STREAM; ++r) {        // dk += ds^T q
      float ds[4], a[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = Ts[(ty + 16 * i) * SP + r];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) a[jj] = Qs[r * DP + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj)
          dk_acc[i][jj] = fmaf(ds[i], a[jj], dk_acc[i][jj]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kc = k0 + ty + 16 * i;
    if (kc >= S) continue;
    T* krow = dk + offset(b, kc, h, S, H);
    T* vrow = dv + offset(b, kc, h, S, H);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      krow[tx + 16 * jj] = from_f<T>(dk_acc[i][jj]);
      vrow[tx + 16 * jj] = from_f<T>(dv_acc[i][jj]);
    }
  }
}

// --------------------------------------------- forward, bfloat16, mma.sync
// A warp keeps its 16 q rows as A fragments in registers, computes s = q k^T
// per key tile as 8 tiles of 16x8 float accumulators, runs the online
// softmax on them (a row is spread over the 4 threads of a quad: shuffles
// over lanes ^1, ^2), rounds p to bf16 (the TPU kernel's p.astype(v.dtype))
// straight into the A fragments of p v, and accumulates o as 16 tiles of
// 16x8.
constexpr int MMA_WARPS = 4;
constexpr int MMA_ROWS = 16 * MMA_WARPS;   // query rows per block
constexpr int MMA_KEYS = 64;               // keys per tile
constexpr int KP = D + 8;                  // padded bf16 row of K/V tiles

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// rows [row0, row0 + MMA_KEYS) of head h of a [B, N, H, D] bf16 tensor into
// shared memory [MMA_KEYS][KP], 16 bytes a thread at a time; rows past N = 0
__device__ void load_tile_bf16(__nv_bfloat16* dst, const __nv_bfloat16* src,
                               int b, int h, int N, int H, int row0) {
  constexpr int kVecs = D / 8;             // 16-byte vectors per row
  for (int e = threadIdx.x; e < MMA_KEYS * kVecs; e += 32 * MMA_WARPS) {
    const int r = e / kVecs, c = (e % kVecs) * 8, row = row0 + r;
    uint4 x = make_uint4(0, 0, 0, 0);
    if (row < N)
      x = *reinterpret_cast<const uint4*>(src + offset(b, row, h, N, H) + c);
    *reinterpret_cast<uint4*>(dst + r * KP + c) = x;
  }
}

// grid (ceil(L / MMA_ROWS), B*H), MMA_WARPS warps
__global__ void __launch_bounds__(32 * MMA_WARPS)
    flash_fwd_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int H, int L, int S,
                         float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[MMA_KEYS * KP];
  __shared__ __align__(16) __nv_bfloat16 Vs[MMA_KEYS * KP];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;   // this thread's rows

  // q as A fragments: k-step kk covers d = 16kk .. 16kk + 15
  uint32_t qa[D / 16][4];
  {
    const uint32_t* qa_row = row_a < L ? reinterpret_cast<const uint32_t*>(
        q + offset(b, row_a, h, L, H)) : nullptr;
    const uint32_t* qb_row = row_b < L ? reinterpret_cast<const uint32_t*>(
        q + offset(b, row_b, h, L, H)) : nullptr;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int w = kk * 8 + t;            // word of columns 16kk + 2t, +1
      qa[kk][0] = qa_row ? qa_row[w] : 0u;
      qa[kk][1] = qb_row ? qb_row[w] : 0u;
      qa[kk][2] = qa_row ? qa_row[w + 4] : 0u;
      qa[kk][3] = qb_row ? qb_row[w + 4] : 0u;
    }
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};   // rows a, b

  const int k_end = min(S, q0 + MMA_ROWS);
  for (int k0 = 0; k0 < k_end; k0 += MMA_KEYS) {
    __syncthreads();
    load_tile_bf16(Ks, k, b, h, S, H, k0);
    load_tile_bf16(Vs, v, b, h, S, H, k0);
    __syncthreads();
    // s = q k^T: 8 tiles of 8 keys
    float s[MMA_KEYS / 8][4];
#pragma unroll
    for (int j = 0; j < MMA_KEYS / 8; ++j)
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < MMA_KEYS / 8; j += 2) {
        // matrices: keys 8j.. / 8j+8.., d 16kk.. / 16kk+8..
        const int mi = lane / 8;
        const int key = 8 * j + lane % 8 + 8 * (mi / 2);
        uint32_t kb[4];
        ldmatrix_x4(kb, Ks + key * KP + 16 * kk + 8 * (mi % 2));
        mma_bf16(s[j], qa[kk], kb[0], kb[1]);
        mma_bf16(s[j + 1], qa[kk], kb[2], kb[3]);
      }
    }
    // online softmax over this tile, rows a (c0, c1) and b (c2, c3)
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < MMA_KEYS / 8; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kc = k0 + 8 * j + 2 * t + (i & 1);
        const int qr = i < 2 ? row_a : row_b;
        s[j][i] = (kc <= qr && kc < S) ? s[j][i] * scale : NEG_INF;
        mx[i / 2] = fmaxf(mx[i / 2], s[j][i]);
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];                    // this thread's share of the row sum
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // p (float) into the row sums, p rounded to bf16 into the A fragments
    uint32_t pa[MMA_KEYS / 16][4];
#pragma unroll
    for (int j = 0; j < MMA_KEYS / 8; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = expf(s[j][i] - m[i / 2]);
        l[i / 2] += p[i];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // o += p v: k-step jj covers keys 16jj .. 16jj + 15
#pragma unroll
    for (int jj = 0; jj < MMA_KEYS / 16; ++jj) {
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        // matrices (transposed): keys 16jj.. / 16jj+8.., d 8n.. / 8n+8..
        const int mi = lane / 8;
        const int key = 16 * jj + lane % 8 + 8 * (mi % 2);
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, Vs + key * KP + 8 * n + 8 * (mi / 2));
        mma_bf16(acc[n], pa[jj], vb[0], vb[1]);
        mma_bf16(acc[n + 1], pa[jj], vb[2], vb[3]);
      }
    }
  }
  // the quad's shares of each row sum, then o = acc / l and lse
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qr = r == 0 ? row_a : row_b;
    if (qr >= L) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(o + offset(b, qr, h, L, H));
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      orow[n * 4 + t] = pack_bf16(acc[n][2 * r] / l[r], acc[n][2 * r + 1] / l[r]);
    if (t == 0) lse[static_cast<int64_t>(bh) * L + qr] = m[r] + logf(l[r]);
  }
}

// ------------------------------------------- backward, bfloat16, mma.sync

// x = hi + mid + lo, each a bf16 (exact for a normal float)
__device__ __forceinline__ void split3(float x, __nv_bfloat16 (&part)[3]) {
  part[0] = __float2bfloat16(x);
  x -= __bfloat162float(part[0]);
  part[1] = __float2bfloat16(x);
  x -= __bfloat162float(part[1]);
  part[2] = __float2bfloat16(x);
}

// A fragments (one per term) of a 16x16 float operand held as two 16x8
// accumulator tiles (columns 0-7 in c0, 8-15 in c1), the layout mma.sync
// returns: register r of the fragment takes (c0[0], c0[1]), (c0[2], c0[3]),
// (c1[0], c1[1]), (c1[2], c1[3])
__device__ __forceinline__ void split_a(uint32_t (&a)[3][4],
                                        const float (&c0)[4],
                                        const float (&c1)[4]) {
  const float* src[2] = {c0, c1};
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    __nv_bfloat16 x[3], y[3];
    split3(src[r / 2][(r % 2) * 2], x);
    split3(src[r / 2][(r % 2) * 2 + 1], y);
#pragma unroll
    for (int term = 0; term < 3; ++term) {
      __nv_bfloat162 v = __halves2bfloat162(x[term], y[term]);
      a[term][r] = *reinterpret_cast<uint32_t*>(&v);
    }
  }
}

// the A fragments of rows row_a (= row0 + g) and row_a + 8 of head h of a
// [B, N, H, D] bf16 tensor, for the 8 k-steps of D; rows past N read as 0
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4],
                                            const __nv_bfloat16* src, int b,
                                            int h, int N, int H, int row_a,
                                            int t) {
  const uint32_t* ra = row_a < N ? reinterpret_cast<const uint32_t*>(
      src + offset(b, row_a, h, N, H)) : nullptr;
  const uint32_t* rb = row_a + 8 < N ? reinterpret_cast<const uint32_t*>(
      src + offset(b, row_a + 8, h, N, H)) : nullptr;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int w = kk * 8 + t;
    a[kk][0] = ra ? ra[w] : 0u;
    a[kk][1] = rb ? rb[w] : 0u;
    a[kk][2] = ra ? ra[w + 4] : 0u;
    a[kk][3] = rb ? rb[w + 4] : 0u;
  }
}

__device__ __forceinline__ void store_rows_bf16(__nv_bfloat16* dst, int b,
                                                int h, int N, int H,
                                                int row_a, int t,
                                                const float (&acc)[D / 8][4]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_a + 8 * r;
    if (row >= N) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + offset(b, row, h, N, H));
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      out[n * 4 + t] = pack_bf16(acc[n][2 * r], acc[n][2 * r + 1]);
  }
}

// dq, grid (ceil(L / MMA_ROWS), B*H), MMA_WARPS warps: a warp owns 16 query
// rows (q and dO as A fragments in registers) and walks the key tiles
__global__ void __launch_bounds__(32 * MMA_WARPS)
    flash_dq_mma_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        __nv_bfloat16* __restrict__ dq, int H, int L, int S,
                        float scale) {
  __shared__ __align__(16) __nv_bfloat16 Ks[MMA_KEYS * KP];
  __shared__ __align__(16) __nv_bfloat16 Vs[MMA_KEYS * KP];
  const int q0 = (gridDim.x - 1 - blockIdx.x) * MMA_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mi = lane / 8;
  const int row_a = q0 + warp * 16 + g;
  const int row[2] = {row_a, row_a + 8};

  uint32_t qa[D / 16][4], ga[D / 16][4];
  load_a_rows(qa, q, b, h, L, H, row_a, t);
  load_a_rows(ga, dout, b, h, L, H, row_a, t);
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int64_t i = static_cast<int64_t>(bh) * L + row[r];
    lse_r[r] = row[r] < L ? lse[i] : 0.f;
    delta_r[r] = row[r] < L ? delta[i] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int k_end = min(S, q0 + MMA_ROWS);
  for (int k0 = 0; k0 < k_end; k0 += MMA_KEYS) {
    __syncthreads();
    load_tile_bf16(Ks, k, b, h, S, H, k0);
    load_tile_bf16(Vs, v, b, h, S, H, k0);
    __syncthreads();
#pragma unroll 1
    for (int jj = 0; jj < MMA_KEYS / 16; ++jj) {   // keys 16jj .. 16jj + 15
      float s[2][4] = {}, dp[2][4] = {};
      const int key = 16 * jj + lane % 8 + 8 * (mi / 2);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, Ks + key * KP + 16 * kk + 8 * (mi % 2));
        ldmatrix_x4(vb, Vs + key * KP + 16 * kk + 8 * (mi % 2));
        mma_bf16(s[0], qa[kk], kb[0], kb[1]);
        mma_bf16(s[1], qa[kk], kb[2], kb[3]);
        mma_bf16(dp[0], ga[kk], vb[0], vb[1]);
        mma_bf16(dp[1], ga[kk], vb[2], vb[3]);
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kc = k0 + 16 * jj + 8 * nt + 2 * t + (i & 1);
          const int r = i / 2;
          const float sv = (kc <= row[r] && kc < S) ? s[nt][i] * scale
                                                    : NEG_INF;
          const float p = expf(sv - lse_r[r]);
          s[nt][i] = p * (dp[nt][i] - delta_r[r]) * scale;      // ds
        }
      uint32_t da[3][4];
      split_a(da, s[0], s[1]);
      // dq += ds k: B[key][d] = k[key][d], transposed 8x8 loads
      const int key_t = 16 * jj + lane % 8 + 8 * (mi % 2);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t kt[4];
        ldmatrix_x4_trans(kt, Ks + key_t * KP + 8 * n + 8 * (mi / 2));
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          mma_bf16(acc[n], da[term], kt[0], kt[1]);
          mma_bf16(acc[n + 1], da[term], kt[2], kt[3]);
        }
      }
    }
  }
  store_rows_bf16(dq, b, h, L, H, row_a, t, acc);
}

// dk and dv, grid (ceil(S / MMA_ROWS), B*H), MMA_WARPS warps: a warp owns
// 16 keys and computes s^T = k q^T and dp^T = v dO^T for them, so p^T and
// ds^T come out as A fragments of dv = p^T dO and dk = ds^T q; the block
// walks the query tiles that can see its keys (rows >= k0). Dynamic shared
// memory: K, V, Q, dO tiles and the query tile's lse and delta.
__global__ void __launch_bounds__(32 * MMA_WARPS)
    flash_dkv_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int L, int S,
                         float scale) {
  extern __shared__ __align__(16) unsigned char raw[];
  auto* Ks = reinterpret_cast<__nv_bfloat16*>(raw);
  __nv_bfloat16* Vs = Ks + MMA_KEYS * KP;
  __nv_bfloat16* Qs = Vs + MMA_KEYS * KP;
  __nv_bfloat16* Gs = Qs + MMA_KEYS * KP;
  auto* lse_s = reinterpret_cast<float*>(Gs + MMA_KEYS * KP);
  float* delta_s = lse_s + MMA_KEYS;
  const int k0 = blockIdx.x * MMA_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4, mi = lane / 8;
  const int key_a = k0 + warp * 16 + g;
  const int key[2] = {key_a, key_a + 8};

  load_tile_bf16(Ks, k, b, h, S, H, k0);
  load_tile_bf16(Vs, v, b, h, S, H, k0);
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[n][i] = dv_acc[n][i] = 0.f;
  // this warp's 16 keys as A operand rows (row, column 8x8 blocks)
  const int a_row = warp * 16 + lane % 8 + 8 * (mi % 2);
  const int a_col = 8 * (mi / 2);

  for (int q0 = k0; q0 < L; q0 += MMA_KEYS) {
    __syncthreads();
    load_tile_bf16(Qs, q, b, h, L, H, q0);
    load_tile_bf16(Gs, dout, b, h, L, H, q0);
    load_stat(lse_s, lse, bh, L, q0, MMA_KEYS);
    load_stat(delta_s, delta, bh, L, q0, MMA_KEYS);
    __syncthreads();
#pragma unroll 1
    for (int jj = 0; jj < MMA_KEYS / 16; ++jj) {   // query rows 16jj .. +15
      float st[2][4] = {}, dpt[2][4] = {};
      const int qrow = 16 * jj + lane % 8 + 8 * (mi / 2);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ka[4], va[4], qb[4], gb[4];
        ldmatrix_x4(ka, Ks + a_row * KP + 16 * kk + a_col);
        ldmatrix_x4(va, Vs + a_row * KP + 16 * kk + a_col);
        ldmatrix_x4(qb, Qs + qrow * KP + 16 * kk + 8 * (mi % 2));
        ldmatrix_x4(gb, Gs + qrow * KP + 16 * kk + 8 * (mi % 2));
        mma_bf16(st[0], ka, qb[0], qb[1]);
        mma_bf16(st[1], ka, qb[2], qb[3]);
        mma_bf16(dpt[0], va, gb[0], gb[1]);
        mma_bf16(dpt[1], va, gb[2], gb[3]);
      }
      // rows: keys key[i / 2]; columns: query rows 16jj + 8nt + 2t + (i & 1)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = 16 * jj + 8 * nt + 2 * t + (i & 1), qr = q0 + r;
          const int kc = key[i / 2];
          const float sv = (kc <= qr && kc < S) ? st[nt][i] * scale : NEG_INF;
          const float p = expf(sv - lse_s[r]);
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - delta_s[r]) * scale;   // ds^T
        }
      uint32_t pa[3][4], da[3][4];
      split_a(pa, st[0], st[1]);
      split_a(da, dpt[0], dpt[1]);
      // dv += p^T dO and dk += ds^T q: B[qrow][d], transposed 8x8 loads
      const int brow = 16 * jj + lane % 8 + 8 * (mi % 2);
#pragma unroll
      for (int n = 0; n < D / 8; n += 2) {
        uint32_t gt[4], qt[4];
        ldmatrix_x4_trans(gt, Gs + brow * KP + 8 * n + 8 * (mi / 2));
        ldmatrix_x4_trans(qt, Qs + brow * KP + 8 * n + 8 * (mi / 2));
#pragma unroll
        for (int term = 0; term < 3; ++term) {
          mma_bf16(dv_acc[n], pa[term], gt[0], gt[1]);
          mma_bf16(dv_acc[n + 1], pa[term], gt[2], gt[3]);
          mma_bf16(dk_acc[n], da[term], qt[0], qt[1]);
          mma_bf16(dk_acc[n + 1], da[term], qt[2], qt[3]);
        }
      }
    }
  }
  store_rows_bf16(dk, b, h, S, H, key_a, t, dk_acc);
  store_rows_bf16(dv, b, h, S, H, key_a, t, dv_acc);
}

constexpr size_t kDkvMmaSmem = 4 * MMA_KEYS * KP * sizeof(__nv_bfloat16) +
                               2 * MMA_KEYS * sizeof(float);

constexpr size_t kFwdSmem = sizeof(float) * (TILE * DP + 2 * STREAM * DP +
                                             TILE * SP);
constexpr size_t kDqSmem = sizeof(float) * (2 * TILE * DP + 2 * STREAM * DP +
                                            TILE * SP + 2 * TILE);
constexpr size_t kDkvSmem = sizeof(float) * (2 * TILE * DP +
                                             2 * STREAM * DP + TILE * SP +
                                             2 * STREAM);

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <typename T>
int launch_fwd(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int L, int S, float scale,
               cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_fwd_kernel<T>, kFwdSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + TILE - 1) / TILE, B * H);
  flash_fwd_kernel<T><<<grid, NT, kFwdSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const float* lse, const float* delta, void* dq, int B, int H,
              int L, int S, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_dq_kernel<T>, kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + TILE - 1) / TILE, B * H);
  flash_dq_kernel<T><<<grid, NT, kDqSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dq), H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const float* lse, const float* delta, void* dk, void* dv,
               int B, int H, int L, int S, float scale, cudaStream_t stream) {
  cudaError_t err = allow_smem(flash_dkv_kernel<T>, kDkvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + TILE - 1) / TILE, B * H);
  flash_dkv_kernel<T><<<grid, NT, kDkvSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta,
      static_cast<T*>(dk), static_cast<T*>(dv), H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// q, o [B, L, H, 128], k, v [B, S, H, 128], contiguous, all bfloat16 when
// bf16 is non-zero, else float; lse [B*H, L] float. Each entry point returns
// a cudaError_t value; 0 means the launch was accepted.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int L, int S, float scale,
                        int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  if (!bf16) return launch_fwd<float>(q, k, v, o, lse_f, B, H, L, S, scale, s);
  const dim3 grid((L + MMA_ROWS - 1) / MMA_ROWS, B * H);
  flash_fwd_mma_kernel<<<grid, 32 * MMA_WARPS, 0, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse_f, H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// dout and dq as q; delta [B*H, L] float = rowsum(dout * o)
int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int H, int L, int S, float scale,
                       int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (!bf16)
    return launch_dq<float>(q, k, v, dout, l, dl, dq, B, H, L, S, scale, s);
  using bf = __nv_bfloat16;
  const dim3 grid((L + MMA_ROWS - 1) / MMA_ROWS, B * H);
  flash_dq_mma_kernel<<<grid, 32 * MMA_WARPS, 0, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
      static_cast<bf*>(dq), H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// dk, dv as k
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int L, int S,
                        float scale, int bf16, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (!bf16)
    return launch_dkv<float>(q, k, v, dout, l, dl, dk, dv, B, H, L, S, scale,
                             s);
  using bf = __nv_bfloat16;
  cudaError_t err = allow_smem(flash_dkv_mma_kernel, kDkvMmaSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + MMA_ROWS - 1) / MMA_ROWS, B * H);
  flash_dkv_mma_kernel<<<grid, 32 * MMA_WARPS, kDkvMmaSmem, s>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k),
      static_cast<const bf*>(v), static_cast<const bf*>(dout), l, dl,
      static_cast<bf*>(dk), static_cast<bf*>(dv), H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
