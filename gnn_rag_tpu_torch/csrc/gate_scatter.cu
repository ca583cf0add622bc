// Gate-scatter forward and backward for Hopper (sm_90a), bound through a
// plain C interface.
//
// The forward replaces the TPU kernels of gnn_rag_tpu/ops/pallas_mp.py:
//   _fused_kernel_v4  (:844)  both directions in one launch (ReasonGNN)
//   _fused_kernel_v4s (:1231) one direction / one instruction (huge-E tiers)
//   _fused_kernel_v3  (:565)  one direction, [B,J,E,D] output (TypeLayer)
// All three compute, per direction d, sample b and fact f of the tile-sorted
// layout,
//   out[d, b, scatter[f], j*D + k] += float(act(vals[f, k] * ins[b, j, k]))
//                                     * float(T(prior[f]))
// where act is relu or identity, the product vals*ins is formed in the input
// type T, prior is rounded to T before it multiplies, and the sum is float.
// Slots with scatter < 0 (chunk padding) add nothing.
//
// Design: one thread block per (direction, sample, 128-entity tile). The
// block walks the tile's fact chunks chunk_starts[t] .. chunk_starts[t+1] (in
// layout order), accumulates a [128, J*D] float tile in shared memory and
// writes it out once, so every output element is written exactly once by one
// block: no atomics, no memset, and the sum order is fixed (deterministic).
// Thread c owns output column c for the whole walk, so the read-modify-write
// of a fact's row never conflicts and needs no atomics. The walk goes
// kStage fact slots at a time: the block first copies the slots' rows,
// priors and [kStage, D] values into shared memory (the values with
// asynchronous 16-byte copies, all in flight at once), then each thread runs
// the slots from shared memory.
//
// What bounds it on an H100: it reads B*Fp*D*sizeof(T) bytes of fact values
// per direction and writes B*E*J*D floats; the arithmetic is one multiply
// and one add per (fact, column), far below the card's rates, so it is
// bound by memory traffic and load latency: with a few blocks per SM, the
// loads in flight per SM, not HBM bandwidth, set the rate. Loading each
// slot's value inside the per-slot loop, or staging with one 4-byte load
// per thread at a time, keeps too few bytes in flight; the asynchronous
// 16-byte staging copies are what this design does about it.
//
// The backward replaces the TPU kernels
//   _fused_bwd_kernel_v4  (:988)  both directions (ReasonGNN)
//   _fused_bwd_kernel_v4s (:1267) one direction / one instruction
//   _fused_bwd_kernel_v3  (:639)  one direction, TypeLayer (J=1, no relu)
// With g the [ndir,B,E,J*D] float cotangent, gb = g[d, b, scatter[f], :],
// pre_jk = float(vals[f,k]) * float(ins[b,j,k]) and act = relu or identity:
//   dprior[f]  = sum_{j,k} gb_jk * act(pre_jk)
//   dval_jk    = gb_jk * prior[f] * (relu ? [pre_jk > 0] : 1)
//   dvals[f,k] = sum_j dval_jk * ins[b,j,k]            (cast to T)
//   dins[b,j,k] = sum_{d,f} dval_jk * vals[f,k]         (cast to T)
// all in float, with the prior unrounded (the TPU backward reads it in f32
// although its forward rounds it to T). Pad slots get dvals = dprior = 0.
//
// Design: the same grid as the forward. Facts of tile t's chunk range scatter
// only into tile t, so the block stages the tile's [128, J*D] slice of g in
// shared memory once (asynchronous 16-byte copies) and every fact reads its
// cotangent row from there. One warp per fact slot: lanes run the columns k
// (and all j for each k), so dvals[f,:] needs no reduction across threads and
// is written once, coalesced, and dprior[f] is one warp-shuffle reduction.
// dins is a sum over all facts of the sample: each warp keeps its own partial
// [J*D] in shared memory, the block adds the warps in a fixed order and
// writes one partial per tile to a workspace [ndir,B,n_tiles,J*D], and a
// second small kernel adds the tiles in a fixed order. No float atomics, so
// the result repeats bit for bit. Slots past the last tile's range (the
// loader pads the chunk count to the bucket) are zeroed by all blocks in a
// strided loop.
//
// What bounds the backward on an H100: per direction it reads B*E*J*D
// floats of g once and B*Fp*D values, and writes B*Fp*D values and B*Fp
// priors; about 6 flops per (fact, column). Memory traffic and load latency
// again, not arithmetic: g comes in as whole-tile async copies, and each
// warp's loads are independent of the other warps' facts.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kTileE = 128;
constexpr int kTileF = 128;
constexpr int kStage = 64;   // fact slots staged in shared memory at a time

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
__device__ __forceinline__ float mul(float a, float b) { return a * b; }
__device__ __forceinline__ __nv_bfloat16 mul(__nv_bfloat16 a,
                                             __nv_bfloat16 b) {
  return __hmul(a, b);
}

// Per-direction inputs: one pointer per direction, so the caller passes the
// forward and inverse tensors as they are, without stacking them.
struct DirPtrs {
  const void* vals[2];             // [B,Fp,D] T
  const float* prior[2];           // [B,Fp]
  const int32_t* scatter[2];       // [B,Fp]
  const int32_t* chunk_starts[2];  // [B,n_tiles+1]
};

// ins [B,J,D] T; out [ndir,B,n_tiles*128,J*D] f32.
// grid (n_tiles, B, ndir), block >= J*D threads.
template <typename T>
__global__ void gate_scatter_fwd_kernel(DirPtrs p, const T* __restrict__ ins,
                                        float* __restrict__ out, int B, int Fp,
                                        int D, int J, int n_tiles,
                                        int apply_relu) {
  extern __shared__ __align__(16) float smem[];
  const int JD = J * D;
  float* acc = smem;                                    // [kTileE, JD]
  int32_t* s_row = reinterpret_cast<int32_t*>(acc + kTileE * JD);  // [kStage]
  float* s_pri = reinterpret_cast<float*>(s_row + kStage);         // [kStage]
  T* s_val = reinterpret_cast<T*>(s_pri + kStage);                 // [kStage, D]

  const int t = blockIdx.x, b = blockIdx.y, d = blockIdx.z;
  const int col = threadIdx.x;
  const bool active = col < JD;
  const int j = active ? col / D : 0;
  const int k = active ? col - j * D : 0;

  if (active) {
    for (int r = 0; r < kTileE; ++r) acc[r * JD + col] = 0.f;
  }
  const T ins_jk = active ? ins[((size_t)b * J + j) * D + k] : from_float<T>(0.f);

  // select, not p.x[d]: indexing a parameter array with a runtime index
  // copies the array to local memory first
  const int32_t* cs = (d ? p.chunk_starts[1] : p.chunk_starts[0]) +
                      (size_t)b * (n_tiles + 1);
  const int f_begin = cs[t] * kTileF, f_end = cs[t + 1] * kTileF;
  const int32_t* sc = (d ? p.scatter[1] : p.scatter[0]) + (size_t)b * Fp;
  const float* pr = (d ? p.prior[1] : p.prior[0]) + (size_t)b * Fp;
  const T* vl = static_cast<const T*>(d ? p.vals[1] : p.vals[0]) +
                (size_t)b * Fp * D;
  const int row0 = t * kTileE;

  for (int f0 = f_begin; f0 < f_end; f0 += kStage) {
    __syncthreads();  // the previous stage is no longer read
    // stage kStage fact slots: their rows, priors and [kStage, D] values,
    // read contiguously by the whole block (coalesced, many loads in flight)
    for (int i = threadIdx.x; i < kStage; i += blockDim.x) {
      s_row[i] = sc[f0 + i] - row0;
      // prior rounded to the input type, as the TPU kernel's one-hot operand
      s_pri[i] = to_float(from_float<T>(pr[f0 + i]));
    }
    // [kStage, D] values: one contiguous, 16-byte aligned block, copied
    // with asynchronous 16-byte copies so all of them are in flight at once
    const uint4* src = reinterpret_cast<const uint4*>(vl + (size_t)f0 * D);
    uint4* dst = reinterpret_cast<uint4*>(s_val);
    const int n16 = kStage * D * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if (!active) continue;
    for (int i = 0; i < kStage; ++i) {
      const int r = s_row[i];
      if ((unsigned)r >= (unsigned)kTileE) continue;  // pad slot (scatter < 0)
      float gv = to_float(mul(s_val[i * D + k], ins_jk));
      if (apply_relu) gv = fmaxf(gv, 0.f);
      acc[r * JD + col] += gv * s_pri[i];
    }
  }

  if (active) {
    const size_t db = (size_t)d * B + b;
    float* o = out + (db * n_tiles * kTileE + row0) * JD + col;
    for (int r = 0; r < kTileE; ++r) o[(size_t)r * JD] = acc[r * JD + col];
  }
}

template <typename T>
int launch(const DirPtrs& p, const void* ins, void* out, int ndir, int B,
           int Fp, int D, int J, int n_tiles, int apply_relu, void* stream) {
  const int JD = J * D;
  const int threads = ((JD + 31) / 32) * 32;
  const size_t smem = (size_t)kTileE * JD * sizeof(float) +
                      kStage * (sizeof(int32_t) + sizeof(float)) +
                      (size_t)kStage * D * sizeof(T);
  cudaError_t err = cudaFuncSetAttribute(
      gate_scatter_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return (int)err;
  }
  dim3 grid(n_tiles, B, ndir);
  gate_scatter_fwd_kernel<T><<<grid, threads, smem, (cudaStream_t)stream>>>(
      p, static_cast<const T*>(ins), static_cast<float*>(out), B, Fp, D, J,
      n_tiles, apply_relu);
  return (int)cudaGetLastError();
}

constexpr int kBwdThreads = 256;   // 8 warps, one fact slot each at a time

// Backward outputs. dvals [ndir,B,Fp,D] T and dprior [ndir,B,Fp] f32 are
// stacked on the direction; dprior and dins_ws may be null (not needed).
struct BwdOut {
  void* dvals;
  float* dprior;
  float* dins_ws;  // [ndir,B,n_tiles,J*D] per-tile partials of dins
};

// g [ndir,B,n_tiles*128,J*D] f32; grid (n_tiles, B, ndir), kBwdThreads.
template <typename T>
__global__ void gate_scatter_bwd_kernel(DirPtrs p, const T* __restrict__ ins,
                                        const float* __restrict__ g, BwdOut o,
                                        int B, int Fp, int D, int J,
                                        int n_tiles, int apply_relu) {
  extern __shared__ __align__(16) float smem[];
  const int JD = J * D;
  const int nwarps = kBwdThreads / 32;
  float* s_g = smem;                    // [kTileE, JD] cotangent rows of the tile
  float* s_ins = s_g + kTileE * JD;     // [JD]
  float* s_dins = s_ins + JD;           // [nwarps, JD] per-warp dins partials

  const int t = blockIdx.x, b = blockIdx.y, d = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const bool need_dins = o.dins_ws != nullptr;
  const int row0 = t * kTileE;
  const size_t db = (size_t)d * B + b;

  // stage the tile's [128, JD] slice of g: one contiguous, 16-byte aligned
  // block (128 * JD floats is a multiple of 4)
  const uint4* src = reinterpret_cast<const uint4*>(
      g + (db * n_tiles * kTileE + row0) * JD);
  uint4* dst = reinterpret_cast<uint4*>(s_g);
  for (int i = threadIdx.x; i < kTileE * JD / 4; i += kBwdThreads)
    __pipeline_memcpy_async(dst + i, src + i, 16);
  __pipeline_commit();
  for (int c = threadIdx.x; c < JD; c += kBwdThreads)
    s_ins[c] = to_float(ins[(size_t)b * JD + c]);
  if (need_dins)
    for (int c = threadIdx.x; c < nwarps * JD; c += kBwdThreads) s_dins[c] = 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();

  const int32_t* cs = (d ? p.chunk_starts[1] : p.chunk_starts[0]) +
                      (size_t)b * (n_tiles + 1);
  const int f_begin = cs[t] * kTileF, f_end = cs[t + 1] * kTileF;
  const int f_last = cs[n_tiles] * kTileF;  // end of the last tile's range
  const int32_t* sc = (d ? p.scatter[1] : p.scatter[0]) + (size_t)b * Fp;
  const float* pr = (d ? p.prior[1] : p.prior[0]) + (size_t)b * Fp;
  const T* vl = static_cast<const T*>(d ? p.vals[1] : p.vals[0]) +
                (size_t)b * Fp * D;
  T* dv = static_cast<T*>(o.dvals) + db * Fp * D;
  float* dp = o.dprior ? o.dprior + db * Fp : nullptr;
  float* s_dw = s_dins + warp * JD;

  for (int f = f_begin + warp; f < f_end; f += nwarps) {
    const int r = sc[f] - row0;
    T* dv_row = dv + (size_t)f * D;
    if ((unsigned)r >= (unsigned)kTileE) {  // pad slot (scatter < 0)
      for (int k = lane; k < D; k += 32) dv_row[k] = from_float<T>(0.f);
      if (dp && lane == 0) dp[f] = 0.f;
      continue;
    }
    const float pri = pr[f];
    const float* g_row = s_g + r * JD;
    const T* v_row = vl + (size_t)f * D;
    float dpri = 0.f;
    for (int k = lane; k < D; k += 32) {
      const float v = to_float(v_row[k]);
      float dvk = 0.f;
      for (int j = 0; j < J; ++j) {
        const int c = j * D + k;
        const float in = s_ins[c];
        const float gb = g_row[c];
        const float pre = v * in;
        dpri += gb * (apply_relu ? fmaxf(pre, 0.f) : pre);
        const float dval = (apply_relu && !(pre > 0.f)) ? 0.f : gb * pri;
        dvk += dval * in;
        if (need_dins) s_dw[c] += dval * v;
      }
      dv_row[k] = from_float<T>(dvk);
    }
    if (dp) {
      for (int off = 16; off > 0; off >>= 1)
        dpri += __shfl_xor_sync(0xffffffffu, dpri, off);
      if (lane == 0) dp[f] = dpri;
    }
  }
  // slots past the last tile's range: every block zeroes its share
  for (int f = f_last + t * nwarps + warp; f < Fp; f += n_tiles * nwarps) {
    for (int k = lane; k < D; k += 32) dv[(size_t)f * D + k] = from_float<T>(0.f);
    if (dp && lane == 0) dp[f] = 0.f;
  }

  if (need_dins) {
    __syncthreads();
    float* ws = o.dins_ws + (db * n_tiles + t) * JD;
    for (int c = threadIdx.x; c < JD; c += kBwdThreads) {
      float s = 0.f;
      for (int w = 0; w < nwarps; ++w) s += s_dins[w * JD + c];
      ws[c] = s;
    }
  }
}

// dins[b, c] = sum over directions, then tiles, of the partials; grid (B).
template <typename T>
__global__ void dins_reduce_kernel(const float* __restrict__ ws,
                                   T* __restrict__ dins, int ndir, int B,
                                   int n_tiles, int JD) {
  const int b = blockIdx.x;
  for (int c = threadIdx.x; c < JD; c += blockDim.x) {
    float s = 0.f;
    for (int d = 0; d < ndir; ++d) {
      const float* w = ws + (((size_t)d * B + b) * n_tiles) * JD + c;
      for (int t = 0; t < n_tiles; ++t) s += w[(size_t)t * JD];
    }
    dins[(size_t)b * JD + c] = from_float<T>(s);
  }
}

template <typename T>
int launch_bwd(const DirPtrs& p, const void* ins, const float* g,
               const BwdOut& o, void* dins, int ndir, int B, int Fp, int D,
               int J, int n_tiles, int apply_relu, void* stream) {
  const int JD = J * D;
  const size_t smem = ((size_t)kTileE * JD + JD + (kBwdThreads / 32) * JD) *
                      sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gate_scatter_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  dim3 grid(n_tiles, B, ndir);
  gate_scatter_bwd_kernel<T><<<grid, kBwdThreads, smem, (cudaStream_t)stream>>>(
      p, static_cast<const T*>(ins), g, o, B, Fp, D, J, n_tiles, apply_relu);
  err = cudaGetLastError();
  if (err != cudaSuccess || o.dins_ws == nullptr) return (int)err;
  dins_reduce_kernel<T><<<B, 128, 0, (cudaStream_t)stream>>>(
      o.dins_ws, static_cast<T*>(dins), ndir, B, n_tiles, JD);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Direction d's inputs are vals_d, prior_d, scatter_d and chunk_starts_d;
// with ndir == 1 the *_1 pointers are not read. vals and ins are bfloat16
// when bf16 is non-zero, else float. Returns a cudaError_t value; 0 means
// the launch was accepted.
int gate_scatter_fwd(const void* vals_0, const void* vals_1, const void* ins,
                     const void* prior_0, const void* prior_1,
                     const void* scatter_0, const void* scatter_1,
                     const void* chunk_starts_0, const void* chunk_starts_1,
                     void* out, int ndir, int B, int Fp, int D, int J,
                     int n_tiles, int apply_relu, int bf16, void* stream) {
  const DirPtrs p{{vals_0, vals_1},
                  {static_cast<const float*>(prior_0),
                   static_cast<const float*>(prior_1)},
                  {static_cast<const int32_t*>(scatter_0),
                   static_cast<const int32_t*>(scatter_1)},
                  {static_cast<const int32_t*>(chunk_starts_0),
                   static_cast<const int32_t*>(chunk_starts_1)}};
  return bf16 ? launch<__nv_bfloat16>(p, ins, out, ndir, B, Fp, D, J, n_tiles,
                                      apply_relu, stream)
              : launch<float>(p, ins, out, ndir, B, Fp, D, J, n_tiles,
                              apply_relu, stream);
}

// The backward of gate_scatter_fwd, inputs as there; g [ndir,B,E,J*D] f32.
// Writes dvals [ndir,B,Fp,D] (vals' type), dprior [ndir,B,Fp] f32 unless
// dprior is null, and dins [B,J,D] (ins' type) unless dins_ws is null
// (dins_ws: [ndir,B,n_tiles,J*D] f32 scratch). Returns a cudaError_t value.
int gate_scatter_bwd(const void* vals_0, const void* vals_1, const void* ins,
                     const void* prior_0, const void* prior_1,
                     const void* scatter_0, const void* scatter_1,
                     const void* chunk_starts_0, const void* chunk_starts_1,
                     const void* g, void* dvals, void* dprior, void* dins_ws,
                     void* dins, int ndir, int B, int Fp, int D, int J,
                     int n_tiles, int apply_relu, int bf16, void* stream) {
  const DirPtrs p{{vals_0, vals_1},
                  {static_cast<const float*>(prior_0),
                   static_cast<const float*>(prior_1)},
                  {static_cast<const int32_t*>(scatter_0),
                   static_cast<const int32_t*>(scatter_1)},
                  {static_cast<const int32_t*>(chunk_starts_0),
                   static_cast<const int32_t*>(chunk_starts_1)}};
  const BwdOut o{dvals, static_cast<float*>(dprior),
                 static_cast<float*>(dins_ws)};
  const float* gf = static_cast<const float*>(g);
  return bf16 ? launch_bwd<__nv_bfloat16>(p, ins, gf, o, dins, ndir, B, Fp, D,
                                          J, n_tiles, apply_relu, stream)
              : launch_bwd<float>(p, ins, gf, o, dins, ndir, B, Fp, D, J,
                                  n_tiles, apply_relu, stream);
}

const char* gate_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
