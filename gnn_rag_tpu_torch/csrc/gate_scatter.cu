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
//
// The fused-projection op (one direction per call) replaces
//   _fused_kernel     (:126) v1, a grid step per chunk
//   _fused_kernel_v2  (:210) the same function, a grid cell per entity tile
//   _fused_bwd_kernel (:316) their backward, dW and db summed over the grid
// Its values are the relation features of each slot before rel_linear:
//   rl[f, k] = T(float(sum_m fact_rel[f, m] * w[m, k]) + float(b[k]))
// and the gate above runs on rl. The forward is an instance (kProject) of
// the forward kernel: the block also stages w and b in shared memory once,
// and each staged group of fact_rel rows is projected into the staged
// values before the gate loop, so no [B, Fp, D] projection goes through
// device memory and each fact is projected by one block only. It does
// 2*D*D more flops per fact slot (5,000 at D 50) and reads the same bytes,
// so at D 50 float32 its operations and bytes take about the same least
// time on the card. The backward (fused_bwd_kernel) recomputes rl in float
// from the widened inputs WITHOUT rounding it, and reads the prior
// unrounded, as the TPU backward does (pallas_mp.py:345-352), then runs the
// gate backward above with drl = sum_j dval_j * ins_j in place of dvals, and
// adds dfact_rel = drl @ w^T (cast to T) and this block's partials of
// dW = fact_rel^T drl and db = sum drl. Its 6*D*D flops per slot bound it
// by operations, so its three D x D products run as register-tiled SIMT
// GEMMs over shared memory: D zero-padded to a multiple of 4, 64 slots a
// stage, each thread a 4 x 4 output tile from float4 loads (8 loads for 64
// FMAs), and a fixed 4 x 4 block of dW a thread summed over the stages. The
// gate backward runs on the rl tile in registers between the products. A tile's
// chunk range is split over up to kFbParts blocks (at least kFbPartChunks
// chunks each), so the few long tiles of a skewed subgraph no longer set
// the time; every part writes its dins and dW/db partials to a workspace
// that part_reduce_kernel adds in a fixed order, so there are no float
// atomics and two launches give the same bits.
//
// The scatter-only op (kScatter) replaces _scatter_kernel (:32, scatter_mm):
//   out[b, scatter[f], c] += float(values[f, c])
// for any width C, with the tile ranges found from chunk_tiles. It reads
// B*Fp*C values and writes B*E*C floats with one add each: bound by bytes.

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

// What the forward kernel adds per staged value: the gate of the serving
// and training path, the same gate on values it projects itself (the
// fused-projection op), or the value alone (scatter_mm). Compile-time
// instances, so the gate path's loop has no branch of the other two.
enum FwdMode { kGate = 0, kProject = 1, kScatter = 2 };
constexpr int kProjRows = 4;  // staged rows a thread projects at once
constexpr int kProjThreads = 256;  // least block size of the kProject forward

// rel_linear of the fused-projection op: w [D,D] (rl = fact_rel @ w + b) and
// b [D], in the input type.
struct Proj {
  const void* w;
  const void* b;
};

// rl[i, k] = T(sum_m fr[i, m] * w[m, k] + b[k]) for the kStage staged rows,
// sums in float over m in order; each thread projects kProjRows rows of one
// column k, so every w load serves kProjRows FMAs.
template <typename T>
__device__ __forceinline__ void project_stage(const T* s_fr, const float* s_w,
                                              const float* s_b, T* s_val,
                                              int D) {
  for (int idx = threadIdx.x; idx < (kStage / kProjRows) * D;
       idx += blockDim.x) {
    const int grp = idx / D, k = idx - grp * D;
    const T* fr = s_fr + grp * kProjRows * D;
    float s[kProjRows] = {};
    for (int m = 0; m < D; ++m) {
      const float w = s_w[m * D + k];
#pragma unroll
      for (int r = 0; r < kProjRows; ++r)
        s[r] = fmaf(to_float(fr[r * D + m]), w, s[r]);
    }
#pragma unroll
    for (int r = 0; r < kProjRows; ++r)
      s_val[(grp * kProjRows + r) * D + k] = from_float<T>(s[r] + s_b[k]);
  }
}

// First index i of the non-decreasing row a[0..n) with a[i] >= v (n if none).
__device__ __forceinline__ int first_at_least(const int32_t* a, int n, int v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ins [B,J,D] T; out [ndir,B,n_tiles*128,J*D] f32.
// grid (n_tiles, B, ndir), block >= J*D threads.
// kProject: vals are fact_rel rows, projected with proj in the kernel.
// kScatter: J = 1, D is the width C, ins and prior are not read, and
// p.chunk_starts holds chunk_tiles [B, Fp/128] instead.
template <typename T, int kMode>
__global__ void gate_scatter_fwd_kernel(DirPtrs p, const T* __restrict__ ins,
                                        Proj proj, float* __restrict__ out,
                                        int B, int Fp, int D, int J,
                                        int n_tiles, int apply_relu) {
  extern __shared__ __align__(16) float smem[];
  const int JD = J * D;
  float* acc = smem;                                    // [kTileE, JD]
  int32_t* s_row = reinterpret_cast<int32_t*>(acc + kTileE * JD);  // [kStage]
  float* s_pri = reinterpret_cast<float*>(s_row + kStage);         // [kStage]
  T* s_val = reinterpret_cast<T*>(s_pri + kStage);                 // [kStage, D]
  T* s_fr = s_val + kStage * D;                // kProject: [kStage, D] fact_rel
  float* s_w = reinterpret_cast<float*>(s_fr + kStage * D);  // kProject: [D, D]
  float* s_b = s_w + D * D;                                   // kProject: [D]

  const int t = blockIdx.x, b = blockIdx.y, d = blockIdx.z;
  const int col = threadIdx.x;
  const bool active = col < JD;
  const int j = active ? col / D : 0;
  const int k = active ? col - j * D : 0;

  if (active) {
    for (int r = 0; r < kTileE; ++r) acc[r * JD + col] = 0.f;
  }
  T ins_jk = from_float<T>(0.f);
  if constexpr (kMode != kScatter) {
    if (active) ins_jk = ins[((size_t)b * J + j) * D + k];
  }
  if constexpr (kMode == kProject) {
    // w and b once per block, widened to float (visible to all threads
    // after the first stage's barrier)
    const T* w = static_cast<const T*>(proj.w);
    const T* bias = static_cast<const T*>(proj.b);
    for (int i = threadIdx.x; i < D * D; i += blockDim.x) s_w[i] = to_float(w[i]);
    for (int i = threadIdx.x; i < D; i += blockDim.x) s_b[i] = to_float(bias[i]);
  }

  // select, not p.x[d]: indexing a parameter array with a runtime index
  // copies the array to local memory first
  int f_begin, f_end;
  if constexpr (kMode == kScatter) {
    // tile t's chunks: from the first whose tile is >= t to the first whose
    // tile is > t (padding chunks repeat the last tile, with scatter -1)
    const int nc = Fp / kTileF;
    const int32_t* ct = p.chunk_starts[0] + (size_t)b * nc;
    f_begin = first_at_least(ct, nc, t) * kTileF;
    f_end = first_at_least(ct, nc, t + 1) * kTileF;
  } else {
    const int32_t* cs = (d ? p.chunk_starts[1] : p.chunk_starts[0]) +
                        (size_t)b * (n_tiles + 1);
    f_begin = cs[t] * kTileF;
    f_end = cs[t + 1] * kTileF;
  }
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
      if constexpr (kMode != kScatter)
        s_pri[i] = to_float(from_float<T>(pr[f0 + i]));
    }
    // [kStage, D] values: one contiguous, 16-byte aligned block, copied
    // with asynchronous 16-byte copies so all of them are in flight at once
    const uint4* src = reinterpret_cast<const uint4*>(vl + (size_t)f0 * D);
    uint4* dst = reinterpret_cast<uint4*>(kMode == kProject ? s_fr : s_val);
    const int n16 = kStage * D * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += blockDim.x)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    __syncthreads();
    if constexpr (kMode == kProject) {
      project_stage(s_fr, s_w, s_b, s_val, D);
      __syncthreads();
    }
    if (!active) continue;
    for (int i = 0; i < kStage; ++i) {
      const int r = s_row[i];
      if ((unsigned)r >= (unsigned)kTileE) continue;  // pad slot (scatter < 0)
      if constexpr (kMode == kScatter) {
        acc[r * JD + col] += to_float(s_val[i * D + k]);
      } else {
        float gv = to_float(mul(s_val[i * D + k], ins_jk));
        if (apply_relu) gv = fmaxf(gv, 0.f);
        acc[r * JD + col] += gv * s_pri[i];
      }
    }
  }

  if (active) {
    const size_t db = (size_t)d * B + b;
    float* o = out + (db * n_tiles * kTileE + row0) * JD + col;
    for (int r = 0; r < kTileE; ++r) o[(size_t)r * JD] = acc[r * JD + col];
  }
}

template <typename T, int kMode>
int launch(const DirPtrs& p, const void* ins, Proj proj, void* out, int ndir,
           int B, int Fp, int D, int J, int n_tiles, int apply_relu,
           void* stream) {
  const int JD = J * D;
  // kProject: at least kProjThreads, so that the projection, which all
  // threads run, has more warps in flight than the gate loop needs
  int threads = ((JD + 31) / 32) * 32;
  if (kMode == kProject && threads < kProjThreads) threads = kProjThreads;
  size_t smem = (size_t)kTileE * JD * sizeof(float) +
                kStage * (sizeof(int32_t) + sizeof(float)) +
                (size_t)kStage * D * sizeof(T);
  if (kMode == kProject)   // staged fact_rel, w and b
    smem += (size_t)kStage * D * sizeof(T) + ((size_t)D * D + D) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gate_scatter_fwd_kernel<T, kMode>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return (int)err;
  }
  dim3 grid(n_tiles, B, ndir);
  gate_scatter_fwd_kernel<T, kMode>
      <<<grid, threads, smem, (cudaStream_t)stream>>>(
          p, static_cast<const T*>(ins), proj, static_cast<float*>(out), B, Fp,
          D, J, n_tiles, apply_relu);
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

// The fused-projection backward stages kFbSlots fact slots at a time and
// splits each tile's chunk range over up to kFbParts blocks.
constexpr int kFbSlots = 64;      // fact slots a stage
constexpr int kFbParts = 8;       // blocks a tile at most
constexpr int kFbPartChunks = 2;  // least chunks a part takes
constexpr int kFbPre = 4;         // 16-byte fact_rel pieces a thread prefetches

// Outputs of the fused-projection backward (one direction).
struct ProjBwdOut {
  void* dfr;       // [B,Fp,D] T
  float* dprior;   // [B,Fp]
  float* dins_ws;  // [B,n_tiles,kFbParts,J*D] per-part partials of dins
  float* dw_ws;    // [B*n_tiles*kFbParts,D*D+D] per-part partials of dW, db
};

// A tile with n chunks runs in min(kFbParts, ceil(n / kFbPartChunks))
// parts; the others of its kFbParts blocks are empty.
__host__ __device__ __forceinline__ int fb_parts(int n) {
  const int parts = (n + kFbPartChunks - 1) / kFbPartChunks;
  return parts < kFbParts ? parts : kFbParts;
}

// Shared-memory layout of fused_bwd_kernel, offsets in floats. D is padded
// to Dp, a multiple of 4, so every row starts on 16 bytes for float4 loads;
// the padding of w, ins and the staged rows is zero.
struct FbLayout {
  int g, w, fr, x, dw, db, ins, bias, dins, dinsp, dpp, row, pri, total;
  __host__ __device__ FbLayout(int D, int J) {
    const int Dp = (D + 3) & ~3;
    g = 0;                                 // [kTileE, J*D] the tile's cotangent
    w = g + kTileE * J * D;                // [Dp, Dp] w[m, k]
    fr = w + Dp * Dp;                      // [kFbSlots, Dp] the stage's fact_rel
    x = fr + kFbSlots * Dp;                // [kFbSlots, Dp] the stage's drl
    dw = x + kFbSlots * Dp;                // [Dp, Dp] this part's dW
    db = dw + Dp * Dp;                     // [Dp] this part's db
    ins = db + Dp;                         // [J, Dp]
    bias = ins + J * Dp;                   // [Dp]
    dins = bias + Dp;                      // [J*D] this part's dins
    dinsp = dins + J * D;                  // [kFbSlots/4, J, Dp] group partials
    dpp = dinsp + (kFbSlots / 4) * J * Dp; // [Dp/4, kFbSlots] dprior partials
    row = dpp + (Dp / 4) * kFbSlots;       // [kFbSlots] int32
    pri = row + kFbSlots;                  // [kFbSlots]
    total = pri + kFbSlots;
  }
};

__device__ __forceinline__ void fma4(float (&acc)[4], float s, float4 v) {
  acc[0] = fmaf(s, v.x, acc[0]);
  acc[1] = fmaf(s, v.y, acc[1]);
  acc[2] = fmaf(s, v.z, acc[2]);
  acc[3] = fmaf(s, v.w, acc[3]);
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float elem(float4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
// element u of the T values packed in a 16-byte piece, widened to float
__device__ __forceinline__ uint32_t word(uint4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
template <typename T> __device__ __forceinline__ float piece(uint4 v, int u);
template <> __device__ __forceinline__ float piece<float>(uint4 v, int u) {
  return __uint_as_float(word(v, u));
}
template <>
__device__ __forceinline__ float piece<__nv_bfloat16>(uint4 v, int u) {
  return __uint_as_float((word(v, u / 2) >> (16 * (u % 2))) << 16);
}

// The backward of the kProject forward. g [B,n_tiles*128,J*D] f32; grid
// (n_tiles, kFbParts, B), kBwdThreads. Block (t, part, b) takes part `part`
// of tile t's chunk range and walks it kFbSlots slots a stage:
//   1. rl = fact_rel w + b, unrounded: each thread a 4-slot x 4-column tile
//      of float4 loads (8 loads for 64 FMAs), then the gate backward on that
//      tile in registers: drl (to shared memory), its dprior and dins
//      partials;
//   2. dprior of each slot and this part's dins (one thread a column) from
//      the partials, in a fixed order; dfact_rel = drl w^T (a 4 x 4 tile a
//      thread, written out); dW += fact_rel^T drl and db += sum drl (a
//      fixed 4 x 4 block of dW a thread, accumulated in shared memory
//      over the stages, slots in order).
// Two barriers a stage; the next stage's fact_rel rows are loaded into
// registers while this one computes.
template <typename T>
__global__ void __launch_bounds__(kBwdThreads, 2)
    fused_bwd_kernel(DirPtrs p, const T* __restrict__ ins, Proj proj,
                     const float* __restrict__ g, ProjBwdOut o, int Fp, int D,
                     int J, int n_tiles, int apply_relu) {
  extern __shared__ __align__(16) float smem[];
  const FbLayout lay(D, J);
  const int Dp = (D + 3) & ~3, nq = Dp / 4, JD = J * D, DD = D * D;
  const int t = blockIdx.x, part = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int32_t* cs = p.chunk_starts[0] + (size_t)b * (n_tiles + 1);
  const int32_t* sc = p.scatter[0] + (size_t)b * Fp;
  const float* pr = p.prior[0] + (size_t)b * Fp;
  const T* frg = static_cast<const T*>(p.vals[0]) + (size_t)b * Fp * D;
  T* dfr = static_cast<T*>(o.dfr) + (size_t)b * Fp * D;
  float* dp = o.dprior + (size_t)b * Fp;

  // slots past the last tile's range: every block zeroes its share
  {
    const int nwarps = kBwdThreads / 32, lane = tid & 31, warp = tid >> 5;
    const int f_last = cs[n_tiles] * kTileF;
    const int step = n_tiles * kFbParts * nwarps;
    for (int f = f_last + (t * kFbParts + part) * nwarps + warp; f < Fp;
         f += step) {
      for (int k = lane; k < D; k += 32) dfr[(size_t)f * D + k] = from_float<T>(0.f);
      if (lane == 0) dp[f] = 0.f;
    }
  }
  const int c0 = cs[t], nch = cs[t + 1] - c0, parts = fb_parts(nch);
  if (part >= parts) return;   // an empty part writes no partials
  const int f_begin = (c0 + part * nch / parts) * kTileF;
  const int f_end = (c0 + (part + 1) * nch / parts) * kTileF;
  const int row0 = t * kTileE;

  float* s_g = smem + lay.g;
  float* s_w = smem + lay.w;
  float* s_fr = smem + lay.fr;
  float* s_x = smem + lay.x;
  float* s_dw = smem + lay.dw;
  float* s_db = smem + lay.db;
  float* s_ins = smem + lay.ins;
  float* s_b = smem + lay.bias;
  float* s_dins = smem + lay.dins;
  float* s_dinsp = smem + lay.dinsp;
  float* s_dpp = smem + lay.dpp;
  int32_t* s_row = reinterpret_cast<int32_t*>(smem + lay.row);
  float* s_pri = smem + lay.pri;

  // the tile's [128, JD] slice of g, as in gate_scatter_bwd_kernel
  const uint4* gsrc = reinterpret_cast<const uint4*>(
      g + ((size_t)b * n_tiles * kTileE + row0) * JD);
  uint4* gdst = reinterpret_cast<uint4*>(s_g);
  for (int i = tid; i < kTileE * JD / 4; i += kBwdThreads)
    __pipeline_memcpy_async(gdst + i, gsrc + i, 16);
  __pipeline_commit();
  const T* w = static_cast<const T*>(proj.w);
  const T* bias = static_cast<const T*>(proj.b);
  for (int i = tid; i < Dp * Dp; i += kBwdThreads) {
    const int m = i / Dp, k = i - m * Dp;
    s_w[i] = m < D && k < D ? to_float(w[m * D + k]) : 0.f;
    s_dw[i] = 0.f;
  }
  for (int i = tid; i < Dp; i += kBwdThreads) {
    s_b[i] = i < D ? to_float(bias[i]) : 0.f;
    s_db[i] = 0.f;
  }
  for (int i = tid; i < J * Dp; i += kBwdThreads) {
    const int j = i / Dp, k = i - j * Dp;
    s_ins[i] = k < D ? to_float(ins[(size_t)b * JD + j * D + k]) : 0.f;
  }
  for (int c = tid; c < JD; c += kBwdThreads) s_dins[c] = 0.f;
  for (int i = tid; i < kFbSlots * Dp; i += kBwdThreads) s_fr[i] = 0.f;

  // a stage's [kFbSlots, D] fact_rel rows are one contiguous, 16-byte
  // aligned block: kFbPre 16-byte pieces a thread go through registers,
  // loaded a stage ahead; a wider D loads the rest when it is stored
  constexpr int kV = 16 / sizeof(T);
  const int n16 = kFbSlots * D / kV;
  uint4 pre[kFbPre];
  int32_t pre_row = 0;
  float pre_pri = 0.f;
  auto fetch = [&](int f0) {
    const uint4* src = reinterpret_cast<const uint4*>(frg + (size_t)f0 * D);
#pragma unroll
    for (int q = 0; q < kFbPre; ++q) {
      const int i = tid + q * kBwdThreads;
      if (i < n16) pre[q] = src[i];
    }
    if (tid < kFbSlots) {
      pre_row = sc[f0 + tid] - row0;
      pre_pri = pr[f0 + tid];         // unrounded, as the TPU backward
    }
  };
  auto put = [&](int i, uint4 v) {
#pragma unroll
    for (int u = 0; u < kV; ++u) {
      const int e = i * kV + u, r = e / D;
      s_fr[r * Dp + e - r * D] = piece<T>(v, u);
    }
  };
  auto stash = [&](int f0) {
#pragma unroll
    for (int q = 0; q < kFbPre; ++q) {
      const int i = tid + q * kBwdThreads;
      if (i < n16) put(i, pre[q]);
    }
    const uint4* src = reinterpret_cast<const uint4*>(frg + (size_t)f0 * D);
    for (int i = tid + kFbPre * kBwdThreads; i < n16; i += kBwdThreads)
      put(i, src[i]);
    if (tid < kFbSlots) {
      s_row[tid] = pre_row;
      s_pri[tid] = pre_pri;
    }
  };

  __pipeline_wait_prior(0);
  fetch(f_begin);
  for (int f0 = f_begin; f0 < f_end; f0 += kFbSlots) {
    __syncthreads();   // the setup, or the previous stage's reads, are done
    stash(f0);
    if (f0 + kFbSlots < f_end) fetch(f0 + kFbSlots);
    __syncthreads();

    // 1. rl tile, then the gate backward on it
    for (int id = tid; id < (kFbSlots / 4) * nq; id += kBwdThreads) {
      const int ig = id / nq, kq = id - ig * nq;
      float a[4][4] = {};                 // rl[4 ig + r][4 kq + c]
      const float* fr = s_fr + 4 * ig * Dp;
      const float* wc = s_w + 4 * kq;
      for (int m = 0; m < Dp; m += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = ld4(fr + r * Dp + m);
#pragma unroll
        for (int u = 0; u < 4; ++u) y[u] = ld4(wc + (m + u) * Dp);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          fma4(a[r], x[r].x, y[0]);
          fma4(a[r], x[r].y, y[1]);
          fma4(a[r], x[r].z, y[2]);
          fma4(a[r], x[r].w, y[3]);
        }
      }
      const float4 bv = ld4(s_b + 4 * kq);
      int rows[4];
      float pri[4], drl[4][4] = {}, dpri[4] = {};
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) a[r][c] += elem(bv, c);
        rows[r] = s_row[4 * ig + r];
        pri[r] = s_pri[4 * ig + r];
      }
      for (int j = 0; j < J; ++j) {
        const float4 in4 = ld4(s_ins + j * Dp + 4 * kq);
        float dins[4] = {};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if ((unsigned)rows[r] >= (unsigned)kTileE) continue;  // pad slot
          const float* grow = s_g + rows[r] * JD + j * D + 4 * kq;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float in = elem(in4, c);
            const float gb = 4 * kq + c < D ? grow[c] : 0.f;
            const float pre = a[r][c] * in;
            dpri[r] += gb * (apply_relu ? fmaxf(pre, 0.f) : pre);
            const float dval = (apply_relu && !(pre > 0.f)) ? 0.f : gb * pri[r];
            drl[r][c] += dval * in;
            dins[c] += dval * a[r][c];
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s_dinsp[(ig * J + j) * Dp + 4 * kq + c] = dins[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        *reinterpret_cast<float4*>(s_x + (4 * ig + r) * Dp + 4 * kq) =
            make_float4(drl[r][0], drl[r][1], drl[r][2], drl[r][3]);
        s_dpp[kq * kFbSlots + 4 * ig + r] = dpri[r];
      }
    }
    __syncthreads();

    // 2a. dprior of the stage's slots: the column groups in order
    for (int i = tid; i < kFbSlots; i += kBwdThreads) {
      float s = 0.f;
      for (int q = 0; q < nq; ++q) s += s_dpp[q * kFbSlots + i];
      dp[f0 + i] = (unsigned)s_row[i] < (unsigned)kTileE ? s : 0.f;
    }
    // 2b. this part's dins: a column a thread, the 4-slot groups in order
    for (int c = tid; c < JD; c += kBwdThreads) {
      const int j = c / D, k = c - j * D;
      float s = s_dins[c];
      for (int ig = 0; ig < kFbSlots / 4; ++ig)
        s += s_dinsp[(ig * J + j) * Dp + k];
      s_dins[c] = s;
    }
    // 2c. dfact_rel = drl w^T: 4 slots x the columns m = mq + nq mm of a
    // thread (w's rows at stride nq apart fall in distinct banks)
    for (int id = tid; id < (kFbSlots / 4) * nq; id += kBwdThreads) {
      const int ig = id / nq, mq = id - ig * nq;
      float a[4][4] = {};                 // dfr[4 ig + r][mq + nq mm]
      const float* xr = s_x + 4 * ig * Dp;
      for (int k = 0; k < Dp; k += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = ld4(xr + r * Dp + k);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) y[mm] = ld4(s_w + (mq + nq * mm) * Dp + k);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int mm = 0; mm < 4; ++mm) {
            float s = a[r][mm];
            s = fmaf(x[r].x, y[mm].x, s);
            s = fmaf(x[r].y, y[mm].y, s);
            s = fmaf(x[r].z, y[mm].z, s);
            a[r][mm] = fmaf(x[r].w, y[mm].w, s);
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        T* out = dfr + (size_t)(f0 + 4 * ig + r) * D;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int m = mq + nq * mm;
          if (m < D) out[m] = from_float<T>(a[r][mm]);
        }
      }
    }
    // 2d. dW[m, k] += sum_i fr[i, m] drl[i, k] (a fixed 4 x 4 block a
    // thread) and db[k] += sum_i drl[i, k], slots in order
    for (int id = tid; id < nq * nq + nq; id += kBwdThreads) {
      if (id < nq * nq) {
        const int mq = id / nq, kq = id - mq * nq;
        float a[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = ld4(s_dw + (4 * mq + r) * Dp + 4 * kq);
          a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
        }
        for (int i = 0; i < kFbSlots; ++i) {
          const float4 f = ld4(s_fr + i * Dp + 4 * mq);
          const float4 x = ld4(s_x + i * Dp + 4 * kq);
          fma4(a[0], f.x, x);
          fma4(a[1], f.y, x);
          fma4(a[2], f.z, x);
          fma4(a[3], f.w, x);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(s_dw + (4 * mq + r) * Dp + 4 * kq) =
              make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
      } else {
        const int kq = id - nq * nq;
        float4 a = ld4(s_db + 4 * kq);
        for (int i = 0; i < kFbSlots; ++i) {
          const float4 x = ld4(s_x + i * Dp + 4 * kq);
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        }
        *reinterpret_cast<float4*>(s_db + 4 * kq) = a;
      }
    }
  }
  __syncthreads();
  const size_t blk = ((size_t)b * n_tiles + t) * kFbParts + part;
  for (int c = tid; c < JD; c += kBwdThreads) o.dins_ws[blk * JD + c] = s_dins[c];
  float* dw_ws = o.dw_ws + blk * (DD + D);
  for (int e = tid; e < DD + D; e += kBwdThreads) {
    const int m = e / D, k = e - m * D;
    dw_ws[e] = e < DD ? s_dw[m * Dp + k] : s_db[e - DD];
  }
}

constexpr int kRedCols = 32, kRedRows = 32;

// out = the sum of the non-empty parts' partials ws [groups, kFbParts,
// width] of fused_bwd_kernel, in a fixed order, for each of the grid's
// sets: set s adds groups s*n_groups .. (s+1)*n_groups - 1, a group being a
// (sample, tile) whose part count comes from chunk_starts. kRedRows threads
// add a contiguous strip of groups each (all of a group's parts loaded
// before they are added in order), then the strips are added in order.
// Entry e < split goes to out_a[s*split + e], the rest to out_b[e - split].
// grid (ceil(width / kRedCols), sets), block (kRedCols, kRedRows).
template <typename T>
__global__ void part_reduce_kernel(const float* __restrict__ ws,
                                   const int32_t* __restrict__ chunk_starts,
                                   int n_tiles, int n_groups, int width,
                                   int split, T* __restrict__ out_a,
                                   T* __restrict__ out_b) {
  __shared__ float strip[kRedRows][kRedCols];
  const int e = blockIdx.x * kRedCols + threadIdx.x, set = blockIdx.y;
  const int per = (n_groups + kRedRows - 1) / kRedRows;
  const int i0 = threadIdx.y * per, i1 = min(n_groups, i0 + per);
  float s = 0.f;
  if (e < width) {
    for (int i = i0; i < i1; ++i) {
      const int gi = set * n_groups + i, bb = gi / n_tiles, t = gi - bb * n_tiles;
      const int32_t* cs = chunk_starts + (size_t)bb * (n_tiles + 1);
      const int parts = fb_parts(cs[t + 1] - cs[t]);
      const float* src = ws + (size_t)gi * kFbParts * width + e;
      float v[kFbParts];
#pragma unroll
      for (int q = 0; q < kFbParts; ++q)
        v[q] = q < parts ? src[(size_t)q * width] : 0.f;
#pragma unroll
      for (int q = 0; q < kFbParts; ++q)
        if (q < parts) s += v[q];
    }
  }
  strip[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < width) {
    float sum = 0.f;
    for (int r = 0; r < kRedRows; ++r) sum += strip[r][threadIdx.x];
    if (e < split) out_a[(size_t)set * split + e] = from_float<T>(sum);
    else out_b[e - split] = from_float<T>(sum);
  }
}

template <typename T>
int launch_fused_bwd(const DirPtrs& p, const void* ins, Proj proj,
                     const float* g, const ProjBwdOut& o, void* dins, void* dw,
                     void* db, int B, int Fp, int D, int J, int n_tiles,
                     int apply_relu, void* stream) {
  const int JD = J * D, width = D * D + D;
  const size_t smem = (size_t)FbLayout(D, J).total * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  fused_bwd_kernel<T><<<dim3(n_tiles, kFbParts, B), kBwdThreads, smem, s>>>(
      p, static_cast<const T*>(ins), proj, g, o, Fp, D, J, n_tiles,
      apply_relu);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const dim3 red(kRedCols, kRedRows);
  part_reduce_kernel<T><<<dim3((JD + kRedCols - 1) / kRedCols, B), red, 0, s>>>(
      o.dins_ws, p.chunk_starts[0], n_tiles, n_tiles, JD, JD,
      static_cast<T*>(dins), static_cast<T*>(nullptr));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  part_reduce_kernel<T><<<dim3((width + kRedCols - 1) / kRedCols, 1), red, 0,
                          s>>>(o.dw_ws, p.chunk_starts[0], n_tiles,
                               B * n_tiles, width, D * D,
                               static_cast<T*>(dw), static_cast<T*>(db));
  return (int)cudaGetLastError();
}

DirPtrs one_direction(const void* vals, const void* prior, const void* scatter,
                      const void* chunk) {
  const float* pr = static_cast<const float*>(prior);
  const int32_t* sc = static_cast<const int32_t*>(scatter);
  const int32_t* cs = static_cast<const int32_t*>(chunk);
  return DirPtrs{{vals, vals}, {pr, pr}, {sc, sc}, {cs, cs}};
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
  return bf16 ? launch<__nv_bfloat16, kGate>(p, ins, Proj{}, out, ndir, B, Fp,
                                             D, J, n_tiles, apply_relu, stream)
              : launch<float, kGate>(p, ins, Proj{}, out, ndir, B, Fp, D, J,
                                     n_tiles, apply_relu, stream);
}

// The fused-projection forward, one direction: fact_rel [B,Fp,D], w [D,D],
// bias [D] and ins [B,J,D] bfloat16 when bf16 is non-zero, else float;
// prior [B,Fp] f32, scatter [B,Fp] i32, chunk_starts [B,n_tiles+1] i32;
// out [B,n_tiles*128,J*D] f32. Returns a cudaError_t value.
int fused_gate_scatter_fwd(const void* fact_rel, const void* w,
                           const void* bias, const void* ins,
                           const void* prior, const void* scatter,
                           const void* chunk_starts, void* out, int B, int Fp,
                           int D, int J, int n_tiles, int apply_relu, int bf16,
                           void* stream) {
  const DirPtrs p = one_direction(fact_rel, prior, scatter, chunk_starts);
  const Proj proj{w, bias};
  return bf16 ? launch<__nv_bfloat16, kProject>(p, ins, proj, out, 1, B, Fp,
                                                D, J, n_tiles, apply_relu,
                                                stream)
              : launch<float, kProject>(p, ins, proj, out, 1, B, Fp, D, J,
                                        n_tiles, apply_relu, stream);
}

// Its backward, inputs as there; g [B,E,J*D] f32. Writes dfr [B,Fp,D] and
// dins [B,J,D], dw [D,D] and db [D] in the input type, dprior [B,Fp] f32;
// dins_ws [B,n_tiles,P,J*D] and dw_ws [B*n_tiles*P,D*D+D] are f32 scratch,
// P = fused_gate_scatter_bwd_parts().
int fused_gate_scatter_bwd_parts() { return kFbParts; }

int fused_gate_scatter_bwd(const void* fact_rel, const void* w,
                           const void* bias, const void* ins,
                           const void* prior, const void* scatter,
                           const void* chunk_starts, const void* g, void* dfr,
                           void* dprior, void* dins_ws, void* dins,
                           void* dw_ws, void* dw, void* db, int B, int Fp,
                           int D, int J, int n_tiles, int apply_relu, int bf16,
                           void* stream) {
  const DirPtrs p = one_direction(fact_rel, prior, scatter, chunk_starts);
  const Proj proj{w, bias};
  const ProjBwdOut o{dfr, static_cast<float*>(dprior),
                     static_cast<float*>(dins_ws), static_cast<float*>(dw_ws)};
  const float* gf = static_cast<const float*>(g);
  return bf16 ? launch_fused_bwd<__nv_bfloat16>(p, ins, proj, gf, o, dins, dw,
                                                db, B, Fp, D, J, n_tiles,
                                                apply_relu, stream)
              : launch_fused_bwd<float>(p, ins, proj, gf, o, dins, dw, db, B,
                                        Fp, D, J, n_tiles, apply_relu, stream);
}

// scatter_mm: values [B,Fp,C] (bfloat16 when bf16 is non-zero, else float),
// scatter [B,Fp] i32, chunk_tiles [B,Fp/128] i32 (non-decreasing per row);
// out [B,n_tiles*128,C] f32. Returns a cudaError_t value.
int scatter_mm_fwd(const void* values, const void* scatter,
                   const void* chunk_tiles, void* out, int B, int Fp, int C,
                   int n_tiles, int bf16, void* stream) {
  const DirPtrs p = one_direction(values, nullptr, scatter, chunk_tiles);
  return bf16 ? launch<__nv_bfloat16, kScatter>(p, nullptr, Proj{}, out, 1, B,
                                                Fp, C, 1, n_tiles, 0, stream)
              : launch<float, kScatter>(p, nullptr, Proj{}, out, 1, B, Fp, C,
                                        1, n_tiles, 0, stream);
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
