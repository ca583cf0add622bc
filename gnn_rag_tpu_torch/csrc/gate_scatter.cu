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
// dW = fact_rel^T drl and db = sum drl. The partials go to a workspace
// [B * n_tiles, D*D + D] that a second kernel adds in a fixed order, so
// there are no float atomics and two launches give the same bits. Its
// 6*D*D flops per slot bound it by operations; on an H100 the rl,
// dfact_rel and dW loops issue about two shared-memory loads per FMA, and
// that load rate, not the FMA rate, limits it (more partial sums per loop
// do not help; reusing each load over several slots or entries would).
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

constexpr int kProjStage = 32;  // fact slots staged at a time (4 a warp)

// Outputs of the fused-projection backward (one direction).
struct ProjBwdOut {
  void* dfr;       // [B,Fp,D] T
  float* dprior;   // [B,Fp]
  float* dins_ws;  // [B,n_tiles,J*D] per-tile partials of dins
  float* dw_ws;    // [B,n_tiles,D*D+D] per-tile partials of dW, then db
};

// The backward of the kProject forward. g [B,n_tiles*128,J*D] f32; grid
// (n_tiles, B), kBwdThreads. A kernel of its own rather than a branch of
// gate_scatter_bwd_kernel: the block-wide dW sum needs a barrier per stage
// of slots, which the plain backward's free-running warps do not have.
template <typename T>
__global__ void fused_bwd_kernel(DirPtrs p, const T* __restrict__ ins,
                                 Proj proj, const float* __restrict__ g,
                                 ProjBwdOut o, int Fp, int D, int J,
                                 int n_tiles, int apply_relu) {
  extern __shared__ __align__(16) float smem[];
  const int JD = J * D, DD = D * D;
  const int nwarps = kBwdThreads / 32;
  float* s_g = smem;                                  // [kTileE, JD]
  T* s_fr = reinterpret_cast<T*>(s_g + kTileE * JD);  // [kProjStage, D]
  float* s_w = reinterpret_cast<float*>(s_fr + kProjStage * D);  // [D, D]
  float* s_wt = s_w + DD;                 // [D, D], s_wt[k*D + m] = w[m, k]
  float* s_b = s_wt + DD;                 // [D]
  float* s_ins = s_b + D;                 // [JD]
  float* s_dins = s_ins + JD;             // [nwarps, JD] per-warp dins partials
  float* s_drl = s_dins + nwarps * JD;    // [kProjStage, D] the stage's drl
  float* s_dw = s_drl + kProjStage * D;   // [DD + D] this block's dW, db
  int32_t* s_row = reinterpret_cast<int32_t*>(s_dw + DD + D);  // [kProjStage]
  float* s_pri = reinterpret_cast<float*>(s_row + kProjStage);  // [kProjStage]

  const int t = blockIdx.x, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row0 = t * kTileE;

  // the tile's [128, JD] slice of g, as in gate_scatter_bwd_kernel
  const uint4* gsrc = reinterpret_cast<const uint4*>(
      g + ((size_t)b * n_tiles * kTileE + row0) * JD);
  uint4* gdst = reinterpret_cast<uint4*>(s_g);
  for (int i = threadIdx.x; i < kTileE * JD / 4; i += kBwdThreads)
    __pipeline_memcpy_async(gdst + i, gsrc + i, 16);
  __pipeline_commit();
  const T* w = static_cast<const T*>(proj.w);
  const T* bias = static_cast<const T*>(proj.b);
  for (int i = threadIdx.x; i < DD; i += kBwdThreads) {
    const float v = to_float(w[i]);
    s_w[i] = v;
    s_wt[(i % D) * D + i / D] = v;
  }
  for (int i = threadIdx.x; i < D; i += kBwdThreads) s_b[i] = to_float(bias[i]);
  for (int c = threadIdx.x; c < JD; c += kBwdThreads)
    s_ins[c] = to_float(ins[(size_t)b * JD + c]);
  for (int c = threadIdx.x; c < nwarps * JD; c += kBwdThreads) s_dins[c] = 0.f;
  for (int e = threadIdx.x; e < DD + D; e += kBwdThreads) s_dw[e] = 0.f;

  const int32_t* cs = p.chunk_starts[0] + (size_t)b * (n_tiles + 1);
  const int f_begin = cs[t] * kTileF, f_end = cs[t + 1] * kTileF;
  const int f_last = cs[n_tiles] * kTileF;  // end of the last tile's range
  const int32_t* sc = p.scatter[0] + (size_t)b * Fp;
  const float* pr = p.prior[0] + (size_t)b * Fp;
  const T* frg = static_cast<const T*>(p.vals[0]) + (size_t)b * Fp * D;
  T* dfr = static_cast<T*>(o.dfr) + (size_t)b * Fp * D;
  float* dp = o.dprior + (size_t)b * Fp;
  float* s_dwarp = s_dins + warp * JD;

  for (int f0 = f_begin; f0 < f_end; f0 += kProjStage) {
    for (int i = threadIdx.x; i < kProjStage; i += kBwdThreads) {
      s_row[i] = sc[f0 + i] - row0;
      s_pri[i] = pr[f0 + i];          // unrounded, as the TPU backward
    }
    const uint4* src = reinterpret_cast<const uint4*>(frg + (size_t)f0 * D);
    uint4* dst = reinterpret_cast<uint4*>(s_fr);
    const int n16 = kProjStage * D * (int)sizeof(T) / 16;
    for (int i = threadIdx.x; i < n16; i += kBwdThreads)
      __pipeline_memcpy_async(dst + i, src + i, 16);
    __pipeline_commit();
    __pipeline_wait_prior(0);   // also the g tile and w, on the first stage
    __syncthreads();

    for (int i = warp; i < kProjStage; i += nwarps) {
      const int f = f0 + i;
      const int r = s_row[i];
      float* drl = s_drl + i * D;
      T* dfr_row = dfr + (size_t)f * D;
      if ((unsigned)r >= (unsigned)kTileE) {  // pad slot (scatter < 0)
        for (int k = lane; k < D; k += 32) {
          drl[k] = 0.f;
          dfr_row[k] = from_float<T>(0.f);
        }
        if (lane == 0) dp[f] = 0.f;
        continue;
      }
      const float pri = s_pri[i];
      const float* g_row = s_g + r * JD;
      const T* fr = s_fr + i * D;
      float dpri = 0.f;
      for (int k = lane; k < D; k += 32) {
        float v = 0.f;                    // rl[f, k] in float, unrounded
        for (int m = 0; m < D; ++m) v = fmaf(to_float(fr[m]), s_w[m * D + k], v);
        v += s_b[k];
        float dvk = 0.f;
        for (int j = 0; j < J; ++j) {
          const int c = j * D + k;
          const float in = s_ins[c];
          const float gb = g_row[c];
          const float pre = v * in;
          dpri += gb * (apply_relu ? fmaxf(pre, 0.f) : pre);
          const float dval = (apply_relu && !(pre > 0.f)) ? 0.f : gb * pri;
          dvk += dval * in;
          s_dwarp[c] += dval * v;
        }
        drl[k] = dvk;
      }
      for (int off = 16; off > 0; off >>= 1)
        dpri += __shfl_xor_sync(0xffffffffu, dpri, off);
      if (lane == 0) dp[f] = dpri;
      __syncwarp();
      // dfact_rel[f, m] = sum_k drl[k] * w[m, k]
      for (int m = lane; m < D; m += 32) {
        float s = 0.f;
        for (int k = 0; k < D; ++k) s = fmaf(drl[k], s_wt[k * D + m], s);
        dfr_row[m] = from_float<T>(s);
      }
    }
    __syncthreads();
    // this block's dW[m, k] += sum_i fr[i, m] * drl[i, k] and db[k] +=
    // sum_i drl[i, k], one thread per entry, slots in order
    for (int e = threadIdx.x; e < DD + D; e += kBwdThreads) {
      float s = s_dw[e];
      if (e < DD) {
        const int m = e / D, k = e - m * D;
        for (int i = 0; i < kProjStage; ++i)
          s = fmaf(to_float(s_fr[i * D + m]), s_drl[i * D + k], s);
      } else {
        for (int i = 0; i < kProjStage; ++i) s += s_drl[i * D + e - DD];
      }
      s_dw[e] = s;
    }
    __syncthreads();  // the stage's buffers are free again
  }
  // slots past the last tile's range: every block zeroes its share
  for (int f = f_last + t * nwarps + warp; f < Fp; f += n_tiles * nwarps) {
    for (int k = lane; k < D; k += 32) dfr[(size_t)f * D + k] = from_float<T>(0.f);
    if (lane == 0) dp[f] = 0.f;
  }

  __pipeline_wait_prior(0);   // a tile with no chunk never waited for g
  __syncthreads();
  const size_t blk = (size_t)b * n_tiles + t;
  for (int c = threadIdx.x; c < JD; c += kBwdThreads) {
    float s = 0.f;
    for (int wp = 0; wp < nwarps; ++wp) s += s_dins[wp * JD + c];
    o.dins_ws[blk * JD + c] = s;
  }
  for (int e = threadIdx.x; e < DD + D; e += kBwdThreads)
    o.dw_ws[blk * (DD + D) + e] = s_dw[e];
}

constexpr int kRedCols = 32, kRedRows = 8;

// dW (then db) = the sum of the n block partials ws [n, D*D+D], in a fixed
// order: kRedRows threads add a contiguous strip of rows each, then the
// strips are added in order. grid ceil((D*D+D)/kRedCols), block
// (kRedCols, kRedRows).
template <typename T>
__global__ void dw_reduce_kernel(const float* __restrict__ ws, int n, int D,
                                 T* __restrict__ dw, T* __restrict__ db) {
  __shared__ float part[kRedRows][kRedCols];
  const int DD = D * D, width = DD + D;
  const int e = blockIdx.x * kRedCols + threadIdx.x;
  const int per = (n + kRedRows - 1) / kRedRows;
  const int i0 = threadIdx.y * per, i1 = min(n, i0 + per);
  float s = 0.f;
  if (e < width)
    for (int i = i0; i < i1; ++i) s += ws[(size_t)i * width + e];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < width) {
    float sum = 0.f;
    for (int r = 0; r < kRedRows; ++r) sum += part[r][threadIdx.x];
    if (e < DD) dw[e] = from_float<T>(sum);
    else db[e - DD] = from_float<T>(sum);
  }
}

template <typename T>
int launch_fused_bwd(const DirPtrs& p, const void* ins, Proj proj,
                     const float* g, const ProjBwdOut& o, void* dins, void* dw,
                     void* db, int B, int Fp, int D, int J, int n_tiles,
                     int apply_relu, void* stream) {
  const int JD = J * D;
  const size_t smem =
      (size_t)kTileE * JD * sizeof(float) + (size_t)kProjStage * D * sizeof(T) +
      (2 * (size_t)D * D + D + JD + (kBwdThreads / 32) * JD +
       (size_t)kProjStage * D + (size_t)D * D + D + 2 * kProjStage) *
          sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  fused_bwd_kernel<T><<<dim3(n_tiles, B), kBwdThreads, smem, s>>>(
      p, static_cast<const T*>(ins), proj, g, o, Fp, D, J, n_tiles,
      apply_relu);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  dins_reduce_kernel<T><<<B, 128, 0, s>>>(o.dins_ws, static_cast<T*>(dins), 1,
                                          B, n_tiles, JD);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int width = D * D + D;
  dw_reduce_kernel<T><<<(width + kRedCols - 1) / kRedCols,
                        dim3(kRedCols, kRedRows), 0, s>>>(
      o.dw_ws, B * n_tiles, D, static_cast<T*>(dw), static_cast<T*>(db));
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
// dins_ws [B,n_tiles,J*D] and dw_ws [B*n_tiles,D*D+D] are f32 scratch.
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
