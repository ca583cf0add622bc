// Gate-scatter forward for Hopper (sm_90a), bound through a plain C interface.
//
// Replaces the TPU kernels of gnn_rag_tpu/ops/pallas_mp.py:
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

const char* gate_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
