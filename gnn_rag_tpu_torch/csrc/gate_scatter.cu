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
// Design (gate_fwd_kernel): the output rows of a 128-entity tile, [128,
// J*D] floats, are summed in shared memory by the blocks that take the
// tile's fact chunks chunk_starts[t] .. chunk_starts[t+1] (layout order;
// facts of tile t's chunks scatter only into tile t). What bounds it on an
// H100: it reads B*Fp*D*sizeof(T) bytes of fact values per direction and
// writes B*E*J*D floats; the arithmetic is one multiply and one add per
// (fact, column), far below the card's rates, so it is bound by bytes, by
// the latency of the loads that bring them and by the shared-memory
// read-modify-writes of the sum. What held the first design (one block a
// tile, J*D threads, each stage of slots copied and then waited on) back,
// and what this one does about it:
//   1. the few long tiles of a skewed subgraph ran in one block each while
//      the rest of the grid idled, so a tile's chunk range is split into up
//      to kParts parts of at least kFwdPartChunks chunks: a tile of one part
//      writes its rows directly, the parts of a longer tile write float
//      partial tiles to a workspace that tile_sum_kernel adds in part
//      order. The grid has a block for each tile's first part and a few
//      more for the other parts of a (direction, sample), which find theirs
//      by a prefix sum over the tiles (find_part): a block for every
//      (tile, possible part) left thousands of empty blocks, ~10 us of a
//      0.07 ms launch on an H100;
//   2. no copy overlapped the gate, so stages of kFwdSlots slots (values,
//      scatter, prior) stream by asynchronous copies through a ring of 2-4
//      shared-memory stages, the next stages in flight while one computes;
//   3. only J*D threads ran the gate, each a chain of dependent shared-
//      memory read-modify-writes, so ~128 threads run it in ngrp groups of
//      whole warps: thread (grp, q) adds the slots whose row falls to group
//      grp into columns 2q and 2q + 1 (one at an odd D) with 8-byte shared-
//      memory accesses; each output element's sum stays with one thread, in
//      slot order, without atomics; a warp finds its group's slots in the
//      stage by one ballot and issues four read-modify-writes at once where
//      their rows differ;
//   4. the ring is sized so that the most blocks fit an SM that fit with
//      two stages: at D 50 in float32 five at J 1, three at J 2, two at J 3.
// No float atomics, so two launches give the same bits.
//
// The backward (gate_scatter_bwd_kernel) replaces the TPU kernels
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
// What bounds the backward on an H100: per direction it reads B*E*J*D
// floats of g once and B*Fp*D values, and writes B*Fp*D values and B*Fp
// priors; about 6 flops per (fact, column). Bytes, and the latency of the
// loads that bring them: a warp that walks its slots one at a time and
// loads each slot's row, prior and values from device memory only once
// the slot's turn comes waits on two or three dependent round trips a
// slot. The design keeps every load ahead of the slot that needs it:
// facts of tile t's chunk range scatter only into tile t, so a block
// stages the tile's [128, J*D] slice of g in shared memory once
// (asynchronous 16-byte copies), and streams its slots kStage at a
// time through a ring of two or three shared-memory stages (values,
// scatter and prior by asynchronous copies), the next stages in flight
// while this one computes. Half a warp takes a slot (16 lanes, columns k
// = lane + 16 q), so a warp runs two slots side by side; dvals[f,:] needs
// no reduction across threads and dprior[f] is one shuffle reduction over
// the 16 lanes. A tile's chunk range is split over up to kParts blocks (at
// least kBwdPartChunks chunks each), so the few long tiles of a skewed
// subgraph do not set the time; each slot's dvals and dprior are written
// once, by the part that holds it. dins is a sum over all facts of the
// sample: each half-warp keeps its own partial [J*D] in shared memory, the
// block adds them in a fixed order into one partial per part in a
// workspace [ndir,B,n_tiles,kParts,J*D], and part_reduce_kernel adds those
// in a fixed order (direction, then tile, then part). No float atomics, so
// the result repeats bit for bit. Slots past the last tile's range (the
// loader pads the chunk count to the bucket) are zeroed by all blocks in a
// strided loop.
//
// The fused-projection op (one direction per call) replaces
//   _fused_kernel     (:126) v1, a grid step per chunk
//   _fused_kernel_v2  (:210) the same function, a grid cell per entity tile
//   _fused_bwd_kernel (:316) their backward, dW and db summed over the grid
// Its values are the relation features of each slot before rel_linear:
//   rl[f, k] = T(float(sum_m fact_rel[f, m] * w[m, k]) + float(b[k]))
// and the gate above runs on rl. The forward (fused_fwd_kernel) does 2*D*D
// flops per fact slot besides the gate's bytes, so at D 50 in float32 its
// operations and its bytes take about the same least time on the card; no
// [B, Fp, D] projection goes through device memory. What held its first
// version back, and what this design does about it: (1) one block a tile
// let the few long tiles of a skewed subgraph set the time, so a tile's
// chunk range is split over up to kParts blocks of at least kFfPartChunks
// chunks; a tile with one part writes its [128, J*D] rows directly, the
// parts of a longer tile write float partial tiles to a workspace that
// tile_sum_kernel adds in part order (two launches give the same
// bits); (2) the projection made 5 shared-memory loads for 4 FMAs, so it
// runs as the backward's register-tiled SIMT GEMM (D zero-padded to a
// multiple of 4, each thread a 4-slot x 4-column tile from float4 loads,
// 8 loads for 64 FMAs; the bias added in float, rl rounded to T once);
// (3) only J*D of the block's threads ran the gate loop, so every thread
// does: thread (grp, c) adds the slots whose row r has r % ngrp == grp
// into column c, which keeps each output element's sum with one thread
// and in slot order, without atomics; (4) the next stage's fact_rel rows
// are loaded into registers while this stage computes, and the two
// shared-memory stages (fact_rel in, rl out) need two barriers a stage.
//
// The backward (fused_bwd_kernel) recomputes rl in float from the widened
// inputs WITHOUT rounding it, and reads the prior unrounded, as the TPU
// backward does (pallas_mp.py:345-352), then runs the gate backward above
// with drl = sum_j dval_j * ins_j in place of dvals, and adds dfact_rel =
// drl @ w^T (cast to T) and this block's partials of dW = fact_rel^T drl and
// db = sum drl. Its 6*D*D flops per slot bound it by operations, so its
// three D x D products run as the register-tiled SIMT GEMMs above, 64 slots
// a stage, and a fixed 4 x 4 block of dW a thread summed over the stages.
// The gate backward runs on the rl tile in registers between the products.
// A tile's chunk range is split over up to kParts blocks (at least
// kFbPartChunks chunks each); every part writes its dins and dW/db partials
// to a workspace that part_reduce_kernel adds in a fixed order, so there
// are no float atomics and two launches give the same bits.
//
// The scatter-only op (the kScatter instance of gate_fwd_kernel) replaces
// _scatter_kernel (:32, scatter_mm):
//   out[b, scatter[f], c] += float(values[f, c])
// for any width C that fits, with the tile ranges found from chunk_tiles. It
// reads B*Fp*C values and writes B*E*C floats with one add each: bound by
// bytes.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kTileE = 128;
constexpr int kTileF = 128;
constexpr int kStage = 64;   // fact slots a stage of the backward and fused kernels

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

// What gate_fwd_kernel adds per staged value: the gate of the serving and
// training path, or the value alone (scatter_mm). Compile-time instances,
// so the gate path's loop has no branch of the other.
enum FwdMode { kGate = 0, kScatter = 2 };

// ----------------------------------------------- split tiles, shared parts
constexpr int kBwdThreads = 256;  // threads of the backward and fused kernels
constexpr int kParts = 8;         // blocks a tile at most

// A tile with n chunks runs in min(kParts, ceil(n / min_chunks)) parts
// (none when it has no chunk); the others of its kParts blocks are empty.
// Part q takes chunks c0 + q n / parts .. c0 + (q + 1) n / parts.
__host__ __device__ __forceinline__ int split_parts(int n, int min_chunks) {
  const int parts = (n + min_chunks - 1) / min_chunks;
  return parts < kParts ? parts : kParts;
}

// Occupancy rule of the split-tile kernels: a ring of three stages where
// two blocks of that size still fit an SM, else two.
int ring_stages(size_t fixed_bytes, size_t stage_bytes) {
  const size_t sm = 228 * 1024, reserved = 1024;
  return 2 * (fixed_bytes + 3 * stage_bytes + reserved) <= sm ? 3 : 2;
}

// ------------------------------------------------------- column windows
// Every kernel below takes a window of D's columns, [c0, c0 + wc), across
// all J instructions: window win of width W (wc = W but for the last one,
// which takes the remainder) holds columns c0 = win * W .. The gate and its
// backward are elementwise in the column, so a block that keeps only its
// window's [128, J*wc] tile (and stages [slots, W] values) computes its
// columns of every output whole; what sums over all columns (dprior, and
// the fused backward's dfact_rel) each window writes as a float partial,
// added in window order by window_sum_kernel. One launch covers every
// window as one more grid dimension, folded into the (direction, sample)
// one. Each kernel is compiled twice, on kWin: the instance for one window
// (W = D) folds the window arithmetic away and is the kernel of a whole
// tile width, so today's widths run the code (and registers) they did.

// The most dynamic shared memory a block may take on the current device
// (227 KB on an H100), which the window fit entries and launches hold to.
int max_block_smem() {
  int dev = 0, bytes = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return bytes;
}

// The widest window W in [1, D] whose block takes at most max_block_smem()
// bytes (``floats(W)`` floats), or 0 if none does; floats grows with W.
template <typename F>
int widest_window(int D, F floats) {
  const size_t limit = (size_t)max_block_smem();
  auto fits = [&](int W) { return (size_t)floats(W) * sizeof(float) <= limit; };
  if (D < 1 || !fits(1)) return 0;
  int lo = 1, hi = D;   // fits(lo)
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (fits(mid)) lo = mid;
    else hi = mid - 1;
  }
  return lo;
}

// Bytes of one copy of a window's rows: the largest of 16, 8, 4, 2 that
// divides the row stride D and the window width W in bytes (so every
// window's start and every row of it), for elements of `elem` bytes.
__host__ __device__ __forceinline__ int piece_bytes(int D, int W, int elem) {
  const int x = (D * elem) | (W * elem) | 16;
  return x & -x;
}

// A window's column c of a j-major [J, wc] row, as a column of the j-major
// [J, D] row of the whole width: j D + c0 + k for c = j wc + k.
__device__ __forceinline__ int full_col(int c, int wc, int D, int c0) {
  return c + (c / wc) * (D - wc) + c0;
}

// A window's [kTileE, J*wc] float tile into the rows of dst (row stride
// J*D): column c of row r at full_col(c). One window (wc = D): one
// contiguous block in 16-byte stores.
template <bool kWin>
__device__ __forceinline__ void store_tile(float* dst, const float* tile,
                                           int JD, int JW, int wc, int D,
                                           int c0, int tid, int nthr) {
  if (!kWin) {
    float4* d4 = reinterpret_cast<float4*>(dst);
    const float4* t4 = reinterpret_cast<const float4*>(tile);
    for (int i = tid; i < kTileE * JD / 4; i += nthr) d4[i] = t4[i];
  } else {
    for (int i = tid; i < kTileE * JW; i += nthr) {
      const int r = i / JW, c = i - r * JW;
      dst[(size_t)r * JD + full_col(c, wc, D, c0)] = tile[i];
    }
  }
}

// n_rows rows of wc T values, row r from src + r ld into dst + r ldd (in
// T elements), by the block's threads in pieces of g bytes: asynchronous
// 16-, 8- or 4-byte copies (the caller commits them), or plain 2-byte
// loads and stores (g = 2: bfloat16 at an odd width). src and dst
// aligned to g.
template <typename T>
__device__ __forceinline__ void copy_rows(T* dst, int ldd, const T* src,
                                          size_t ld, int n_rows, int wc, int g,
                                          int tid, int nthr) {
  const int per = wc * (int)sizeof(T) / g;   // pieces a row
  char* d = reinterpret_cast<char*>(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (int i = tid; i < n_rows * per; i += nthr) {
    const int r = i / per, q = i - r * per;
    char* to = d + (size_t)r * ldd * sizeof(T) + q * g;
    const char* from = s + r * ld * sizeof(T) + q * g;
    switch (g) {
      case 16: __pipeline_memcpy_async(to, from, 16); break;
      case 8: __pipeline_memcpy_async(to, from, 8); break;
      case 4: __pipeline_memcpy_async(to, from, 4); break;
      default:
        *reinterpret_cast<uint16_t*>(to) = *reinterpret_cast<const uint16_t*>(from);
    }
  }
}

// out[e] = T(ws[e] + ws[n + e] + ... + ws[(nwin - 1) n + e]): the windows'
// float partials of a sum over all columns, added in window order.
constexpr int kWinSumThreads = 256;
template <typename T>
__global__ void window_sum_kernel(const float* __restrict__ ws, int nwin,
                                  size_t n, T* __restrict__ out) {
  for (size_t e = (size_t)blockIdx.x * kWinSumThreads + threadIdx.x; e < n;
       e += (size_t)gridDim.x * kWinSumThreads) {
    float s = ws[e];
    for (int w = 1; w < nwin; ++w) s += ws[(size_t)w * n + e];
    out[e] = from_float<T>(s);
  }
}

template <typename T>
cudaError_t launch_window_sum(const float* ws, int nwin, size_t n, T* out,
                              cudaStream_t s) {
  const size_t blocks = (n + kWinSumThreads - 1) / kWinSumThreads;
  window_sum_kernel<T><<<(unsigned)(blocks < 4096 ? blocks : 4096),
                         kWinSumThreads, 0, s>>>(ws, nwin, n, out);
  return cudaGetLastError();
}

// out = the sum of the non-empty parts' partials in ws [ndir, sets *
// n_groups, kParts, width] (a split-tile kernel's workspace), in a fixed
// order, for each of the grid's sets: set s adds, for each direction d in
// turn, groups s*n_groups .. (s+1)*n_groups - 1, a group being a (sample,
// tile) whose part count comes from direction d's chunk_starts. kRedRows
// threads add a contiguous strip of the (direction, group) pairs each (all
// of a group's parts loaded before they are added in order), then the
// strips are added in order. Entry e < split goes to out_a[s*split + e],
// the rest to out_b[e - split].
// grid (ceil(width / kRedCols), sets), block (kRedCols, kRedRows).
constexpr int kRedCols = 32, kRedRows = 32;

template <typename T>
__global__ void part_reduce_kernel(const float* __restrict__ ws,
                                   const int32_t* __restrict__ cs0,
                                   const int32_t* __restrict__ cs1, int ndir,
                                   int min_chunks, int n_tiles, int n_groups,
                                   int width, int split, T* __restrict__ out_a,
                                   T* __restrict__ out_b) {
  __shared__ float strip[kRedRows][kRedCols];
  const int e = blockIdx.x * kRedCols + threadIdx.x, set = blockIdx.y;
  const int n = ndir * n_groups, total = gridDim.y * n_groups;
  const int per = (n + kRedRows - 1) / kRedRows;
  const int u0 = threadIdx.y * per, u1 = min(n, u0 + per);
  float s = 0.f;
  if (e < width) {
    for (int u = u0; u < u1; ++u) {
      const int d = u / n_groups;
      const int gi = set * n_groups + u - d * n_groups;
      const int bb = gi / n_tiles, t = gi - bb * n_tiles;
      const int32_t* cs = (d ? cs1 : cs0) + (size_t)bb * (n_tiles + 1);
      const int parts = split_parts(cs[t + 1] - cs[t], min_chunks);
      const float* src =
          ws + ((size_t)d * total + gi) * kParts * width + e;
      float v[kParts];
#pragma unroll
      for (int q = 0; q < kParts; ++q)
        v[q] = q < parts ? src[(size_t)q * width] : 0.f;
#pragma unroll
      for (int q = 0; q < kParts; ++q)
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

// --------------------------- gate-scatter forward (K1/K3f/K4f) and K6d
constexpr int kFwdSlots = 32;       // fact slots a stage: lane l reads slot l
constexpr int kFwdMaxStages = 4;    // ring stages at most
constexpr int kFwdPartChunks = 4;   // least chunks a part takes
constexpr int kFwdMaxThreads = 512;
constexpr int kSumThreads = 256;    // tile_sum_kernel

// A forward tile with n chunks runs in clamp(n / min_chunks, 1, kParts)
// parts, each of at least min_chunks chunks (a tile with none still writes
// its zero rows). Part begins are then at least min_chunks chunks apart in
// a sample, so chunk c0 / min_chunks, c0 the first chunk of a part of a
// split tile, names its partial tile in the workspace uniquely.
__host__ __device__ __forceinline__ int fwd_parts(int n, int min_chunks) {
  const int parts = n / min_chunks;
  return parts < 1 ? 1 : parts < kParts ? parts : kParts;
}
// partial tiles a (direction, sample) of a forward's workspace holds
__host__ __device__ __forceinline__ int fwd_slots(int Fp, int min_chunks) {
  return (Fp / kTileF + min_chunks - 1) / min_chunks;
}
// A sample's parts beyond the first of each tile number at most
// sum_t (floor(n_t / min_chunks) - 1) over its split tiles, so at most
// floor(nc / min_chunks) - 1 for nc chunks.
__host__ __device__ __forceinline__ int fwd_extra_parts(int Fp, int min_chunks) {
  const int extra = Fp / kTileF / min_chunks - 1;
  return extra > 0 ? extra : 0;
}

// One sample's chunk_starts [n_tiles + 1] from its chunk_tiles row [nc]
// (non-decreasing; padding chunks past the last range repeat the last
// tile) into s_cs: tiles ct[c-1] + 1 .. ct[c] start at chunk c. The whole
// block calls it.
__device__ __forceinline__ void starts_of_tiles(const int32_t* ct, int nc,
                                                int n_tiles, int32_t* s_cs) {
  for (int c = threadIdx.x; c <= nc; c += blockDim.x) {
    const int lo = c > 0 ? ct[c - 1] : -1;
    const int hi = c < nc ? min(ct[c], n_tiles) : n_tiles;
    for (int t = lo + 1; t <= hi; ++t) s_cs[t] = c;
  }
  __syncthreads();
}

// Tile t and part of block x of a (direction, sample)'s row of the grid,
// from the sample's chunk_starts cs: block x < n_tiles takes part 0 of tile
// x; block n_tiles + e the e-th extra part of the row (the parts of split
// tiles after their first, in tile order), found by every warp from prefix
// sums of the tiles' extra parts 32 tiles at a time; t = -1 past the last.
__device__ __forceinline__ void find_part(const int32_t* cs, int n_tiles,
                                          int min_chunks, int x, int& t,
                                          int& part) {
  t = x;
  part = 0;
  if (x < n_tiles) return;
  const int e = x - n_tiles, lane = threadIdx.x & 31;
  int before = 0;   // extra parts of the tiles before this batch of 32
  for (int t0 = 0; t0 < n_tiles; t0 += 32) {
    const int tt = t0 + lane;
    const int ex =
        tt < n_tiles ? fwd_parts(cs[tt + 1] - cs[tt], min_chunks) - 1 : 0;
    int incl = ex;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    const unsigned hit = __ballot_sync(0xffffffffu, before + incl > e);
    if (hit) {
      const int l = __ffs(hit) - 1;
      t = t0 + l;
      part = e - before - __shfl_sync(0xffffffffu, incl - ex, l) + 1;
      return;
    }
    before += __shfl_sync(0xffffffffu, incl, 31);
  }
  t = -1;
}

// kVec consecutive values at p, kVec * sizeof(T) aligned (a stage's values
// and the float accumulator in shared memory)
template <int kVec, typename T>
__device__ __forceinline__ void load_vec(const T* p, T (&x)[kVec]) {
  if constexpr (kVec == 1) {
    x[0] = p[0];
  } else if constexpr (sizeof(T) == 4) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x;
    x[1] = v.y;
  } else {
    const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(p);
    x[0] = v.x;
    x[1] = v.y;
  }
}
template <int kVec>
__device__ __forceinline__ void store_vec(float* p, const float (&x)[kVec]) {
  if constexpr (kVec == 1) {
    p[0] = x[0];
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
}

// Shared-memory layout of gate_fwd_kernel for a window of W columns,
// offsets in floats: the output tile [kTileE, J*W], then a ring of
// `stages` stages of kFwdSlots slots: [kFwdSlots, W] values (16-byte
// aligned), scatter, prior.
struct GfLayout {
  int ring, vals, stage, total;
  __host__ __device__ GfLayout(int W, int J, int elem, int stages) {
    ring = kTileE * J * W;             // a multiple of 4
    vals = kFwdSlots * W * elem / 4;   // a multiple of 4
    stage = vals + 2 * kFwdSlots;
    total = ring + stages * stage;
  }
};

// A launch of gate_fwd_kernel: threads a block; ngrp gate groups of
// gthreads threads each (whole warps), a thread taking vec adjacent columns
// (vec 2 where D and the window are even), or one group of the whole block
// whose threads loop over the columns when J*W is wider; ring stages; least
// chunks a part; the window width W.
struct FwdPlan {
  int threads, ngrp, gthreads, vec, stages, min_chunks, W;
};

// out [ndir,B,n_tiles*128,J*D] f32; ws [ndir,B,fwd_slots(Fp),128*J*D] f32,
// the partial tiles of split tiles. grid (n_tiles + fwd_extra_parts,
// ndir*B*nwin), plan.threads (whole warps, at least 64). Block (x, (d*B +
// b)*nwin + win) takes window win of part `part` of tile t (find_part) of
// direction d, sample b, and walks it kFwdSlots slots a stage: one barrier
// a stage (the stage landed for every thread, and the ring slot of the
// stage before is free), the copies of the stage stages - 1 ahead issued,
// then each warp's ballot and the gate of its threads' columns. A window
// writes its columns of the tile's rows (or of its part's partial tile).
// kScatter: J = 1, D is the width C, ins and prior are not read, and
// p.chunk_starts holds chunk_tiles [B, Fp/128].
template <typename T, int kMode, int kVec, bool kWin>
__global__ void __launch_bounds__(kFwdMaxThreads, 2)
    gate_fwd_kernel(DirPtrs p, const T* __restrict__ ins,
                    float* __restrict__ out, float* __restrict__ ws, int B,
                    int Fp, int D, int J, int n_tiles, int apply_relu,
                    FwdPlan plan) {
  extern __shared__ __align__(16) float smem[];
  const int JD = J * D, nc = Fp / kTileF, W = kWin ? plan.W : D;
  const int nwin = kWin ? (D + W - 1) / W : 1, y = blockIdx.y / nwin;
  const int c0 = kWin ? (blockIdx.y - y * nwin) * W : 0;
  const int wc = kWin ? min(W, D - c0) : D;
  const int JW = J * wc;   // the window's columns, j-major
  const int d = y / B, b = y - d * B;
  const int tid = threadIdx.x, nthr = blockDim.x;
  // select, not p.x[d]: indexing a parameter array with a runtime index
  // copies the array to local memory first
  const int32_t* cs = (d ? p.chunk_starts[1] : p.chunk_starts[0]) +
                      (size_t)b * (kMode == kScatter ? nc : n_tiles + 1);
  if constexpr (kMode == kScatter) {
    int32_t* s_cs = reinterpret_cast<int32_t*>(smem);
    starts_of_tiles(cs, nc, n_tiles, s_cs);
    cs = s_cs;
  }
  int t, part;
  find_part(cs, n_tiles, plan.min_chunks, blockIdx.x, t, part);
  if (t < 0) return;   // past the row's last extra part
  const int ch0 = cs[t], nch = cs[t + 1] - ch0;
  const int parts = fwd_parts(nch, plan.min_chunks);
  if constexpr (kMode == kScatter) __syncthreads();   // s_cs is read
  const int cb = ch0 + part * nch / parts, ce = ch0 + (part + 1) * nch / parts;
  const int f_begin = cb * kTileF;
  const int n_stages = (ce - cb) * (kTileF / kFwdSlots);
  const int row0 = t * kTileE;
  const size_t db = (size_t)d * B + b;
  const int32_t* sc = (d ? p.scatter[1] : p.scatter[0]) + (size_t)b * Fp;
  const float* pr = (d ? p.prior[1] : p.prior[0]) + (size_t)b * Fp;
  const T* vl = static_cast<const T*>(d ? p.vals[1] : p.vals[0]) +
                (size_t)b * Fp * D;
  const GfLayout lay(W, J, (int)sizeof(T), plan.stages);
  float* acc = smem;   // [kTileE, JW]
  float4* acc4 = reinterpret_cast<float4*>(acc);

  // thread (grp, q) of the gate takes columns c = kVec q .. kVec q + kVec - 1
  // (and c + kVec gthreads, ... in a group of the whole block); a warp's
  // threads are in one group
  const int ngrp = plan.ngrp, lane = tid & 31;
  const int grp = tid / plan.gthreads;
  const int col = kVec * (tid - grp * plan.gthreads);
  const bool active = grp < ngrp && col < JW;
  const T* ins_b = ins + (size_t)b * JD;
  T ins_col[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    ins_col[v] = from_float<T>(0.f);
    if constexpr (kMode != kScatter) {
      if (active) ins_col[v] = ins_b[full_col(col, wc, D, c0) + v];
    }
  }

  // stage st of the walk into ring slot st % stages: [kFwdSlots, W] values
  // (at one window, one contiguous, 16-byte aligned block in 16-byte
  // copies; else the window's piece of each row, piece_bytes at a time),
  // scatter and prior in 4-byte copies; one commit group a stage, empty
  // past the range
  const int n16 = kFwdSlots * D * (int)sizeof(T) / 16;
  const int g = piece_bytes(D, W, (int)sizeof(T));
  auto issue = [&](int st) {
    if (st < n_stages) {
      const int f0 = f_begin + st * kFwdSlots;
      float* buf = smem + lay.ring + (st % plan.stages) * lay.stage;
      if (!kWin) {
        const uint4* src = reinterpret_cast<const uint4*>(vl + (size_t)f0 * D);
        uint4* dst = reinterpret_cast<uint4*>(buf);
        for (int i = tid; i < n16; i += nthr)
          __pipeline_memcpy_async(dst + i, src + i, 16);
      } else {
        copy_rows(reinterpret_cast<T*>(buf), W, vl + (size_t)f0 * D + c0, D,
                  kFwdSlots, wc, g, tid, nthr);
      }
      if (tid < kFwdSlots)
        __pipeline_memcpy_async(buf + lay.vals + tid, sc + f0 + tid, 4);
      else if (kMode != kScatter && tid < 2 * kFwdSlots)
        __pipeline_memcpy_async(buf + lay.vals + tid,
                                pr + f0 + tid - kFwdSlots, 4);
    }
    __pipeline_commit();
  };
  for (int st = 0; st < plan.stages - 1; ++st) issue(st);
  // the tile zeroed while the first stages land
  for (int i = tid; i < kTileE * JW / 4; i += nthr)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int st = 0; st < n_stages; ++st) {
    __pipeline_wait_prior(plan.stages - 2);
    __syncthreads();
    issue(st + plan.stages - 1);
    const float* buf = smem + lay.ring + (st % plan.stages) * lay.stage;
    const T* s_val = reinterpret_cast<const T*>(buf);
    const int32_t* s_sc = reinterpret_cast<const int32_t*>(buf + lay.vals);
    const float* s_pr = buf + lay.vals + kFwdSlots;
    // slot l's gate group (rows r with r * ngrp / 128 == grp; -1: a pad
    // slot), and the slots of this warp's group in the stage, by a ballot
    const int r_l = s_sc[lane] - row0;
    const int o_l = (unsigned)r_l < (unsigned)kTileE ? (r_l * ngrp) >> 7 : -1;
    const unsigned mine = __ballot_sync(0xffffffffu, o_l == grp);
    if (!active) continue;
    for (int c = col; c < JW; c += kVec * plan.gthreads) {
      const int k = c % wc;   // c .. c + kVec - 1 share j (wc % kVec == 0)
      T in_c[kVec];
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        in_c[v] = ins_col[v];
        if constexpr (kMode != kScatter) {
          if (c != col) in_c[v] = ins_b[full_col(c, wc, D, c0) + v];
        }
      }
      float* acc_c = acc + c;
      unsigned m = mine;
      // the group's next slot, in slot order: acc_c[at + v] += x[v] * w
      auto term = [&](int& at, float (&x)[kVec], float& w) {
        const int i = __ffs(m) - 1;
        m &= m - 1;
        at = (s_sc[i] - row0) * JW;
        T val[kVec];
        load_vec<kVec>(s_val + i * W + k, val);
        if constexpr (kMode == kScatter) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) x[v] = to_float(val[v]);
          w = 1.f;
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            x[v] = to_float(mul(val[v], in_c[v]));
            if (apply_relu) x[v] = fmaxf(x[v], 0.f);
          }
          // the prior rounded to the input type, as the TPU kernel's
          // one-hot operand
          w = to_float(from_float<T>(s_pr[i]));
        }
      };
      auto add = [&](int at, const float (&x)[kVec], float w) {
        float a[kVec];
        load_vec<kVec>(acc_c + at, a);
#pragma unroll
        for (int v = 0; v < kVec; ++v) a[v] = fmaf(x[v], w, a[v]);
        store_vec<kVec>(acc_c + at, a);
      };
      int n = __popc(m);
      // four slots a round: their read-modify-writes at once where their
      // rows differ (the sums are independent), else in slot order
      for (; n >= 4; n -= 4) {
        int at[4];
        float x[4][kVec], w[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) term(at[u], x[u], w[u]);
        if (at[0] != at[1] && at[0] != at[2] && at[0] != at[3] &&
            at[1] != at[2] && at[1] != at[3] && at[2] != at[3]) {
          float a[4][kVec];
#pragma unroll
          for (int u = 0; u < 4; ++u) load_vec<kVec>(acc_c + at[u], a[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
#pragma unroll
            for (int v = 0; v < kVec; ++v) a[u][v] = fmaf(x[u][v], w[u], a[u][v]);
            store_vec<kVec>(acc_c + at[u], a[u]);
          }
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u) add(at[u], x[u], w[u]);
        }
      }
      for (; n > 0; --n) {
        int at;
        float x[kVec], w;
        term(at, x, w);
        add(at, x, w);
      }
    }
  }
  __syncthreads();
  // one part: the tile's rows; more: this part's partial tile
  float* dst = parts == 1
      ? out + (db * n_tiles * kTileE + row0) * JD
      : ws + (db * fwd_slots(Fp, plan.min_chunks) + cb / plan.min_chunks) *
                kTileE * JD;
  store_tile<kWin>(dst, acc, JD, JW, wc, D, c0, tid, nthr);
}

// The split tiles of a forward (gate_fwd_kernel, fused_fwd_kernel): out's
// rows of tile t = the sum of its parts' partial tiles in part order. ws
// [ndir*B, fwd_slots(Fp, min_chunks), n4] and out [ndir*B, n_tiles, n4] in
// float4s, n4 = 128*J*D/4; the tile ranges of direction d from cs_d, its
// chunk_starts [B, n_tiles+1] or (by_tiles) chunk_tiles [B, Fp/128], then
// turned into chunk_starts in (n_tiles + 1) ints of dynamic shared memory.
// grid (n_tiles, ndir*B), kSumThreads.
__global__ void tile_sum_kernel(const float* __restrict__ ws,
                                const int32_t* __restrict__ cs0,
                                const int32_t* __restrict__ cs1, int by_tiles,
                                float* __restrict__ out, int B, int Fp,
                                int n_tiles, int min_chunks, int n4) {
  extern __shared__ int32_t s_starts[];
  const int t = blockIdx.x, db = blockIdx.y;
  const int d = db / B, b = db - d * B, nc = Fp / kTileF;
  const int32_t* cs = (d ? cs1 : cs0) +
                      (size_t)b * (by_tiles ? nc : n_tiles + 1);
  if (by_tiles) {
    starts_of_tiles(cs, nc, n_tiles, s_starts);
    cs = s_starts;
  }
  const int c0 = cs[t], nch = cs[t + 1] - c0;
  const int parts = fwd_parts(nch, min_chunks);
  if (parts < 2) return;   // the tile's rows were written directly
  const float4* ws4 = reinterpret_cast<const float4*>(ws) +
                      (size_t)db * fwd_slots(Fp, min_chunks) * n4;
  float4* o4 = reinterpret_cast<float4*>(out) + ((size_t)db * n_tiles + t) * n4;
  for (int e = threadIdx.x; e < n4; e += kSumThreads) {
    float4 v[kParts];
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      v[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q < parts)
        v[q] = ws4[(size_t)((c0 + q * nch / parts) / min_chunks) * n4 + e];
    }
    float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      if (q < parts) {
        s.x += v[q].x; s.y += v[q].y; s.z += v[q].z; s.w += v[q].w;
      }
    }
    o4[e] = s;
  }
}

// The launch rule of gate_fwd_kernel at window width W: two columns a
// thread where D and W are even; groups of ceil(J*W / vec) threads rounded
// up to a warp, about kFwdGroupThreads threads in at least two groups
// (fewer warps a block left the SM short of work: measured), at most
// kFwdMaxThreads; one group of kFwdMaxThreads looping over the columns
// where J*W is wider; the most ring stages, up to kFwdMaxStages, that keep
// as many blocks an SM as a ring of two does.
constexpr int kFwdGroupThreads = 128;
FwdPlan fwd_plan(int D, int W, int J, int elem) {
  const int vec = D % 2 == 0 && W % 2 == 0 ? 2 : 1;
  int gthreads = ((J * W + vec - 1) / vec + 31) / 32 * 32;
  int ngrp = kFwdGroupThreads / gthreads > 2 ? kFwdGroupThreads / gthreads : 2;
  if (ngrp * gthreads > kFwdMaxThreads) ngrp = kFwdMaxThreads / gthreads;
  if (ngrp < 1) {
    ngrp = 1;
    gthreads = kFwdMaxThreads;
  }
  const int threads = ngrp * gthreads;
  auto per_sm = [&](int stages) {
    const size_t block = (size_t)GfLayout(W, J, elem, stages).total * 4 + 1024;
    const int by_smem = (int)((size_t)228 * 1024 / block);
    const int by_threads = 2048 / threads;
    return by_smem < by_threads ? by_smem : by_threads;
  };
  int stages = 2;
  while (stages < kFwdMaxStages && per_sm(stages + 1) >= per_sm(2)) ++stages;
  return FwdPlan{threads, ngrp, gthreads, vec, stages, kFwdPartChunks, W};
}

// The widest window of gate_fwd_kernel (a ring of two stages) that fits a
// block, or 0.
int fwd_window(int D, int J, int elem) {
  return widest_window(D, [&](int W) { return GfLayout(W, J, elem, 2).total; });
}

// gate_fwd_kernel, then tile_sum_kernel for the split tiles; ws as there.
template <typename T, int kMode, int kVec, bool kWin>
int launch_gate_fwd_vec(const DirPtrs& p, const void* ins, void* out, void* ws,
                        int ndir, int B, int Fp, int D, int J, int n_tiles,
                        int apply_relu, const FwdPlan& plan, void* stream) {
  // kScatter first turns chunk_tiles into n_tiles + 1 chunk starts in the
  // same shared memory
  size_t smem = (size_t)GfLayout(plan.W, J, (int)sizeof(T), plan.stages).total;
  if (kMode == kScatter && smem < (size_t)n_tiles + 1) smem = n_tiles + 1;
  smem *= sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      gate_fwd_kernel<T, kMode, kVec, kWin>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch check reports it
    return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  const int nwin = (D + plan.W - 1) / plan.W;
  const dim3 grid(n_tiles + fwd_extra_parts(Fp, plan.min_chunks),
                  ndir * B * nwin);
  gate_fwd_kernel<T, kMode, kVec, kWin><<<grid, plan.threads, smem, s>>>(
      p, static_cast<const T*>(ins), o, w, B, Fp, D, J, n_tiles, apply_relu,
      plan);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const bool by_tiles = kMode == kScatter;
  tile_sum_kernel<<<dim3(n_tiles, ndir * B), kSumThreads,
                    by_tiles ? (n_tiles + 1) * sizeof(int32_t) : 0, s>>>(
      w, p.chunk_starts[0], p.chunk_starts[1], by_tiles, o, B, Fp, n_tiles,
      plan.min_chunks, kTileE * J * D / 4);
  return (int)cudaGetLastError();
}

template <typename T, int kMode, bool kWin>
int launch_gate_fwd_win(const DirPtrs& p, const void* ins, void* out, void* ws,
                        int ndir, int B, int Fp, int D, int J, int n_tiles,
                        int apply_relu, const FwdPlan& plan, void* stream) {
  return plan.vec == 2
      ? launch_gate_fwd_vec<T, kMode, 2, kWin>(p, ins, out, ws, ndir, B, Fp, D,
                                               J, n_tiles, apply_relu, plan,
                                               stream)
      : launch_gate_fwd_vec<T, kMode, 1, kWin>(p, ins, out, ws, ndir, B, Fp, D,
                                               J, n_tiles, apply_relu, plan,
                                               stream);
}

template <typename T, int kMode>
int launch_gate_fwd(const DirPtrs& p, const void* ins, void* out, void* ws,
                    int ndir, int B, int Fp, int D, int J, int n_tiles,
                    int apply_relu, const FwdPlan& plan, void* stream) {
  return plan.W < D
      ? launch_gate_fwd_win<T, kMode, true>(p, ins, out, ws, ndir, B, Fp, D, J,
                                            n_tiles, apply_relu, plan, stream)
      : launch_gate_fwd_win<T, kMode, false>(p, ins, out, ws, ndir, B, Fp, D,
                                             J, n_tiles, apply_relu, plan,
                                             stream);
}

// ------------------------------------------------- gate-scatter backward
constexpr int kBwdPartChunks = 2;   // least chunks a part takes
constexpr int kHalves = kBwdThreads / 16;  // half-warps, one slot each

// Backward outputs. dvals [ndir,B,Fp,D] T and dprior [ndir,B,Fp] f32 are
// stacked on the direction; dprior and dins_ws may be null (not needed).
struct BwdOut {
  void* dvals;
  float* dprior;
  float* dins_ws;  // [ndir,B,n_tiles,kParts,J*D] per-part partials of dins
};

// Shared-memory layout of gate_scatter_bwd_kernel for a window of W
// columns, offsets in floats: the tile's cotangent, ins, the half-warps'
// dins partials, then a ring of stages of [kStage, W] values (16-byte
// aligned), scatter and prior.
struct BwdLayout {
  int g, ins, dins, ring, vals, stage, total;
  __host__ __device__ BwdLayout(int W, int J, int elem, int stages) {
    g = 0;                                    // [kTileE, J*W]
    ins = g + kTileE * J * W;                 // [J*W]
    dins = ins + J * W;                       // [kHalves, J*W]
    ring = (dins + kHalves * J * W + 3) & ~3;
    vals = kStage * W * elem / 4;          // a multiple of 4 floats
    stage = vals + 2 * kStage;             // + scatter, prior
    total = ring + stages * stage;
  }
};

// g [ndir,B,n_tiles*128,J*D] f32; grid (n_tiles, kParts, ndir*B*nwin),
// kBwdThreads. Block (t, part, (d*B + b)*nwin + win) takes window win (W
// columns a window) of part `part` of tile t's chunk range of direction d,
// sample b. kJ = J (at most kRegJ, with W <= 64): each lane keeps ins and
// its half-warp's dins partial for its columns k = lane + 16 q (q < 4) in
// registers; kJ = 0 (any J and W): both in shared memory. The two add in
// the same order. A window writes its columns of dvals and of its part's
// dins partial whole; dprior, a sum over all columns, goes to o.dprior's
// plane of the window ([nwin, ndir, B, Fp]: one plane at one window).
constexpr int kRegJ = 3;
template <typename T, int kJ, bool kWin>
__global__ void __launch_bounds__(kBwdThreads, 2)
    gate_scatter_bwd_kernel(DirPtrs p, const T* __restrict__ ins,
                            const float* __restrict__ g, BwdOut o, int B,
                            int Fp, int D, int J, int n_tiles, int apply_relu,
                            int stages, int W_) {
  extern __shared__ __align__(16) float smem[];
  const int JD = J * D, W = kWin ? W_ : D;
  const int nwin = kWin ? (D + W - 1) / W : 1, z = blockIdx.z / nwin;
  const int win = kWin ? blockIdx.z - z * nwin : 0, c0 = win * W;
  const int wc = kWin ? min(W, D - c0) : D;
  const int JW = J * wc;   // the window's columns, j-major
  const int t = blockIdx.x, part = blockIdx.y;
  const int d = z / B, b = z - d * B;
  const int tid = threadIdx.x;
  const bool need_dins = o.dins_ws != nullptr;
  const size_t db = (size_t)d * B + b;
  const int32_t* cs = (d ? p.chunk_starts[1] : p.chunk_starts[0]) +
                      (size_t)b * (n_tiles + 1);
  const int32_t* sc = (d ? p.scatter[1] : p.scatter[0]) + (size_t)b * Fp;
  const float* pr = (d ? p.prior[1] : p.prior[0]) + (size_t)b * Fp;
  const T* vl = static_cast<const T*>(d ? p.vals[1] : p.vals[0]) +
                (size_t)b * Fp * D;
  T* dv = static_cast<T*>(o.dvals) + db * Fp * D;
  float* dp = o.dprior ? o.dprior + ((size_t)win * (gridDim.z / nwin) + db) * Fp
                       : nullptr;   // at one window: o.dprior + db * Fp

  // slots past the last tile's range: every block of (d, b, win) zeroes its
  // share
  {
    const int nwarps = kBwdThreads / 32, lane = tid & 31, warp = tid >> 5;
    const int f_last = cs[n_tiles] * kTileF;
    const int step = n_tiles * kParts * nwarps;
    for (int f = f_last + (t * kParts + part) * nwarps + warp; f < Fp;
         f += step) {
      for (int k = c0 + lane; k < c0 + wc; k += 32)
        dv[(size_t)f * D + k] = from_float<T>(0.f);
      if (dp && lane == 0) dp[f] = 0.f;
    }
  }
  const int ch0 = cs[t], nch = cs[t + 1] - ch0;
  const int parts = split_parts(nch, kBwdPartChunks);
  if (part >= parts) return;   // an empty part writes no partial
  const int f_begin = (ch0 + part * nch / parts) * kTileF;
  const int f_end = (ch0 + (part + 1) * nch / parts) * kTileF;
  const int row0 = t * kTileE;

  const BwdLayout lay(W, J, (int)sizeof(T), stages);
  float* s_g = smem + lay.g;
  float* s_ins = smem + lay.ins;
  float* s_dins = smem + lay.dins;

  // the tile's [128, JW] slice of g: at one window one contiguous, 16-byte
  // aligned block (128 * JD floats is a multiple of 4); else the window's
  // piece of each (row, instruction), the row of instruction j of entity r
  // being row r J + j of a [128 J, D] array
  const float* gt = g + (db * n_tiles * kTileE + row0) * JD;
  if (!kWin) {
    const uint4* gsrc = reinterpret_cast<const uint4*>(gt);
    uint4* gdst = reinterpret_cast<uint4*>(s_g);
    for (int i = tid; i < kTileE * JD / 4; i += kBwdThreads)
      __pipeline_memcpy_async(gdst + i, gsrc + i, 16);
  } else {
    copy_rows(s_g, wc, gt + c0, D, kTileE * J, wc, piece_bytes(D, W, 4), tid,
              kBwdThreads);
  }
  __pipeline_commit();
  const int half = tid >> 4, l = tid & 15;
  constexpr int kRJ = kJ > 0 ? kJ : 1;
  float in_r[kRJ][4], dins_r[kRJ][4];
  if constexpr (kJ > 0) {
#pragma unroll
    for (int j = 0; j < kJ; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int k = l + 16 * q;
        in_r[j][q] =
            k < wc ? to_float(ins[(size_t)b * JD + j * D + c0 + k]) : 0.f;
        dins_r[j][q] = 0.f;
      }
  } else {
    for (int c = tid; c < JW; c += kBwdThreads)
      s_ins[c] = to_float(ins[(size_t)b * JD + full_col(c, wc, D, c0)]);
    if (need_dins)
      for (int c = tid; c < kHalves * JW; c += kBwdThreads) s_dins[c] = 0.f;
  }

  // stage st of the walk into ring slot st % stages: [kStage, W] values (at
  // one window one contiguous, 16-byte aligned block in 16-byte copies, else
  // the window's piece of each row), scatter and prior in 4-byte copies;
  // one commit group a stage, empty past the range
  const int n_stages = (f_end - f_begin) / kStage;
  const int n16 = kStage * D * (int)sizeof(T) / 16;
  const int gv = piece_bytes(D, W, (int)sizeof(T));
  auto issue = [&](int st) {
    if (st < n_stages) {
      const int f0 = f_begin + st * kStage;
      float* buf = smem + lay.ring + (st % stages) * lay.stage;
      if (!kWin) {
        const uint4* src = reinterpret_cast<const uint4*>(vl + (size_t)f0 * D);
        uint4* dst = reinterpret_cast<uint4*>(buf);
        for (int i = tid; i < n16; i += kBwdThreads)
          __pipeline_memcpy_async(dst + i, src + i, 16);
      } else {
        copy_rows(reinterpret_cast<T*>(buf), W, vl + (size_t)f0 * D + c0, D,
                  kStage, wc, gv, tid, kBwdThreads);
      }
      if (tid < kStage)
        __pipeline_memcpy_async(buf + lay.vals + tid, sc + f0 + tid, 4);
      else if (tid < 2 * kStage)
        __pipeline_memcpy_async(buf + lay.vals + tid, pr + f0 + tid - kStage,
                                4);
    }
    __pipeline_commit();
  };
  for (int st = 0; st < stages - 1; ++st) issue(st);

  float* s_dh = s_dins + half * JW;   // this half-warp's dins partial
  for (int st = 0; st < n_stages; ++st) {
    // this stage (and g) landed for this thread; the barrier makes every
    // thread's copies visible and frees the ring slot of stage st - 1
    __pipeline_wait_prior(stages - 2);
    __syncthreads();
    issue(st + stages - 1);
    const float* buf = smem + lay.ring + (st % stages) * lay.stage;
    const T* s_val = reinterpret_cast<const T*>(buf);
    const int32_t* s_sc = reinterpret_cast<const int32_t*>(buf + lay.vals);
    const float* s_pr = buf + lay.vals + kStage;
    const int f0 = f_begin + st * kStage;
    for (int i = half; i < kStage; i += kHalves) {
      const int r = s_sc[i] - row0;
      const bool valid = (unsigned)r < (unsigned)kTileE;  // else a pad slot
      const float pri = s_pr[i];
      const float* g_row = s_g + (valid ? r : 0) * JW;
      const T* v_row = s_val + i * W;
      T* dv_row = dv + (size_t)(f0 + i) * D + c0;
      float dpri = 0.f;
      // one (column, instruction) of the slot: dpri, dvals and dins terms
      auto term = [&](float v, float in, float gb, float& dvk, float& dins) {
        const float pre = v * in;
        dpri += gb * (apply_relu ? fmaxf(pre, 0.f) : pre);
        const float dval = (apply_relu && !(pre > 0.f)) ? 0.f : gb * pri;
        dvk += dval * in;
        dins += dval * v;
      };
      if constexpr (kJ > 0) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int k = l + 16 * q;
          if (k >= wc) continue;
          float dvk = 0.f;
          if (valid) {
            const float v = to_float(v_row[k]);
#pragma unroll
            for (int j = 0; j < kJ; ++j)
              term(v, in_r[j][q], g_row[j * wc + k], dvk, dins_r[j][q]);
          }
          dv_row[k] = from_float<T>(dvk);
        }
      } else {
        for (int k = l; k < wc; k += 16) {
          float dvk = 0.f;
          if (valid) {
            const float v = to_float(v_row[k]);
            for (int j = 0; j < J; ++j) {
              const int c = j * wc + k;
              float dins = need_dins ? s_dh[c] : 0.f;
              term(v, s_ins[c], g_row[c], dvk, dins);
              if (need_dins) s_dh[c] = dins;
            }
          }
          dv_row[k] = from_float<T>(dvk);
        }
      }
      if (dp) {   // both halves of the warp run the same trip counts
        for (int off = 8; off > 0; off >>= 1)
          dpri += __shfl_xor_sync(0xffffffffu, dpri, off);
        if (l == 0) dp[f0 + i] = dpri;
      }
    }
  }

  if (need_dins) {
    if constexpr (kJ > 0) {
#pragma unroll
      for (int j = 0; j < kJ; ++j)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (l + 16 * q < wc) s_dh[j * wc + l + 16 * q] = dins_r[j][q];
    }
    __syncthreads();
    // this part's partial of dins: the [J*D] row, the window's columns
    float* ws = o.dins_ws + ((db * n_tiles + t) * kParts + part) * JD;
    for (int c = tid; c < JW; c += kBwdThreads) {
      float s = 0.f;
      for (int h = 0; h < kHalves; ++h) s += s_dins[h * JW + c];
      ws[full_col(c, wc, D, c0)] = s;
    }
  }
}

// The widest window of gate_scatter_bwd_kernel (a ring of two stages) that
// fits a block, or 0.
int bwd_window(int D, int J, int elem) {
  return widest_window(D, [&](int W) { return BwdLayout(W, J, elem, 2).total; });
}

// win_ws: [nwin, ndir, B, Fp] f32, the windows' dprior partials (read only
// with more than one window and a dprior to write).
template <typename T>
int launch_bwd(const DirPtrs& p, const void* ins, const float* g,
               const BwdOut& o, void* dins, int ndir, int B, int Fp, int D,
               int J, int n_tiles, int apply_relu, int W, float* win_ws,
               void* stream) {
  const int JD = J * D, nwin = (D + W - 1) / W;
  const BwdLayout one(W, J, (int)sizeof(T), 1), none(W, J, (int)sizeof(T), 0);
  const int stages = ring_stages((size_t)none.total * sizeof(float),
                                 (size_t)one.stage * sizeof(float));
  const size_t smem =
      (size_t)BwdLayout(W, J, (int)sizeof(T), stages).total * sizeof(float);
  const int kj = W <= 64 && J <= kRegJ ? J : 0;
  const bool win = nwin > 1;
  auto kernel = kj == 1   ? (win ? gate_scatter_bwd_kernel<T, 1, true>
                                 : gate_scatter_bwd_kernel<T, 1, false>)
                : kj == 2 ? (win ? gate_scatter_bwd_kernel<T, 2, true>
                                 : gate_scatter_bwd_kernel<T, 2, false>)
                : kj == 3 ? (win ? gate_scatter_bwd_kernel<T, 3, true>
                                 : gate_scatter_bwd_kernel<T, 3, false>)
                          : (win ? gate_scatter_bwd_kernel<T, 0, true>
                                 : gate_scatter_bwd_kernel<T, 0, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  BwdOut ow = o;
  if (nwin > 1 && o.dprior) ow.dprior = win_ws;
  kernel<<<dim3(n_tiles, kParts, ndir * B * nwin), kBwdThreads, smem, s>>>(
          p, static_cast<const T*>(ins), g, ow, B, Fp, D, J, n_tiles,
          apply_relu, stages, W);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (nwin > 1 && o.dprior &&
      (err = launch_window_sum(win_ws, nwin, (size_t)ndir * B * Fp, o.dprior,
                               s)) != cudaSuccess)
    return (int)err;
  if (o.dins_ws == nullptr) return 0;
  part_reduce_kernel<T>
      <<<dim3((JD + kRedCols - 1) / kRedCols, B), dim3(kRedCols, kRedRows), 0,
         s>>>(o.dins_ws, p.chunk_starts[0], p.chunk_starts[1], ndir,
              kBwdPartChunks, n_tiles, n_tiles, JD, JD, static_cast<T*>(dins),
              static_cast<T*>(nullptr));
  return (int)cudaGetLastError();
}

// ---------------------------------------- fused-projection op (K6a-c)
constexpr int kFbPartChunks = 2;  // least chunks a part of the backward takes
constexpr int kFfPartChunks = 4;  // least chunks a part of the forward takes
constexpr int kFbPre = 4;         // 16-byte fact_rel pieces a thread prefetches

// rel_linear of the fused-projection op: w [D,D] (rl = fact_rel @ w + b) and
// b [D], in the input type.
struct Proj {
  const void* w;
  const void* b;
};

// Outputs of the fused-projection backward (one direction).
struct ProjBwdOut {
  void* dfr;       // [B,Fp,D] T
  float* dprior;   // [B,Fp]
  float* dins_ws;  // [B,n_tiles,kParts,J*D] per-part partials of dins
  float* dw_ws;    // [B*n_tiles*kParts,D*D+D] per-part partials of dW, db
  float* dfr_ws;   // [nwin,B,Fp,D] the windows' partials of dfact_rel
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

// a[r][c] = sum_m fr[r * Dp + m] * w[m * ldw + c] over m in order (float,
// a 4-slot x 4-column tile from float4 loads: 8 loads for 64 FMAs); fr
// points at the tile's first row, w (rows of ldw floats) at its first
// column.
__device__ __forceinline__ void tile4x4(const float* fr, const float* w,
                                        int Dp, int ldw, float (&a)[4][4]) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) a[r][c] = 0.f;
  for (int m = 0; m < Dp; m += 4) {
    float4 x[4], y[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ld4(fr + r * Dp + m);
#pragma unroll
    for (int u = 0; u < 4; ++u) y[u] = ld4(w + (m + u) * ldw);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      fma4(a[r], x[r].x, y[0]);
      fma4(a[r], x[r].y, y[1]);
      fma4(a[r], x[r].z, y[2]);
      fma4(a[r], x[r].w, y[3]);
    }
  }
}

// A stage of kStage fact slots of one sample: load() brings its [kStage,
// D] fact_rel rows (one contiguous, 16-byte aligned block; kFbPre 16-byte
// pieces a thread), rows within the tile and priors into registers, and
// store() puts them in shared memory, the rows widened to float into a
// [kStage, Dp] tile (a wider D loads its other pieces there). Loading a
// stage ahead keeps its loads in flight while the block computes.
template <typename T>
struct SlotStager {
  static constexpr int kV = 16 / sizeof(T);
  const T* frg;
  const int32_t* sc;
  const float* pr;
  int D, Dp, n16, row0, tid;
  uint4 pre[kFbPre];
  int32_t pre_row = 0;
  float pre_pri = 0.f;

  __device__ void load(int f0) {
    const uint4* src = reinterpret_cast<const uint4*>(frg + (size_t)f0 * D);
#pragma unroll
    for (int q = 0; q < kFbPre; ++q) {
      const int i = tid + q * kBwdThreads;
      if (i < n16) pre[q] = src[i];
    }
    if (tid < kStage) {
      pre_row = sc[f0 + tid] - row0;
      pre_pri = pr[f0 + tid];
    }
  }
  // piece i holds elements i kV .. i kV + kV - 1 of the [kStage, D]
  // block, from row e0 / D on
  __device__ void put(float* s_fr, int i, uint4 v) const {
    const int e0 = i * kV, r0 = e0 / D;
    int at = r0 * Dp + e0 - r0 * D, k = e0 - r0 * D;
#pragma unroll
    for (int u = 0; u < kV; ++u, ++k, ++at) {
      if (k == D) {
        k = 0;
        at += Dp - D;
      }
      s_fr[at] = piece<T>(v, u);
    }
  }
  // kRoundPrior: the prior rounded to T, as the forward's one-hot operand
  template <bool kRoundPrior>
  __device__ void store(int f0, float* s_fr, int32_t* s_row,
                        float* s_pri) const {
#pragma unroll
    for (int q = 0; q < kFbPre; ++q) {
      const int i = tid + q * kBwdThreads;
      if (i < n16) put(s_fr, i, pre[q]);
    }
    const uint4* src = reinterpret_cast<const uint4*>(frg + (size_t)f0 * D);
    for (int i = tid + kFbPre * kBwdThreads; i < n16; i += kBwdThreads)
      put(s_fr, i, src[i]);
    if (tid < kStage) {
      s_row[tid] = pre_row;
      s_pri[tid] = kRoundPrior ? to_float(from_float<T>(pre_pri)) : pre_pri;
    }
  }
};

// Shared-memory layout of fused_fwd_kernel for a window of W columns,
// offsets in floats: the output tile, w's window columns and b padded to
// Wp (zeros), the stage's fact_rel [kStage, Dp] (float) and rl [kStage, Wp]
// (T), two buffers of the slots' rows and priors, and the stage's slots
// sorted by gate group: entries {slot | row << 8, prior} and each group's
// first entry.
struct FfLayout {
  int acc, w, bias, fr, rl, row, pri, ent, gfirst, total;
  __host__ __device__ FfLayout(int D, int J, int W) {
    const int Dp = (D + 3) & ~3, Wp = (W + 3) & ~3;
    acc = 0;                          // [kTileE, J*W]
    w = acc + kTileE * J * W;         // [Dp, Wp]
    bias = w + Dp * Wp;               // [Wp]
    fr = bias + Wp;                   // [kStage, Dp]
    rl = fr + kStage * Dp;            // [kStage, Wp] T
    row = rl + kStage * Wp;           // [2, kStage] int32
    pri = row + 2 * kStage;           // [2, kStage]
    ent = pri + 2 * kStage;           // [kStage] int2
    gfirst = ent + 2 * kStage;        // [kBwdThreads + 1] int32
    total = gfirst + kBwdThreads + 1;
  }
};

// The fused-projection forward: out [B,n_tiles*128,J*D] f32 and ws [B,
// fwd_slots(Fp, kFfPartChunks), 128*J*D] f32 (partial tiles of split
// tiles, added by tile_sum_kernel); grid (n_tiles, kParts, B*nwin),
// kBwdThreads. Block (t, part, b*nwin + win) takes window win (W columns a
// window: rl[:, c0:c0+wc] = fact_rel w[:, c0:c0+wc] + b[c0:c0+wc] from the
// whole fact_rel rows) of part `part` of tile t's chunk range and walks it
// kStage slots a stage:
//   A. rl = T(fact_rel w + b) of the stage, a 4-slot x 4-column tile a
//      thread (tile4x4), into shared memory;
//      meanwhile the last warp sorts the stage's slots by gate group (the
//      group of row r is r % ngrp), keeping their order within each group;
//   B. the next stage's rows go from registers to shared memory (and the
//      one after is loaded), while every thread (grp, c) adds the gate of
//      its group's slots into column c, four read-modify-writes at once
//      when their rows differ.
template <typename T, bool kWin>
__global__ void __launch_bounds__(kBwdThreads, 2)
    fused_fwd_kernel(DirPtrs p, const T* __restrict__ ins, Proj proj,
                     float* __restrict__ out, float* __restrict__ ws, int Fp,
                     int D, int J, int n_tiles, int apply_relu, int W_) {
  extern __shared__ __align__(16) float smem[];
  const int W = kWin ? W_ : D;
  const FfLayout lay(D, J, W);
  const int nwin = kWin ? (D + W - 1) / W : 1, b = blockIdx.z / nwin;
  const int c0 = kWin ? (blockIdx.z - b * nwin) * W : 0;
  const int wc = kWin ? min(W, D - c0) : D;
  const int Dp = (D + 3) & ~3, Wp = kWin ? (W + 3) & ~3 : Dp;
  const int nq = kWin ? ((wc + 3) & ~3) / 4 : Dp / 4;
  const int JD = J * D, JW = J * wc;
  const int t = blockIdx.x, part = blockIdx.y;
  const int tid = threadIdx.x;
  const int32_t* cs = p.chunk_starts[0] + (size_t)b * (n_tiles + 1);
  const int ch0 = cs[t], nch = cs[t + 1] - ch0;
  const int parts = fwd_parts(nch, kFfPartChunks);
  if (part >= parts) return;
  const int cb = ch0 + part * nch / parts;
  const int ce = ch0 + (part + 1) * nch / parts;
  const int f_begin = cb * kTileF, f_end = ce * kTileF;
  const int row0 = t * kTileE;

  float* acc = smem + lay.acc;
  float* s_w = smem + lay.w;
  float* s_b = smem + lay.bias;
  float* s_fr = smem + lay.fr;
  T* s_rl = reinterpret_cast<T*>(smem + lay.rl);
  int32_t* s_row = reinterpret_cast<int32_t*>(smem + lay.row);
  float* s_pri = smem + lay.pri;
  int2* s_ent = reinterpret_cast<int2*>(smem + lay.ent);
  int32_t* s_first = reinterpret_cast<int32_t*>(smem + lay.gfirst);

  // the gate's threads: ngrp groups of JW, thread (grp, col) (one group
  // of kBwdThreads taking columns col, col + kBwdThreads, ... when JW is
  // wider than the block)
  const int ngrp = kBwdThreads / JW > 1 ? kBwdThreads / JW : 1;
  const int grp = tid / JW, col = tid - grp * JW;
  const bool active = grp < ngrp;
  const T* ins_b = ins + (size_t)b * JD;

  float4* acc4 = reinterpret_cast<float4*>(acc);
  for (int i = tid; i < kTileE * JW / 4; i += kBwdThreads)
    acc4[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  const T* w = static_cast<const T*>(proj.w);
  const T* bias = static_cast<const T*>(proj.b);
  for (int i = tid; i < Dp * Wp; i += kBwdThreads) {
    const int m = i / Wp, c = i - m * Wp;
    s_w[i] = m < D && c < wc ? to_float(w[m * D + c0 + c]) : 0.f;
  }
  for (int i = tid; i < Wp; i += kBwdThreads)
    s_b[i] = i < wc ? to_float(bias[c0 + i]) : 0.f;
  for (int i = tid; i < kStage * Dp; i += kBwdThreads) s_fr[i] = 0.f;

  SlotStager<T> stg{static_cast<const T*>(p.vals[0]) + (size_t)b * Fp * D,
                    p.scatter[0] + (size_t)b * Fp, p.prior[0] + (size_t)b * Fp,
                    D, Dp, kStage * D / SlotStager<T>::kV, row0, tid};
  // a stage's fact_rel rows, and its slots' rows and priors into meta
  // buffer `buf`
  auto stash = [&](int f0, int buf) {
    stg.template store<true>(f0, s_fr, s_row + buf * kStage,
                             s_pri + buf * kStage);
  };
  // the last warp (its threads hold no projection tile at W <= 56): the
  // slots of meta buffer `buf` sorted by gate group (pad slots dropped), in
  // slot order within a group, by ballots over the two halves of the stage
  auto sort_slots = [&](int buf) {
    const int32_t* rows = s_row + buf * kStage;
    const float* pri = s_pri + buf * kStage;
    const int l = tid & 31, r0 = rows[l], r1 = rows[l + 32];
    const int o0 = (unsigned)r0 < (unsigned)kTileE ? r0 % ngrp : -1;
    const int o1 = (unsigned)r1 < (unsigned)kTileE ? r1 % ngrp : -1;
    const unsigned below = (1u << l) - 1;
    int first = 0;
    for (int g = 0; g < ngrp; ++g) {
      const unsigned b0 = __ballot_sync(0xffffffffu, o0 == g);
      const unsigned b1 = __ballot_sync(0xffffffffu, o1 == g);
      if (l == 0) s_first[g] = first;
      if (o0 == g)
        s_ent[first + __popc(b0 & below)] =
            make_int2(l | (r0 << 8), __float_as_int(pri[l]));
      if (o1 == g)
        s_ent[first + __popc(b0) + __popc(b1 & below)] =
            make_int2((l + 32) | (r1 << 8), __float_as_int(pri[l + 32]));
      first += __popc(b0) + __popc(b1);
    }
    if (l == 0) s_first[ngrp] = first;
  };
  if (f_begin < f_end) {
    stg.load(f_begin);
    __syncthreads();   // the zero fill of s_fr before its rows land
    stash(f_begin, 0);
    if (f_begin + kStage < f_end) stg.load(f_begin + kStage);
  }
  for (int f0 = f_begin, buf = 0; f0 < f_end; f0 += kStage, buf ^= 1) {
    __syncthreads();   // s_fr holds this stage; the last gate read s_rl
    if (tid >= kBwdThreads - 32) sort_slots(buf);
    // A. rl of the stage's window columns, rounded to T once
    const int32_t* rows = s_row + buf * kStage;
    for (int id = tid; id < (kStage / 4) * nq; id += kBwdThreads) {
      const int ig = id / nq, kq = id - ig * nq;
      // four pad slots (a tile's range ends in them): no gate reads their rl
      const int4 r4 = *reinterpret_cast<const int4*>(rows + 4 * ig);
      if (r4.x < 0 && r4.y < 0 && r4.z < 0 && r4.w < 0) continue;
      float a[4][4];
      tile4x4(s_fr + 4 * ig * Dp, s_w + 4 * kq, Dp, Wp, a);
      const float4 bv = ld4(s_b + 4 * kq);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s_rl[(4 * ig + r) * Wp + 4 * kq + c] = from_float<T>(a[r][c] + elem(bv, c));
    }
    __syncthreads();   // rl is complete; s_fr is free
    // B. the next stage's rows in, then the gate of this one
    if (f0 + kStage < f_end) {
      stash(f0 + kStage, buf ^ 1);
      if (f0 + 2 * kStage < f_end) stg.load(f0 + 2 * kStage);
    }
    if (!active) continue;
    const int e0 = s_first[grp], n = s_first[grp + 1] - e0;
    const int2* ent = s_ent + e0;
    for (int c = col; c < JW; c += kBwdThreads) {
      const int k = c % wc;
      const T ins_jk = ins_b[full_col(c, wc, D, c0)];
      float* acc_c = acc + c;
      // slot (i, row, prior): acc_c[row * JW] += act(rl[i, k] * ins_jk) * prior
      auto term = [&](int2 e, int& at, float& x, float& pr) {
        at = (e.x >> 8) * JW;
        x = to_float(mul(s_rl[(e.x & 255) * Wp + k], ins_jk));
        if (apply_relu) x = fmaxf(x, 0.f);
        pr = __int_as_float(e.y);
      };
      int q = 0;
      for (; q + 4 <= n; q += 4) {
        int at[4];
        float x[4], pr[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) term(ent[q + u], at[u], x[u], pr[u]);
        if (at[0] != at[1] && at[0] != at[2] && at[0] != at[3] &&
            at[1] != at[2] && at[1] != at[3] && at[2] != at[3]) {
          float a[4];   // four rows: their sums are independent
#pragma unroll
          for (int u = 0; u < 4; ++u) a[u] = acc_c[at[u]];
#pragma unroll
          for (int u = 0; u < 4; ++u) acc_c[at[u]] = fmaf(x[u], pr[u], a[u]);
        } else {
#pragma unroll
          for (int u = 0; u < 4; ++u)
            acc_c[at[u]] = fmaf(x[u], pr[u], acc_c[at[u]]);
        }
      }
      for (; q < n; ++q) {
        int at;
        float x, pr;
        term(ent[q], at, x, pr);
        acc_c[at] = fmaf(x, pr, acc_c[at]);
      }
    }
  }
  __syncthreads();
  // one part: the tile's rows; more: this part's partial tile
  float* dst = parts == 1
      ? out + ((size_t)b * n_tiles * kTileE + row0) * JD
      : ws + ((size_t)b * fwd_slots(Fp, kFfPartChunks) + cb / kFfPartChunks) *
                kTileE * JD;
  store_tile<kWin>(dst, acc, JD, JW, wc, D, c0, tid, kBwdThreads);
}

// The widest window of fused_fwd_kernel that fits a block, or 0.
int fused_fwd_window(int D, int J) {
  return widest_window(D, [&](int W) { return FfLayout(D, J, W).total; });
}

template <typename T>
int launch_fused_fwd(const DirPtrs& p, const void* ins, Proj proj, void* out,
                     void* ws, int B, int Fp, int D, int J, int n_tiles,
                     int apply_relu, int W, void* stream) {
  const size_t smem = (size_t)FfLayout(D, J, W).total * sizeof(float);
  const int nwin = (D + W - 1) / W;
  auto kernel = nwin > 1 ? fused_fwd_kernel<T, true> : fused_fwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  float* o = static_cast<float*>(out);
  float* w = static_cast<float*>(ws);
  kernel<<<dim3(n_tiles, kParts, B * nwin), kBwdThreads, smem, s>>>(
      p, static_cast<const T*>(ins), proj, o, w, Fp, D, J, n_tiles,
      apply_relu, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  tile_sum_kernel<<<dim3(n_tiles, B), kSumThreads, 0, s>>>(
      w, p.chunk_starts[0], p.chunk_starts[0], 0, o, B, Fp, n_tiles,
      kFfPartChunks, kTileE * J * D / 4);
  return (int)cudaGetLastError();
}

// Shared-memory layout of fused_bwd_kernel for a window of W columns,
// offsets in floats. D is padded to Dp and W to Wp, multiples of 4, so
// every row starts on 16 bytes for float4 loads; the padding of w, ins and
// the staged rows is zero.
struct FbLayout {
  int g, w, fr, x, dw, db, ins, bias, dins, dinsp, dpp, row, pri, total;
  __host__ __device__ FbLayout(int D, int J, int W) {
    const int Dp = (D + 3) & ~3, Wp = (W + 3) & ~3;
    g = 0;                                 // [kTileE, J*W] the tile's cotangent
    w = g + kTileE * J * W;                // [Dp, Wp] w[m, c0 + k]
    fr = w + Dp * Wp;                      // [kStage, Dp] the stage's fact_rel
    x = fr + kStage * Dp;                  // [kStage, Wp] the stage's drl
    dw = x + kStage * Wp;                  // [Dp, Wp] this part's dW
    db = dw + Dp * Wp;                     // [Wp] this part's db
    ins = db + Wp;                         // [J, Wp]
    bias = ins + J * Wp;                   // [Wp]
    dins = bias + Wp;                      // [J*W] this part's dins
    dinsp = dins + J * W;                  // [kStage/4, J, Wp] group partials
    dpp = dinsp + (kStage / 4) * J * Wp;   // [Wp/4, kStage] dprior partials
    row = dpp + (Wp / 4) * kStage;         // [kStage] int32
    pri = row + kStage;                    // [kStage]
    total = pri + kStage;
  }
};

// The backward of the fused forward. g [B,n_tiles*128,J*D] f32; grid
// (n_tiles, kParts, B*nwin), kBwdThreads. Block (t, part, b*nwin + win)
// takes window win (columns c0 .. c0 + wc - 1 of rl, w's columns) of part
// `part` of tile t's chunk range and walks it kStage slots a stage:
//   1. rl = fact_rel w + b of the window, unrounded (tile4x4), then the
//      gate backward on that tile in registers: drl (to shared memory), its
//      dprior and dins partials;
//   2. dprior of each slot and this part's dins (one thread a column) from
//      the partials, in a fixed order; dfact_rel = drl w^T (a 4 x 4 tile a
//      thread, written out); dW += fact_rel^T drl and db += sum drl (a
//      fixed 4 x 4 block of dW a thread, accumulated in shared memory
//      over the stages, slots in order).
// A window's columns of dins, dW and db are whole; dprior and dfact_rel
// (sums over every column) it writes as float partials to its planes of
// o.dprior and o.dfr_ws ([nwin, B, Fp] and [nwin, B, Fp, D]) when there is
// more than one window, and directly (dfact_rel rounded to T) at one.
// Two barriers a stage; the next stage's fact_rel rows are loaded into
// registers while this one computes.
template <typename T, bool kWin>
__global__ void __launch_bounds__(kBwdThreads, 2)
    fused_bwd_kernel(DirPtrs p, const T* __restrict__ ins, Proj proj,
                     const float* __restrict__ g, ProjBwdOut o, int Fp, int D,
                     int J, int n_tiles, int apply_relu, int W_) {
  extern __shared__ __align__(16) float smem[];
  const int W = kWin ? W_ : D;
  const FbLayout lay(D, J, W);
  const int nwin = kWin ? (D + W - 1) / W : 1, b = blockIdx.z / nwin;
  const int win = kWin ? blockIdx.z - b * nwin : 0, c0 = win * W;
  const int wc = kWin ? min(W, D - c0) : D;
  const int Dp = (D + 3) & ~3, Wp = kWin ? (W + 3) & ~3 : Dp;
  // column quads of the window and of D
  const int nqd = Dp / 4, nq = kWin ? ((wc + 3) & ~3) / 4 : nqd;
  const int JD = J * D, JW = J * wc, DD = D * D;
  const int t = blockIdx.x, part = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t plane = (size_t)win * (gridDim.z / nwin) + b;
  const int32_t* cs = p.chunk_starts[0] + (size_t)b * (n_tiles + 1);
  T* dfr = static_cast<T*>(o.dfr) + (size_t)b * Fp * D;
  float* dfr_part = kWin ? o.dfr_ws + plane * Fp * D : nullptr;
  float* dp = o.dprior + plane * Fp;

  // slots past the last tile's range: every block of (b, win) zeroes its
  // share
  {
    const int nwarps = kBwdThreads / 32, lane = tid & 31, warp = tid >> 5;
    const int f_last = cs[n_tiles] * kTileF;
    const int step = n_tiles * kParts * nwarps;
    for (int f = f_last + (t * kParts + part) * nwarps + warp; f < Fp;
         f += step) {
      for (int k = lane; k < D; k += 32) {
        if (dfr_part) dfr_part[(size_t)f * D + k] = 0.f;
        else dfr[(size_t)f * D + k] = from_float<T>(0.f);
      }
      if (lane == 0) dp[f] = 0.f;
    }
  }
  const int ch0 = cs[t], nch = cs[t + 1] - ch0;
  const int parts = split_parts(nch, kFbPartChunks);
  if (part >= parts) return;   // an empty part writes no partials
  const int f_begin = (ch0 + part * nch / parts) * kTileF;
  const int f_end = (ch0 + (part + 1) * nch / parts) * kTileF;
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

  // the tile's [128, JW] slice of g, as in gate_scatter_bwd_kernel
  const float* gt = g + ((size_t)b * n_tiles * kTileE + row0) * JD;
  if (!kWin) {
    const uint4* gsrc = reinterpret_cast<const uint4*>(gt);
    uint4* gdst = reinterpret_cast<uint4*>(s_g);
    for (int i = tid; i < kTileE * JD / 4; i += kBwdThreads)
      __pipeline_memcpy_async(gdst + i, gsrc + i, 16);
  } else {
    copy_rows(s_g, wc, gt + c0, D, kTileE * J, wc, piece_bytes(D, W, 4), tid,
              kBwdThreads);
  }
  __pipeline_commit();
  const T* w = static_cast<const T*>(proj.w);
  const T* bias = static_cast<const T*>(proj.b);
  for (int i = tid; i < Dp * Wp; i += kBwdThreads) {
    const int m = i / Wp, k = i - m * Wp;
    s_w[i] = m < D && k < wc ? to_float(w[m * D + c0 + k]) : 0.f;
    s_dw[i] = 0.f;
  }
  for (int i = tid; i < Wp; i += kBwdThreads) {
    s_b[i] = i < wc ? to_float(bias[c0 + i]) : 0.f;
    s_db[i] = 0.f;
  }
  for (int i = tid; i < J * Wp; i += kBwdThreads) {
    const int j = i / Wp, k = i - j * Wp;
    s_ins[i] = k < wc ? to_float(ins[(size_t)b * JD + j * D + c0 + k]) : 0.f;
  }
  for (int c = tid; c < JW; c += kBwdThreads) s_dins[c] = 0.f;
  for (int i = tid; i < kStage * Dp; i += kBwdThreads) s_fr[i] = 0.f;

  // the prior unrounded, as the TPU backward reads it
  SlotStager<T> stg{static_cast<const T*>(p.vals[0]) + (size_t)b * Fp * D,
                    p.scatter[0] + (size_t)b * Fp, p.prior[0] + (size_t)b * Fp,
                    D, Dp, kStage * D / SlotStager<T>::kV, row0, tid};
  __pipeline_wait_prior(0);
  stg.load(f_begin);
  for (int f0 = f_begin; f0 < f_end; f0 += kStage) {
    __syncthreads();   // the setup, or the previous stage's reads, are done
    stg.template store<false>(f0, s_fr, s_row, s_pri);
    if (f0 + kStage < f_end) stg.load(f0 + kStage);
    __syncthreads();

    // 1. rl tile, then the gate backward on it
    for (int id = tid; id < (kStage / 4) * nq; id += kBwdThreads) {
      const int ig = id / nq, kq = id - ig * nq;
      float a[4][4];                      // rl[4 ig + r][c0 + 4 kq + c]
      tile4x4(s_fr + 4 * ig * Dp, s_w + 4 * kq, Dp, Wp, a);
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
        const float4 in4 = ld4(s_ins + j * Wp + 4 * kq);
        float dins[4] = {};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if ((unsigned)rows[r] >= (unsigned)kTileE) continue;  // pad slot
          const float* grow = s_g + rows[r] * JW + j * wc + 4 * kq;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const float in = elem(in4, c);
            const float gb = 4 * kq + c < wc ? grow[c] : 0.f;
            const float pre = a[r][c] * in;
            dpri[r] += gb * (apply_relu ? fmaxf(pre, 0.f) : pre);
            const float dval = (apply_relu && !(pre > 0.f)) ? 0.f : gb * pri[r];
            drl[r][c] += dval * in;
            dins[c] += dval * a[r][c];
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c)
          s_dinsp[(ig * J + j) * Wp + 4 * kq + c] = dins[c];
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        *reinterpret_cast<float4*>(s_x + (4 * ig + r) * Wp + 4 * kq) =
            make_float4(drl[r][0], drl[r][1], drl[r][2], drl[r][3]);
        s_dpp[kq * kStage + 4 * ig + r] = dpri[r];
      }
    }
    __syncthreads();

    // 2a. dprior of the stage's slots (the window's columns): the column
    // groups in order
    for (int i = tid; i < kStage; i += kBwdThreads) {
      float s = 0.f;
      for (int q = 0; q < nq; ++q) s += s_dpp[q * kStage + i];
      dp[f0 + i] = (unsigned)s_row[i] < (unsigned)kTileE ? s : 0.f;
    }
    // 2b. this part's dins: a column a thread, the 4-slot groups in order
    for (int c = tid; c < JW; c += kBwdThreads) {
      const int j = c / wc, k = c - j * wc;
      float s = s_dins[c];
      for (int ig = 0; ig < kStage / 4; ++ig)
        s += s_dinsp[(ig * J + j) * Wp + k];
      s_dins[c] = s;
    }
    // 2c. dfact_rel = drl w^T over the window's columns: 4 slots x the
    // columns m = mq + nqd mm of a thread (w's rows at stride nqd apart fall
    // in distinct banks)
    for (int id = tid; id < (kStage / 4) * nqd; id += kBwdThreads) {
      const int ig = id / nqd, mq = id - ig * nqd;
      float a[4][4] = {};                 // dfr[4 ig + r][mq + nqd mm]
      const float* xr = s_x + 4 * ig * Wp;
      for (int k = 0; k < 4 * nq; k += 4) {
        float4 x[4], y[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) x[r] = ld4(xr + r * Wp + k);
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) y[mm] = ld4(s_w + (mq + nqd * mm) * Wp + k);
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
        const size_t row = (size_t)(f0 + 4 * ig + r) * D;
#pragma unroll
        for (int mm = 0; mm < 4; ++mm) {
          const int m = mq + nqd * mm;
          if (m >= D) continue;
          if (dfr_part) dfr_part[row + m] = a[r][mm];
          else dfr[row + m] = from_float<T>(a[r][mm]);
        }
      }
    }
    // 2d. dW[m, c0 + k] += sum_i fr[i, m] drl[i, k] (a fixed 4 x 4 block a
    // thread) and db[c0 + k] += sum_i drl[i, k], slots in order
    for (int id = tid; id < nqd * nq + nq; id += kBwdThreads) {
      if (id < nqd * nq) {
        const int mq = id / nq, kq = id - mq * nq;
        float a[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float4 v = ld4(s_dw + (4 * mq + r) * Wp + 4 * kq);
          a[r][0] = v.x; a[r][1] = v.y; a[r][2] = v.z; a[r][3] = v.w;
        }
        for (int i = 0; i < kStage; ++i) {
          const float4 f = ld4(s_fr + i * Dp + 4 * mq);
          const float4 x = ld4(s_x + i * Wp + 4 * kq);
          fma4(a[0], f.x, x);
          fma4(a[1], f.y, x);
          fma4(a[2], f.z, x);
          fma4(a[3], f.w, x);
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
          *reinterpret_cast<float4*>(s_dw + (4 * mq + r) * Wp + 4 * kq) =
              make_float4(a[r][0], a[r][1], a[r][2], a[r][3]);
      } else {
        const int kq = id - nqd * nq;
        float4 a = ld4(s_db + 4 * kq);
        for (int i = 0; i < kStage; ++i) {
          const float4 x = ld4(s_x + i * Wp + 4 * kq);
          a.x += x.x; a.y += x.y; a.z += x.z; a.w += x.w;
        }
        *reinterpret_cast<float4*>(s_db + 4 * kq) = a;
      }
    }
  }
  __syncthreads();
  // this part's partials: the [J*D] dins row and the [D*D + D] dW, db row,
  // the window's columns of each
  const size_t blk = ((size_t)b * n_tiles + t) * kParts + part;
  for (int c = tid; c < JW; c += kBwdThreads)
    o.dins_ws[blk * JD + full_col(c, wc, D, c0)] = s_dins[c];
  float* dw_ws = o.dw_ws + blk * (DD + D);
  for (int e = tid; e < D * wc + wc; e += kBwdThreads) {
    const int m = e / wc, k = e - m * wc;
    if (e < D * wc) dw_ws[m * D + c0 + k] = s_dw[m * Wp + k];
    else dw_ws[DD + c0 + e - D * wc] = s_db[e - D * wc];
  }
}

// The widest window of fused_bwd_kernel that fits a block, or 0.
int fused_bwd_window(int D, int J) {
  return widest_window(D, [&](int W) { return FbLayout(D, J, W).total; });
}

// win_ws: [nwin, B, Fp, D] then [nwin, B, Fp] f32, the windows' dfact_rel
// and dprior partials (read only with more than one window).
template <typename T>
int launch_fused_bwd(const DirPtrs& p, const void* ins, Proj proj,
                     const float* g, const ProjBwdOut& o, void* dins, void* dw,
                     void* db, int B, int Fp, int D, int J, int n_tiles,
                     int apply_relu, int W, float* win_ws, void* stream) {
  const int JD = J * D, width = D * D + D, nwin = (D + W - 1) / W;
  const size_t smem = (size_t)FbLayout(D, J, W).total * sizeof(float);
  auto kernel = nwin > 1 ? fused_bwd_kernel<T, true> : fused_bwd_kernel<T, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return (int)err;
  }
  cudaStream_t s = (cudaStream_t)stream;
  ProjBwdOut ow = o;
  const size_t n_dfr = (size_t)B * Fp * D;
  if (nwin > 1) {
    ow.dfr_ws = win_ws;
    ow.dprior = win_ws + nwin * n_dfr;
  }
  kernel<<<dim3(n_tiles, kParts, B * nwin), kBwdThreads, smem, s>>>(
      p, static_cast<const T*>(ins), proj, g, ow, Fp, D, J, n_tiles,
      apply_relu, W);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (nwin > 1) {
    if ((err = launch_window_sum(ow.dfr_ws, nwin, n_dfr, static_cast<T*>(o.dfr),
                                 s)) != cudaSuccess ||
        (err = launch_window_sum(ow.dprior, nwin, (size_t)B * Fp, o.dprior,
                                 s)) != cudaSuccess)
      return (int)err;
  }
  const dim3 red(kRedCols, kRedRows);
  const int32_t* cs = p.chunk_starts[0];
  part_reduce_kernel<T><<<dim3((JD + kRedCols - 1) / kRedCols, B), red, 0, s>>>(
      o.dins_ws, cs, cs, 1, kFbPartChunks, n_tiles, n_tiles, JD, JD,
      static_cast<T*>(dins), static_cast<T*>(nullptr));
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  part_reduce_kernel<T><<<dim3((width + kRedCols - 1) / kRedCols, 1), red, 0,
                          s>>>(o.dw_ws, cs, cs, 1, kFbPartChunks, n_tiles,
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

DirPtrs two_directions(const void* vals_0, const void* vals_1,
                       const void* prior_0, const void* prior_1,
                       const void* scatter_0, const void* scatter_1,
                       const void* chunk_starts_0, const void* chunk_starts_1) {
  return DirPtrs{{vals_0, vals_1},
                 {static_cast<const float*>(prior_0),
                  static_cast<const float*>(prior_1)},
                 {static_cast<const int32_t*>(scatter_0),
                  static_cast<const int32_t*>(scatter_1)},
                 {static_cast<const int32_t*>(chunk_starts_0),
                  static_cast<const int32_t*>(chunk_starts_1)}};
}

}  // namespace

extern "C" {

// Each launch below takes W, the width of its column windows (1 <= W <= D;
// the last window takes the remainder): the widest that fits one block is
// what the *_window entry of the kernel reports for (D, J, element bytes),
// 0 if no window fits. A W outside [1, D] returns cudaErrorInvalidValue.

// Direction d's inputs are vals_d, prior_d, scatter_d and chunk_starts_d;
// with ndir == 1 the *_1 pointers are not read. vals and ins are bfloat16
// when bf16 is non-zero, else float. out [ndir,B,n_tiles*128,J*D] f32; ws
// [ndir,B,gate_scatter_fwd_slots(Fp),128*J*D] f32 scratch. Returns a
// cudaError_t value; 0 means the launch was accepted.
int gate_scatter_fwd(const void* vals_0, const void* vals_1, const void* ins,
                     const void* prior_0, const void* prior_1,
                     const void* scatter_0, const void* scatter_1,
                     const void* chunk_starts_0, const void* chunk_starts_1,
                     void* out, int ndir, int B, int Fp, int D, int J,
                     int n_tiles, int apply_relu, int bf16, int W, void* ws,
                     void* stream) {
  if (W < 1 || W > D) return (int)cudaErrorInvalidValue;
  const DirPtrs p = two_directions(vals_0, vals_1, prior_0, prior_1, scatter_0,
                                   scatter_1, chunk_starts_0, chunk_starts_1);
  const FwdPlan plan = fwd_plan(D, W, J, bf16 ? 2 : 4);
  return bf16 ? launch_gate_fwd<__nv_bfloat16, kGate>(
                    p, ins, out, ws, ndir, B, Fp, D, J, n_tiles, apply_relu,
                    plan, stream)
              : launch_gate_fwd<float, kGate>(p, ins, out, ws, ndir, B, Fp, D,
                                              J, n_tiles, apply_relu, plan,
                                              stream);
}

// The widest window of gate_scatter_fwd and scatter_mm_fwd (J 1) at width
// D, J instructions, elem bytes a value.
int gate_scatter_fwd_window(int D, int J, int elem) {
  return fwd_window(D, J, elem);
}

// Partial tiles a (direction, sample) of the workspace of gate_scatter_fwd
// and scatter_mm_fwd holds.
int gate_scatter_fwd_slots(int Fp) { return fwd_slots(Fp, kFwdPartChunks); }

// Blocks a tile's chunk range is split over at most, in the backward
// kernels' workspaces: gate_scatter_bwd's dins_ws and fused_gate_scatter_
// bwd's dins_ws and dw_ws.
int gate_scatter_parts() { return kParts; }

// Partial tiles a sample's workspace of fused_gate_scatter_fwd holds.
int fused_gate_scatter_fwd_slots(int Fp) {
  return fwd_slots(Fp, kFfPartChunks);
}

// The fused-projection forward, one direction: fact_rel [B,Fp,D], w [D,D],
// bias [D] and ins [B,J,D] bfloat16 when bf16 is non-zero, else float;
// prior [B,Fp] f32, scatter [B,Fp] i32, chunk_starts [B,n_tiles+1] i32;
// out [B,n_tiles*128,J*D] f32; ws [B,fused_gate_scatter_fwd_slots(Fp),
// 128*J*D] f32 scratch. Returns a cudaError_t value.
int fused_gate_scatter_fwd(const void* fact_rel, const void* w,
                           const void* bias, const void* ins,
                           const void* prior, const void* scatter,
                           const void* chunk_starts, void* out, void* ws,
                           int B, int Fp, int D, int J, int n_tiles,
                           int apply_relu, int bf16, int W, void* stream) {
  if (W < 1 || W > D) return (int)cudaErrorInvalidValue;
  const DirPtrs p = one_direction(fact_rel, prior, scatter, chunk_starts);
  const Proj proj{w, bias};
  return bf16 ? launch_fused_fwd<__nv_bfloat16>(p, ins, proj, out, ws, B, Fp,
                                                D, J, n_tiles, apply_relu, W,
                                                stream)
              : launch_fused_fwd<float>(p, ins, proj, out, ws, B, Fp, D, J,
                                        n_tiles, apply_relu, W, stream);
}

// The widest window of fused_gate_scatter_fwd (its layout holds values as
// floats whatever elem).
int fused_gate_scatter_fwd_window(int D, int J, int elem) {
  (void)elem;
  return fused_fwd_window(D, J);
}

// Its backward, inputs as there; g [B,E,J*D] f32. Writes dfr [B,Fp,D] and
// dins [B,J,D], dw [D,D] and db [D] in the input type, dprior [B,Fp] f32;
// dins_ws [B,n_tiles,P,J*D] and dw_ws [B*n_tiles*P,D*D+D] are f32 scratch,
// P = gate_scatter_parts(), and with more than one window so is win_ws,
// [nwin,B,Fp,D] then [nwin,B,Fp] (the windows' dfr and dprior partials).
int fused_gate_scatter_bwd(const void* fact_rel, const void* w,
                           const void* bias, const void* ins,
                           const void* prior, const void* scatter,
                           const void* chunk_starts, const void* g, void* dfr,
                           void* dprior, void* dins_ws, void* dins,
                           void* dw_ws, void* dw, void* db, int B, int Fp,
                           int D, int J, int n_tiles, int apply_relu, int bf16,
                           int W, void* win_ws, void* stream) {
  if (W < 1 || W > D) return (int)cudaErrorInvalidValue;
  const DirPtrs p = one_direction(fact_rel, prior, scatter, chunk_starts);
  const Proj proj{w, bias};
  const ProjBwdOut o{dfr, static_cast<float*>(dprior),
                     static_cast<float*>(dins_ws), static_cast<float*>(dw_ws),
                     nullptr};
  const float* gf = static_cast<const float*>(g);
  float* ww = static_cast<float*>(win_ws);
  return bf16 ? launch_fused_bwd<__nv_bfloat16>(p, ins, proj, gf, o, dins, dw,
                                                db, B, Fp, D, J, n_tiles,
                                                apply_relu, W, ww, stream)
              : launch_fused_bwd<float>(p, ins, proj, gf, o, dins, dw, db, B,
                                        Fp, D, J, n_tiles, apply_relu, W, ww,
                                        stream);
}

// The widest window of fused_gate_scatter_bwd.
int fused_gate_scatter_bwd_window(int D, int J, int elem) {
  (void)elem;
  return fused_bwd_window(D, J);
}

// scatter_mm: values [B,Fp,C] (bfloat16 when bf16 is non-zero, else float),
// scatter [B,Fp] i32, chunk_tiles [B,Fp/128] i32 (non-decreasing per row);
// out [B,n_tiles*128,C] f32; ws [B,gate_scatter_fwd_slots(Fp),128*C] f32
// scratch; W the windows of C. Returns a cudaError_t value.
int scatter_mm_fwd(const void* values, const void* scatter,
                   const void* chunk_tiles, void* out, int B, int Fp, int C,
                   int n_tiles, int bf16, int W, void* ws, void* stream) {
  if (W < 1 || W > C) return (int)cudaErrorInvalidValue;
  const DirPtrs p = one_direction(values, nullptr, scatter, chunk_tiles);
  const FwdPlan plan = fwd_plan(C, W, 1, bf16 ? 2 : 4);
  return bf16 ? launch_gate_fwd<__nv_bfloat16, kScatter>(
                    p, nullptr, out, ws, 1, B, Fp, C, 1, n_tiles, 0, plan,
                    stream)
              : launch_gate_fwd<float, kScatter>(p, nullptr, out, ws, 1, B, Fp,
                                                 C, 1, n_tiles, 0, plan,
                                                 stream);
}

// The backward of gate_scatter_fwd, inputs as there; g [ndir,B,E,J*D] f32.
// Writes dvals [ndir,B,Fp,D] (vals' type), dprior [ndir,B,Fp] f32 unless
// dprior is null, and dins [B,J,D] (ins' type) unless dins_ws is null
// (dins_ws: [ndir,B,n_tiles,P,J*D] f32 scratch, P = gate_scatter_parts()).
// With more than one window and a dprior, win_ws [nwin,ndir,B,Fp] f32 is
// scratch for the windows' dprior partials. Returns a cudaError_t value.
int gate_scatter_bwd(const void* vals_0, const void* vals_1, const void* ins,
                     const void* prior_0, const void* prior_1,
                     const void* scatter_0, const void* scatter_1,
                     const void* chunk_starts_0, const void* chunk_starts_1,
                     const void* g, void* dvals, void* dprior, void* dins_ws,
                     void* dins, int ndir, int B, int Fp, int D, int J,
                     int n_tiles, int apply_relu, int bf16, int W,
                     void* win_ws, void* stream) {
  if (W < 1 || W > D) return (int)cudaErrorInvalidValue;
  const DirPtrs p = two_directions(vals_0, vals_1, prior_0, prior_1, scatter_0,
                                   scatter_1, chunk_starts_0, chunk_starts_1);
  const BwdOut o{dvals, static_cast<float*>(dprior),
                 static_cast<float*>(dins_ws)};
  const float* gf = static_cast<const float*>(g);
  float* ww = static_cast<float*>(win_ws);
  return bf16 ? launch_bwd<__nv_bfloat16>(p, ins, gf, o, dins, ndir, B, Fp, D,
                                          J, n_tiles, apply_relu, W, ww,
                                          stream)
              : launch_bwd<float>(p, ins, gf, o, dins, ndir, B, Fp, D, J,
                                  n_tiles, apply_relu, W, ww, stream);
}

// The widest window of gate_scatter_bwd.
int gate_scatter_bwd_window(int D, int J, int elem) {
  return bwd_window(D, J, elem);
}

const char* gate_scatter_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
