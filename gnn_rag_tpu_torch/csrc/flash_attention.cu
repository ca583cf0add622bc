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
// Tensors keep the model's [B, N, H, D] layout (D a multiple of 128: 128 to
// 2304 in float32, 128 to 4096 in bfloat16 and float16; the wrapper raises
// on any other D); lse and delta are [B*H, L] float, stored
// once per row (the TPU kernel replicated them over 128 lanes for its block
// shapes). All sums are float; every product is the
// float product of the (widened) inputs, as in the TPU kernels
// (flash_attention.py:79, :144-147, float32 at Precision.HIGHEST :43-44),
// to within the splits below, except p in the forward, which is rounded to
// T before it multiplies v.
//
// Two groups of kernels, chosen by the input type (the C entry points'
// `dtype`: 0 float32, 1 bfloat16, 2 float16):
//
// float32 (flash_{fwd,dq,dkv}_split3_kernel), on the tensor cores as the
// TPU's HIGHEST precision runs float32 dots (bf16_6x): every float operand
// x enters wgmma as three bf16 terms x1 = bf16(x), x2 = bf16(x - x1), x3 =
// bf16(x - x1 - x2), which hold its 24 significand bits, and x y as the six
// term products whose indices add up to at most 4 (x3y1, x2y2, x1y3, x2y1,
// x1y2, x1y1: the small ones first into the float accumulator); the
// dropped x2y3, x3y2 and x3y3 are within ~2^-23 |x y|
// (tests/test_torch_flash_split3.py: each product within 2^-21 of the sum
// of its terms' sizes, o, dq, dk and dv within 0.1 of the card check's
// 1e-4 of max|plain|). Six bf16 passes at 989 TFLOP/s do the work of 3
// TF32 passes at 495, and bf16 terms (6 bytes an element) can be read
// MN-major through the descriptor's transpose bit, which wgmma allows only
// for 16-bit types. No tensor map: a converter warpgroup loads float rows
// with 16-byte loads and writes their terms into shared memory in TMA's
// 128-byte-swizzled layout (split_rows), fences them for the async proxy
// and arrives on the stage's full barrier; consumers split their own
// resident rows likewise.
// - forward: 128 query rows a block, two consumers of 64 rows, each with
//   its Q terms (96 KB in all) resident; 64-key K and V tiles as terms in
//   one 48 KB slot each (K_j+1 is split while the consumers run softmax and
//   PV of tile j); s = q k^T, 48 wgmma m64n64k16 from shared memory; p
//   split into three register A terms for o += p v, 24 wgmma m64n128k16.
//   198 KB of shared memory, 384 threads, one block an SM; setmaxnreg
//   moves registers from the converter (104) to the consumers (200).
// - dk/dv: 64 keys a block, the K and V terms resident (96 KB), which
//   leaves room for one consumer warpgroup and two 48 KB stages of 32-row
//   Q and dO terms with their lse and delta; s^T = k q^T and dp^T = v dO^T,
//   48 wgmma m64n32k16 each, p^T and ds^T split into register A terms for
//   dv += p^T dO and dk += ds^T q, 12 wgmma m64n128k16 each. 198 KB, 256
//   threads, one block an SM, registers unsplit (up to 255).
// - dq: dk/dv's mirror image. 64 query rows a block, the Q and dO terms
//   resident (96 KB) with the rows' lse and delta in registers, one
//   consumer and two 48 KB stages of 32-key K and V terms; s = q k^T and
//   dp = dO v^T, 48 wgmma m64n32k16 each, ds split into register A terms
//   for dq += ds k, 12 wgmma m64n128k16 (k's terms MN-major). 198 KB, 256
//   threads, one block an SM, registers unsplit.
// - head dims 256 to 2048 (the same three kernels, instances <256>, <384>,
//   <512> and, for every head dim from 640 to 2048, <SPLIT3_ANY>, whose
//   cluster size is a launch attribute; <128> above): past D 128 the
//   layouts above would not fit a block: at 256 the forward's 128 resident
//   Q rows as terms take 192 KB, dk/dv's resident K and V terms of 64 keys
//   192 KB (and dk and dv of 64 x 256 floats would be 256 registers a
//   thread), dq's resident Q and dO terms 192 KB, against the 227 KB
//   (232,448 bytes) a block may have. So the depth is split over a thread
//   block cluster of NB = D / 128 blocks (2 to 16: head dims 256 to 2048;
//   past 8 Hopper's non-portable cluster sizes, which a kernel takes once
//   its cudaFuncAttributeNonPortableClusterSizeAllowed is set) on the same
//   rows: block rank r owns columns 128r .. 128r + 127 and runs the D 128
//   layout above on them (its Q, K, V and dO terms are those 128 columns),
//   so every product from shared memory, every
//   tile and (but for the exchange) every register stays as at D 128. Each
//   consumer warpgroup forms its partial of s (dq and dk/dv: of s and dp)
//   over its 128 columns from zero (the six products) and the cluster adds
//   the NB partials (Exchange: 32 floats a thread, 16 KB, one a consumer);
//   every block then holds the same bits of s and dp, hence of m, l, p and
//   ds, and accumulates only its own columns: o in the forward, dq, dk and
//   dv; no score product is done twice. At 256 (a pair) each stores its
//   partial with st.shared::cluster into the same warpgroup's buffer in the
//   peer, arrives on the peer's mbarrier, waits for the peer's partial in
//   its own buffer and adds it to its own in one float add an element: IEEE
//   addition commutes, so both hold the same sum. With three or more
//   partials the order matters (addition does not associate), so from 384
//   each block stores its partial in its own slot, arrives on full in
//   every peer (release at cluster scope), waits until every peer has
//   arrived on its own full ((NB - 1) x 128 threads), reads the peers'
//   slots with ld.shared::cluster and adds all NB in rank order, ((p0 +
//   p1) + p2) + .., the same operands in the same order in every block,
//   then arrives on empty in every peer. At 384 and 512 each element
//   group's peer loads are unrolled together; from 640 (five to sixteen
//   blocks) the sum runs rank by rank in a loop that is not unrolled, one
//   rank's loads in flight at a time (unrolled, seven peers' would be in
//   flight at 1024, and spill); the mbarriers count (NB - 1) x 128
//   arrivals, 1,920 at 16 blocks. <SPLIT3_ANY> (640 to 2048: the forward,
//   dq and dk/dv) instead adds them as a reduce-scatter
//   (reduce_scatter_partials): each block sums one slice of the groups
//   from all NB slots in the same rank order, in place, and every block
//   reads each group back from its owner, so the sums keep their bits and
//   the remote reads fall from (NB - 1) x 16 KB to 2 (NB - 1) / NB x 16 KB
//   an exchange; <384> and <512> keep the all-gather. Shared memory, the
//   same at every head dim past 128: the forward's 197,664 bytes + two
//   exchanges (16 KB each, one a consumer) = 230,464; dq 197,664 + 16,400
//   = 214,064; dk/dv 198,176 + 16,400 = 214,576; at <SPLIT3_ANY> each
//   exchange is an ExchangeRS, 16 bytes more (230,496, 214,080 and
//   214,592). The exchange costs per tile: forward 16 KB
//   out of a block a consumer (64 x 64 floats) and (NB - 1) x 16 KB in, dq
//   and dk/dv the same for two 64 x 32 tiles, against a block's 25.2 MFLOP
//   (forward), 9.4 (dq) and 12.6 (dk/dv) of six-pass products a tile. A
//   slot is rewritten only after every reader arrived on its empty
//   barrier, mbarriers arrive with release and wait with acquire at
//   cluster scope, a cluster barrier after the barriers' init precedes
//   every remote arrival, and each warpgroup waits, after its last
//   exchange, until every peer has read it, so no block exits while a
//   peer may still reach its shared memory. A cluster of four blocks of
//   210-230 KB takes four SMs of one GPC: the card holds 30 at once (39 of
//   three, 66 pairs; 22 of five, 17 of six, 15 of seven and of eight;
//   cudaOccupancyMaxActiveClusters on an H100 SXM, chip_smoke.py's build
//   line). Only rank 0 writes lse.
// - head dims 2176 and 2304 (flash_{fwd,dq,dkv}_shares3_kernel<192>, one
//   instance each, the head dim a launch argument): past sixteen 128-column
//   blocks, twelve blocks on shares of whole 64-column boxes of at most 192
//   columns (2304 = 12 x 192, 2176 = 10 x 192 + 2 x 128), on 64 rows (keys)
//   a block with 32-key forward and 16-row backward tiles; the section
//   before allow_smem says how they fit.
//
// bfloat16 and float16, on the tensor cores: Hopper's TMA and warpgroup
// wgmma (building blocks in sm90.cuh), each kernel a template on the 16-bit
// element type T and the head dim (<__nv_bfloat16, 128>, <__nv_bfloat16,
// 256>, <__half, 128>, <__half, 256>; the two types take the same tiles,
// descriptors, instruction shapes and rate, and differ only where the
// float16 paragraph below says). A block is three warpgroups: a producer
// whose one thread keeps
// TMA loads in flight through a ring of shared-memory stages (full/empty
// mbarriers, its registers given up with setmaxnreg), and two consumers
// that own 64 rows each and run wgmma with float accumulators in
// registers, 64 x 128 tiles of 64 floats a thread (o and dq at D 256 are
// two). A head row of D 256 is four 64-column boxes, so every tile's
// shared memory doubles at the same rows; each kernel halves its streamed
// tiles or its stages to stay under the 227 KB a block may have:
// - forward (flash_fwd_sm90_kernel): 128 query rows a block, Q loaded once,
//   K and V tiles through 2 stages: 128 keys at D 128 (160 KB), 64 at D 256
//   (Q 64 KB + 2 x 64 KB = 192 KB); s = q k^T from shared memory, the
//   online softmax on the accumulators, p rounded to bf16 straight into the
//   A registers of o += p v (at D 256 two m64n128 products a depth slice,
//   one a half of o).
// - dq (flash_dq_sm90_kernel): 128 query rows a block, Q and dO loaded once
//   with the rows' lse and delta in registers, K and V tiles through 3
//   stages: 64 keys at D 128 (160 KB), 32 at D 256 (Q and dO 128 KB + 3 x
//   32 KB = 224 KB); s = q k^T and dp = dO v^T from shared memory, p and ds
//   in registers, dq += ds k with ds as the register A operand and k
//   MN-major (two products at D 256, one a half of dq).
// - dk/dv (flash_dkv_sm90_kernel): K and V loaded once, 64-row Q and dO
//   tiles (TMA) with their lse and delta (plain loads: a [B*H, L] row need
//   not start on 16 bytes) through the ring; s^T = k q^T and dp^T = v dO^T
//   from shared memory, p^T and ds^T in registers, dv += p^T dO and dk +=
//   ds^T q with p^T and ds^T as register A operands. D 128: 128 keys a
//   block, each consumer 64 of them with all 128 columns, 3 stages (162
//   KB). D 256: 64 keys x 256 columns of dk and dv would be 256 floats a
//   thread, so both consumers take the block's 64 keys and split the
//   columns (consumer c accumulates dk and dv columns 128c ..), each forming
//   s^T and dp^T over the whole depth itself (twice the score products, for
//   no exchange between them); 2 stages (194 KB).
// - head dims 384 to 4096: a head row of 512 is 1 KB, so 128 resident Q
//   rows take 128 KB and one 64-key K + V stage 128 KB, and o, dq or dk/dv
//   of 64 rows x 512 would be 256 floats a thread. So the depth is split
//   over a thread block cluster of NB = ceil(HD / 256) blocks on the same
//   rows (keys), as the float32 kernels split it from 256, each block
//   owning a share of whole 64-column boxes, at most four (256 columns, the
//   HD 256 layouts' shared memory): at 384 and 512 a pair, each on HD / 2
//   columns (flash_{fwd,dq,dkv}_pair_kernel<T, 384|512>); from 640 to 4096
//   three to sixteen blocks whose shares differ by at most one box, the
//   wider first (flash_{fwd,dq,dkv}_cluster_kernel<T, 256>: 640 = 256 +
//   192 + 192, 896 = 2 x 256 + 2 x 192, 1152 = 3 x 256 + 2 x 192, 2176 = 7
//   x 256 + 2 x 192, 3968 = 14 x 256 + 2 x 192; 768, 1024, 1280, .., 4096
//   all 256; share16_units; past eight blocks Hopper's non-portable cluster
//   sizes). Of
//   the two plans with at most 256 columns a block, this one and 256-column
//   blocks with a narrower last one (640 = 256 + 256 + 128), both give the
//   same blocks and the same widest block, which sets a cluster's time; the
//   even one keeps every block at three or four boxes, so one template body
//   of each serves every head dim. (Equal shares, the fewest blocks whose
//   share is whole boxes, took 640 and 896 to five and seven blocks of 128
//   columns, 2-4x slower, and found no cluster of eight or fewer at 1408,
//   1664 and 1920.) Block rank r runs the HD 256 layouts above on its
//   columns: the forward's 64-key tiles; dq's 32-key tiles in 2 stages
//   rather than 3, to make room for two 16 KB exchanges; dk/dv's 64 keys a
//   block with the consumers splitting the columns of dk and dv, but 32-row
//   Q and dO tiles (3 stages): s^T and dp^T of 64 rows would be 64 floats a
//   thread beside dk and dv's 128, and spill. Each consumer forms its
//   partial s (and dp) over the block's columns and the cluster adds the
//   NB partials through the same consumer's Exchange in every block, as the
//   float32 clusters do: a pair sends its partial to the peer and adds the
//   peer's (IEEE addition commutes), three to sixteen blocks add all NB in
//   rank order, rank by rank (add_cluster_partials_n; the forward as a
//   reduce-scatter of the same sums, reduce_scatter_partials; NB a launch
//   argument: one instance of each cluster kernel per type serves every
//   head dim from 640 to 4096, each block running the body for its own
//   share, three or four boxes, a template on it). So every block holds the
//   same bits of s and dp, no score product is done twice across the
//   cluster, and every block accumulates only its own columns (in dk/dv both
//   consumers of a block form the same partials, as at 256). Accumulators
//   are 64 x 64 units (m64n64k16 with A from registers), one a box: dk/dv's
//   consumer 0 takes the first half of the block's units, rounded up,
//   consumer 1 the rest (two and two at 256 columns, two and one at 192).
//   Shared memory at 256 columns: forward and dq 230,488 bytes, dk/dv
//   198,488 (of 232,448), laid out for 256 columns in every block of a
//   cluster kernel (each Exchange at the same offset in every block).
//   Products issued / needed: forward 2 / 2 (s, PV), dq 4 / 3 (ds's two
//   terms), dk/dv 8 / 4 (both consumers' s^T and dp^T, the two terms of p^T
//   and of ds^T). 1/sqrt(D) is not exact in float past 256 (it is at 128
//   and 256); it is the float nearest, as in the JAX kernels.
// Tensor maps cover the 4-D (D, H, N, B) view with the real strides, so rows
// past L read as TMA's zeros (never the next batch's rows; the float32
// converters write zeros there) and are masked or not stored. Only tiles
// that cross the diagonal or the ragged end are masked; tiles past the
// diagonal are not loaded.
// s and dp take bf16 operands, whose products are exact in float. The
// backward's float p and ds enter the tensor cores as two bf16 terms, hi +
// mid (split2), so that the backward still multiplies in float to within
// 2^-16 of each product (hi is within 2^-8 of x, mid within 2^-8 of x - hi):
// a sum is off by under 2^-16 of the sum of its terms' sizes, against the
// check's tolerance of one bf16 step (2^-7) of the output plus 1e-2 of the
// row's rms (tests/test_torch_llm.py emulates the split on the CPU: dq, dk
// and dv within ~1e-3 of that tolerance of their float values). Two terms
// make dq 4 products where the function needs 3, and dk/dv 6 where it
// needs 4.
//
// float16 (the <__half, HD> instances): q, k, v and dO as float16, whose
// products are exact in float too. The forward rounds p to float16 with
// no scale, to nearest with subnormals kept (cvt.rn.f16x2.f32, no .ftz):
// JAX's p.astype(v.dtype) (flash_attention.py:79), whose p under 2^-25
// vanishes as here. The backward forms p and ds in float, as JAX does from
// its widened inputs (:144-147, :184-187), and splits them into float16
// terms hi + mid: 11 bits each, 22 together, but float16's range ends at
// 2^-14 (normal) and 2^-24 (subnormal), and an SFT step's ds (a loss
// averaged over ~16k positions: |dO| ~ 1e-5 .. 1e-7) lies far below it.
// So the split runs on exactly scaled values and the scale is undone on
// the float accumulators at the store: p^T (dv's A operand) times 2^14
// (p <= 1, so hi <= 2^14, 4x under 65504), ds (dq's and dk's) times 2^e
// per accumulator row, e chosen from the data as the forward's online max
// is: a tile row's max |ds| m sets 14 - floor(log2 m), the row keeps the
// least e seen so far, and a drop rescales the row's accumulators by the
// exact power of two 2^(new - old) (scale_ds_rows). So every scaled ds is
// under 2^15 (no term overflows), every ds of 2^-60 m or more keeps 22
// bits (|r| <= 2^-22 |x| + 2^-25 in the scaled units), and a cotangent as
// small as float16 holds gives dq, dk and dv as exact as an ordinary one
// (chip_smoke.py checks B2 L1000 with dO x 2^-16 and x 2^4;
// tests/test_torch_flash_f16.py emulates the arithmetic on the CPU). The
// cost: a quad max, a warp vote, a few integer operations and 16-32
// multiplies a consumer thread and tile, and 64 more (128 for dq at 256) in
// a tile where a row's scale falls, beside the same products as bf16.
//
// Every kernel: every sum runs in a fixed order (no atomics), so two
// launches repeat bit for bit. Ragged edges (L or S not a multiple of the
// tile) are masked in the kernel, not padded by the caller. Work per block
// grows with the query index (causal), so the forward and dq start the last
// query tiles first, and dk/dv the first key tiles; the query (key) tile
// index is the grid's fastest axis, so the blocks in flight share one
// head's K and V (Q and dO) in L2.
//
// What bounds it on an H100 (D 256 alike: at B2 L2047 H8 D256 the bounds
// are 0.035 ms forward, 0.052 dq, 0.069 dk/dv; there dk/dv runs 8
// products of its 4, the two terms of p^T and ds^T and both consumers'
// score products, so it reaches at most half its bound): at B8 L2047 H32
// D128 the forward does 2.75e11
// causal FLOP against 2.1e8 bytes of q/k/v/o, so the arithmetic bounds it:
// 0.278 ms at the 989 TFLOP/s bf16 tensor-core rate; in float32, 1.667 ms
// for the six bf16 passes that keep float32 accuracy on the tensor cores
// (4.10 ms on the float cores at 67 TFLOP/s); dq and dk/dv do 1.5x and 2x
// the forward's products (float32: 2.500 and 3.334 ms; 6.15 and 8.20 on
// the float cores). The float32 split kernels reach 57% (forward), 44%
// (dq) and 52% (dk/dv) of their six-pass bounds (chip_smoke.py on an H100
// at 700 W): all read both operands of their score products from shared
// memory (m64n32 in dq and dk/dv, 3 KB a product: 1.5x the bytes a FLOP
// of the forward's m64n64), the converter's term stores (48 KB a tile)
// share that bandwidth, and the one consumer of dq and dk/dv leaves the
// tensor cores idle while it works on p and ds (dq, with 12 register-A
// products a tile to dk/dv's 24, has less work to hide it behind). The
// Hopper kernels run each consumer's steps in order (scores, softmax,
// products): the tensor cores wait while a warpgroup works on its
// registers unless the other warpgroup fills the gap. FlashAttention-3's
// ping-pong of the two consumers and its overlap of one tile's softmax
// with the next tile's scores are the next steps.
//
// ptxas -v (CUDA 12.8, sm_90a; chip_smoke.py prints it on its build line):
// the three 16-bit Hopper kernels, bf16 and float16, <128> and <256>
// alike, 168 registers at launch (384 threads, one block an SM; setmaxnreg
// then gives the consumers 240 (forward, dq) and 232 (dk/dv), the producer
// 24 (forward, dq) and 40 (dk/dv)); for the bf16 dk/dv instances ptxas
// reports their wgmma serialised for want of registers (C7512), not for
// the float16 ones (at 256 the float16 dk/dv runs ~7% faster, at 128 the
// two are within noise);
// flash_fwd_split3_kernel 168 at launch (consumers 200, converter 104) at
// every head dim, flash_dkv_split3_kernel 222 (<128>), 244 (<256>), 254
// (<384>), 255 (<512>) and 252 (<SPLIT3_ANY>, 640 to 2048: the
// reduce-scatter with eight ranks' loads in flight),
// flash_dq_split3_kernel 137, 142, 212 and 238 (the rank-order sum's loads
// of the peers' partials in flight together) and 174 at <SPLIT3_ANY> (the
// reduce-scatter, eight ranks' loads in flight); the 16-bit pair and
// cluster kernels (384 to 4096, both types) 168 at launch, consumers 240
// (forward, dq) and 232 (dk/dv); no spills, no stack frames (at 256
// columns with three or more blocks only because their sum runs rank by
// rank: unrolled over the peers it spilled 8-156 bytes).
//
// At head dims 512 and 384 the pairs take 1.29 / 2.31 / 4.56 ms and 1.20 /
// 2.12 / 4.07 ms in bf16 at B8 L2047 H8 (float16 within 5%; chip_smoke.py
// on an H100 at 700 W): 21% / 18% / 12% and 17% / 15% / 10% of their
// bounds. Each consumer runs its tile's scores, the exchange with the peer
// and its p and ds in turn, in step with the other consumer, so the
// tensor cores idle through every exchange; dk/dv on 64-row tiles ran
// 16-44% faster, but spilled. The cluster kernels take 1.72 / 3.19 / 5.95,
// 1.73 / 3.24 / 6.26, 2.91 / 5.60 / 10.59 and 3.01 / 5.78 / 11.10 ms in
// bf16 at B8 L2047 H4 at head dims 640, 768, 896 and 1024 (float16 within
// 4%; llm/flash_bench.py --phases wide16 on an H100 at 700 W): 10 / 8 / 6%
// of their bounds at 640, 9 / 7 / 5% at 1024; a cluster's time is a
// 256-column block's, whatever the narrower ones hold. At 2048 (B8 L2047
// H2, H4 D1024's operations, eight blocks) 6.18 / 11.88 / 22.06 ms: 4.5 /
// 3.5 / 2.5% of the bounds, each exchange waiting for seven peers; at 4096
// (B8 L2047 H1, the same operations, sixteen blocks) 13.30 / 25.67 / 46.43
// ms in bf16, 13.26 / 25.70 / 45.01 in float16 (flash_bench --phases
// clusters16 on an H100 at 700 W): 2.1 / 1.6 / 1.2% of the bounds, twice
// D2048's, each exchange waiting for fifteen peers. The card holds 9
// clusters of nine 230 KB blocks at once and 7 of ten to sixteen.
//
// At head dim 256 the float32 kernels take 0.62 / 1.16 / 1.30 ms (forward /
// dq / dk/dv) at B2 L2047 H8 D256 (chip_smoke.py on an H100 at 700 W): 34%
// / 27% / 32% of their six-pass bounds (0.208 / 0.313 / 0.417 ms). The same
// kernels at head dim 128 over the same blocks of the same work (B2 L2047
// H16, llm/flash_bench.py's d128_same_blocks) take 0.50 / 0.80 / 0.93 ms
// against 0.64 / 1.18 / 1.32 in the same runs, so the exchange and the two
// blocks' lock step cost 29% (forward), 48% (dq) and 42% (dk/dv): a
// consumer waits for its peer's partial with the tensor cores idle. Issuing
// the next tile's score products before the exchange would hide it (dq has
// the registers; dk/dv, at 244, would need its p^T and ds^T terms made in
// two halves). At head dims 512 and 384 (clusters of four and three) they
// take 1.78 / 4.11 / 4.40 ms and 1.23 / 2.57 / 2.85 ms at B2 L2047 H8
// (chip_smoke.py on an H100 at 700 W): 23 / 15 / 19% and 25 / 18 / 22% of
// their six-pass bounds, 2.2 / 2.8 / 2.6x and 1.9 / 2.3 / 2.2x the <128>
// kernels over the same blocks (flash_bench's d128_same_blocks_D512,
// _D384). Each consumer waits for the slowest of three peers and makes six
// remote arrivals and 24 remote 16-byte reads an exchange (four blocks);
// dq, with the least work a tile, loses most. At head dims 640 to 1024
// (clusters of five to eight) they take 1.66 / 3.78 / 3.96 ms (D 640) up
// to 3.47 / 7.77 / 8.07 ms (D 1024) at B2 L2047 H4 (chip_smoke.py on an
// H100 at 700 W): 16 / 10 / 13% down to 12 / 8 / 10% of their six-pass
// bounds, and at D 1024 slower than SDPA's float32 forward (2.34 ms) and
// backward (7.88 for dq, dk and dv together) and than the plain versions'
// dq and dk/dv (5.34, 6.73): each exchange waits for the slowest of seven
// peers and reads seven 16 KB partials, rank after rank. <SPLIT3_ANY>,
// whose NB is read from the cluster, runs 640-1024 within 4% of the
// instances <640>..<1024> it replaced (flash_bench --phases clusters16 in
// turns on an H100 at 700 W), and at 2048 (B2 L2047 H2, sixteen blocks)
// takes 7.12 / 15.40 / 15.87 ms, twice D 1024 at H4, 6 / 4 / 5% of the
// six-pass bounds. With the exchange a reduce-scatter (each block sums one
// slice, below) they take 1.49-1.59 / 3.34-3.46 / 3.57-3.67 ms at D 1024
// (H4) and 1.84-1.91 / 3.95-4.02 / 4.18-4.35 ms at 2048 (H2): 26-28 / 18-19
// / 23% and 22-23 / 16 / 19-20% of the six-pass bounds, under SDPA's
// forward (2.28, 3.21 ms) and the shares of its backward that dq (3/7) and
// dk/dv (4/7) stand for (flash_bench --phases exchange,clusters16 --rounds
// 3, A B B A three times, on an H100 at 700 W).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "sm90.cuh"

namespace {

constexpr int D = 128;        // the float32 kernels' columns a block
constexpr float NEG_INF = -1e30f;

// element offset of row `row`, head h, batch b of a [B, N, H, HD] tensor
template <int HD = D>
__device__ __forceinline__ int64_t offset(int b, int row, int h, int N,
                                          int H) {
  return ((static_cast<int64_t>(b) * N + row) * H + h) * HD;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// lo and hi rounded to nearest float16 (subnormals kept: cvt.rn without
// .ftz) as a pair, low half first
__device__ __forceinline__ uint32_t pack_f16(float lo, float hi) {
  __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// a pair of floats as an A-register pair of the 16-bit type T
template <typename T>
__device__ __forceinline__ uint32_t pack16(float lo, float hi) {
  if constexpr (sm90::is_f16<T>)
    return pack_f16(lo, hi);
  else
    return pack_bf16(lo, hi);
}

// ------------------------------- bfloat16 on Hopper: TMA + wgmma, forward,
// dq and dk/dv, each a template on the head dim HD (128 or 256). Three
// warpgroups a block: warpgroup 0 is the producer (its registers cut; one
// thread keeps TMA loads in flight through a ring of stages, each with a
// full and an empty mbarrier), warpgroups 1 and 2 are consumers (registers
// raised) that own 64 rows each and run wgmma on the tiles that have
// arrived, from shared memory and from registers. A consumer's float
// accumulators are 64 x 128 tiles (64 floats a thread): at HD 256 the
// forward and dq hold two of them (o and dq 64 x 256), and dk/dv gives each
// consumer one 128-column half of dk and of dv.
constexpr int WG = 128;                    // threads per warpgroup
constexpr int SM90_THREADS = 3 * WG;
// the float32 kernels' tiles (a term of 128 or 64 rows of a D-128 head)
constexpr int TILE_BYTES = 128 * D * 2;    // 128 rows: two boxes
constexpr int BOX128 = TILE_BYTES / 2;     // 128 rows x 64 columns
constexpr int QTILE_BYTES = 64 * D * 2;    // 64 rows
constexpr int BOX64 = QTILE_BYTES / 2;
constexpr int ROW_BYTES = 64 * 2;          // one swizzled box row
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr size_t MAX_SMEM = 232448;        // a block's dynamic shared memory

// the first 1024-byte boundary at or after p (the swizzle's atom)
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// Descriptors are made once per loop step (sm90::opaque keeps the compiler
// from hoisting one register pair per depth slice out of the loop) and
// stepped by adding a byte offset / 16 to their start address.
// K-major operand whose rows start at `rows`; depth slice kk of a tile whose
// 64-column boxes lie `box` bytes apart is k_major(rows) + k_step(box, kk)
__device__ __forceinline__ uint64_t k_major(const unsigned char* rows) {
  return sm90::opaque(sm90::desc_sw128(rows, 16, 1024));
}
__device__ __forceinline__ uint64_t k_step(int box, int kk) {
  return ((kk / 4) * box + (kk % 4) * 32) >> 4;
}

// MN-major operand (transposed B) of a tile, 128 output columns spanning two
// boxes from `tile`; rows 16kk .. 16kk + 15 are mn_major(...) + mn_step(kk)
__device__ __forceinline__ uint64_t mn_major(const unsigned char* tile,
                                            int box) {
  return sm90::opaque(sm90::desc_sw128(tile, box, 1024));
}
__device__ __forceinline__ uint64_t mn_step(int kk) {
  return (kk * 16 * ROW_BYTES) >> 4;
}

// x and y as pairs hi and mid of the 16-bit type T with x = hi.x + mid.x +
// r: bf16, |r| <= 2^-16 |x|; float16 (for |x| < 2^15, as the scales below
// keep it: no term overflows 65504), |r| <= 2^-22 |x| + 2^-25 (mid's
// rounding, subnormals kept)
template <typename T>
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi,
                                       uint32_t& mid) {
  if constexpr (sm90::is_f16<T>) {
    const __half2 h = __floats2half2_rn(x, y);
    const float2 hf = __half22float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    mid = pack_f16(x - hf.x, y - hf.y);
  } else {
    const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
    const float2 hf = __bfloat1622float2(h);
    hi = *reinterpret_cast<const uint32_t*>(&h);
    mid = pack_bf16(x - hf.x, y - hf.y);
  }
}

// Float16's exponent range (normal from 2^-14, subnormal down to 2^-24)
// would lose the backward's small p and ds, so the float16 backward splits
// p 2^P16_E and ds 2^e, both exact powers of two undone on the float
// accumulators at the store (pow2). p <= 1 (to rounding) takes the fixed
// 2^14 (4x headroom under 65504); ds takes a scale per accumulator row
// (scale_ds_rows).
constexpr int P16_E = 14;
constexpr int DS16_E0 = 74;   // a row's scale before its first nonzero ds

// 2^e as a float, e in [-126, 127]
__device__ __forceinline__ float pow2(int e) {
  return __uint_as_float(static_cast<uint32_t>(127 + e) << 23);
}

// The float16 backward's ds scale: a thread's ds values v (row (i / 2) & 1:
// rows row and row + 8 of the 64-row tile, a row spread over the 4 threads
// of a quad) times 2^e[r], where e[r] is the least over the row's tiles so
// far of 14 - floor(log2 m), m the tile row's max |ds| clamped to [2^-60,
// 2^60]: so |v| < 2^15 and every split term stays under 65504, and a ds of
// 2^-60 m or more keeps its 22 bits. e[r] only falls (from DS16_E0), within
// [-46, 74]; rescale[r] = 2^(new - old) >= 2^-120, by which the caller
// multiplies the row's float accumulators, exactly, to keep them on the
// row's scale (as the forward rescales o by alpha), when this returns true:
// some row of the warp's changed its scale (a warp vote: after a row's
// first tiles its scale seldom falls; with the rescale in every tile dq
// took 1.47 ms at B8 L2047 H32 D128, with the vote 1.12-1.14, bf16 1.01-
// 1.12 in the same runs on an H100 at 700 W). |ds| <= p |dp - delta| /
// sqrt(D) <= 2 sqrt(D) 65504^2 < 2^39 for any finite float16 inputs at
// every D the kernels take, up to 4096 (|dp|, |delta| <= D 65504^2 < D
// 2^32), so the clamp at 2^60 never binds.
template <int N>
__device__ __forceinline__ bool scale_ds_rows(float (&v)[N], int (&e)[2],
                                              float (&rescale)[2]) {
  float mx[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i)
    mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], fabsf(v[i]));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    mx[r] = fminf(fmaxf(mx[r], 0x1p-60f), 0x1p60f);
    const int en = min(
        e[r], 14 - (static_cast<int>(__float_as_uint(mx[r]) >> 23) - 127));
    rescale[r] = pow2(en - e[r]);
    e[r] = en;
  }
  const float sc[2] = {pow2(e[0]), pow2(e[1])};
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] *= sc[(i / 2) & 1];
  return __any_sync(0xffffffffu, rescale[0] != 1.f || rescale[1] != 1.f);
}

// a pair of adjacent output columns in the output type T
__device__ __forceinline__ uint32_t pack_pair(const __nv_bfloat16*, float lo,
                                              float hi) {
  return pack_bf16(lo, hi);
}
__device__ __forceinline__ uint32_t pack_pair(const __half*, float lo,
                                              float hi) {
  return pack_f16(lo, hi);
}
__device__ __forceinline__ float2 pack_pair(const float*, float lo, float hi) {
  return make_float2(lo, hi);
}

// rows row and row + 8 of a 64 x 2NA float accumulator (NA floats a
// thread: 64 for 128 columns, 32 for 64), scaled by inv[r], into columns
// col0 .. of head h of a [B, N, H, HD] tensor of T (bf16, float16 or
// float); rows past N are not stored
template <typename T, int HD = D, int NA>
__device__ __forceinline__ void store_acc_rows(T* dst, int b, int h, int N,
                                               int H, int row, int t,
                                               const float (&acc)[NA],
                                               const float (&inv)[2],
                                               int col0 = 0) {
  using Pair = decltype(pack_pair(dst, 0.f, 0.f));
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row + 8 * r >= N) continue;
    Pair* out = reinterpret_cast<Pair*>(
        dst + offset<HD>(b, row + 8 * r, h, N, H) + col0);
#pragma unroll
    for (int n = 0; n < NA / 4; ++n)
      out[n * 4 + t] = pack_pair(dst, acc[4 * n + 2 * r] * inv[r],
                                 acc[4 * n + 2 * r + 1] * inv[r]);
  }
}

// rows row0 .. of head h, batch b, columns col0 .. col0 + W - 1, into a
// tile of W / 64 boxes `box` bytes apart, one TMA load a box, completing on
// `bar`
template <int W>
__device__ __forceinline__ void load_rows(unsigned char* dst, int box,
                                          const CUtensorMap* map,
                                          uint64_t* bar, int h, int row0,
                                          int b, int col0 = 0) {
#pragma unroll
  for (int c = 0; c < W / 64; ++c)
    sm90::tma_load_4d(dst + c * box, map, bar, col0 + 64 * c, h, row0, b);
}

constexpr int FWD_ROWS = 128;   // query rows per block
constexpr int FWD_STAGES = 2;
// keys per K or V tile: 128 at HD 128, 64 at HD 256 (a K + V stage is 64 KB
// at both)
__host__ __device__ constexpr int fwd_keys(int hd) {
  return 128 * 128 / hd;
}

struct FwdBars {
  uint64_t q_full, k_full[FWD_STAGES], v_full[FWD_STAGES], empty[FWD_STAGES];
};
template <int HD>
constexpr size_t fwd_sm90_smem() {
  return 1024 +
         static_cast<size_t>(FWD_ROWS + 2 * FWD_STAGES * fwd_keys(HD)) * HD *
             2 +
         sizeof(FwdBars);
}
static_assert(fwd_sm90_smem<256>() <= MAX_SMEM, "forward at HD 256");

// forward, grid (ceil(L / FWD_ROWS), B*H): Q once, K and V tiles through the
// ring; s = q k^T (m64n128k16 at HD 128, m64n64k16 at 256; both operands
// K-major from shared memory), the online softmax on the accumulators (a
// row spans the 4 threads of a quad), p rounded to T (bf16 or float16, no
// scale: the rounding JAX makes) into the A registers of o += p v
// (m64n128k16 a 128-column half of o, v MN-major with the transpose bit).
// Key tiles wholly below the block's rows run unmasked; tiles past the
// diagonal are never loaded.
template <typename T, int HD>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          T* __restrict__ o,
                          float* __restrict__ lse, int H, int L, int S,
                          float scale) {
  constexpr int KEYS = fwd_keys(HD);
  constexpr int Q_BOX = FWD_ROWS * ROW_BYTES;     // 64 columns of Q's rows
  constexpr int KV_BOX = KEYS * ROW_BYTES;        // 64 columns of a K/V tile
  constexpr int Q_BYTES = HD / 64 * Q_BOX, KV_BYTES = HD / 64 * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);
  unsigned char* const Ks = Qs + Q_BYTES;                  // [stage]
  unsigned char* const Vs = Ks + FWD_STAGES * KV_BYTES;    // [stage]
  auto* bars = reinterpret_cast<FwdBars*>(Vs + FWD_STAGES * KV_BYTES);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = (min(S, q0 + FWD_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->q_full, 1);
    for (int st = 0; st < FWD_STAGES; ++st) {
      sm90::mbar_init(&bars->k_full[st], 1);
      sm90::mbar_init(&bars->v_full[st], 1);
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);   // consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&bars->q_full, Q_BYTES);
      load_rows<HD>(Qs, Q_BOX, &tq, &bars->q_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % FWD_STAGES;
        sm90::mbar_wait(&bars->empty[st], ((j / FWD_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars->k_full[st], KV_BYTES);
        load_rows<HD>(Ks + st * KV_BYTES, KV_BOX, &tk, &bars->k_full[st], h,
                      j * KEYS, b);
        sm90::mbar_arrive_expect_tx(&bars->v_full[st], KV_BYTES);
        load_rows<HD>(Vs + st * KV_BYTES, KV_BOX, &tv, &bars->v_full[st], h,
                      j * KEYS, b);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;                     // rows q0 + 64 cw ..
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 64 * cw + 16 * warp + g;   // and row + 8
  const unsigned char* const Qw = Qs + 64 * cw * ROW_BYTES;
  const float sl2 = scale * LOG2E;           // scores in log2 units
  float acc[HD / 128][64];                   // o, a 128-column half each
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[c][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  sm90::mbar_wait(&bars->q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % FWD_STAGES, k0 = j * KEYS;
    const uint32_t phase = (j / FWD_STAGES) & 1;
    const unsigned char* kt = Ks + st * KV_BYTES;
    const unsigned char* vt = Vs + st * KV_BYTES;
    float s[KEYS / 2];
    const uint64_t desc_q = k_major(Qw), desc_k = k_major(kt);
    sm90::mbar_wait(&bars->k_full[st], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_ss<T>(s, desc_q + k_step(Q_BOX, kk),
                        desc_k + k_step(KV_BOX, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);

#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) s[i] *= sl2;
    // the diagonal tile and a ragged last tile: key > row or key >= S
    if (k0 + KEYS - 1 > q0 + 64 * cw || k0 + KEYS > S) {
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (key > row + 8 * ((i / 2) & 1) || key >= S) s[i] = NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i)
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];                      // this thread's share of the sum
    }
#pragma unroll
    for (int c = 0; c < HD / 128; ++c) {
      sm90::fence_regs(acc[c]);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[c][i] *= alpha[(i / 2) & 1];
    }
    // p (float) into the row sums, p rounded to T into the A registers
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, half = r & 1;
        const float p0 = exp2f(s[i] - m[half]), p1 = exp2f(s[i + 1] - m[half]);
        l[half] += p0;
        l[half] += p1;
        pa[kk][r] = pack16<T>(p0, p1);
      }

    const uint64_t desc_v = mn_major(vt, KV_BOX);
    sm90::mbar_wait(&bars->v_full[st], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int c = 0; c < HD / 128; ++c)
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        sm90::wgmma_m64n128k16_rs<T>(acc[c], pa[kk],
                                     desc_v + ((2 * c * KV_BOX) >> 4) +
                                         mn_step(kk),
                                     1);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int c = 0; c < HD / 128; ++c) sm90::fence_regs(acc[c]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
    if (t == 0 && row + 8 * r < L)
      lse[static_cast<int64_t>(bh) * L + row + 8 * r] = m[r] * LN2 + logf(l[r]);
  }
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
    store_acc_rows<T, HD>(o, b, h, L, H, row, t, acc[c], inv, 128 * c);
}

constexpr int DKV_ROWS = 64;    // query rows per streamed tile
// keys per block: 128 at HD 128 (consumer c keys k0 + 64c .., every column
// of dk and dv), 64 at HD 256 (both consumers the block's 64 keys, consumer
// c columns 128c .. 128c + 127 of dk and dv, so that each keeps 64 x 128
// floats of each: 64 x 256 of both would be 256 registers a thread). At HD
// 256 the two consumers both form s^T and dp^T of the keys.
__host__ __device__ constexpr int dkv_keys(int hd) {
  return 128 * 128 / hd;
}
// stages of streamed Q and dO tiles: 3 at HD 128 (162 KB), 2 at 256 (194 KB)
__host__ __device__ constexpr int dkv_stages(int hd) {
  return hd == 128 ? 3 : 2;
}

template <int ST>
struct DkvBars {
  uint64_t kv_full, full[ST], empty[ST];
};
template <int ST, int ROWS = DKV_ROWS>
struct DkvStats {                // a streamed tile's lse and delta
  float lse[ST][ROWS], delta[ST][ROWS];
};
template <int HD>
constexpr size_t dkv_sm90_smem() {
  return 1024 +
         static_cast<size_t>(2 * dkv_keys(HD) +
                             2 * dkv_stages(HD) * DKV_ROWS) *
             HD * 2 +
         sizeof(DkvStats<dkv_stages(HD)>) + sizeof(DkvBars<dkv_stages(HD)>);
}
static_assert(dkv_sm90_smem<256>() <= MAX_SMEM, "dk/dv at HD 256");

// dk and dv, grid (ceil(S / keys), B*H): K and V once, 64-row tiles of Q and
// dO (TMA) with their lse and delta (plain loads by the producer warp: a
// [B*H, L] float row need not start on 16 bytes) through the ring, for the
// query rows >= k0. s^T = k q^T and dp^T = v dO^T (m64n64k16, all K-major
// from shared memory); p^T and ds^T in registers; dv += p^T dO and dk +=
// ds^T q (m64n128k16 over the consumer's 128 columns, A from registers as
// hi + mid terms of T, dO and q MN-major with the transpose bit; float16:
// the terms of p^T 2^P16_E and of ds^T on its rows' scales).
template <typename T, int HD>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int L,
                          int S, float scale) {
  constexpr int KEYS = dkv_keys(HD), ST = dkv_stages(HD);
  constexpr int K_BOX = KEYS * ROW_BYTES, Q_BOX = DKV_ROWS * ROW_BYTES;
  constexpr int K_BYTES = HD / 64 * K_BOX, Q_BYTES = HD / 64 * Q_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Ks = align1024(raw_smem);
  unsigned char* const Vs = Ks + K_BYTES;
  unsigned char* const Qs = Vs + K_BYTES;                // [stage]
  unsigned char* const Gs = Qs + ST * Q_BYTES;           // [stage] dO
  auto* stats = reinterpret_cast<DkvStats<ST>*>(Gs + ST * Q_BYTES);
  auto* bars = reinterpret_cast<DkvBars<ST>*>(stats + 1);
  const int k0 = blockIdx.x * KEYS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = k0 < L ? (L - k0 + DKV_ROWS - 1) / DKV_ROWS : 0;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->kv_full, 1);
    for (int st = 0; st < ST; ++st) {
      sm90::mbar_init(&bars->full[st], 32);            // the producer warp
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);  // consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer: its first warp
    sm90::setmaxnreg_dec<40>();
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    const float* const lse_bh = lse + static_cast<int64_t>(bh) * L;
    const float* const delta_bh = delta + static_cast<int64_t>(bh) * L;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&bars->kv_full, 2 * K_BYTES);
      load_rows<HD>(Ks, K_BOX, &tk, &bars->kv_full, h, k0, b);
      load_rows<HD>(Vs, K_BOX, &tv, &bars->kv_full, h, k0, b);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % ST, q0 = k0 + j * DKV_ROWS;
      sm90::mbar_wait(&bars->empty[st], ((j / ST) & 1) ^ 1);
      for (int r = lane; r < DKV_ROWS; r += 32) {
        const bool in = q0 + r < L;
        stats->lse[st][r] = in ? lse_bh[q0 + r] : 0.f;
        stats->delta[st][r] = in ? delta_bh[q0 + r] : 0.f;
      }
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&bars->full[st], 2 * Q_BYTES);
        load_rows<HD>(Qs + st * Q_BYTES, Q_BOX, &tq, &bars->full[st], h, q0,
                      b);
        load_rows<HD>(Gs + st * Q_BYTES, Q_BOX, &tg, &bars->full[st], h, q0,
                      b);
      } else {
        sm90::mbar_arrive(&bars->full[st]);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  const int cw = wg - 1;
  // this consumer's 64 keys (k0 + 64 kw ..) and 128 columns (128 half ..)
  const int kw = KEYS == 128 ? cw : 0, half = KEYS == 128 ? 0 : cw;
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = k0 + 64 * kw + 16 * warp + g;   // and key + 8
  const unsigned char* const Kw = Ks + 64 * kw * ROW_BYTES;
  const unsigned char* const Vw = Vs + 64 * kw * ROW_BYTES;
  const float sl2 = scale * LOG2E;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  int ds_e[2] = {DS16_E0, DS16_E0};          // float16: ds^T's row scales
  sm90::mbar_wait(&bars->kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % ST, q0 = k0 + j * DKV_ROWS;
    const unsigned char* qt = Qs + st * Q_BYTES;
    const unsigned char* gt = Gs + st * Q_BYTES;
    float s[32], dp[32];
    const uint64_t desc_k = k_major(Kw), desc_q = k_major(qt);
    const uint64_t desc_v = k_major(Vw), desc_g = k_major(gt);
    sm90::mbar_wait(&bars->full[st], (j / ST) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_m64n64k16_ss<T>(s, desc_k + k_step(K_BOX, kk),
                                  desc_q + k_step(Q_BOX, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      sm90::wgmma_m64n64k16_ss<T>(dp, desc_v + k_step(K_BOX, kk),
                                  desc_g + k_step(Q_BOX, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale; rows:
    // keys key + 8((i / 2) & 1), columns: query rows q0 + c
    const bool edge = k0 + 64 * kw + 63 > q0 || q0 + DKV_ROWS > L ||
                      k0 + KEYS > S;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);
      float p = exp2f(fmaf(s[i], sl2, -stats->lse[st][c] * LOG2E));
      if (edge) {
        const int kc = key + 8 * ((i / 2) & 1), qr = q0 + c;
        if (kc > qr || kc >= S || qr >= L) p = 0.f;
      }
      dp[i] = p * (dp[i] - stats->delta[st][c]) * scale;
      s[i] = p;
    }
    if constexpr (sm90::is_f16<T>) {   // p^T 2^P16_E, ds^T on its row scales
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= pow2(P16_E);
      float rescale[2];
      if (scale_ds_rows(dp, ds_e, rescale)) {
        sm90::fence_regs(dk_acc);
#pragma unroll
        for (int i = 0; i < 64; ++i) dk_acc[i] *= rescale[(i / 2) & 1];
      }
    }
    uint32_t a_hi[DKV_ROWS / 16][4], a_mid[DKV_ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < DKV_ROWS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], a_hi[kk][r],
                  a_mid[kk][r]);
    sm90::fence_regs(dv_acc);
    sm90::wgmma_fence();
    const uint64_t desc_gt = mn_major(gt + 2 * half * Q_BOX, Q_BOX);
#pragma unroll
    for (int kk = 0; kk < DKV_ROWS / 16; ++kk) {
      sm90::wgmma_m64n128k16_rs<T>(dv_acc, a_hi[kk], desc_gt + mn_step(kk),
                                   1);
      sm90::wgmma_m64n128k16_rs<T>(dv_acc, a_mid[kk], desc_gt + mn_step(kk),
                                   1);
    }
    uint32_t d_hi[DKV_ROWS / 16][4], d_mid[DKV_ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < DKV_ROWS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], d_hi[kk][r],
                  d_mid[kk][r]);
    sm90::fence_regs(dk_acc);
    sm90::wgmma_fence();
    const uint64_t desc_qt = mn_major(qt + 2 * half * Q_BOX, Q_BOX);
#pragma unroll
    for (int kk = 0; kk < DKV_ROWS / 16; ++kk) {
      sm90::wgmma_m64n128k16_rs<T>(dk_acc, d_hi[kk], desc_qt + mn_step(kk),
                                   1);
      sm90::wgmma_m64n128k16_rs<T>(dk_acc, d_mid[kk], desc_qt + mn_step(kk),
                                   1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(dv_acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  if constexpr (sm90::is_f16<T>) {   // the scales undone
    const float dk_inv[2] = {pow2(-ds_e[0]), pow2(-ds_e[1])};
    const float dv_inv[2] = {pow2(-P16_E), pow2(-P16_E)};
    store_acc_rows<T, HD>(dk, b, h, S, H, key, t, dk_acc, dk_inv, 128 * half);
    store_acc_rows<T, HD>(dv, b, h, S, H, key, t, dv_acc, dv_inv, 128 * half);
  } else {
    const float one[2] = {1.f, 1.f};
    store_acc_rows<T, HD>(dk, b, h, S, H, key, t, dk_acc, one, 128 * half);
    store_acc_rows<T, HD>(dv, b, h, S, H, key, t, dv_acc, one, 128 * half);
  }
}

constexpr int DQ_ROWS = 128;   // query rows per block
constexpr int DQ_STAGES = 3;
// keys per streamed K or V tile: 64 at HD 128, 32 at HD 256 (a tile is 16
// KB at both; Q and dO resident take 64 and 128 KB)
__host__ __device__ constexpr int dq_keys(int hd) {
  return 64 * 128 / hd;
}

struct DqBars {
  uint64_t qg_full, k_full[DQ_STAGES], v_full[DQ_STAGES], empty[DQ_STAGES];
};
template <int HD>
constexpr size_t dq_sm90_smem() {
  return 1024 +
         static_cast<size_t>(2 * DQ_ROWS + 2 * DQ_STAGES * dq_keys(HD)) * HD *
             2 +
         sizeof(DqBars);
}
static_assert(dq_sm90_smem<256>() <= MAX_SMEM, "dq at HD 256");

// dq, grid (ceil(L / DQ_ROWS), B*H): Q and dO once, K and V tiles (TMA)
// through the ring, for the keys <= the block's last row. s = q k^T and dp =
// dO v^T (m64n64k16 at HD 128, m64n32k16 at 256; all K-major from shared
// memory); p and ds in registers; dq += ds k (m64n128k16 a 128-column half
// of dq, A from registers as hi + mid terms of T (float16: of ds on its
// rows' scales), k MN-major with the transpose bit). lse and delta belong
// to the block's own rows, so each
// consumer thread loads its two rows' values into registers once. A
// consumer whose rows all lie before a tile's first key skips the tile's
// products (it still waits for the tile, so its arrivals on the empty
// barrier stay in step with the other consumer's).
template <typename T, int HD>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dq, int H, int L, int S,
                         float scale) {
  constexpr int KEYS = dq_keys(HD);
  constexpr int Q_BOX = DQ_ROWS * ROW_BYTES, KV_BOX = KEYS * ROW_BYTES;
  constexpr int Q_BYTES = HD / 64 * Q_BOX, KV_BYTES = HD / 64 * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);
  unsigned char* const Gs = Qs + Q_BYTES;                  // dO
  unsigned char* const Ks = Gs + Q_BYTES;                  // [stage]
  unsigned char* const Vs = Ks + DQ_STAGES * KV_BYTES;     // [stage]
  auto* bars = reinterpret_cast<DqBars*>(Vs + DQ_STAGES * KV_BYTES);
  const int q0 = (gridDim.x - 1 - blockIdx.x) * DQ_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = (min(S, q0 + DQ_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->qg_full, 1);
    for (int st = 0; st < DQ_STAGES; ++st) {
      sm90::mbar_init(&bars->k_full[st], 1);
      sm90::mbar_init(&bars->v_full[st], 1);
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);   // consumer warps
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 0) {   // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&bars->qg_full, 2 * Q_BYTES);
      load_rows<HD>(Qs, Q_BOX, &tq, &bars->qg_full, h, q0, b);
      load_rows<HD>(Gs, Q_BOX, &tg, &bars->qg_full, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % DQ_STAGES;
        sm90::mbar_wait(&bars->empty[st], ((j / DQ_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars->k_full[st], KV_BYTES);
        load_rows<HD>(Ks + st * KV_BYTES, KV_BOX, &tk, &bars->k_full[st], h,
                      j * KEYS, b);
        sm90::mbar_arrive_expect_tx(&bars->v_full[st], KV_BYTES);
        load_rows<HD>(Vs + st * KV_BYTES, KV_BOX, &tv, &bars->v_full[st], h,
                      j * KEYS, b);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;                     // rows r0 = q0 + 64 cw ..
  const int warp = threadIdx.x % WG / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * cw;
  const int row = r0 + 16 * warp + g;        // and row + 8
  const unsigned char* const Qw = Qs + 64 * cw * ROW_BYTES;
  const unsigned char* const Gw = Gs + 64 * cw * ROW_BYTES;
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];                      // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < L;
    const int64_t i = static_cast<int64_t>(bh) * L + row + 8 * r;
    lse2[r] = in ? lse[i] * LOG2E : 0.f;
    dl[r] = in ? delta[i] : 0.f;
  }
  // tiles whose first key lies past this consumer's last row add nothing
  const int my_tiles = (min(S, r0 + 64) + KEYS - 1) / KEYS;
  float acc[HD / 128][64];                   // dq, a 128-column half each
#pragma unroll
  for (int c = 0; c < HD / 128; ++c)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[c][i] = 0.f;
  int ds_e[2] = {DS16_E0, DS16_E0};          // float16: ds's row scales
  sm90::mbar_wait(&bars->qg_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % DQ_STAGES, k0 = j * KEYS;
    const uint32_t phase = (j / DQ_STAGES) & 1;
    const unsigned char* kt = Ks + st * KV_BYTES;
    const unsigned char* vt = Vs + st * KV_BYTES;
    sm90::mbar_wait(&bars->k_full[st], phase);
    sm90::mbar_wait(&bars->v_full[st], phase);
    if (j < my_tiles) {
      float s[KEYS / 2], dp[KEYS / 2];
      const uint64_t desc_q = k_major(Qw), desc_k = k_major(kt);
      const uint64_t desc_g = k_major(Gw), desc_v = k_major(vt);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss<T>(s, desc_q + k_step(Q_BOX, kk),
                          desc_k + k_step(KV_BOX, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk)
        sm90::wgmma_ss<T>(dp, desc_g + k_step(Q_BOX, kk),
                          desc_v + k_step(KV_BOX, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);

      // p = exp(s scale - lse), ds = p (dp - delta) scale; rows: queries
      // row + 8((i / 2) & 1), columns: keys k0 + c. Only a tile that crosses
      // this consumer's diagonal or the ragged end is masked.
      const bool edge = k0 + KEYS - 1 > r0 || k0 + KEYS > S;
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int r = (i / 2) & 1;
        float p = exp2f(fmaf(s[i], sl2, -lse2[r]));
        if (edge) {
          const int kc = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (kc > row + 8 * r || kc >= S) p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[r]) * scale;
      }
      if constexpr (sm90::is_f16<T>) {   // ds on its row scales
        float rescale[2];
        if (scale_ds_rows(dp, ds_e, rescale)) {
#pragma unroll
          for (int c = 0; c < HD / 128; ++c) {
            sm90::fence_regs(acc[c]);
#pragma unroll
            for (int i = 0; i < 64; ++i) acc[c][i] *= rescale[(i / 2) & 1];
          }
        }
      }
      uint32_t d_hi[KEYS / 16][4], d_mid[KEYS / 16][4];
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], d_hi[kk][r],
                    d_mid[kk][r]);
#pragma unroll
      for (int c = 0; c < HD / 128; ++c) sm90::fence_regs(acc[c]);
      sm90::wgmma_fence();
      const uint64_t desc_kt = mn_major(kt, KV_BOX);
#pragma unroll
      for (int c = 0; c < HD / 128; ++c)
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          const uint64_t bk = desc_kt + ((2 * c * KV_BOX) >> 4) + mn_step(kk);
          sm90::wgmma_m64n128k16_rs<T>(acc[c], d_hi[kk], bk, 1);
          sm90::wgmma_m64n128k16_rs<T>(acc[c], d_mid[kk], bk, 1);
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
#pragma unroll
      for (int c = 0; c < HD / 128; ++c) sm90::fence_regs(acc[c]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  if constexpr (sm90::is_f16<T>) {   // the row scales undone
    const float inv[2] = {pow2(-ds_e[0]), pow2(-ds_e[1])};
#pragma unroll
    for (int c = 0; c < HD / 128; ++c)
      store_acc_rows<T, HD>(dq, b, h, L, H, row, t, acc[c], inv, 128 * c);
  } else {
    const float one[2] = {1.f, 1.f};
#pragma unroll
    for (int c = 0; c < HD / 128; ++c)
      store_acc_rows<T, HD>(dq, b, h, L, H, row, t, acc[c], one, 128 * c);
  }
}

// ---------------------- float32 on Hopper: three bf16 terms, TMA-free, wgmma
// Every float operand x enters the tensor cores as three bf16 terms,
// x1 = bf16(x), x2 = bf16(x - x1), x3 = bf16(x - x1 - x2) (each rounded to
// nearest; the float subtractions are exact), and a product x y as the six
// term products whose indices add up to at most 4, the small ones first
// into the float accumulator: x3y1, x2y2, x1y3, x2y1, x1y2, x1y1
// (a_term / b_term below). Three 8-bit terms hold a float's 24 significand
// bits, and the dropped x2y3, x3y2 and x3y3 are within ~2^-23 |x y|: the
// TPU's float32 dots at Precision.HIGHEST (bf16_6x) do the same.

// the term of the A and of the B operand in product p (0..5) of the six
__device__ __forceinline__ constexpr int a_term(int p) {
  return p == 0 ? 2 : (p == 1 || p == 3) ? 1 : 0;
}
__device__ __forceinline__ constexpr int b_term(int p) {
  return p == 2 ? 2 : (p == 1 || p == 4) ? 1 : 0;
}
// descriptor offset of term `term` of an operand whose terms lie `bytes`
// apart
__device__ __forceinline__ constexpr uint64_t term_off(int bytes, int term) {
  return static_cast<uint64_t>(term * bytes) >> 4;
}

// x and y as three bf16 pairs t1 + t2 + t3 (low half x)
__device__ __forceinline__ void split3(float x, float y, uint32_t& t1,
                                       uint32_t& t2, uint32_t& t3) {
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(x, y);
  const float2 f1 = __bfloat1622float2(h1);
  const float rx = x - f1.x, ry = y - f1.y;
  const __nv_bfloat162 h2 = __floats2bfloat162_rn(rx, ry);
  const float2 f2 = __bfloat1622float2(h2);
  t1 = *reinterpret_cast<const uint32_t*>(&h1);
  t2 = *reinterpret_cast<const uint32_t*>(&h2);
  t3 = pack_bf16(rx - f2.x, ry - f2.y);
}

// Rows [row0, row0 + ROWS) of head h of a float [B, N, H, HD] tensor, its
// 128 columns from col0, as their three bf16 terms in shared memory: term s
// at dst + s * term, each a tile of two 64-column boxes `box` bytes apart
// in the 128-byte-swizzled layout that TMA writes and desc_sw128 reads (row
// r at r * 128 bytes, its 16-byte chunk c at chunk c ^ (r % 8)); rows past
// N as zeros. The 128 threads of a warpgroup (tid) each take the 8-column
// chunk tid % 16 of rows tid / 16 + 8 i; BATCH rows are loaded (16-byte
// loads, a warp on two whole rows of 128 columns) before they are split and
// stored (16-byte stores, a quarter warp on one swizzled row: no bank
// conflicts).
template <int ROWS, int BATCH, int HD>
__device__ __forceinline__ void split_rows(unsigned char* dst, int box,
                                           int term,
                                           const float* __restrict__ src,
                                           int b, int h, int N, int H,
                                           int row0, int tid, int col0) {
  static_assert(ROWS % (8 * BATCH) == 0, "whole batches of 8 rows");
  const int c = tid % 16, rr = tid / 16;
  unsigned char* const out =
      dst + (c / 8) * box + rr * ROW_BYTES + (((c % 8) ^ rr) * 16);
#pragma unroll
  for (int i0 = 0; i0 < ROWS / 8; i0 += BATCH) {
    float4 x[BATCH][2];
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      const int row = row0 + rr + 8 * (i0 + i);
      if (row < N) {
        const float4* p = reinterpret_cast<const float4*>(
            src + offset<HD>(b, row, h, N, H) + col0 + 8 * c);
        x[i][0] = __ldg(p);
        x[i][1] = __ldg(p + 1);
      } else {
        x[i][0] = x[i][1] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
#pragma unroll
    for (int i = 0; i < BATCH; ++i) {
      uint4 t1, t2, t3;
      split3(x[i][0].x, x[i][0].y, t1.x, t2.x, t3.x);
      split3(x[i][0].z, x[i][0].w, t1.y, t2.y, t3.y);
      split3(x[i][1].x, x[i][1].y, t1.z, t2.z, t3.z);
      split3(x[i][1].z, x[i][1].w, t1.w, t2.w, t3.w);
      unsigned char* const o = out + (i0 + i) * 8 * ROW_BYTES;
      *reinterpret_cast<uint4*>(o) = t1;
      *reinterpret_cast<uint4*>(o + term) = t2;
      *reinterpret_cast<uint4*>(o + 2 * term) = t3;
    }
  }
}

constexpr int TERMS = 3;
constexpr int F3_ROWS = 128;   // query rows per block, 64 a consumer
constexpr int F3_KEYS = 64;    // keys per K or V tile
// setmaxnreg moves registers between the warpgroups of a block: a block of
// 384 threads starts with 168 a thread, and the consumers' increase must
// come from what the converter gives up
constexpr int LAUNCH_REGS = 168;
constexpr int F3_CONVERTER_REGS = 104;
constexpr int F3_CONSUMER_REGS = 200;
static_assert(LAUNCH_REGS - F3_CONVERTER_REGS >=
                  2 * (F3_CONSUMER_REGS - LAUNCH_REGS),
              "the consumers take more registers than the converter frees");

// Head dims 256 to 2048: a cluster of NB = HD / 128 blocks (2-16) on the
// same rows, block rank r owning columns 128r .. 128r + 127. Each consumer
// warpgroup forms its partial of s (and dp) over those columns from zero
// and the cluster adds the NB partials; every block then holds the same
// bits, so p and ds agree, and each block accumulates only its own columns
// of o, dq or dk and dv. A pair (NB 2, head dim 256: PAIR below) writes its
// partial into the peer's buffer and adds the peer's to its own in one
// float add (add_peer_partials: IEEE addition commutes). With three to
// sixteen partials the order of the sum matters (IEEE addition does not
// associate), so each block keeps its own partial in its own slot, reads
// all NB and adds them in rank order, ((p0 + p1) + p2) + ..
// (add_cluster_partials). The instances <256> to <512> fix NB; one
// instance, <SPLIT3_ANY>, serves every head dim from 640 to 2048 (five to
// sixteen blocks): its NB is the cluster's size (%cluster_nctarank, a
// launch attribute) and its head dim 128 NB.
constexpr int PAIR = 2;          // blocks of a cluster at head dim 256
constexpr int SPLIT3_ANY = 0;    // the instance whose NB is the cluster's size

// a float32 cluster's blocks: HD / 128, or the cluster's size at SPLIT3_ANY
template <int HD>
__device__ __forceinline__ int split3_blocks() {
  if constexpr (HD == SPLIT3_ANY)
    return static_cast<int>(sm90::cluster_nctarank());
  else
    return HD / D;
}

// One consumer warpgroup's exchange with the same warpgroup of the other
// blocks of its cluster, 32 floats a thread (float4 i of thread tid at
// part[i][tid]: a warp's stores on 512 consecutive bytes). A pair: the peer
// writes its partial here, then arrives on full; this block reads it and
// arrives on the peer's empty, so that the peer may write the next one.
// NB > 2: this block writes its own partial here and arrives on full in
// every peer; the peers read it and arrive on empty here. N4 float4 a
// thread: 8 (32 floats) but for the float32 192-column shares' 16
// (ExchangeT<4>, 8 KB)
template <int N4>
struct ExchangeT {
  float4 part[N4][WG];
  uint64_t full, empty;
};
using Exchange = ExchangeT<8>;

// `peers` other blocks' threads arrive on each barrier (NB - 1)
template <typename Xc>
__device__ __forceinline__ void init_exchange(Xc* x, uint32_t peers = 1) {
  sm90::mbar_init(&x->full, peers * WG);
  sm90::mbar_init(&x->empty, peers * WG);
}

template <int N>
__device__ __forceinline__ void put_partial(const float (&x)[N], uint32_t dst,
                                            int& i) {
#pragma unroll
  for (int n = 0; n < N; n += 4, ++i)
    sm90::st_cluster(dst + i * WG * 16,
                     make_float4(x[n], x[n + 1], x[n + 2], x[n + 3]));
}
template <int N>
__device__ __forceinline__ void add_partial(float (&x)[N], const Exchange* xc,
                                            int tid, int& i) {
#pragma unroll
  for (int n = 0; n < N; n += 4, ++i) {
    const float4 y = xc->part[i][tid];
    x[n] = x[n] + y.x;
    x[n + 1] = x[n + 1] + y.y;
    x[n + 2] = x[n + 2] + y.z;
    x[n + 3] = x[n + 3] + y.w;
  }
}

// Exchange e (0, 1, ..) of this warpgroup's half-depth partials `parts`
// (32 floats a thread in all) with the peer block's: each becomes own +
// peer, one float add an element.
template <typename... Parts>
__device__ __forceinline__ void add_peer_partials(Exchange* xc, uint32_t peer,
                                                  int tid, int e,
                                                  Parts&... parts) {
  const uint32_t parity = e & 1;
  sm90::mbar_wait_cluster(&xc->empty, parity ^ 1);   // the peer read e - 1
  const uint32_t dst = sm90::map_peer(&xc->part[0][tid], peer);
  int i = 0;
  (put_partial(parts, dst, i), ...);
  sm90::mbar_arrive_cluster(sm90::map_peer(&xc->full, peer));
  sm90::mbar_wait_cluster(&xc->full, parity);
  i = 0;
  (add_partial(parts, xc, tid, i), ...);
  sm90::mbar_arrive_cluster(sm90::map_peer(&xc->empty, peer));
}

template <int N, typename Xc>
__device__ __forceinline__ void keep_partial(const float (&x)[N], Xc* xc,
                                             int tid, int& i) {
#pragma unroll
  for (int n = 0; n < N; n += 4, ++i)
    xc->part[i][tid] = make_float4(x[n], x[n + 1], x[n + 2], x[n + 3]);
}
// x becomes the rank-order sum of the NB blocks' partials: this block's
// own (rank `rank`) from x, the others' from their slots
template <int NB, int N>
__device__ __forceinline__ void sum_partials(float (&x)[N], const Exchange* xc,
                                             uint32_t rank, int tid, int& i) {
#pragma unroll
  for (int n = 0; n < N; n += 4, ++i) {
    const float4 own = make_float4(x[n], x[n + 1], x[n + 2], x[n + 3]);
    float4 sum;
#pragma unroll
    for (int r = 0; r < NB; ++r) {
      float4 y = own;
      if (r != static_cast<int>(rank))
        y = sm90::ld_cluster(sm90::map_peer(&xc->part[i][tid], r));
      if (r == 0) {
        sum = y;
      } else {
        sum.x = sum.x + y.x;
        sum.y = sum.y + y.y;
        sum.z = sum.z + y.z;
        sum.w = sum.w + y.w;
      }
    }
    x[n] = sum.x;
    x[n + 1] = sum.y;
    x[n + 2] = sum.z;
    x[n + 3] = sum.w;
  }
}

// x becomes (kFirst), or adds, rank r's partial, read from its slot (this
// block's own, r == rank, from its own). Called rank by rank in a loop that
// is not unrolled (add_cluster_partials_n), so the loads in flight are one
// rank's, the same at every NB: sum_partials unrolls the NB - 1 peers'
// loads, which at NB 8 would be seven float4 loads in flight an element
// group, and spill
template <bool kFirst, int N, typename Xc>
__device__ __forceinline__ void add_rank_partial(float (&x)[N], const Xc* xc,
                                                 uint32_t r, uint32_t rank,
                                                 int tid, int& i) {
#pragma unroll
  for (int n = 0; n < N; n += 4, ++i) {
    const float4 y =
        r == rank ? xc->part[i][tid]
                  : sm90::ld_cluster(sm90::map_peer(&xc->part[i][tid], r));
    if constexpr (kFirst) {
      x[n] = y.x;
      x[n + 1] = y.y;
      x[n + 2] = y.z;
      x[n + 3] = y.w;
    } else {
      x[n] = x[n] + y.x;
      x[n + 1] = x[n + 1] + y.y;
      x[n + 2] = x[n + 2] + y.z;
      x[n + 3] = x[n + 3] + y.w;
    }
  }
}

// Exchange e (0, 1, ..) of this warpgroup's partials `parts` (32 floats a
// thread in all) in a cluster of NB = 3 or 4 blocks (<384>, <512>): once
// every peer has read this block's exchange e - 1, its partials go into its
// own slot and it arrives on full in every peer (release at cluster scope);
// once every peer's have arrived here, each element becomes the rank-order
// sum of the NB partials, read from the peers' slots (ld.shared::cluster),
// and this block arrives on empty in every peer. Every block adds the same
// operands in the same order, so all hold the same bits. Each element
// group's NB - 1 peer loads are unrolled together (sum_partials); larger
// clusters sum rank by rank (add_cluster_partials_n).
template <int NB, typename... Parts>
__device__ __forceinline__ void add_cluster_partials(Exchange* xc,
                                                     uint32_t rank, int tid,
                                                     int e, Parts&... parts) {
  const uint32_t parity = e & 1;
  sm90::mbar_wait_cluster(&xc->empty, parity ^ 1);   // the peers read e - 1
  int i = 0;
  (keep_partial(parts, xc, tid, i), ...);
#pragma unroll
  for (int r = 0; r < NB; ++r)
    if (r != static_cast<int>(rank))
      sm90::mbar_arrive_cluster(sm90::map_peer(&xc->full, r));
  sm90::mbar_wait_cluster(&xc->full, parity);        // the peers' e
  i = 0;
  (sum_partials<NB>(parts, xc, rank, tid, i), ...);
#pragma unroll
  for (int r = 0; r < NB; ++r)
    if (r != static_cast<int>(rank))
      sm90::mbar_arrive_cluster(sm90::map_peer(&xc->empty, r));
}

// x becomes the rank-order sum of the nb blocks' partials in their slots,
// rank by rank, with one rank's loads in flight
template <typename Xc, typename... Parts>
__device__ __forceinline__ void sum_cluster_slots(const Xc* xc, int nb,
                                                  uint32_t rank, int tid,
                                                  Parts&... parts) {
  int i = 0;
  (add_rank_partial<true>(parts, xc, 0, rank, tid, i), ...);
#pragma unroll 1
  for (int r = 1; r < nb; ++r) {
    i = 0;
    (add_rank_partial<false>(parts, xc, r, rank, tid, i), ...);
  }
}

// add_cluster_partials rank by rank in a cluster of `nb` blocks, nb known
// only at run time (the 16-bit cluster kernels, 3 to 16 blocks: one
// instance for every head dim from 640 to 4096; the float32 <SPLIT3_ANY>, 5
// to 16): the same barriers, slots and sum, ((p0 + p1) + p2) + .. + p(nb -
// 1), with one rank's loads in flight
template <typename Xc, typename... Parts>
__device__ __forceinline__ void add_cluster_partials_n(Xc* xc, int nb,
                                                       uint32_t rank, int tid,
                                                       int e,
                                                       Parts&... parts) {
  const uint32_t parity = e & 1;
  sm90::mbar_wait_cluster(&xc->empty, parity ^ 1);   // the peers read e - 1
  int i = 0;
  (keep_partial(parts, xc, tid, i), ...);
  for (int r = 0; r < nb; ++r)
    if (r != static_cast<int>(rank))
      sm90::mbar_arrive_cluster(sm90::map_peer(&xc->full, r));
  sm90::mbar_wait_cluster(&xc->full, parity);        // the peers' e
  sum_cluster_slots(xc, nb, rank, tid, parts...);
  for (int r = 0; r < nb; ++r)
    if (r != static_cast<int>(rank))
      sm90::mbar_arrive_cluster(sm90::map_peer(&xc->empty, r));
}

// after a warpgroup's last exchange (`n` in all): every peer has read it,
// so it touches this block's shared memory no more and the block may exit
// (its writes and its arrivals on full came before this block's last wait
// on full)
template <typename Xc>
__device__ __forceinline__ void drain_exchange(Xc* xc, int n) {
  if (n > 0) sm90::mbar_wait_cluster(&xc->empty, (n - 1) & 1);
}

// ----- the reduce-scatter exchange: the 16-bit cluster forward (640 to
// 4096, three to sixteen blocks) and the float32 forward, dq and dk/dv
// <SPLIT3_ANY> (640 to 2048, five to sixteen). The all-gather
// (add_cluster_partials_n and its variants) stays in the 16-bit cluster dq
// and dk/dv, the float32 shares3 kernels and, unrolled
// (add_cluster_partials), the float32 <384> and <512>.
// add_cluster_partials_n has every block read every peer's whole slot and
// add all NB: (NB - 1) x 16 KB of remote reads a warpgroup an exchange
// (240 KB at sixteen blocks) and 2 (NB - 1) x 128 remote arrivals, every
// block computing the same sum. Here the exchange's XCHG_GROUPS float4
// groups (float4 i of thread tid is group i WG + tid) are cut into NB
// contiguous slices, block r owning slice r (xchg_slice0):
// (1) each thread writes its partial into its block's own slot, as there;
//     each warp arrives on full in every block of the cluster, its own too;
// (2) each block adds its slice's groups from the NB slots in rank order,
//     ((p0 + p1) + p2) + .., as sum_cluster_slots does, and writes the sums
//     in place into slice r of its own slot (in this round no block reads
//     that slice of it); each warp arrives on sum_full in every block;
// (3) each thread reads its 8 groups back, each from the slot of the block
//     that owns it (xchg_owner), all 8 loads in flight; each warp arrives
//     on empty in every block, which then may take the next partial.
// Every element is summed once, by its owner, from the same operands in
// the same order, so every block holds the bits that add_cluster_partials_n
// gives. Remote reads a warpgroup an exchange: 2 (NB - 1) / NB x 16 KB, 30
// KB at sixteen blocks; remote arrivals 3 x 4 (NB - 1). One arrival a
// warp: __syncwarp orders the warp's accesses before those of lane r,
// which then arrives on block r's barrier with release at cluster scope
// (cumulative: it covers what the lane has observed), and each barrier
// counts the NB x 4 warps of the cluster. Measured against
// add_cluster_partials_n, it is faster at every cluster size the four
// kernels run (the 16-bit forward from three blocks, the float32 ones from
// five), so none keeps the all-gather.
struct ExchangeRS : Exchange {
  uint64_t sum_full;   // every block's slice holds its sums
};
constexpr int XCHG_GROUPS = 8 * WG;   // an Exchange's float4 groups

// the first group of block r's slice in a cluster of nb blocks (r = nb:
// the end): XCHG_GROUPS / nb groups, rounded down or up
__host__ __device__ constexpr int xchg_slice0(int nb, int r) {
  return r * XCHG_GROUPS / nb;
}
// the block whose slice holds group g
__host__ __device__ constexpr int xchg_owner(int nb, int g) {
  return ((g + 1) * nb - 1) / XCHG_GROUPS;
}
// in every cluster of 3 to 16 blocks: the slices one after another from
// group 0 to XCHG_GROUPS, their sizes differing by at most one group, and
// each group's owner the one block whose slice holds it
constexpr bool xchg_slices_cover() {
  for (int nb = 3; nb <= 16; ++nb) {
    if (xchg_slice0(nb, 0) != 0 || xchg_slice0(nb, nb) != XCHG_GROUPS)
      return false;
    for (int r = 0; r < nb; ++r) {
      const int n = xchg_slice0(nb, r + 1) - xchg_slice0(nb, r);
      if (n != XCHG_GROUPS / nb && n != XCHG_GROUPS / nb + 1) return false;
    }
    for (int g = 0; g < XCHG_GROUPS; ++g) {
      const int r = xchg_owner(nb, g);
      if (r < 0 || r >= nb || g < xchg_slice0(nb, r) ||
          g >= xchg_slice0(nb, r + 1))
        return false;
    }
  }
  return true;
}
static_assert(xchg_slices_cover(),
              "each float4 group of an exchange in one block's slice");

// full, sum_full and empty: one arrival a warp of the cluster's nb blocks
__device__ __forceinline__ void init_exchange_rs(ExchangeRS* x, int nb) {
  const uint32_t n = nb * (WG / 32);
  sm90::mbar_init(&x->full, n);
  sm90::mbar_init(&x->sum_full, n);
  sm90::mbar_init(&x->empty, n);
}

// this warp's one arrival on `bar` in every block of a cluster of nb, its
// own too: lane r arrives on block r's, after the warp's earlier accesses
__device__ __forceinline__ void warp_arrive_cluster(uint64_t* bar, int nb) {
  const int lane = threadIdx.x % 32;
  __syncwarp();
  if (lane < nb) sm90::mbar_arrive_cluster(sm90::map_peer(bar, lane));
}

// this block's slice of the exchange becomes, in place in its own slot,
// the rank-order sums ((p0 + p1) + p2) + .. of the nb blocks' slots: a
// thread's groups (the slice spread over the warpgroup) with K ranks'
// loads in flight
template <int K>
__device__ __forceinline__ void reduce_slice(ExchangeRS* xc, int nb,
                                             uint32_t rank, int tid) {
  float* const own = reinterpret_cast<float*>(xc->part);
  const int end = xchg_slice0(nb, rank + 1);
  for (int g = xchg_slice0(nb, rank) + tid; g < end; g += WG) {
    float sum[4];
#pragma unroll 1
    for (int r0 = 0; r0 < nb; r0 += K) {
      float y[K][4];
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (r0 + j < nb) {
          const float4 t =
              sm90::ld_cluster(sm90::map_peer(own + 4 * g, r0 + j));
          y[j][0] = t.x;
          y[j][1] = t.y;
          y[j][2] = t.z;
          y[j][3] = t.w;
        }
#pragma unroll
      for (int j = 0; j < K; ++j)
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          if (r0 + j == 0)
            sum[w] = y[j][w];
          else if (r0 + j < nb)
            sum[w] = sum[w] + y[j][w];
        }
    }
    *reinterpret_cast<float4*>(own + 4 * g) =
        make_float4(sum[0], sum[1], sum[2], sum[3]);
  }
}

template <int N>
__device__ __forceinline__ void take_sums(float (&x)[N], const float4 (&y)[8],
                                          int& i) {
#pragma unroll
  for (int n = 0; n < N; n += 4, ++i) {
    x[n] = y[i].x;
    x[n + 1] = y[i].y;
    x[n + 2] = y[i].z;
    x[n + 3] = y[i].w;
  }
}

// exchange e (0, 1, ..) of this warpgroup's partials `parts` (32 floats a
// thread in all) as a reduce-scatter, then an all-gather, in the slots of
// the cluster's nb blocks (above), the reduce with K ranks' loads in flight
template <int K, typename... Parts>
__device__ __forceinline__ void reduce_scatter_partials(ExchangeRS* xc,
                                                        int nb, uint32_t rank,
                                                        int tid, int e,
                                                        Parts&... parts) {
  const uint32_t parity = e & 1;
  sm90::mbar_wait_cluster(&xc->empty, parity ^ 1);   // all read e - 1
  int i = 0;
  (keep_partial(parts, xc, tid, i), ...);
  warp_arrive_cluster(&xc->full, nb);
  sm90::mbar_wait_cluster(&xc->full, parity);        // every block's e
  reduce_slice<K>(xc, nb, rank, tid);
  warp_arrive_cluster(&xc->sum_full, nb);
  sm90::mbar_wait_cluster(&xc->sum_full, parity);    // every slice's sums
  float4 y[8];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    y[n] = sm90::ld_cluster(sm90::map_peer(
        &xc->part[n][tid], xchg_owner(nb, n * WG + tid)));
  i = 0;
  (take_sums(parts, y, i), ...);
  warp_arrive_cluster(&xc->empty, nb);
}

struct Fwd3Bars {
  uint64_t k_full, v_full, k_empty, v_empty;
};
constexpr size_t kFwd3Smem = 1024 + TERMS * TILE_BYTES +
                             2 * TERMS * QTILE_BYTES + sizeof(Fwd3Bars);
// + an exchange a consumer at head dims 256 to 2048 (230,464 bytes; at
// <SPLIT3_ANY> two ExchangeRS, 230,496)
template <int HD>
constexpr size_t fwd3_smem() {
  return kFwd3Smem + (HD == D            ? 0
                      : HD == SPLIT3_ANY ? 2 * sizeof(ExchangeRS)
                                         : 2 * sizeof(Exchange));
}
static_assert(fwd3_smem<4 * D>() <= MAX_SMEM, "float32 forward at HD 512");
static_assert(fwd3_smem<SPLIT3_ANY>() <= MAX_SMEM,
              "float32 forward at HD 640 to 2048");

// float32 forward, grid (ceil(L / F3_ROWS), B*H), 384 threads. Warpgroup 0
// converts: it streams 64-key K and V tiles, K_0, V_0, K_1, ..., each into
// its own slot of three terms (48 KB; the slots are the whole ring: the 96
// KB of Q's terms leave no room for a second K/V pair), so that K_j+1 is
// split while the consumers run softmax and PV of tile j, and V_j+1 while
// they run the scores of j+1. Warpgroups 1 and 2 own 64 query rows each:
// they split their own Q rows once, then per tile s = q k^T (48 wgmma
// m64n64k16, both operands' terms K-major from shared memory), the online
// softmax on the accumulators, p split into three register A terms, and
// o += p v (24 wgmma m64n128k16, v's terms MN-major with the transpose
// bit). A consumer whose rows all lie before a tile's first key skips its
// products (it still waits and releases, keeping the barriers in step).
// At HD 256 to 2048 the grid is NB = HD / 128 times as wide, clusters
// of NB blocks on the same rows, each on its 128 columns; a live tile's s is
// the sum of the blocks' partials (add_peer_partials at 256,
// add_cluster_partials in rank order at 384 and 512, reduce_scatter_partials
// in the same order from 640). <SPLIT3_ANY> (640 to 2048) reads NB from the
// cluster and addresses the head's 128 NB floats a row as offset<1> of a
// head dim of one (head h at h HD, a row H HD).
template <int HD>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_split3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v, float* __restrict__ o,
                            float* __restrict__ lse, int H, int L, int S,
                            float scale) {
  constexpr int NB = HD / D;               // a cluster's 128-column slices
  constexpr bool kPair = NB == PAIR, kCluster = NB != 1;
  constexpr int OFF = HD == SPLIT3_ANY ? 1 : HD;   // offset<>'s head dim
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);             // [term]
  unsigned char* const Ks = Qs + TERMS * TILE_BYTES;         // [term]
  unsigned char* const Vs = Ks + TERMS * QTILE_BYTES;        // [term]
  auto* bars = reinterpret_cast<Fwd3Bars*>(Vs + TERMS * QTILE_BYTES);
  using Xc = std::conditional_t<HD == SPLIT3_ANY, ExchangeRS, Exchange>;
  auto* xch = reinterpret_cast<Xc*>(bars + 1);         // [consumer], NB > 1
  const uint32_t rank = kCluster ? sm90::cluster_ctarank() : 0;
  const int nb = split3_blocks<HD>();
  const int col0 = D * rank;                 // this block's columns
  const int row_blocks = gridDim.x / nb;
  const int q0 = (row_blocks - 1 - blockIdx.x / nb) * F3_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oh = OFF == 1 ? h * D * nb : h, oH = OFF == 1 ? H * D * nb : H;
  const int n_tiles = (min(S, q0 + F3_ROWS) + F3_KEYS - 1) / F3_KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->k_full, WG);               // converter threads
    sm90::mbar_init(&bars->v_full, WG);
    sm90::mbar_init(&bars->k_empty, 2 * WG / 32);     // consumer warps
    sm90::mbar_init(&bars->v_empty, 2 * WG / 32);
    if constexpr (HD == SPLIT3_ANY) {
      init_exchange_rs(&xch[0], nb);
      init_exchange_rs(&xch[1], nb);
    } else if constexpr (kCluster) {
      init_exchange(&xch[0], nb - 1);
      init_exchange(&xch[1], nb - 1);
    }
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if constexpr (kCluster) sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // converter
    sm90::setmaxnreg_dec<F3_CONVERTER_REGS>();
    for (int j = 0; j < n_tiles; ++j) {
      const uint32_t parity = (j & 1) ^ 1;
      sm90::mbar_wait(&bars->k_empty, parity);
      split_rows<F3_KEYS, 4, OFF>(Ks, BOX64, QTILE_BYTES, k, b, oh, S, oH,
                                  j * F3_KEYS, threadIdx.x, col0);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&bars->k_full);
      sm90::mbar_wait(&bars->v_empty, parity);
      split_rows<F3_KEYS, 4, OFF>(Vs, BOX64, QTILE_BYTES, v, b, oh, S, oH,
                                  j * F3_KEYS, threadIdx.x, col0);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&bars->v_full);
    }
    return;
  }

  sm90::setmaxnreg_inc<F3_CONSUMER_REGS>();
  const int cw = wg - 1;                     // rows r0 = q0 + 64 cw ..
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * cw;
  const int row = r0 + 16 * warp + g;        // and row + 8
  unsigned char* const Qw = Qs + 64 * cw * ROW_BYTES;
  split_rows<64, 4, OFF>(Qw, BOX128, TILE_BYTES, q, b, oh, L, oH, r0, tid,
                         col0);
  sm90::fence_proxy_async();
  sm90::named_bar_sync(1 + cw, WG);          // this consumer's Q terms
  // tiles whose first key lies past this consumer's last row add nothing
  const int my_tiles = (min(S, r0 + 64) + F3_KEYS - 1) / F3_KEYS;
  const float sl2 = scale * LOG2E;           // scores in log2 units
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * F3_KEYS;
    const uint32_t phase = j & 1;
    const bool live = j < my_tiles;
    float s[32];
    sm90::mbar_wait(&bars->k_full, phase);
    if (live) {
      const uint64_t desc_q = k_major(Qw), desc_k = k_major(Ks);
      sm90::wgmma_fence();
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          sm90::wgmma_m64n64k16_ss(
              s, desc_q + term_off(TILE_BYTES, a_term(p)) + k_step(BOX128, kk),
              desc_k + term_off(QTILE_BYTES, b_term(p)) + k_step(BOX64, kk),
              p > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->k_empty);
    // live tiles are the first my_tiles, so j counts the exchanges; a tile
    // is live for this consumer in every block of the cluster or in none
    if constexpr (kPair) {
      if (live) add_peer_partials(&xch[cw], rank ^ 1, tid, j, s);
    } else if constexpr (HD == SPLIT3_ANY) {
      // one rank's loads in flight in the reduce: with two, four or eight
      // the consumers spilled 32, 140 or 268 bytes
      if (live)
        reduce_scatter_partials<1>(&xch[cw], sm90::cluster_nctarank(), rank,
                                   tid, j, s);
    } else if constexpr (NB > 2) {
      if (live) add_cluster_partials<NB>(&xch[cw], rank, tid, j, s);
    }

    uint32_t pa[TERMS][F3_KEYS / 16][4];
    if (live) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] *= sl2;
      // the diagonal tile and a ragged last tile: key > row or key >= S
      if (k0 + F3_KEYS - 1 > r0 || k0 + F3_KEYS > S) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (key > row + 8 * ((i / 2) & 1) || key >= S) s[i] = NEG_INF;
        }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int i = 0; i < 32; ++i)
        mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];                    // this thread's share of the sum
      }
      sm90::fence_regs(acc);
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] *= alpha[(i / 2) & 1];
      // p (float) into the row sums and, as three terms, the A registers
#pragma unroll
      for (int kk = 0; kk < F3_KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r, half = r & 1;
          const float p0 = exp2f(s[i] - m[half]);
          const float p1 = exp2f(s[i + 1] - m[half]);
          l[half] += p0;
          l[half] += p1;
          split3(p0, p1, pa[0][kk][r], pa[1][kk][r], pa[2][kk][r]);
        }
    }

    sm90::mbar_wait(&bars->v_full, phase);
    if (live) {
      const uint64_t desc_v = mn_major(Vs, BOX64);
      sm90::wgmma_fence();
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < F3_KEYS / 16; ++kk)
          sm90::wgmma_m64n128k16_rs(
              acc, pa[a_term(p)][kk],
              desc_v + term_off(QTILE_BYTES, b_term(p)) + mn_step(kk), 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->v_empty);
  }

  if constexpr (kCluster) drain_exchange(&xch[cw], min(my_tiles, n_tiles));

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
    if (t == 0 && row + 8 * r < L && rank == 0)   // all blocks hold it
      lse[static_cast<int64_t>(bh) * L + row + 8 * r] = m[r] * LN2 + logf(l[r]);
  }
  store_acc_rows<float, OFF>(o, b, oh, L, oH, row, t, acc, inv, col0);
}

constexpr int D3_KEYS = 64;      // keys per block
constexpr int D3_ROWS = 32;      // query rows per streamed tile
constexpr int D3_STAGES = 2;
constexpr int D3_TILE = D3_ROWS * D * 2;   // one term of a 32-row tile
constexpr int BOX32 = D3_TILE / 2;         // 32 rows x 64 columns
constexpr int D3_THREADS = 2 * WG;

struct Ring3Bars {               // the streamed stages' barriers
  uint64_t full[D3_STAGES], empty[D3_STAGES];
};
struct Dkv3Stats {               // a streamed tile's lse and delta
  float lse[D3_STAGES][D3_ROWS], delta[D3_STAGES][D3_ROWS];
};
constexpr size_t kDkv3Smem = 1024 + 2 * TERMS * QTILE_BYTES +
                             2 * D3_STAGES * TERMS * D3_TILE +
                             sizeof(Dkv3Stats) + sizeof(Ring3Bars);
// + the consumer's exchange at head dims 256 to 2048 (214,576 bytes; at
// <SPLIT3_ANY> an ExchangeRS, 214,592)
template <int HD>
constexpr size_t dkv3_smem() {
  return kDkv3Smem + (HD == D            ? 0
                      : HD == SPLIT3_ANY ? sizeof(ExchangeRS)
                                         : sizeof(Exchange));
}
static_assert(dkv3_smem<4 * D>() <= MAX_SMEM, "float32 dk/dv at HD 512");
static_assert(dkv3_smem<SPLIT3_ANY>() <= MAX_SMEM,
              "float32 dk/dv at HD 640 to 2048");

// float32 dk and dv, grid (ceil(S / D3_KEYS), B*H), 256 threads: the K and
// V terms of 64 keys stay resident (96 KB), so a block has one consumer
// warpgroup (warpgroup 1; it splits K and V itself) and the converter
// (warpgroup 0), which streams 32-row Q and dO tiles as terms, with their
// lse and delta, through 2 stages of 48 KB, for the query rows >= k0. Per
// tile: s^T = k q^T and dp^T = v dO^T (48 wgmma m64n32k16 each, all terms
// K-major from shared memory); p^T and ds^T in registers, each split into
// three A terms; dv += p^T dO and dk += ds^T q (12 wgmma m64n128k16 each,
// dO's and q's terms MN-major with the transpose bit). One block an SM:
// 198 KB of shared memory, up to 255 registers a thread. At HD 256 to
// 2048, clusters of NB = HD / 128 blocks on the same keys, each on its 128
// columns, s^T and dp^T the sums of the blocks' partials (<SPLIT3_ANY>
// from 640, as the forward: a reduce-scatter).
template <int HD>
__global__ void __launch_bounds__(D3_THREADS, 1)
    flash_dkv_split3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            int H, int L, int S, float scale) {
  constexpr int NB = HD / D;               // a cluster's 128-column slices
  constexpr bool kPair = NB == PAIR, kCluster = NB != 1;
  constexpr int OFF = HD == SPLIT3_ANY ? 1 : HD;   // offset<>'s head dim
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Ks = align1024(raw_smem);              // [term]
  unsigned char* const Vs = Ks + TERMS * QTILE_BYTES;         // [term]
  unsigned char* const Qs = Vs + TERMS * QTILE_BYTES;         // [stage][term]
  unsigned char* const Gs = Qs + D3_STAGES * TERMS * D3_TILE; // dO
  auto* stats = reinterpret_cast<Dkv3Stats*>(Gs + D3_STAGES * TERMS * D3_TILE);
  auto* bars = reinterpret_cast<Ring3Bars*>(stats + 1);
  using Xc = std::conditional_t<HD == SPLIT3_ANY, ExchangeRS, Exchange>;
  auto* xch = reinterpret_cast<Xc*>(bars + 1);               // NB > 1
  const uint32_t rank = kCluster ? sm90::cluster_ctarank() : 0;
  const int nb = split3_blocks<HD>();
  const int col0 = D * rank;                 // this block's columns
  const int k0 = blockIdx.x / nb * D3_KEYS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oh = OFF == 1 ? h * D * nb : h, oH = OFF == 1 ? H * D * nb : H;
  const int n_tiles = k0 < L ? (L - k0 + D3_ROWS - 1) / D3_ROWS : 0;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int st = 0; st < D3_STAGES; ++st) {
      sm90::mbar_init(&bars->full[st], WG);           // converter threads
      sm90::mbar_init(&bars->empty[st], WG / 32);     // consumer warps
    }
    if constexpr (HD == SPLIT3_ANY)
      init_exchange_rs(xch, nb);
    else if constexpr (kCluster)
      init_exchange(xch, nb - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if constexpr (kCluster) sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // converter
    const int tid = threadIdx.x;
    const float* const lse_bh = lse + static_cast<int64_t>(bh) * L;
    const float* const delta_bh = delta + static_cast<int64_t>(bh) * L;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % D3_STAGES, q0 = k0 + j * D3_ROWS;
      sm90::mbar_wait(&bars->empty[st], ((j / D3_STAGES) & 1) ^ 1);
      if (tid < D3_ROWS) {
        const bool in = q0 + tid < L;
        stats->lse[st][tid] = in ? lse_bh[q0 + tid] : 0.f;
        stats->delta[st][tid] = in ? delta_bh[q0 + tid] : 0.f;
      }
      split_rows<D3_ROWS, 4, OFF>(Qs + st * TERMS * D3_TILE, BOX32, D3_TILE,
                                  q, b, oh, L, oH, q0, tid, col0);
      split_rows<D3_ROWS, 4, OFF>(Gs + st * TERMS * D3_TILE, BOX32, D3_TILE,
                                  dout, b, oh, L, oH, q0, tid, col0);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&bars->full[st]);
    }
    return;
  }

  const int tid = threadIdx.x - WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = k0 + 16 * warp + g;        // and key + 8
  split_rows<D3_KEYS, 4, OFF>(Ks, BOX64, QTILE_BYTES, k, b, oh, S, oH, k0,
                              tid, col0);
  split_rows<D3_KEYS, 4, OFF>(Vs, BOX64, QTILE_BYTES, v, b, oh, S, oH, k0,
                              tid, col0);
  sm90::fence_proxy_async();
  sm90::named_bar_sync(1, WG);               // the K and V terms
  const float sl2 = scale * LOG2E;
  float dk_acc[64], dv_acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % D3_STAGES, q0 = k0 + j * D3_ROWS;
    const unsigned char* qt = Qs + st * TERMS * D3_TILE;
    const unsigned char* gt = Gs + st * TERMS * D3_TILE;
    float s[16], dp[16];
    const uint64_t desc_k = k_major(Ks), desc_q = k_major(qt);
    const uint64_t desc_v = k_major(Vs), desc_g = k_major(gt);
    sm90::mbar_wait(&bars->full[st], (j / D3_STAGES) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_m64n32k16_ss(
            s, desc_k + term_off(QTILE_BYTES, a_term(p)) + k_step(BOX64, kk),
            desc_q + term_off(D3_TILE, b_term(p)) + k_step(BOX32, kk),
            p > 0 || kk > 0);
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_m64n32k16_ss(
            dp, desc_v + term_off(QTILE_BYTES, a_term(p)) + k_step(BOX64, kk),
            desc_g + term_off(D3_TILE, b_term(p)) + k_step(BOX32, kk),
            p > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if constexpr (kPair)
      add_peer_partials(xch, rank ^ 1, tid, j, s, dp);
    else if constexpr (HD == SPLIT3_ANY)   // 252 registers, no spill
      reduce_scatter_partials<8>(xch, sm90::cluster_nctarank(), rank, tid, j,
                                 s, dp);
    else if constexpr (NB > 2)
      add_cluster_partials<NB>(xch, rank, tid, j, s, dp);

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale; rows:
    // keys key + 8((i / 2) & 1), columns: query rows q0 + c
    const bool edge = k0 + D3_KEYS - 1 > q0 || q0 + D3_ROWS > L ||
                      k0 + D3_KEYS > S;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);
      float p = exp2f(fmaf(s[i], sl2, -stats->lse[st][c] * LOG2E));
      if (edge) {
        const int kc = key + 8 * ((i / 2) & 1), qr = q0 + c;
        if (kc > qr || kc >= S || qr >= L) p = 0.f;
      }
      dp[i] = p * (dp[i] - stats->delta[st][c]) * scale;
      s[i] = p;
    }
    uint32_t pa[TERMS][D3_ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < D3_ROWS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], pa[0][kk][r],
               pa[1][kk][r], pa[2][kk][r]);
    sm90::fence_regs(dv_acc);
    sm90::wgmma_fence();
    const uint64_t desc_gt = mn_major(gt, BOX32);
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < D3_ROWS / 16; ++kk)
        sm90::wgmma_m64n128k16_rs(
            dv_acc, pa[a_term(p)][kk],
            desc_gt + term_off(D3_TILE, b_term(p)) + mn_step(kk), 1);
    uint32_t da[TERMS][D3_ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < D3_ROWS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], da[0][kk][r],
               da[1][kk][r], da[2][kk][r]);
    sm90::fence_regs(dk_acc);
    sm90::wgmma_fence();
    const uint64_t desc_qt = mn_major(qt, BOX32);
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < D3_ROWS / 16; ++kk)
        sm90::wgmma_m64n128k16_rs(
            dk_acc, da[a_term(p)][kk],
            desc_qt + term_off(D3_TILE, b_term(p)) + mn_step(kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(dk_acc);
    sm90::fence_regs(dv_acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  if constexpr (kCluster) drain_exchange(xch, n_tiles);
  const float one[2] = {1.f, 1.f};
  store_acc_rows<float, OFF>(dk, b, oh, S, oH, key, t, dk_acc, one, col0);
  store_acc_rows<float, OFF>(dv, b, oh, S, oH, key, t, dv_acc, one, col0);
}

constexpr int Q3_ROWS = 64;         // query rows per block
constexpr int Q3_KEYS = D3_ROWS;    // keys per streamed tile
constexpr size_t kDq3Smem = 1024 + 2 * TERMS * QTILE_BYTES +
                            2 * D3_STAGES * TERMS * D3_TILE +
                            sizeof(Ring3Bars);
// + the consumer's exchange at head dims 256 to 2048 (214,064 bytes; at
// <SPLIT3_ANY> an ExchangeRS, 214,080)
template <int HD>
constexpr size_t dq3_smem() {
  return kDq3Smem + (HD == D            ? 0
                     : HD == SPLIT3_ANY ? sizeof(ExchangeRS)
                                        : sizeof(Exchange));
}
static_assert(dq3_smem<4 * D>() <= MAX_SMEM, "float32 dq at HD 512");

// float32 dq, grid (ceil(L / Q3_ROWS), B*H), 256 threads: dk/dv's mirror
// image. The Q and dO terms of 64 query rows stay resident (96 KB), split
// by the one consumer warpgroup (warpgroup 1), which keeps its rows' lse
// and delta in registers; the converter (warpgroup 0) streams 32-key K and
// V tiles as terms through 2 stages of 48 KB, for the keys below
// min(S, q0 + 64). Per tile: s = q k^T and dp = dO v^T (48 wgmma m64n32k16
// each, all terms K-major from shared memory); p and ds in registers, ds
// split into three A terms; dq += ds k (12 wgmma m64n128k16, k's terms
// MN-major with the transpose bit). One block an SM: 198 KB of shared
// memory, up to 255 registers a thread. At HD 256 to 2048, clusters of
// NB = HD / 128 blocks on the same rows, each on its 128 columns, s and dp
// the sums of the blocks' partials (<SPLIT3_ANY> from 640, as the
// forward).
template <int HD>
__global__ void __launch_bounds__(D3_THREADS, 1)
    flash_dq_split3_kernel(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           const float* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq, int H, int L, int S,
                           float scale) {
  constexpr int NB = HD / D;               // a cluster's 128-column slices
  constexpr bool kPair = NB == PAIR, kCluster = NB != 1;
  constexpr int OFF = HD == SPLIT3_ANY ? 1 : HD;   // offset<>'s head dim
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);               // [term]
  unsigned char* const Gs = Qs + TERMS * QTILE_BYTES;          // [term] dO
  unsigned char* const Ks = Gs + TERMS * QTILE_BYTES;          // [stage][term]
  unsigned char* const Vs = Ks + D3_STAGES * TERMS * D3_TILE;  // [stage][term]
  auto* bars = reinterpret_cast<Ring3Bars*>(Vs + D3_STAGES * TERMS * D3_TILE);
  using Xc = std::conditional_t<HD == SPLIT3_ANY, ExchangeRS, Exchange>;
  auto* xch = reinterpret_cast<Xc*>(bars + 1);                 // NB > 1
  const uint32_t rank = kCluster ? sm90::cluster_ctarank() : 0;
  const int nb = split3_blocks<HD>();
  const int col0 = D * rank;                 // this block's columns
  const int row_blocks = gridDim.x / nb;
  const int q0 = (row_blocks - 1 - blockIdx.x / nb) * Q3_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oh = OFF == 1 ? h * D * nb : h, oH = OFF == 1 ? H * D * nb : H;
  const int n_tiles = (min(S, q0 + Q3_ROWS) + Q3_KEYS - 1) / Q3_KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int st = 0; st < D3_STAGES; ++st) {
      sm90::mbar_init(&bars->full[st], WG);           // converter threads
      sm90::mbar_init(&bars->empty[st], WG / 32);     // consumer warps
    }
    if constexpr (HD == SPLIT3_ANY)
      init_exchange_rs(xch, nb);
    else if constexpr (kCluster)
      init_exchange(xch, nb - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  if constexpr (kCluster) sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // converter
    const int tid = threadIdx.x;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % D3_STAGES, k0 = j * Q3_KEYS;
      sm90::mbar_wait(&bars->empty[st], ((j / D3_STAGES) & 1) ^ 1);
      split_rows<Q3_KEYS, 4, OFF>(Ks + st * TERMS * D3_TILE, BOX32, D3_TILE,
                                  k, b, oh, S, oH, k0, tid, col0);
      split_rows<Q3_KEYS, 4, OFF>(Vs + st * TERMS * D3_TILE, BOX32, D3_TILE,
                                  v, b, oh, S, oH, k0, tid, col0);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&bars->full[st]);
    }
    return;
  }

  const int tid = threadIdx.x - WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * warp + g;        // and row + 8
  split_rows<Q3_ROWS, 4, OFF>(Qs, BOX64, QTILE_BYTES, q, b, oh, L, oH, q0,
                              tid, col0);
  split_rows<Q3_ROWS, 4, OFF>(Gs, BOX64, QTILE_BYTES, dout, b, oh, L, oH, q0,
                              tid, col0);
  sm90::fence_proxy_async();
  sm90::named_bar_sync(1, WG);               // the Q and dO terms
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];                      // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < L;
    const int64_t i = static_cast<int64_t>(bh) * L + row + 8 * r;
    lse2[r] = in ? lse[i] * LOG2E : 0.f;
    dl[r] = in ? delta[i] : 0.f;
  }
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % D3_STAGES, k0 = j * Q3_KEYS;
    const unsigned char* kt = Ks + st * TERMS * D3_TILE;
    const unsigned char* vt = Vs + st * TERMS * D3_TILE;
    float s[16], dp[16];
    const uint64_t desc_q = k_major(Qs), desc_k = k_major(kt);
    const uint64_t desc_g = k_major(Gs), desc_v = k_major(vt);
    sm90::mbar_wait(&bars->full[st], (j / D3_STAGES) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_m64n32k16_ss(
            s, desc_q + term_off(QTILE_BYTES, a_term(p)) + k_step(BOX64, kk),
            desc_k + term_off(D3_TILE, b_term(p)) + k_step(BOX32, kk),
            p > 0 || kk > 0);
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        sm90::wgmma_m64n32k16_ss(
            dp, desc_g + term_off(QTILE_BYTES, a_term(p)) + k_step(BOX64, kk),
            desc_v + term_off(D3_TILE, b_term(p)) + k_step(BOX32, kk),
            p > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    if constexpr (kPair)
      add_peer_partials(xch, rank ^ 1, tid, j, s, dp);
    else if constexpr (HD == SPLIT3_ANY)
      reduce_scatter_partials<8>(xch, sm90::cluster_nctarank(), rank, tid, j,
                                 s, dp);
    else if constexpr (NB > 2)
      add_cluster_partials<NB>(xch, rank, tid, j, s, dp);

    // p = exp(s scale - lse), ds = p (dp - delta) scale; rows: queries
    // row + 8((i / 2) & 1), columns: keys k0 + c. Only a tile that crosses
    // the diagonal or the ragged end is masked.
    const bool edge = k0 + Q3_KEYS - 1 > q0 || k0 + Q3_KEYS > S;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = (i / 2) & 1;
      float p = exp2f(fmaf(s[i], sl2, -lse2[r]));
      if (edge) {
        const int kc = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (kc > row + 8 * r || kc >= S) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl[r]) * scale;
    }
    uint32_t da[TERMS][Q3_KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < Q3_KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        split3(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], da[0][kk][r],
               da[1][kk][r], da[2][kk][r]);
    sm90::fence_regs(acc);
    sm90::wgmma_fence();
    const uint64_t desc_kt = mn_major(kt, BOX32);
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < Q3_KEYS / 16; ++kk)
        sm90::wgmma_m64n128k16_rs(
            acc, da[a_term(p)][kk],
            desc_kt + term_off(D3_TILE, b_term(p)) + mn_step(kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(acc);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  if constexpr (kCluster) drain_exchange(xch, n_tiles);
  const float one[2] = {1.f, 1.f};
  store_acc_rows<float, OFF>(dq, b, oh, L, oH, row, t, acc, one, col0);
}

// ----- bfloat16 and float16 at head dims 384 to 4096: clusters of blocks
// A cluster of NB = ceil(HD / 256) blocks on the same rows (keys for
// dk/dv), each owning a share of whole 64-column boxes of the head row: the
// 16-bit layouts above on the block's columns, each consumer forming its
// partial s (and dp) over them from zero and the cluster adding the NB
// partials through an Exchange a consumer, as the float32 clusters do.
// Accumulators are 64 x 64 units (32 floats a thread, wgmma m64n64k16 with
// A from registers), one a box, so that any share of whole boxes splits
// into them. At 384 and 512 (the pair kernels) both blocks own HD / 2
// columns, 192 or 256; from 640 (the cluster kernels below) the shares
// differ by at most one box (share16_units).

// the blocks of a 16-bit cluster at head dim hd: one for every 256 columns,
// rounded up (a block of the <256> layouts holds at most 256 columns: at
// 320 the forward would need 279,600 bytes of shared memory)
__host__ __device__ constexpr int cluster16_blocks(int hd) {
  return (hd + 255) / 256;
}

constexpr int PAIR_FWD_KEYS = 64;   // keys per K or V tile
constexpr int PAIR_DQ_KEYS = 32;
// 128 rows of Q (and of dO in dq) resident, KEYS-key K and V tiles through
// FWD_STAGES stages, an exchange (Xc) a consumer, for blocks of C columns:
// at C 256 230,488 bytes for both (the cluster forward's ExchangeRS:
// 230,520)
template <int C, int KEYS, int RESIDENT, typename Xc = Exchange>
constexpr size_t cluster16_q_smem() {
  return 1024 +
         static_cast<size_t>(RESIDENT * 128 + 2 * FWD_STAGES * KEYS) * C * 2 +
         2 * sizeof(Xc) + sizeof(FwdBars);
}
static_assert(cluster16_q_smem<256, PAIR_FWD_KEYS, 1, ExchangeRS>() <=
                  MAX_SMEM,
              "forward at C 256");
static_assert(cluster16_q_smem<256, PAIR_DQ_KEYS, 2>() <= MAX_SMEM,
              "dq at C 256");

// forward at HD 384 and 512, grid (NB ceil(L / FWD_ROWS), B*H) in pairs
// of blocks along x: flash_fwd_sm90_kernel's layout on the block's C
// columns with 64-key tiles (Q 128 x C, a K + V stage 2 x 64 x C); per tile
// each consumer's partial s (m64n64k16 over C / 16 depth slices) summed
// over the cluster, the online softmax, p rounded to T, o += p v one
// 64-column unit at a time (v MN-major). Only rank 0 writes lse (every
// block holds it).
template <typename T, int HD>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_pair_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          T* __restrict__ o,
                          float* __restrict__ lse, int H, int L, int S,
                          float scale) {
  constexpr int NB = cluster16_blocks(HD), C = HD / NB, U = C / 64;
  constexpr int KEYS = PAIR_FWD_KEYS;
  constexpr int Q_BOX = FWD_ROWS * ROW_BYTES, KV_BOX = KEYS * ROW_BYTES;
  constexpr int Q_BYTES = U * Q_BOX, KV_BYTES = U * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);
  unsigned char* const Ks = Qs + Q_BYTES;                   // [stage]
  unsigned char* const Vs = Ks + FWD_STAGES * KV_BYTES;    // [stage]
  auto* xch = reinterpret_cast<Exchange*>(Vs + FWD_STAGES * KV_BYTES);
  auto* bars = reinterpret_cast<FwdBars*>(xch + 2);
  const uint32_t rank = sm90::cluster_ctarank();
  const int col0 = C * rank;                 // this block's columns
  const int q0 = (gridDim.x / NB - 1 - blockIdx.x / NB) * FWD_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = (min(S, q0 + FWD_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->q_full, 1);
    for (int st = 0; st < FWD_STAGES; ++st) {
      sm90::mbar_init(&bars->k_full[st], 1);
      sm90::mbar_init(&bars->v_full[st], 1);
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);   // consumer warps
    }
    init_exchange(&xch[0], NB - 1);
    init_exchange(&xch[1], NB - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&bars->q_full, Q_BYTES);
      load_rows<C>(Qs, Q_BOX, &tq, &bars->q_full, h, q0, b, col0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % FWD_STAGES;
        sm90::mbar_wait(&bars->empty[st], ((j / FWD_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars->k_full[st], KV_BYTES);
        load_rows<C>(Ks + st * KV_BYTES, KV_BOX, &tk, &bars->k_full[st], h,
                       j * KEYS, b, col0);
        sm90::mbar_arrive_expect_tx(&bars->v_full[st], KV_BYTES);
        load_rows<C>(Vs + st * KV_BYTES, KV_BOX, &tv, &bars->v_full[st], h,
                       j * KEYS, b, col0);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;                     // rows q0 + 64 cw ..
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 64 * cw + 16 * warp + g;   // and row + 8
  const unsigned char* const Qw = Qs + 64 * cw * ROW_BYTES;
  const float sl2 = scale * LOG2E;           // scores in log2 units
  float acc[U][32];                          // o, a 64-column unit each
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  sm90::mbar_wait(&bars->q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % FWD_STAGES, k0 = j * KEYS;
    const uint32_t phase = (j / FWD_STAGES) & 1;
    const unsigned char* kt = Ks + st * KV_BYTES;
    const unsigned char* vt = Vs + st * KV_BYTES;
    float s[KEYS / 2];
    const uint64_t desc_q = k_major(Qw), desc_k = k_major(kt);
    sm90::mbar_wait(&bars->k_full[st], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      sm90::wgmma_m64n64k16_ss<T>(s, desc_q + k_step(Q_BOX, kk),
                                  desc_k + k_step(KV_BOX, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    add_peer_partials(&xch[cw], rank ^ 1, tid, j, s);

#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) s[i] *= sl2;
    // the diagonal tile and a ragged last tile: key > row or key >= S
    if (k0 + KEYS - 1 > q0 + 64 * cw || k0 + KEYS > S) {
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (key > row + 8 * ((i / 2) & 1) || key >= S) s[i] = NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i)
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];                      // this thread's share of the sum
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(acc[u]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[u][i] *= alpha[(i / 2) & 1];
    }
    // p (float) into the row sums, p rounded to T into the A registers
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, half = r & 1;
        const float p0 = exp2f(s[i] - m[half]), p1 = exp2f(s[i + 1] - m[half]);
        l[half] += p0;
        l[half] += p1;
        pa[kk][r] = pack16<T>(p0, p1);
      }

    const uint64_t desc_v = mn_major(vt, KV_BOX);
    sm90::mbar_wait(&bars->v_full[st], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        sm90::wgmma_m64n64k16_rs<T>(
            acc[u], pa[kk], desc_v + ((u * KV_BOX) >> 4) + mn_step(kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(&xch[cw], n_tiles);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
    if (t == 0 && row + 8 * r < L && rank == 0)   // every block holds it
      lse[static_cast<int64_t>(bh) * L + row + 8 * r] = m[r] * LN2 + logf(l[r]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    store_acc_rows<T, HD>(o, b, h, L, H, row, t, acc[u], inv,
                            col0 + 64 * u);
}

// dq at HD 384 and 512, grid (NB ceil(L / DQ_ROWS), B*H) in pairs of
// blocks along x: flash_dq_sm90_kernel's layout on the block's C columns
// with 32-key tiles through 2 stages (Q and dO 2 x 128 x C resident); per
// tile each consumer's partial s and dp (m64n32k16 over C / 16 slices)
// summed over the cluster, p and ds (float16: ds on its row scales), dq +=
// ds k one 64-column unit at a time (ds as hi + mid A terms, k MN-major).
// A consumer whose rows all lie before a tile's first key skips it in every
// block.
template <typename T, int HD>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_dq_pair_kernel(const __grid_constant__ CUtensorMap tq,
                         const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const __grid_constant__ CUtensorMap tg,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         T* __restrict__ dq, int H, int L, int S,
                         float scale) {
  constexpr int NB = cluster16_blocks(HD), C = HD / NB, U = C / 64;
  constexpr int KEYS = PAIR_DQ_KEYS;
  constexpr int Q_BOX = DQ_ROWS * ROW_BYTES, KV_BOX = KEYS * ROW_BYTES;
  constexpr int Q_BYTES = U * Q_BOX, KV_BYTES = U * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);
  unsigned char* const Gs = Qs + Q_BYTES;                   // dO
  unsigned char* const Ks = Gs + Q_BYTES;                   // [stage]
  unsigned char* const Vs = Ks + FWD_STAGES * KV_BYTES;    // [stage]
  auto* xch = reinterpret_cast<Exchange*>(Vs + FWD_STAGES * KV_BYTES);
  auto* bars = reinterpret_cast<FwdBars*>(xch + 2);
  const uint32_t rank = sm90::cluster_ctarank();
  const int col0 = C * rank;                 // this block's columns
  const int q0 = (gridDim.x / NB - 1 - blockIdx.x / NB) * DQ_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = (min(S, q0 + DQ_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->q_full, 1);
    for (int st = 0; st < FWD_STAGES; ++st) {
      sm90::mbar_init(&bars->k_full[st], 1);
      sm90::mbar_init(&bars->v_full[st], 1);
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);   // consumer warps
    }
    init_exchange(&xch[0], NB - 1);
    init_exchange(&xch[1], NB - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      sm90::mbar_arrive_expect_tx(&bars->q_full, 2 * Q_BYTES);
      load_rows<C>(Qs, Q_BOX, &tq, &bars->q_full, h, q0, b, col0);
      load_rows<C>(Gs, Q_BOX, &tg, &bars->q_full, h, q0, b, col0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % FWD_STAGES;
        sm90::mbar_wait(&bars->empty[st], ((j / FWD_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars->k_full[st], KV_BYTES);
        load_rows<C>(Ks + st * KV_BYTES, KV_BOX, &tk, &bars->k_full[st], h,
                       j * KEYS, b, col0);
        sm90::mbar_arrive_expect_tx(&bars->v_full[st], KV_BYTES);
        load_rows<C>(Vs + st * KV_BYTES, KV_BOX, &tv, &bars->v_full[st], h,
                       j * KEYS, b, col0);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;                     // rows r0 = q0 + 64 cw ..
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * cw;
  const int row = r0 + 16 * warp + g;        // and row + 8
  const unsigned char* const Qw = Qs + 64 * cw * ROW_BYTES;
  const unsigned char* const Gw = Gs + 64 * cw * ROW_BYTES;
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];                      // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < L;
    const int64_t i = static_cast<int64_t>(bh) * L + row + 8 * r;
    lse2[r] = in ? lse[i] * LOG2E : 0.f;
    dl[r] = in ? delta[i] : 0.f;
  }
  // tiles whose first key lies past this consumer's last row add nothing
  const int my_tiles = (min(S, r0 + 64) + KEYS - 1) / KEYS;
  float acc[U][32];                          // dq, a 64-column unit each
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  int ds_e[2] = {DS16_E0, DS16_E0};          // float16: ds's row scales
  sm90::mbar_wait(&bars->q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % FWD_STAGES, k0 = j * KEYS;
    const uint32_t phase = (j / FWD_STAGES) & 1;
    const unsigned char* kt = Ks + st * KV_BYTES;
    const unsigned char* vt = Vs + st * KV_BYTES;
    sm90::mbar_wait(&bars->k_full[st], phase);
    sm90::mbar_wait(&bars->v_full[st], phase);
    if (j < my_tiles) {
      float s[KEYS / 2], dp[KEYS / 2];
      const uint64_t desc_q = k_major(Qw), desc_k = k_major(kt);
      const uint64_t desc_g = k_major(Gw), desc_v = k_major(vt);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        sm90::wgmma_m64n32k16_ss<T>(s, desc_q + k_step(Q_BOX, kk),
                                    desc_k + k_step(KV_BOX, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        sm90::wgmma_m64n32k16_ss<T>(dp, desc_g + k_step(Q_BOX, kk),
                                    desc_v + k_step(KV_BOX, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      // live tiles are the first my_tiles, so j counts the exchanges
      add_peer_partials(&xch[cw], rank ^ 1, tid, j, s, dp);

      // p = exp(s scale - lse), ds = p (dp - delta) scale; rows: queries
      // row + 8((i / 2) & 1), columns: keys k0 + c
      const bool edge = k0 + KEYS - 1 > r0 || k0 + KEYS > S;
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int r = (i / 2) & 1;
        float p = exp2f(fmaf(s[i], sl2, -lse2[r]));
        if (edge) {
          const int kc = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (kc > row + 8 * r || kc >= S) p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[r]) * scale;
      }
      if constexpr (sm90::is_f16<T>) {   // ds on its row scales
        float rescale[2];
        if (scale_ds_rows(dp, ds_e, rescale)) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            sm90::fence_regs(acc[u]);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[u][i] *= rescale[(i / 2) & 1];
          }
        }
      }
      uint32_t d_hi[KEYS / 16][4], d_mid[KEYS / 16][4];
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], d_hi[kk][r],
                    d_mid[kk][r]);
#pragma unroll
      for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
      sm90::wgmma_fence();
      const uint64_t desc_kt = mn_major(kt, KV_BOX);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          const uint64_t bk = desc_kt + ((u * KV_BOX) >> 4) + mn_step(kk);
          sm90::wgmma_m64n64k16_rs<T>(acc[u], d_hi[kk], bk, 1);
          sm90::wgmma_m64n64k16_rs<T>(acc[u], d_mid[kk], bk, 1);
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
#pragma unroll
      for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(&xch[cw], min(my_tiles, n_tiles));
  float inv[2] = {1.f, 1.f};
  if constexpr (sm90::is_f16<T>) {           // the row scales undone
    inv[0] = pow2(-ds_e[0]);
    inv[1] = pow2(-ds_e[1]);
  }
#pragma unroll
  for (int u = 0; u < U; ++u)
    store_acc_rows<T, HD>(dq, b, h, L, H, row, t, acc[u], inv,
                            col0 + 64 * u);
}

constexpr int PAIR_DKV_ROWS = 32;    // query rows per streamed tile
constexpr int PAIR_DKV_STAGES = 3;

// K and V of 64 keys x C resident, 32-row Q and dO tiles through
// PAIR_DKV_STAGES stages with their lse and delta, an exchange a consumer,
// for blocks of C columns: at C 256 198,488 bytes
template <int C>
constexpr size_t cluster16_dkv_smem() {
  return 1024 +
         static_cast<size_t>(2 * 64 + 2 * PAIR_DKV_STAGES * PAIR_DKV_ROWS) *
             C * 2 +
         2 * sizeof(Exchange) + sizeof(DkvStats<PAIR_DKV_STAGES, PAIR_DKV_ROWS>) +
         sizeof(DkvBars<PAIR_DKV_STAGES>);
}
static_assert(cluster16_dkv_smem<256>() <= MAX_SMEM, "dk/dv at C 256");

// the 64-column units of dk and dv that a 16-bit cluster's dk/dv consumer 0
// takes of a block's `units`: half, rounded up (two of four, two of three);
// consumer 1 the rest, so that both have at least one
__host__ __device__ constexpr int dkv_units0(int units) {
  return (units + 1) / 2;
}

// A dk/dv consumer of a pair: the block's 64 keys (key, key + 8 its rows),
// U 64-column units of dk and dv from unit cw dkv_units0(C / 64) (consumer
// 0 the first dkv_units0 of the block's C / 64, consumer 1 the rest). Both
// consumers form the block's partial s^T and dp^T; each sums the same
// consumer's of every block of the cluster.
template <typename T, int HD, int U>
__device__ __forceinline__ void dkv_pair_consume(
    const unsigned char* Ks, const unsigned char* Vs,
    const unsigned char* Qs, const unsigned char* Gs,
    const DkvStats<PAIR_DKV_STAGES, PAIR_DKV_ROWS>* stats, DkvBars<PAIR_DKV_STAGES>* bars, Exchange* xch,
    uint32_t rank, T* __restrict__ dk, T* __restrict__ dv, int b, int h,
    int H, int L, int S, int k0, int n_tiles, int cw, float scale) {
  constexpr int NB = cluster16_blocks(HD), C = HD / NB, KEYS = 64;
  constexpr int ROWS = PAIR_DKV_ROWS, ST = PAIR_DKV_STAGES;
  constexpr int K_BOX = KEYS * ROW_BYTES, Q_BOX = ROWS * ROW_BYTES;
  constexpr int Q_BYTES = C / 64 * Q_BOX;
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = k0 + 16 * warp + g;        // and key + 8
  const int u0 = dkv_units0(C / 64) * cw;
  const float sl2 = scale * LOG2E;
  float dk_acc[U][32], dv_acc[U][32];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[u][i] = dv_acc[u][i] = 0.f;
  int ds_e[2] = {DS16_E0, DS16_E0};          // float16: ds^T's row scales
  sm90::mbar_wait(&bars->kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % ST, q0 = k0 + j * ROWS;
    const unsigned char* qt = Qs + st * Q_BYTES;
    const unsigned char* gt = Gs + st * Q_BYTES;
    float s[ROWS / 2], dp[ROWS / 2];
    const uint64_t desc_k = k_major(Ks), desc_q = k_major(qt);
    const uint64_t desc_v = k_major(Vs), desc_g = k_major(gt);
    sm90::mbar_wait(&bars->full[st], (j / ST) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      sm90::wgmma_m64n32k16_ss<T>(s, desc_k + k_step(K_BOX, kk),
                                  desc_q + k_step(Q_BOX, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      sm90::wgmma_m64n32k16_ss<T>(dp, desc_v + k_step(K_BOX, kk),
                                  desc_g + k_step(Q_BOX, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    add_peer_partials(&xch[cw], rank ^ 1, tid, j, s, dp);

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale; rows:
    // keys key + 8((i / 2) & 1), columns: query rows q0 + c
    const bool edge = k0 + KEYS - 1 > q0 || q0 + ROWS > L || k0 + KEYS > S;
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);
      float p = exp2f(fmaf(s[i], sl2, -stats->lse[st][c] * LOG2E));
      if (edge) {
        const int kc = key + 8 * ((i / 2) & 1), qr = q0 + c;
        if (kc > qr || kc >= S || qr >= L) p = 0.f;
      }
      dp[i] = p * (dp[i] - stats->delta[st][c]) * scale;
      s[i] = p;
    }
    if constexpr (sm90::is_f16<T>) {   // p^T 2^P16_E, ds^T on its row scales
#pragma unroll
      for (int i = 0; i < ROWS / 2; ++i) s[i] *= pow2(P16_E);
      float rescale[2];
      if (scale_ds_rows(dp, ds_e, rescale)) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sm90::fence_regs(dk_acc[u]);
#pragma unroll
          for (int i = 0; i < 32; ++i) dk_acc[u][i] *= rescale[(i / 2) & 1];
        }
      }
    }
    uint32_t a_hi[ROWS / 16][4], a_mid[ROWS / 16][4];
    uint32_t d_hi[ROWS / 16][4], d_mid[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], a_hi[kk][r],
                  a_mid[kk][r]);
        split2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], d_hi[kk][r],
                  d_mid[kk][r]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(dv_acc[u]);
      sm90::fence_regs(dk_acc[u]);
    }
    sm90::wgmma_fence();
    const uint64_t desc_gt = mn_major(gt, Q_BOX), desc_qt = mn_major(qt, Q_BOX);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        const uint64_t box = (((u0 + u) * Q_BOX) >> 4) + mn_step(kk);
        sm90::wgmma_m64n64k16_rs<T>(dv_acc[u], a_hi[kk], desc_gt + box, 1);
        sm90::wgmma_m64n64k16_rs<T>(dv_acc[u], a_mid[kk], desc_gt + box, 1);
        sm90::wgmma_m64n64k16_rs<T>(dk_acc[u], d_hi[kk], desc_qt + box, 1);
        sm90::wgmma_m64n64k16_rs<T>(dk_acc[u], d_mid[kk], desc_qt + box, 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(dk_acc[u]);
      sm90::fence_regs(dv_acc[u]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(&xch[cw], n_tiles);
  float dk_inv[2] = {1.f, 1.f}, dv_inv[2] = {1.f, 1.f};
  if constexpr (sm90::is_f16<T>) {           // the scales undone
    dk_inv[0] = pow2(-ds_e[0]);
    dk_inv[1] = pow2(-ds_e[1]);
    dv_inv[0] = dv_inv[1] = pow2(-P16_E);
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int col = C * rank + 64 * (u0 + u);
    store_acc_rows<T, HD>(dk, b, h, S, H, key, t, dk_acc[u], dk_inv, col);
    store_acc_rows<T, HD>(dv, b, h, S, H, key, t, dv_acc[u], dv_inv, col);
  }
}

// dk and dv at HD 384 and 512, grid (NB ceil(S / 64), B*H) in pairs of
// blocks along x on the same 64 keys: K and V (64 x C) resident, 32-row
// Q and dO tiles (TMA) with their lse and delta (plain loads) through 3
// stages; both consumers form s^T and dp^T (m64n32k16 over C / 16 slices)
// summed over the cluster, consumer 0 accumulating the first dkv_units0
// 64-column units of dk and dv, consumer 1 the rest (dv += p^T dO and dk +=
// ds^T q,
// m64n64k16 with p^T and ds^T as hi + mid A terms, dO and q MN-major). The
// HD 256 layout's 64-row tiles would hold s^T and dp^T (64 floats a thread)
// beside 128 of dk and dv, more than a consumer's registers hold without
// spilling; 32 rows halve them.
template <typename T, int HD>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_dkv_pair_kernel(const __grid_constant__ CUtensorMap tq,
                          const __grid_constant__ CUtensorMap tk,
                          const __grid_constant__ CUtensorMap tv,
                          const __grid_constant__ CUtensorMap tg,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          T* __restrict__ dk, T* __restrict__ dv, int H, int L,
                          int S, float scale) {
  constexpr int NB = cluster16_blocks(HD), C = HD / NB, U = C / 64;
  constexpr int KEYS = 64, U0 = dkv_units0(U);
  constexpr int ROWS = PAIR_DKV_ROWS, ST = PAIR_DKV_STAGES;
  constexpr int K_BOX = KEYS * ROW_BYTES, Q_BOX = ROWS * ROW_BYTES;
  constexpr int K_BYTES = U * K_BOX, Q_BYTES = U * Q_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Ks = align1024(raw_smem);
  unsigned char* const Vs = Ks + K_BYTES;
  unsigned char* const Qs = Vs + K_BYTES;                // [stage]
  unsigned char* const Gs = Qs + ST * Q_BYTES;           // [stage] dO
  auto* xch = reinterpret_cast<Exchange*>(Gs + ST * Q_BYTES);
  auto* stats = reinterpret_cast<DkvStats<PAIR_DKV_STAGES, PAIR_DKV_ROWS>*>(xch + 2);
  auto* bars = reinterpret_cast<DkvBars<ST>*>(stats + 1);
  const uint32_t rank = sm90::cluster_ctarank();
  const int col0 = C * rank;                 // this block's columns
  const int k0 = (blockIdx.x / NB) * KEYS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = k0 < L ? (L - k0 + ROWS - 1) / ROWS : 0;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->kv_full, 1);
    for (int st = 0; st < ST; ++st) {
      sm90::mbar_init(&bars->full[st], 32);            // the producer warp
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);  // consumer warps
    }
    init_exchange(&xch[0], NB - 1);
    init_exchange(&xch[1], NB - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // producer: its first warp, one row of a tile a lane
    sm90::setmaxnreg_dec<40>();
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    const float* const lse_bh = lse + static_cast<int64_t>(bh) * L;
    const float* const delta_bh = delta + static_cast<int64_t>(bh) * L;
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&bars->kv_full, 2 * K_BYTES);
      load_rows<C>(Ks, K_BOX, &tk, &bars->kv_full, h, k0, b, col0);
      load_rows<C>(Vs, K_BOX, &tv, &bars->kv_full, h, k0, b, col0);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % ST, q0 = k0 + j * ROWS;
      sm90::mbar_wait(&bars->empty[st], ((j / ST) & 1) ^ 1);
      const bool in = q0 + lane < L;
      stats->lse[st][lane] = in ? lse_bh[q0 + lane] : 0.f;
      stats->delta[st][lane] = in ? delta_bh[q0 + lane] : 0.f;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&bars->full[st], 2 * Q_BYTES);
        load_rows<C>(Qs + st * Q_BYTES, Q_BOX, &tq, &bars->full[st], h, q0,
                       b, col0);
        load_rows<C>(Gs + st * Q_BYTES, Q_BOX, &tg, &bars->full[st], h, q0,
                       b, col0);
      } else {
        sm90::mbar_arrive(&bars->full[st]);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  if (wg == 1)
    dkv_pair_consume<T, HD, U0>(Ks, Vs, Qs, Gs, stats, bars, xch, rank, dk,
                                dv, b, h, H, L, S, k0, n_tiles, 0, scale);
  else
    dkv_pair_consume<T, HD, U - U0>(Ks, Vs, Qs, Gs, stats, bars, xch, rank,
                                    dk, dv, b, h, H, L, S, k0, n_tiles, 1,
                                    scale);
}

// ----- bfloat16 and float16 at head dims 640 to 4096: the cluster kernels
// Block rank r of a cluster of NB = cluster16_blocks(HD) blocks (3 to 16;
// past 8 Hopper's non-portable cluster sizes) owns share16_units(HD, r)
// boxes of the head row from column share16_col0(HD, r): the HD / 64 boxes
// dealt so that the shares differ by at most one box, the wider first (640:
// 4 + 3 + 3 boxes; 896: 4 + 4 + 3 + 3; 1152: 4 + 4 + 4 + 3 + 3; 2176: 7 x 4
// + 2 x 3; 3968: 14 x 4 + 2 x 3; 768, 1024, .., 4096: all 4), so that every
// block holds 3 or 4 boxes (192 or 256 columns) and a cluster's time is set
// by a 256-column block, as at 768 and 1024. One instance per element type
// and kernel, a template on the widest share CMAX (256): the head dim is a
// launch argument and NB the cluster's size (a launch attribute), and each
// block runs the body for its own share, CMAX / 64 boxes or one fewer, a
// template on it. Shared memory is laid out for CMAX columns in every
// block, so that each Exchange lies at the same offset in every block of
// the cluster (map_peer maps a block's own address to a peer's). A block
// reads its rank and the cluster's size (%cluster_ctarank,
// %cluster_nctarank) and works out its first column from the head dim
// where it uses them, holding none of them across the tile loop: held
// there, the forward's consumers spilled 92 bytes.
constexpr int CLUSTER16_CMAX = 256;              // columns a block at most
constexpr int CLUSTER16_MIN_HD = 640, CLUSTER16_MAX_HD = 4096;

// the boxes of block rank r of a 16-bit cluster at head dim hd, and its
// first column
__host__ __device__ constexpr int share16_units(int hd, int r) {
  return hd / 64 / cluster16_blocks(hd) +
         (r < hd / 64 % cluster16_blocks(hd) ? 1 : 0);
}
__host__ __device__ constexpr int share16_col0(int hd, int r) {
  return 64 * (hd / 64 / cluster16_blocks(hd) * r +
               (r < hd / 64 % cluster16_blocks(hd)
                    ? r : hd / 64 % cluster16_blocks(hd)));
}
// at every head dim the cluster kernels take (multiples of 128 from 640 to
// 4096): at most 16 blocks (Hopper's largest cluster), each of CMAX / 64
// boxes or one fewer, the shares one after another covering the row
constexpr bool shares16_cover() {
  for (int hd = CLUSTER16_MIN_HD; hd <= CLUSTER16_MAX_HD; hd += 128) {
    int col = 0;
    for (int r = 0; r < cluster16_blocks(hd); ++r) {
      const int u = share16_units(hd, r);
      if (share16_col0(hd, r) != col || u < CLUSTER16_CMAX / 64 - 1 ||
          u > CLUSTER16_CMAX / 64)
        return false;
      col += 64 * u;
    }
    if (col != hd || cluster16_blocks(hd) > 16) return false;
  }
  return true;
}
static_assert(shares16_cover(), "shares of 3 or 4 boxes on at most 16 blocks");

// rows row and row + 8 of a 64 x 64 accumulator into columns col0 .. of a
// [B, N, H, hd] tensor whose head dim hd is a launch argument:
// store_acc_rows on a head dim of 1 with the head's stride H hd and offset
// h hd
template <typename T>
__device__ __forceinline__ void store_unit_rows(T* dst, int hd, int b, int h,
                                                int N, int H, int row, int t,
                                                const float (&acc)[32],
                                                const float (&inv)[2],
                                                int col0) {
  store_acc_rows<T, 1>(dst, b, h * hd, N, H * hd, row, t, acc, inv, col0);
}

// the forward of a block of a cluster kernel on its U boxes:
// flash_fwd_pair_kernel's steps on its 64 U columns, the partial s summed
// over the cluster's blocks in rank order by a reduce-scatter
// (reduce_scatter_partials)
template <typename T, int CMAX, int U>
__device__ __forceinline__ void fwd_cluster_block(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    T* __restrict__ o, float* __restrict__ lse, int H, int L, int S, int hd,
    float scale) {
  constexpr int C = 64 * U, KEYS = PAIR_FWD_KEYS;
  constexpr int Q_BOX = FWD_ROWS * ROW_BYTES, KV_BOX = KEYS * ROW_BYTES;
  constexpr int Q_BYTES = U * Q_BOX, KV_BYTES = U * KV_BOX;   // loaded
  constexpr int Q_SLOT = CMAX / 64 * Q_BOX, KV_SLOT = CMAX / 64 * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);
  unsigned char* const Ks = Qs + Q_SLOT;                   // [stage]
  unsigned char* const Vs = Ks + FWD_STAGES * KV_SLOT;     // [stage]
  auto* xch = reinterpret_cast<ExchangeRS*>(Vs + FWD_STAGES * KV_SLOT);
  auto* bars = reinterpret_cast<FwdBars*>(xch + 2);
  const int nb = cluster16_blocks(hd);
  const int q0 = (gridDim.x / nb - 1 - blockIdx.x / nb) * FWD_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = (min(S, q0 + FWD_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->q_full, 1);
    for (int st = 0; st < FWD_STAGES; ++st) {
      sm90::mbar_init(&bars->k_full[st], 1);
      sm90::mbar_init(&bars->v_full[st], 1);
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);   // consumer warps
    }
    init_exchange_rs(&xch[0], nb);
    init_exchange_rs(&xch[1], nb);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int col0 = share16_col0(hd, sm90::cluster_ctarank());
      sm90::mbar_arrive_expect_tx(&bars->q_full, Q_BYTES);
      load_rows<C>(Qs, Q_BOX, tq, &bars->q_full, h, q0, b, col0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % FWD_STAGES;
        sm90::mbar_wait(&bars->empty[st], ((j / FWD_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars->k_full[st], KV_BYTES);
        load_rows<C>(Ks + st * KV_SLOT, KV_BOX, tk, &bars->k_full[st], h,
                     j * KEYS, b, col0);
        sm90::mbar_arrive_expect_tx(&bars->v_full[st], KV_BYTES);
        load_rows<C>(Vs + st * KV_SLOT, KV_BOX, tv, &bars->v_full[st], h,
                     j * KEYS, b, col0);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;                     // rows q0 + 64 cw ..
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 64 * cw + 16 * warp + g;   // and row + 8
  const unsigned char* const Qw = Qs + 64 * cw * ROW_BYTES;
  const float sl2 = scale * LOG2E;           // scores in log2 units
  float acc[U][32];                          // o, a 64-column unit each
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  sm90::mbar_wait(&bars->q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % FWD_STAGES, k0 = j * KEYS;
    const uint32_t phase = (j / FWD_STAGES) & 1;
    const unsigned char* kt = Ks + st * KV_SLOT;
    const unsigned char* vt = Vs + st * KV_SLOT;
    float s[KEYS / 2];
    const uint64_t desc_q = k_major(Qw), desc_k = k_major(kt);
    sm90::mbar_wait(&bars->k_full[st], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      sm90::wgmma_m64n64k16_ss<T>(s, desc_q + k_step(Q_BOX, kk),
                                  desc_k + k_step(KV_BOX, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    // two ranks' loads in flight in the reduce: beside o's 128 floats a
    // thread, four or eight spilled
    reduce_scatter_partials<2>(&xch[cw], sm90::cluster_nctarank(),
                               sm90::cluster_ctarank(), tid, j, s);

#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) s[i] *= sl2;
    // the diagonal tile and a ragged last tile: key > row or key >= S
    if (k0 + KEYS - 1 > q0 + 64 * cw || k0 + KEYS > S) {
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (key > row + 8 * ((i / 2) & 1) || key >= S) s[i] = NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i)
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];                      // this thread's share of the sum
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(acc[u]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[u][i] *= alpha[(i / 2) & 1];
    }
    // p (float) into the row sums, p rounded to T into the A registers
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, half = r & 1;
        const float p0 = exp2f(s[i] - m[half]), p1 = exp2f(s[i + 1] - m[half]);
        l[half] += p0;
        l[half] += p1;
        pa[kk][r] = pack16<T>(p0, p1);
      }

    const uint64_t desc_v = mn_major(vt, KV_BOX);
    sm90::mbar_wait(&bars->v_full[st], phase);
    sm90::wgmma_fence();
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
        sm90::wgmma_m64n64k16_rs<T>(
            acc[u], pa[kk], desc_v + ((u * KV_BOX) >> 4) + mn_step(kk), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(&xch[cw], n_tiles);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
    if (t == 0 && row + 8 * r < L &&
        sm90::cluster_ctarank() == 0)        // every block holds it
      lse[static_cast<int64_t>(bh) * L + row + 8 * r] = m[r] * LN2 + logf(l[r]);
  }
  const int col0 = share16_col0(hd, sm90::cluster_ctarank());
#pragma unroll
  for (int u = 0; u < U; ++u)
    store_unit_rows(o, hd, b, h, L, H, row, t, acc[u], inv, col0 + 64 * u);
}

// forward at HD 640 to 4096 (a launch argument), grid (NB ceil(L /
// FWD_ROWS), B*H) in clusters of NB = cluster16_blocks(HD) blocks along x,
// each running fwd_cluster_block on its share
template <typename T, int CMAX>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_fwd_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             T* __restrict__ o, float* __restrict__ lse,
                             int H, int L, int S, int hd, float scale) {
  if (share16_units(hd, sm90::cluster_ctarank()) == CMAX / 64)
    fwd_cluster_block<T, CMAX, CMAX / 64>(&tq, &tk, &tv, o, lse, H, L, S, hd,
                                          scale);
  else
    fwd_cluster_block<T, CMAX, CMAX / 64 - 1>(&tq, &tk, &tv, o, lse, H, L,
                                              S, hd, scale);
}

// dq of a block of a cluster kernel on its U boxes: flash_dq_pair_kernel's
// steps on its 64 U columns, the partial s and dp summed over the
// cluster's blocks rank by rank
template <typename T, int CMAX, int U>
__device__ __forceinline__ void dq_cluster_block(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tg, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int H, int L, int S,
    int hd, float scale) {
  constexpr int C = 64 * U, KEYS = PAIR_DQ_KEYS;
  constexpr int Q_BOX = DQ_ROWS * ROW_BYTES, KV_BOX = KEYS * ROW_BYTES;
  constexpr int Q_BYTES = U * Q_BOX, KV_BYTES = U * KV_BOX;   // loaded
  constexpr int Q_SLOT = CMAX / 64 * Q_BOX, KV_SLOT = CMAX / 64 * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);
  unsigned char* const Gs = Qs + Q_SLOT;                   // dO
  unsigned char* const Ks = Gs + Q_SLOT;                   // [stage]
  unsigned char* const Vs = Ks + FWD_STAGES * KV_SLOT;     // [stage]
  auto* xch = reinterpret_cast<Exchange*>(Vs + FWD_STAGES * KV_SLOT);
  auto* bars = reinterpret_cast<FwdBars*>(xch + 2);
  const int nb = cluster16_blocks(hd);
  const int q0 = (gridDim.x / nb - 1 - blockIdx.x / nb) * DQ_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = (min(S, q0 + DQ_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->q_full, 1);
    for (int st = 0; st < FWD_STAGES; ++st) {
      sm90::mbar_init(&bars->k_full[st], 1);
      sm90::mbar_init(&bars->v_full[st], 1);
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);   // consumer warps
    }
    init_exchange(&xch[0], nb - 1);
    init_exchange(&xch[1], nb - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // producer
    sm90::setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      const int col0 = share16_col0(hd, sm90::cluster_ctarank());
      sm90::mbar_arrive_expect_tx(&bars->q_full, 2 * Q_BYTES);
      load_rows<C>(Qs, Q_BOX, tq, &bars->q_full, h, q0, b, col0);
      load_rows<C>(Gs, Q_BOX, tg, &bars->q_full, h, q0, b, col0);
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % FWD_STAGES;
        sm90::mbar_wait(&bars->empty[st], ((j / FWD_STAGES) & 1) ^ 1);
        sm90::mbar_arrive_expect_tx(&bars->k_full[st], KV_BYTES);
        load_rows<C>(Ks + st * KV_SLOT, KV_BOX, tk, &bars->k_full[st], h,
                     j * KEYS, b, col0);
        sm90::mbar_arrive_expect_tx(&bars->v_full[st], KV_BYTES);
        load_rows<C>(Vs + st * KV_SLOT, KV_BOX, tv, &bars->v_full[st], h,
                     j * KEYS, b, col0);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<240>();
  const int cw = wg - 1;                     // rows r0 = q0 + 64 cw ..
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + 64 * cw;
  const int row = r0 + 16 * warp + g;        // and row + 8
  const unsigned char* const Qw = Qs + 64 * cw * ROW_BYTES;
  const unsigned char* const Gw = Gs + 64 * cw * ROW_BYTES;
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];                      // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < L;
    const int64_t i = static_cast<int64_t>(bh) * L + row + 8 * r;
    lse2[r] = in ? lse[i] * LOG2E : 0.f;
    dl[r] = in ? delta[i] : 0.f;
  }
  // tiles whose first key lies past this consumer's last row add nothing
  const int my_tiles = (min(S, r0 + 64) + KEYS - 1) / KEYS;
  float acc[U][32];                          // dq, a 64-column unit each
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  int ds_e[2] = {DS16_E0, DS16_E0};          // float16: ds's row scales
  sm90::mbar_wait(&bars->q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % FWD_STAGES, k0 = j * KEYS;
    const uint32_t phase = (j / FWD_STAGES) & 1;
    const unsigned char* kt = Ks + st * KV_SLOT;
    const unsigned char* vt = Vs + st * KV_SLOT;
    sm90::mbar_wait(&bars->k_full[st], phase);
    sm90::mbar_wait(&bars->v_full[st], phase);
    if (j < my_tiles) {
      float s[KEYS / 2], dp[KEYS / 2];
      const uint64_t desc_q = k_major(Qw), desc_k = k_major(kt);
      const uint64_t desc_g = k_major(Gw), desc_v = k_major(vt);
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        sm90::wgmma_m64n32k16_ss<T>(s, desc_q + k_step(Q_BOX, kk),
                                    desc_k + k_step(KV_BOX, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < C / 16; ++kk)
        sm90::wgmma_m64n32k16_ss<T>(dp, desc_g + k_step(Q_BOX, kk),
                                    desc_v + k_step(KV_BOX, kk), kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      // live tiles are the first my_tiles, so j counts the exchanges
      add_cluster_partials_n(&xch[cw], sm90::cluster_nctarank(),
                             sm90::cluster_ctarank(), tid, j, s, dp);

      // p = exp(s scale - lse), ds = p (dp - delta) scale; rows: queries
      // row + 8((i / 2) & 1), columns: keys k0 + c
      const bool edge = k0 + KEYS - 1 > r0 || k0 + KEYS > S;
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int r = (i / 2) & 1;
        float p = exp2f(fmaf(s[i], sl2, -lse2[r]));
        if (edge) {
          const int kc = k0 + 8 * (i / 4) + 2 * t + (i & 1);
          if (kc > row + 8 * r || kc >= S) p = 0.f;
        }
        dp[i] = p * (dp[i] - dl[r]) * scale;
      }
      if constexpr (sm90::is_f16<T>) {   // ds on its row scales
        float rescale[2];
        if (scale_ds_rows(dp, ds_e, rescale)) {
#pragma unroll
          for (int u = 0; u < U; ++u) {
            sm90::fence_regs(acc[u]);
#pragma unroll
            for (int i = 0; i < 32; ++i) acc[u][i] *= rescale[(i / 2) & 1];
          }
        }
      }
      uint32_t d_hi[KEYS / 16][4], d_mid[KEYS / 16][4];
#pragma unroll
      for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          split2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], d_hi[kk][r],
                    d_mid[kk][r]);
#pragma unroll
      for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
      sm90::wgmma_fence();
      const uint64_t desc_kt = mn_major(kt, KV_BOX);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          const uint64_t bk = desc_kt + ((u * KV_BOX) >> 4) + mn_step(kk);
          sm90::wgmma_m64n64k16_rs<T>(acc[u], d_hi[kk], bk, 1);
          sm90::wgmma_m64n64k16_rs<T>(acc[u], d_mid[kk], bk, 1);
        }
      sm90::wgmma_commit();
      sm90::wgmma_wait();
#pragma unroll
      for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(&xch[cw], min(my_tiles, n_tiles));
  float inv[2] = {1.f, 1.f};
  if constexpr (sm90::is_f16<T>) {           // the row scales undone
    inv[0] = pow2(-ds_e[0]);
    inv[1] = pow2(-ds_e[1]);
  }
  const int col0 = share16_col0(hd, sm90::cluster_ctarank());
#pragma unroll
  for (int u = 0; u < U; ++u)
    store_unit_rows(dq, hd, b, h, L, H, row, t, acc[u], inv, col0 + 64 * u);
}

// dq at HD 640 to 4096, grid (NB ceil(L / DQ_ROWS), B*H) in clusters of NB
// blocks along x, each running dq_cluster_block on its share
template <typename T, int CMAX>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_dq_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __grid_constant__ CUtensorMap tg,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            T* __restrict__ dq, int H, int L, int S, int hd,
                            float scale) {
  if (share16_units(hd, sm90::cluster_ctarank()) == CMAX / 64)
    dq_cluster_block<T, CMAX, CMAX / 64>(&tq, &tk, &tv, &tg, lse, delta, dq,
                                         H, L, S, hd, scale);
  else
    dq_cluster_block<T, CMAX, CMAX / 64 - 1>(&tq, &tk, &tv, &tg, lse, delta,
                                             dq, H, L, S, hd, scale);
}

// A dk/dv consumer of a block of a cluster kernel on UB boxes: the block's
// 64 keys (key, key + 8 its rows), U 64-column units of dk and dv from unit
// cw dkv_units0(UB) of its share (dkv_pair_consume's steps). Both consumers
// form the block's partial s^T and dp^T; each sums the same consumer's of
// the cluster's blocks rank by rank.
template <typename T, int CMAX, int UB, int U>
__device__ __forceinline__ void dkv_cluster_consume(
    const unsigned char* Ks, const unsigned char* Vs,
    const unsigned char* Qs, const unsigned char* Gs,
    const DkvStats<PAIR_DKV_STAGES, PAIR_DKV_ROWS>* stats,
    DkvBars<PAIR_DKV_STAGES>* bars, Exchange* xch, T* __restrict__ dk,
    T* __restrict__ dv, int b, int h, int H, int L, int S, int hd, int k0,
    int n_tiles, int cw, float scale) {
  constexpr int C = 64 * UB, KEYS = 64;
  constexpr int ROWS = PAIR_DKV_ROWS, ST = PAIR_DKV_STAGES;
  constexpr int K_BOX = KEYS * ROW_BYTES, Q_BOX = ROWS * ROW_BYTES;
  constexpr int Q_SLOT = CMAX / 64 * Q_BOX;
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = k0 + 16 * warp + g;        // and key + 8
  const int u0 = dkv_units0(UB) * cw;
  const float sl2 = scale * LOG2E;
  float dk_acc[U][32], dv_acc[U][32];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[u][i] = dv_acc[u][i] = 0.f;
  int ds_e[2] = {DS16_E0, DS16_E0};          // float16: ds^T's row scales
  sm90::mbar_wait(&bars->kv_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % ST, q0 = k0 + j * ROWS;
    const unsigned char* qt = Qs + st * Q_SLOT;
    const unsigned char* gt = Gs + st * Q_SLOT;
    float s[ROWS / 2], dp[ROWS / 2];
    const uint64_t desc_k = k_major(Ks), desc_q = k_major(qt);
    const uint64_t desc_v = k_major(Vs), desc_g = k_major(gt);
    sm90::mbar_wait(&bars->full[st], (j / ST) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      sm90::wgmma_m64n32k16_ss<T>(s, desc_k + k_step(K_BOX, kk),
                                  desc_q + k_step(Q_BOX, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < C / 16; ++kk)
      sm90::wgmma_m64n32k16_ss<T>(dp, desc_v + k_step(K_BOX, kk),
                                  desc_g + k_step(Q_BOX, kk), kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    add_cluster_partials_n(&xch[cw], sm90::cluster_nctarank(),
                           sm90::cluster_ctarank(), tid, j, s, dp);

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale; rows:
    // keys key + 8((i / 2) & 1), columns: query rows q0 + c
    const bool edge = k0 + KEYS - 1 > q0 || q0 + ROWS > L || k0 + KEYS > S;
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);
      float p = exp2f(fmaf(s[i], sl2, -stats->lse[st][c] * LOG2E));
      if (edge) {
        const int kc = key + 8 * ((i / 2) & 1), qr = q0 + c;
        if (kc > qr || kc >= S || qr >= L) p = 0.f;
      }
      dp[i] = p * (dp[i] - stats->delta[st][c]) * scale;
      s[i] = p;
    }
    if constexpr (sm90::is_f16<T>) {   // p^T 2^P16_E, ds^T on its row scales
#pragma unroll
      for (int i = 0; i < ROWS / 2; ++i) s[i] *= pow2(P16_E);
      float rescale[2];
      if (scale_ds_rows(dp, ds_e, rescale)) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sm90::fence_regs(dk_acc[u]);
#pragma unroll
          for (int i = 0; i < 32; ++i) dk_acc[u][i] *= rescale[(i / 2) & 1];
        }
      }
    }
    uint32_t a_hi[ROWS / 16][4], a_mid[ROWS / 16][4];
    uint32_t d_hi[ROWS / 16][4], d_mid[ROWS / 16][4];
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        split2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1], a_hi[kk][r],
                  a_mid[kk][r]);
        split2<T>(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1], d_hi[kk][r],
                  d_mid[kk][r]);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(dv_acc[u]);
      sm90::fence_regs(dk_acc[u]);
    }
    sm90::wgmma_fence();
    const uint64_t desc_gt = mn_major(gt, Q_BOX), desc_qt = mn_major(qt, Q_BOX);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int kk = 0; kk < ROWS / 16; ++kk) {
        const uint64_t box = (((u0 + u) * Q_BOX) >> 4) + mn_step(kk);
        sm90::wgmma_m64n64k16_rs<T>(dv_acc[u], a_hi[kk], desc_gt + box, 1);
        sm90::wgmma_m64n64k16_rs<T>(dv_acc[u], a_mid[kk], desc_gt + box, 1);
        sm90::wgmma_m64n64k16_rs<T>(dk_acc[u], d_hi[kk], desc_qt + box, 1);
        sm90::wgmma_m64n64k16_rs<T>(dk_acc[u], d_mid[kk], desc_qt + box, 1);
      }
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(dk_acc[u]);
      sm90::fence_regs(dv_acc[u]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(&xch[cw], n_tiles);
  float dk_inv[2] = {1.f, 1.f}, dv_inv[2] = {1.f, 1.f};
  if constexpr (sm90::is_f16<T>) {           // the scales undone
    dk_inv[0] = pow2(-ds_e[0]);
    dk_inv[1] = pow2(-ds_e[1]);
    dv_inv[0] = dv_inv[1] = pow2(-P16_E);
  }
  const int col0 = share16_col0(hd, sm90::cluster_ctarank());
#pragma unroll
  for (int u = 0; u < U; ++u) {
    const int col = col0 + 64 * (u0 + u);
    store_unit_rows(dk, hd, b, h, S, H, key, t, dk_acc[u], dk_inv, col);
    store_unit_rows(dv, hd, b, h, S, H, key, t, dv_acc[u], dv_inv, col);
  }
}

// dk and dv of a block of a cluster kernel on its UB boxes:
// flash_dkv_pair_kernel's steps on its 64 UB columns
template <typename T, int CMAX, int UB>
__device__ __forceinline__ void dkv_cluster_block(
    const CUtensorMap* tq, const CUtensorMap* tk, const CUtensorMap* tv,
    const CUtensorMap* tg, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int H, int L, int S, int hd, float scale) {
  constexpr int C = 64 * UB, KEYS = 64, U0 = dkv_units0(UB);
  constexpr int ROWS = PAIR_DKV_ROWS, ST = PAIR_DKV_STAGES;
  constexpr int K_BOX = KEYS * ROW_BYTES, Q_BOX = ROWS * ROW_BYTES;
  constexpr int K_BYTES = UB * K_BOX, Q_BYTES = UB * Q_BOX;   // loaded
  constexpr int K_SLOT = CMAX / 64 * K_BOX, Q_SLOT = CMAX / 64 * Q_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Ks = align1024(raw_smem);
  unsigned char* const Vs = Ks + K_SLOT;
  unsigned char* const Qs = Vs + K_SLOT;                 // [stage]
  unsigned char* const Gs = Qs + ST * Q_SLOT;            // [stage] dO
  auto* xch = reinterpret_cast<Exchange*>(Gs + ST * Q_SLOT);
  auto* stats = reinterpret_cast<DkvStats<ST, ROWS>*>(xch + 2);
  auto* bars = reinterpret_cast<DkvBars<ST>*>(stats + 1);
  const int nb = cluster16_blocks(hd);
  const int k0 = (blockIdx.x / nb) * KEYS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int n_tiles = k0 < L ? (L - k0 + ROWS - 1) / ROWS : 0;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    sm90::mbar_init(&bars->kv_full, 1);
    for (int st = 0; st < ST; ++st) {
      sm90::mbar_init(&bars->full[st], 32);            // the producer warp
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32);  // consumer warps
    }
    init_exchange(&xch[0], nb - 1);
    init_exchange(&xch[1], nb - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // producer: its first warp, one row of a tile a lane
    sm90::setmaxnreg_dec<40>();
    const int lane = threadIdx.x;
    if (lane >= 32) return;
    const float* const lse_bh = lse + static_cast<int64_t>(bh) * L;
    const float* const delta_bh = delta + static_cast<int64_t>(bh) * L;
    const int col0 = share16_col0(hd, sm90::cluster_ctarank());
    if (lane == 0) {
      sm90::mbar_arrive_expect_tx(&bars->kv_full, 2 * K_BYTES);
      load_rows<C>(Ks, K_BOX, tk, &bars->kv_full, h, k0, b, col0);
      load_rows<C>(Vs, K_BOX, tv, &bars->kv_full, h, k0, b, col0);
    }
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % ST, q0 = k0 + j * ROWS;
      sm90::mbar_wait(&bars->empty[st], ((j / ST) & 1) ^ 1);
      const bool in = q0 + lane < L;
      stats->lse[st][lane] = in ? lse_bh[q0 + lane] : 0.f;
      stats->delta[st][lane] = in ? delta_bh[q0 + lane] : 0.f;
      if (lane == 0) {
        sm90::mbar_arrive_expect_tx(&bars->full[st], 2 * Q_BYTES);
        load_rows<C>(Qs + st * Q_SLOT, Q_BOX, tq, &bars->full[st], h, q0, b,
                     col0);
        load_rows<C>(Gs + st * Q_SLOT, Q_BOX, tg, &bars->full[st], h, q0, b,
                     col0);
      } else {
        sm90::mbar_arrive(&bars->full[st]);
      }
    }
    return;
  }

  sm90::setmaxnreg_inc<232>();
  if (wg == 1)
    dkv_cluster_consume<T, CMAX, UB, U0>(Ks, Vs, Qs, Gs, stats, bars, xch,
                                         dk, dv, b, h, H, L, S, hd, k0,
                                         n_tiles, 0, scale);
  else
    dkv_cluster_consume<T, CMAX, UB, UB - U0>(Ks, Vs, Qs, Gs, stats, bars,
                                              xch, dk, dv, b, h, H, L, S, hd,
                                              k0, n_tiles, 1, scale);
}

// dk and dv at HD 640 to 4096, grid (NB ceil(S / 64), B*H) in clusters of
// NB blocks along x on the same 64 keys, each running dkv_cluster_block on
// its share
template <typename T, int CMAX>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_dkv_cluster_kernel(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const __grid_constant__ CUtensorMap tg,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             T* __restrict__ dk, T* __restrict__ dv, int H,
                             int L, int S, int hd, float scale) {
  if (share16_units(hd, sm90::cluster_ctarank()) == CMAX / 64)
    dkv_cluster_block<T, CMAX, CMAX / 64>(&tq, &tk, &tv, &tg, lse, delta, dk,
                                          dv, H, L, S, hd, scale);
  else
    dkv_cluster_block<T, CMAX, CMAX / 64 - 1>(&tq, &tk, &tv, &tg, lse, delta,
                                              dk, dv, H, L, S, hd, scale);
}

// ----- float32 at head dims 2176 and 2304: clusters of 192-column shares
// Past sixteen 128-column blocks (2048) the float32 layouts above cannot
// grow: Hopper's largest cluster is 16 blocks, and their blocks on 192
// columns would not fit (the forward's 128 resident Q rows as terms take
// 144 KB, its 64-key K and V term tiles 72 KB each). So block rank r of a
// cluster of NB = shares3_blocks(HD) = ceil(HD / 192) blocks owns
// share3_units(HD, r) of the head row's HD / 64 boxes, dealt so that the
// shares differ by at most one box, the wider first (2304 = 12 x 192, 2176
// = 10 x 192 + 2 x 128: twelve blocks; share16_units' rule at 192
// columns), on fewer rows and shorter streamed tiles than the 128-column
// layouts. One instance of each kernel, a template on the widest share
// CMAX (192): the head dim a launch argument, NB the cluster's size (a
// launch attribute, past 8 Hopper's non-portable sizes), each block
// running the body for its own share, three boxes or two, a template on
// it; shared memory laid out for CMAX columns in every block, so that the
// exchange lies at the same offset in each. The arithmetic is the other
// float32 kernels': three bf16 terms a float, six wgmma products a product,
// a converter warpgroup writing term rows in the 128-byte swizzle from
// plain loads (split_share: a box at a time, 16 rows a pass), the cluster's
// partial s (and dp) added rank by rank in rank order, so that every block
// holds the same bits, only rank 0 writing lse. A term row of 192 columns
// is 1,152 bytes (three terms), so:
// - forward: 64 query rows a block and one consumer warpgroup (their Q
//   terms resident, 72 KB), 32-key K and V term tiles in two stages (144
//   KB), s of 64 x 32 (wgmma m64n32k16) through an 8 KB exchange
//   (ExchangeT<4>), o += p v in 64-column units (m64n64k16, v MN-major):
//   230,448 bytes, 256 threads.
// - dq: 64 query rows, their Q and dO terms resident (144 KB), 16-key K and
//   V term tiles in two stages (72 KB), s and dp of 64 x 16 (m64n16k16)
//   through an 8 KB exchange, dq += ds k in units: 230,448 bytes, 256
//   threads.
// - dk/dv: 64 keys, their K and V terms resident (144 KB), 16-row Q and dO
//   term tiles in two stages (72 KB) with their lse and delta. dk and dv of
//   64 x 192 would be 192 floats a thread, so two consumer warpgroups split
//   the block's units (consumer 0 the first UB / 2, consumer 1 the rest:
//   one and two at 192 columns, one and one at 128). Room is left for one
//   exchange only (230,704 of 232,448 bytes), so consumer 0 alone forms the
//   block's partial s^T and dp^T and keeps it in the exchange
//   (add_cluster_partials_w), and consumer 1 reads the same NB slots and
//   adds them in the same order (read_cluster_partials): both hold the same
//   bits, and no score product is done twice. 384 threads; setmaxnreg
//   moves registers from the converter (88) to the consumers (208).
// Products issued / needed as at 128 columns: 12 / 2, 18 / 3, 24 / 4.
constexpr int SHARES3_CMAX = 192;                // columns a block at most
constexpr int SHARES3_MIN_HD = 2176, SHARES3_MAX_HD = 2304;
constexpr int S3_ROWS = 64;       // query rows (dk/dv: keys) a block
constexpr int S3_FWD_KEYS = 32;   // keys a forward K or V tile
constexpr int S3_TILE = 16;       // keys a dq tile, query rows a dk/dv tile
constexpr int S3_STAGES = 2;
constexpr int S3_CONVERTER_REGS = 88, S3_CONSUMER_REGS = 208;
static_assert(LAUNCH_REGS - S3_CONVERTER_REGS >=
                  2 * (S3_CONSUMER_REGS - LAUNCH_REGS),
              "the consumers take more registers than the converter frees");
using Exchange3 = ExchangeT<4>;   // 16 floats a thread, 8 KB

// the blocks of a float32 cluster on 192-column shares at head dim hd, the
// boxes of block rank r and its first column
__host__ __device__ constexpr int shares3_blocks(int hd) {
  return (hd + SHARES3_CMAX - 1) / SHARES3_CMAX;
}
__host__ __device__ constexpr int share3_units(int hd, int r) {
  return hd / 64 / shares3_blocks(hd) +
         (r < hd / 64 % shares3_blocks(hd) ? 1 : 0);
}
__host__ __device__ constexpr int share3_col0(int hd, int r) {
  return 64 * (hd / 64 / shares3_blocks(hd) * r +
               (r < hd / 64 % shares3_blocks(hd)
                    ? r : hd / 64 % shares3_blocks(hd)));
}
// at every head dim from 1152 (where the float32 clusters pass eight
// blocks) to SHARES3_MAX_HD: at most 16 blocks, each of CMAX / 64 boxes or
// one fewer, the shares one after another covering the row
constexpr bool shares3_cover() {
  for (int hd = 1152; hd <= SHARES3_MAX_HD; hd += 128) {
    int col = 0;
    for (int r = 0; r < shares3_blocks(hd); ++r) {
      const int u = share3_units(hd, r);
      if (share3_col0(hd, r) != col || u < SHARES3_CMAX / 64 - 1 ||
          u > SHARES3_CMAX / 64)
        return false;
      col += 64 * u;
    }
    if (col != hd || shares3_blocks(hd) > 16) return false;
  }
  return true;
}
static_assert(shares3_cover(), "shares of 2 or 3 boxes on at most 16 blocks");

// Rows [row0, row0 + ROWS) of a float head (element offset oh of a row of
// oH floats: head h of a [B, N, H, hd] tensor at oh = h hd, oH = H hd), its
// 64 columns from col, as their three bf16 terms in one 64-column box of
// each term (term s at dst + s * term) in the 128-byte swizzle; rows past N
// as zeros. Thread tid of a warpgroup takes the 8-column chunk tid % 8 of
// rows tid / 8 + 16 i (a quarter warp on one row: 256-byte loads, 128-byte
// swizzled stores without bank conflicts).
template <int ROWS>
__device__ __forceinline__ void split_box(unsigned char* dst, int term,
                                          const float* __restrict__ src,
                                          int b, int oh, int N, int oH,
                                          int row0, int tid, int col) {
  static_assert(ROWS % 16 == 0, "whole passes of 16 rows");
  const int c = tid % 8, rr = tid / 8;
  unsigned char* const out = dst + rr * ROW_BYTES + ((c ^ (rr % 8)) * 16);
#pragma unroll
  for (int i = 0; i < ROWS / 16; ++i) {
    const int row = row0 + rr + 16 * i;
    float4 x0 = make_float4(0.f, 0.f, 0.f, 0.f), x1 = x0;
    if (row < N) {
      const float4* p = reinterpret_cast<const float4*>(
          src + offset<1>(b, row, oh, N, oH) + col + 8 * c);
      x0 = __ldg(p);
      x1 = __ldg(p + 1);
    }
    uint4 t1, t2, t3;
    split3(x0.x, x0.y, t1.x, t2.x, t3.x);
    split3(x0.z, x0.w, t1.y, t2.y, t3.y);
    split3(x1.x, x1.y, t1.z, t2.z, t3.z);
    split3(x1.z, x1.w, t1.w, t2.w, t3.w);
    unsigned char* const o = out + i * 16 * ROW_BYTES;
    *reinterpret_cast<uint4*>(o) = t1;
    *reinterpret_cast<uint4*>(o + term) = t2;
    *reinterpret_cast<uint4*>(o + 2 * term) = t3;
  }
}

// split_box for each of the U boxes of a share from column col0, the boxes
// `box` bytes apart
template <int ROWS, int U>
__device__ __forceinline__ void split_share(unsigned char* dst, int box,
                                            int term,
                                            const float* __restrict__ src,
                                            int b, int oh, int N, int oH,
                                            int row0, int tid, int col0) {
#pragma unroll
  for (int u = 0; u < U; ++u)
    split_box<ROWS>(dst + u * box, term, src, b, oh, N, oH, row0, tid,
                    col0 + 64 * u);
}

// add_cluster_partials_n in a block whose other consumer warpgroup reads
// the sums too (read_cluster_partials): this block's partials go into its
// slot once every reader has read exchange e - 1, and this warpgroup
// arrives on full in every block, its own included; once every block's
// writer has arrived here, each element becomes the rank-order sum and it
// arrives on empty in every peer. full counts nb WG arrivals, empty (2 nb -
// 1) WG: every other block's writer and every block's reader.
template <typename Xc, typename... Parts>
__device__ __forceinline__ void add_cluster_partials_w(Xc* xc, int nb,
                                                       uint32_t rank, int tid,
                                                       int e,
                                                       Parts&... parts) {
  const uint32_t parity = e & 1;
  sm90::mbar_wait_cluster(&xc->empty, parity ^ 1);   // all read e - 1
  int i = 0;
  (keep_partial(parts, xc, tid, i), ...);
  for (int r = 0; r < nb; ++r)
    sm90::mbar_arrive_cluster(sm90::map_peer(&xc->full, r));
  sm90::mbar_wait_cluster(&xc->full, parity);        // every block's e
  sum_cluster_slots(xc, nb, rank, tid, parts...);
  for (int r = 0; r < nb; ++r)
    if (r != static_cast<int>(rank))
      sm90::mbar_arrive_cluster(sm90::map_peer(&xc->empty, r));
}

// the reader's side: once every block's writer has kept its exchange e,
// `parts` become the same rank-order sum; then it arrives on empty in every
// block, its own included
template <typename Xc, typename... Parts>
__device__ __forceinline__ void read_cluster_partials(Xc* xc, int nb,
                                                      uint32_t rank, int tid,
                                                      int e,
                                                      Parts&... parts) {
  sm90::mbar_wait_cluster(&xc->full, e & 1);
  sum_cluster_slots(xc, nb, rank, tid, parts...);
  for (int r = 0; r < nb; ++r)
    sm90::mbar_arrive_cluster(sm90::map_peer(&xc->empty, r));
}

// the three kernels' shared memory, laid out for CMAX columns: forward and
// dq 230,448 bytes, dk/dv 230,704
template <int CMAX>
constexpr size_t fwd_shares3_smem() {
  return 1024 +
         static_cast<size_t>(TERMS) * CMAX / 64 * ROW_BYTES *
             (S3_ROWS + 2 * S3_STAGES * S3_FWD_KEYS) +
         sizeof(Exchange3) + sizeof(Ring3Bars);
}
template <int CMAX>
constexpr size_t dq_shares3_smem() {
  return 1024 +
         static_cast<size_t>(TERMS) * CMAX / 64 * ROW_BYTES *
             (2 * S3_ROWS + 2 * S3_STAGES * S3_TILE) +
         sizeof(Exchange3) + sizeof(Ring3Bars);
}
template <int CMAX>
constexpr size_t dkv_shares3_smem() {
  return dq_shares3_smem<CMAX>() + sizeof(DkvStats<S3_STAGES, S3_TILE>);
}
static_assert(fwd_shares3_smem<SHARES3_CMAX>() <= MAX_SMEM &&
                  dq_shares3_smem<SHARES3_CMAX>() <= MAX_SMEM &&
                  dkv_shares3_smem<SHARES3_CMAX>() <= MAX_SMEM,
              "float32 at 192 columns a block");

// the float32 forward of a block of a cluster on its U boxes: the
// converter (warpgroup 0) streams 32-key K and V tiles as terms through
// two stages; the consumer (warpgroup 1) splits its 64 Q rows once, then
// per tile s = q k^T (6 x 4U wgmma m64n32k16), the cluster's rank-order
// sum, the online softmax, p as three register A terms, o += p v (6 x 2
// wgmma m64n64k16 a unit)
template <int CMAX, int U>
__device__ __forceinline__ void fwd_shares3_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ o,
    float* __restrict__ lse, int H, int L, int S, int hd, float scale) {
  constexpr int KEYS = S3_FWD_KEYS;
  constexpr int Q_BOX = S3_ROWS * ROW_BYTES, KV_BOX = KEYS * ROW_BYTES;
  constexpr int Q_TERM = CMAX / 64 * Q_BOX, KV_TERM = CMAX / 64 * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);                 // [term]
  unsigned char* const Ks = Qs + TERMS * Q_TERM;         // [stage][term]
  unsigned char* const Vs = Ks + S3_STAGES * TERMS * KV_TERM;
  auto* xch = reinterpret_cast<Exchange3*>(Vs + S3_STAGES * TERMS * KV_TERM);
  auto* bars = reinterpret_cast<Ring3Bars*>(xch + 1);
  const int nb = shares3_blocks(hd);
  const int q0 = (gridDim.x / nb - 1 - blockIdx.x / nb) * S3_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oh = h * hd, oH = H * hd;
  const int n_tiles = (min(S, q0 + S3_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S3_STAGES; ++st) {
      sm90::mbar_init(&bars->full[st], WG);           // converter threads
      sm90::mbar_init(&bars->empty[st], WG / 32);     // consumer warps
    }
    init_exchange(xch, nb - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // converter
    const int col0 = share3_col0(hd, sm90::cluster_ctarank());
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S3_STAGES;
      sm90::mbar_wait(&bars->empty[st], ((j / S3_STAGES) & 1) ^ 1);
      split_share<KEYS, U>(Ks + st * TERMS * KV_TERM, KV_BOX, KV_TERM, k, b,
                           oh, S, oH, j * KEYS, threadIdx.x, col0);
      split_share<KEYS, U>(Vs + st * TERMS * KV_TERM, KV_BOX, KV_TERM, v, b,
                           oh, S, oH, j * KEYS, threadIdx.x, col0);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&bars->full[st]);
    }
    return;
  }

  const int tid = threadIdx.x - WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * warp + g;        // and row + 8
  split_share<S3_ROWS, U>(Qs, Q_BOX, Q_TERM, q, b, oh, L, oH, q0, tid,
                          share3_col0(hd, sm90::cluster_ctarank()));
  sm90::fence_proxy_async();
  sm90::named_bar_sync(1, WG);               // the Q terms
  const float sl2 = scale * LOG2E;           // scores in log2 units
  float acc[U][32];                          // o, a 64-column unit each
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S3_STAGES, k0 = j * KEYS;
    const unsigned char* kt = Ks + st * TERMS * KV_TERM;
    const unsigned char* vt = Vs + st * TERMS * KV_TERM;
    float s[KEYS / 2];
    const uint64_t desc_q = k_major(Qs), desc_k = k_major(kt);
    sm90::mbar_wait(&bars->full[st], (j / S3_STAGES) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < 4 * U; ++kk)
        sm90::wgmma_m64n32k16_ss(
            s, desc_q + term_off(Q_TERM, a_term(p)) + k_step(Q_BOX, kk),
            desc_k + term_off(KV_TERM, b_term(p)) + k_step(KV_BOX, kk),
            p > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    add_cluster_partials_n(xch, sm90::cluster_nctarank(),
                           sm90::cluster_ctarank(), tid, j, s);

#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) s[i] *= sl2;
    // the diagonal tiles and a ragged last tile: key > row or key >= S
    if (k0 + KEYS - 1 > q0 || k0 + KEYS > S) {
#pragma unroll
      for (int i = 0; i < KEYS / 2; ++i) {
        const int key = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (key > row + 8 * ((i / 2) & 1) || key >= S) s[i] = NEG_INF;
      }
    }
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i)
      mx[(i / 2) & 1] = fmaxf(mx[(i / 2) & 1], s[i]);
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
      l[r] *= alpha[r];                      // this thread's share of the sum
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(acc[u]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[u][i] *= alpha[(i / 2) & 1];
    }
    // p (float) into the row sums and, as three terms, the A registers
    uint32_t pa[TERMS][KEYS / 16][4];
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = 8 * kk + 2 * r, half = r & 1;
        const float p0 = exp2f(s[i] - m[half]);
        const float p1 = exp2f(s[i + 1] - m[half]);
        l[half] += p0;
        l[half] += p1;
        split3(p0, p1, pa[0][kk][r], pa[1][kk][r], pa[2][kk][r]);
      }

    const uint64_t desc_v = mn_major(vt, KV_BOX);
    sm90::wgmma_fence();
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk)
          sm90::wgmma_m64n64k16_rs(
              acc[u], pa[a_term(p)][kk],
              desc_v + term_off(KV_TERM, b_term(p)) + ((u * KV_BOX) >> 4) +
                  mn_step(kk),
              1);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(xch, n_tiles);

  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = fmaxf(l[r], 1e-30f);
    inv[r] = 1.f / l[r];
    if (t == 0 && row + 8 * r < L &&
        sm90::cluster_ctarank() == 0)        // every block holds it
      lse[static_cast<int64_t>(bh) * L + row + 8 * r] = m[r] * LN2 + logf(l[r]);
  }
  const int col0 = share3_col0(hd, sm90::cluster_ctarank());
#pragma unroll
  for (int u = 0; u < U; ++u)
    store_acc_rows<float, 1>(o, b, oh, L, oH, row, t, acc[u], inv,
                             col0 + 64 * u);
}

// float32 forward at HD 2176 and 2304 (a launch argument), grid (NB ceil(L
// / 64), B*H) in clusters of NB = shares3_blocks(HD) blocks along x, each
// running fwd_shares3_block on its share
template <int CMAX>
__global__ void __launch_bounds__(D3_THREADS, 1)
    flash_fwd_shares3_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             float* __restrict__ o, float* __restrict__ lse,
                             int H, int L, int S, int hd, float scale) {
  if (share3_units(hd, sm90::cluster_ctarank()) == CMAX / 64)
    fwd_shares3_block<CMAX, CMAX / 64>(q, k, v, o, lse, H, L, S, hd, scale);
  else
    fwd_shares3_block<CMAX, CMAX / 64 - 1>(q, k, v, o, lse, H, L, S, hd,
                                           scale);
}

// float32 dq of a block of a cluster on its U boxes: the converter streams
// 16-key K and V tiles as terms through two stages; the consumer splits its
// 64 Q and dO rows once and keeps their lse and delta in registers, then
// per tile s = q k^T and dp = dO v^T (6 x 4U wgmma m64n16k16 each), their
// rank-order sums, ds as three register A terms, dq += ds k (6 wgmma
// m64n64k16 a unit, k MN-major)
template <int CMAX, int U>
__device__ __forceinline__ void dq_shares3_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int L, int S, int hd, float scale) {
  constexpr int KEYS = S3_TILE;
  constexpr int Q_BOX = S3_ROWS * ROW_BYTES, KV_BOX = KEYS * ROW_BYTES;
  constexpr int Q_TERM = CMAX / 64 * Q_BOX, KV_TERM = CMAX / 64 * KV_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Qs = align1024(raw_smem);                 // [term]
  unsigned char* const Gs = Qs + TERMS * Q_TERM;                 // [term] dO
  unsigned char* const Ks = Gs + TERMS * Q_TERM;         // [stage][term]
  unsigned char* const Vs = Ks + S3_STAGES * TERMS * KV_TERM;
  auto* xch = reinterpret_cast<Exchange3*>(Vs + S3_STAGES * TERMS * KV_TERM);
  auto* bars = reinterpret_cast<Ring3Bars*>(xch + 1);
  const int nb = shares3_blocks(hd);
  const int q0 = (gridDim.x / nb - 1 - blockIdx.x / nb) * S3_ROWS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oh = h * hd, oH = H * hd;
  const int n_tiles = (min(S, q0 + S3_ROWS) + KEYS - 1) / KEYS;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S3_STAGES; ++st) {
      sm90::mbar_init(&bars->full[st], WG);           // converter threads
      sm90::mbar_init(&bars->empty[st], WG / 32);     // consumer warps
    }
    init_exchange(xch, nb - 1);
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // converter
    const int col0 = share3_col0(hd, sm90::cluster_ctarank());
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S3_STAGES;
      sm90::mbar_wait(&bars->empty[st], ((j / S3_STAGES) & 1) ^ 1);
      split_share<KEYS, U>(Ks + st * TERMS * KV_TERM, KV_BOX, KV_TERM, k, b,
                           oh, S, oH, j * KEYS, threadIdx.x, col0);
      split_share<KEYS, U>(Vs + st * TERMS * KV_TERM, KV_BOX, KV_TERM, v, b,
                           oh, S, oH, j * KEYS, threadIdx.x, col0);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&bars->full[st]);
    }
    return;
  }

  const int tid = threadIdx.x - WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int row = q0 + 16 * warp + g;        // and row + 8
  {
    const int col0 = share3_col0(hd, sm90::cluster_ctarank());
    split_share<S3_ROWS, U>(Qs, Q_BOX, Q_TERM, q, b, oh, L, oH, q0, tid,
                            col0);
    split_share<S3_ROWS, U>(Gs, Q_BOX, Q_TERM, dout, b, oh, L, oH, q0, tid,
                            col0);
  }
  sm90::fence_proxy_async();
  sm90::named_bar_sync(1, WG);               // the Q and dO terms
  const float sl2 = scale * LOG2E;
  float lse2[2], dl[2];                      // lse in log2 units, delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row + 8 * r < L;
    const int64_t i = static_cast<int64_t>(bh) * L + row + 8 * r;
    lse2[r] = in ? lse[i] * LOG2E : 0.f;
    dl[r] = in ? delta[i] : 0.f;
  }
  float acc[U][32];                          // dq, a 64-column unit each
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[u][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S3_STAGES, k0 = j * KEYS;
    const unsigned char* kt = Ks + st * TERMS * KV_TERM;
    const unsigned char* vt = Vs + st * TERMS * KV_TERM;
    float s[KEYS / 2], dp[KEYS / 2];
    const uint64_t desc_q = k_major(Qs), desc_k = k_major(kt);
    const uint64_t desc_g = k_major(Gs), desc_v = k_major(vt);
    sm90::mbar_wait(&bars->full[st], (j / S3_STAGES) & 1);
    sm90::wgmma_fence();
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < 4 * U; ++kk)
        sm90::wgmma_m64n16k16_ss(
            s, desc_q + term_off(Q_TERM, a_term(p)) + k_step(Q_BOX, kk),
            desc_k + term_off(KV_TERM, b_term(p)) + k_step(KV_BOX, kk),
            p > 0 || kk > 0);
#pragma unroll
    for (int p = 0; p < 6; ++p)
#pragma unroll
      for (int kk = 0; kk < 4 * U; ++kk)
        sm90::wgmma_m64n16k16_ss(
            dp, desc_g + term_off(Q_TERM, a_term(p)) + k_step(Q_BOX, kk),
            desc_v + term_off(KV_TERM, b_term(p)) + k_step(KV_BOX, kk),
            p > 0 || kk > 0);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
    sm90::fence_regs(s);
    sm90::fence_regs(dp);
    add_cluster_partials_n(xch, sm90::cluster_nctarank(),
                           sm90::cluster_ctarank(), tid, j, s, dp);

    // p = exp(s scale - lse), ds = p (dp - delta) scale; rows: queries
    // row + 8((i / 2) & 1), columns: keys k0 + c. Only a tile that crosses
    // the diagonal or the ragged end is masked.
    const bool edge = k0 + KEYS - 1 > q0 || k0 + KEYS > S;
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      const int r = (i / 2) & 1;
      float p = exp2f(fmaf(s[i], sl2, -lse2[r]));
      if (edge) {
        const int kc = k0 + 8 * (i / 4) + 2 * t + (i & 1);
        if (kc > row + 8 * r || kc >= S) p = 0.f;
      }
      dp[i] = p * (dp[i] - dl[r]) * scale;
    }
    uint32_t da[TERMS][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split3(dp[2 * r], dp[2 * r + 1], da[0][r], da[1][r], da[2][r]);
#pragma unroll
    for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
    sm90::wgmma_fence();
    const uint64_t desc_kt = mn_major(kt, KV_BOX);
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll
      for (int p = 0; p < 6; ++p)
        sm90::wgmma_m64n64k16_rs(
            acc[u], da[a_term(p)],
            desc_kt + term_off(KV_TERM, b_term(p)) + ((u * KV_BOX) >> 4), 1);
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) sm90::fence_regs(acc[u]);
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  drain_exchange(xch, n_tiles);
  const float one[2] = {1.f, 1.f};
  const int col0 = share3_col0(hd, sm90::cluster_ctarank());
#pragma unroll
  for (int u = 0; u < U; ++u)
    store_acc_rows<float, 1>(dq, b, oh, L, oH, row, t, acc[u], one,
                             col0 + 64 * u);
}

// float32 dq at HD 2176 and 2304, grid (NB ceil(L / 64), B*H) in clusters
// of NB blocks along x, each running dq_shares3_block on its share
template <int CMAX>
__global__ void __launch_bounds__(D3_THREADS, 1)
    flash_dq_shares3_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dq, int H, int L, int S,
                            int hd, float scale) {
  if (share3_units(hd, sm90::cluster_ctarank()) == CMAX / 64)
    dq_shares3_block<CMAX, CMAX / 64>(q, k, v, dout, lse, delta, dq, H, L, S,
                                      hd, scale);
  else
    dq_shares3_block<CMAX, CMAX / 64 - 1>(q, k, v, dout, lse, delta, dq, H,
                                          L, S, hd, scale);
}

// A dk/dv consumer of a block on UB boxes: the block's 64 keys (key, key +
// 8 its rows), U 64-column units of dk and dv from unit U0 of its share.
// The writer (kWriter: consumer 0, U0 0) forms the block's partial s^T = k
// q^T and dp^T = v dO^T (6 x 4UB wgmma m64n16k16 each) and keeps it in the
// exchange; both consumers then hold the cluster's rank-order sums, form
// p^T and ds^T, split them into three register A terms and accumulate dv
// += p^T dO and dk += ds^T q on their units (6 wgmma m64n64k16 each a unit,
// dO and q MN-major).
template <int CMAX, int UB, int U, int U0, bool kWriter>
__device__ __forceinline__ void dkv_shares3_consume(
    const unsigned char* Ks, const unsigned char* Vs,
    const unsigned char* Qs, const unsigned char* Gs,
    const DkvStats<S3_STAGES, S3_TILE>* stats, Ring3Bars* bars,
    Exchange3* xch, float* __restrict__ dk, float* __restrict__ dv, int b,
    int oh, int oH, int L, int S, int hd, int k0, int n_tiles, float scale) {
  constexpr int ROWS = S3_TILE, KEYS = S3_ROWS;
  constexpr int K_BOX = KEYS * ROW_BYTES, Q_BOX = ROWS * ROW_BYTES;
  constexpr int K_TERM = CMAX / 64 * K_BOX, Q_TERM = CMAX / 64 * Q_BOX;
  const int tid = threadIdx.x % WG;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int key = k0 + 16 * warp + g;        // and key + 8
  const float sl2 = scale * LOG2E;
  float dk_acc[U][32], dv_acc[U][32];
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[u][i] = dv_acc[u][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int st = j % S3_STAGES, q0 = k0 + j * ROWS;
    const unsigned char* qt = Qs + st * TERMS * Q_TERM;
    const unsigned char* gt = Gs + st * TERMS * Q_TERM;
    float s[ROWS / 2], dp[ROWS / 2];
    sm90::mbar_wait(&bars->full[st], (j / S3_STAGES) & 1);
    if constexpr (kWriter) {
      const uint64_t desc_k = k_major(Ks), desc_q = k_major(qt);
      const uint64_t desc_v = k_major(Vs), desc_g = k_major(gt);
      sm90::wgmma_fence();
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < 4 * UB; ++kk)
          sm90::wgmma_m64n16k16_ss(
              s, desc_k + term_off(K_TERM, a_term(p)) + k_step(K_BOX, kk),
              desc_q + term_off(Q_TERM, b_term(p)) + k_step(Q_BOX, kk),
              p > 0 || kk > 0);
#pragma unroll
      for (int p = 0; p < 6; ++p)
#pragma unroll
        for (int kk = 0; kk < 4 * UB; ++kk)
          sm90::wgmma_m64n16k16_ss(
              dp, desc_v + term_off(K_TERM, a_term(p)) + k_step(K_BOX, kk),
              desc_g + term_off(Q_TERM, b_term(p)) + k_step(Q_BOX, kk),
              p > 0 || kk > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      add_cluster_partials_w(xch, sm90::cluster_nctarank(),
                             sm90::cluster_ctarank(), tid, j, s, dp);
    } else {
      read_cluster_partials(xch, sm90::cluster_nctarank(),
                            sm90::cluster_ctarank(), tid, j, s, dp);
    }

    // p^T = exp(s^T scale - lse), ds^T = p^T (dp^T - delta) scale; rows:
    // keys key + 8((i / 2) & 1), columns: query rows q0 + c
    const bool edge = k0 + KEYS - 1 > q0 || q0 + ROWS > L || k0 + KEYS > S;
#pragma unroll
    for (int i = 0; i < ROWS / 2; ++i) {
      const int c = 8 * (i / 4) + 2 * t + (i & 1);
      float p = exp2f(fmaf(s[i], sl2, -stats->lse[st][c] * LOG2E));
      if (edge) {
        const int kc = key + 8 * ((i / 2) & 1), qr = q0 + c;
        if (kc > qr || kc >= S || qr >= L) p = 0.f;
      }
      dp[i] = p * (dp[i] - stats->delta[st][c]) * scale;
      s[i] = p;
    }
    uint32_t pa[TERMS][4], da[TERMS][4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      split3(s[2 * r], s[2 * r + 1], pa[0][r], pa[1][r], pa[2][r]);
      split3(dp[2 * r], dp[2 * r + 1], da[0][r], da[1][r], da[2][r]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(dv_acc[u]);
      sm90::fence_regs(dk_acc[u]);
    }
    sm90::wgmma_fence();
    const uint64_t desc_gt = mn_major(gt, Q_BOX), desc_qt = mn_major(qt, Q_BOX);
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const uint64_t box = ((U0 + u) * Q_BOX) >> 4;
#pragma unroll
      for (int p = 0; p < 6; ++p)
        sm90::wgmma_m64n64k16_rs(
            dv_acc[u], pa[a_term(p)],
            desc_gt + term_off(Q_TERM, b_term(p)) + box, 1);
#pragma unroll
      for (int p = 0; p < 6; ++p)
        sm90::wgmma_m64n64k16_rs(
            dk_acc[u], da[a_term(p)],
            desc_qt + term_off(Q_TERM, b_term(p)) + box, 1);
    }
    sm90::wgmma_commit();
    sm90::wgmma_wait();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      sm90::fence_regs(dk_acc[u]);
      sm90::fence_regs(dv_acc[u]);
    }
    __syncwarp();
    if (lane == 0) sm90::mbar_arrive(&bars->empty[st]);
  }
  if constexpr (kWriter) drain_exchange(xch, n_tiles);
  const float one[2] = {1.f, 1.f};
  const int col0 = share3_col0(hd, sm90::cluster_ctarank()) + 64 * U0;
#pragma unroll
  for (int u = 0; u < U; ++u) {
    store_acc_rows<float, 1>(dk, b, oh, S, oH, key, t, dk_acc[u], one,
                             col0 + 64 * u);
    store_acc_rows<float, 1>(dv, b, oh, S, oH, key, t, dv_acc[u], one,
                             col0 + 64 * u);
  }
}

// float32 dk and dv of a block of a cluster on its UB boxes: the converter
// (warpgroup 0) streams 16-row Q and dO tiles as terms with their lse and
// delta through two stages; consumer 0 splits the block's 64 K rows,
// consumer 1 its V rows, then each runs dkv_shares3_consume on its units
template <int CMAX, int UB>
__device__ __forceinline__ void dkv_shares3_block(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int L, int S,
    int hd, float scale) {
  constexpr int ROWS = S3_TILE, KEYS = S3_ROWS;
  constexpr int K_BOX = KEYS * ROW_BYTES, Q_BOX = ROWS * ROW_BYTES;
  constexpr int K_TERM = CMAX / 64 * K_BOX, Q_TERM = CMAX / 64 * Q_BOX;
  extern __shared__ unsigned char raw_smem[];
  unsigned char* const Ks = align1024(raw_smem);                 // [term]
  unsigned char* const Vs = Ks + TERMS * K_TERM;                 // [term]
  unsigned char* const Qs = Vs + TERMS * K_TERM;         // [stage][term]
  unsigned char* const Gs = Qs + S3_STAGES * TERMS * Q_TERM;     // dO
  auto* xch = reinterpret_cast<Exchange3*>(Gs + S3_STAGES * TERMS * Q_TERM);
  auto* stats = reinterpret_cast<DkvStats<S3_STAGES, S3_TILE>*>(xch + 1);
  auto* bars = reinterpret_cast<Ring3Bars*>(stats + 1);
  const int nb = shares3_blocks(hd);
  const int k0 = blockIdx.x / nb * KEYS;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int oh = h * hd, oH = H * hd;
  const int n_tiles = k0 < L ? (L - k0 + ROWS - 1) / ROWS : 0;
  const int wg = threadIdx.x / WG;

  if (threadIdx.x == 0) {
    for (int st = 0; st < S3_STAGES; ++st) {
      sm90::mbar_init(&bars->full[st], WG);           // converter threads
      sm90::mbar_init(&bars->empty[st], 2 * WG / 32); // consumer warps
    }
    sm90::mbar_init(&xch->full, nb * WG);             // every writer
    sm90::mbar_init(&xch->empty, (2 * nb - 1) * WG);  // the readers
    sm90::fence_barrier_init();
  }
  __syncthreads();
  sm90::cluster_sync();   // the peers' barriers too

  if (wg == 0) {   // converter
    sm90::setmaxnreg_dec<S3_CONVERTER_REGS>();
    const int tid = threadIdx.x;
    const int col0 = share3_col0(hd, sm90::cluster_ctarank());
    const float* const lse_bh = lse + static_cast<int64_t>(bh) * L;
    const float* const delta_bh = delta + static_cast<int64_t>(bh) * L;
    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % S3_STAGES, q0 = k0 + j * ROWS;
      sm90::mbar_wait(&bars->empty[st], ((j / S3_STAGES) & 1) ^ 1);
      if (tid < ROWS) {
        const bool in = q0 + tid < L;
        stats->lse[st][tid] = in ? lse_bh[q0 + tid] : 0.f;
        stats->delta[st][tid] = in ? delta_bh[q0 + tid] : 0.f;
      }
      split_share<ROWS, UB>(Qs + st * TERMS * Q_TERM, Q_BOX, Q_TERM, q, b,
                            oh, L, oH, q0, tid, col0);
      split_share<ROWS, UB>(Gs + st * TERMS * Q_TERM, Q_BOX, Q_TERM, dout, b,
                            oh, L, oH, q0, tid, col0);
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&bars->full[st]);
    }
    return;
  }

  sm90::setmaxnreg_inc<S3_CONSUMER_REGS>();
  const int cw = wg - 1;
  split_share<KEYS, UB>(cw == 0 ? Ks : Vs, K_BOX, K_TERM, cw == 0 ? k : v, b,
                        oh, S, oH, k0, threadIdx.x % WG,
                        share3_col0(hd, sm90::cluster_ctarank()));
  sm90::fence_proxy_async();
  sm90::named_bar_sync(1, 2 * WG);           // the K and V terms
  if (cw == 0)
    dkv_shares3_consume<CMAX, UB, UB / 2, 0, true>(
        Ks, Vs, Qs, Gs, stats, bars, xch, dk, dv, b, oh, oH, L, S, hd, k0,
        n_tiles, scale);
  else
    dkv_shares3_consume<CMAX, UB, UB - UB / 2, UB / 2, false>(
        Ks, Vs, Qs, Gs, stats, bars, xch, dk, dv, b, oh, oH, L, S, hd, k0,
        n_tiles, scale);
}

// float32 dk and dv at HD 2176 and 2304, grid (NB ceil(S / 64), B*H) in
// clusters of NB blocks along x on the same 64 keys, each running
// dkv_shares3_block on its share
template <int CMAX>
__global__ void __launch_bounds__(SM90_THREADS, 1)
    flash_dkv_shares3_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int H, int L, int S, int hd, float scale) {
  if (share3_units(hd, sm90::cluster_ctarank()) == CMAX / 64)
    dkv_shares3_block<CMAX, CMAX / 64>(q, k, v, dout, lse, delta, dk, dv, H,
                                       L, S, hd, scale);
  else
    dkv_shares3_block<CMAX, CMAX / 64 - 1>(q, k, v, dout, lse, delta, dk, dv,
                                           H, L, S, hd, scale);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// allow_smem, and for clusters of more than 8 blocks (9 to 16, Hopper's
// non-portable sizes, which cudaLaunchKernelEx and
// cudaOccupancyMaxActiveClusters refuse otherwise) the kernel's leave to
// take them
template <typename Kernel>
cudaError_t allow_cluster(Kernel kernel, size_t bytes, int nb) {
  cudaError_t err = allow_smem(kernel, bytes);
  if (err == cudaSuccess && nb > 8)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  return err;
}

// a launch of `blocks` x `rows` clusters of nb blocks along x (the nb
// column slices of each block of rows: blocks nb i .. nb i + nb - 1);
// `dim` holds the cluster attribute that `cfg` points to
void cluster_config(cudaLaunchConfig_t& cfg, cudaLaunchAttribute& dim,
                    int nb, int blocks, int rows, int threads, size_t smem,
                    cudaStream_t stream) {
  cfg = {};
  cfg.gridDim = dim3(nb * blocks, rows);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  dim.id = cudaLaunchAttributeClusterDimension;
  dim.val.clusterDim.x = nb;
  dim.val.clusterDim.y = 1;
  dim.val.clusterDim.z = 1;
  cfg.attrs = &dim;
  cfg.numAttrs = 1;
}

// `kernel` over `blocks` x `rows` blocks: a plain launch (nb 1), or
// clusters of nb blocks along x through cudaLaunchKernelEx (the float32
// kernels at head dims 256 to 2048: nb = HD / 128; the 16-bit ones at 384
// to 4096: cluster16_blocks; 2 to 16, past 8 the non-portable sizes)
template <typename... Params, typename... Args>
int launch_grid(void (*kernel)(Params...), int nb, int blocks, int rows,
                int threads, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = allow_cluster(kernel, smem, nb);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (nb == 1) {
    kernel<<<dim3(blocks, rows), threads, smem, stream>>>(args...);
  } else {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute dim;
    cluster_config(cfg, dim, nb, blocks, rows, threads, smem, stream);
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

// how many clusters of `kernel` (nb blocks of `threads` threads and `smem`
// bytes each) the card can hold at once, into *n (0: it cannot launch one)
template <typename... Params>
int max_clusters(void (*kernel)(Params...), int nb, int threads, size_t smem,
                 int* n) {
  cudaError_t err = allow_cluster(kernel, smem, nb);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute dim;
  cluster_config(cfg, dim, nb, 1, 1, threads, smem, nullptr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(kernel), &cfg));
}

// float32 forward, dq and dk/dv at head dim hd, instance HD (hd itself, or
// SPLIT3_ANY): three bf16 terms on wgmma, no tensor maps; at hd 256 to 2048
// clusters of hd / 128 blocks
template <int HD>
int launch_fwd_split3(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int H, int L, int S, int hd,
                      float scale, cudaStream_t stream) {
  return launch_grid(
      flash_fwd_split3_kernel<HD>, hd / D, (L + F3_ROWS - 1) / F3_ROWS, B * H,
      SM90_THREADS, fwd3_smem<HD>(), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, L, S, scale);
}

template <int HD>
int launch_dq_split3(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     void* dq, int B, int H, int L, int S, int hd,
                     float scale, cudaStream_t stream) {
  return launch_grid(
      flash_dq_split3_kernel<HD>, hd / D, (L + Q3_ROWS - 1) / Q3_ROWS, B * H,
      D3_THREADS, dq3_smem<HD>(), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
      H, L, S, scale);
}

template <int HD>
int launch_dkv_split3(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dk, void* dv, int B, int H, int L, int S, int hd,
                      float scale, cudaStream_t stream) {
  return launch_grid(
      flash_dkv_split3_kernel<HD>, hd / D, (S + D3_KEYS - 1) / D3_KEYS, B * H,
      D3_THREADS, dkv3_smem<HD>(), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, L, S, scale);
}

// float32 forward, dq and dk/dv at head dim hd (2176 or 2304): clusters of
// shares3_blocks(hd) blocks on 192-column shares, no tensor maps
int launch_fwd_shares3(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int L, int S, int hd,
                       float scale, cudaStream_t stream) {
  return launch_grid(
      flash_fwd_shares3_kernel<SHARES3_CMAX>, shares3_blocks(hd),
      (L + S3_ROWS - 1) / S3_ROWS, B * H, D3_THREADS,
      fwd_shares3_smem<SHARES3_CMAX>(), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, H, L, S, hd, scale);
}

int launch_dq_shares3(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int L, int S, int hd,
                      float scale, cudaStream_t stream) {
  return launch_grid(
      flash_dq_shares3_kernel<SHARES3_CMAX>, shares3_blocks(hd),
      (L + S3_ROWS - 1) / S3_ROWS, B * H, D3_THREADS,
      dq_shares3_smem<SHARES3_CMAX>(), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dq),
      H, L, S, hd, scale);
}

int launch_dkv_shares3(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int L, int S, int hd,
                       float scale, cudaStream_t stream) {
  return launch_grid(
      flash_dkv_shares3_kernel<SHARES3_CMAX>, shares3_blocks(hd),
      (S + S3_ROWS - 1) / S3_ROWS, B * H, SM90_THREADS,
      dkv_shares3_smem<SHARES3_CMAX>(), stream, static_cast<const float*>(q),
      static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), lse, delta, static_cast<float*>(dk),
      static_cast<float*>(dv), H, L, S, hd, scale);
}

// 16-bit (bf16 or float16: T) forward, dq and dk/dv at head dim HD: tensor
// maps encoded per call over the caller's tensors, then the launch
template <typename T, int HD>
int launch_fwd_sm90(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int L, int S, float scale,
                    cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, HD, FWD_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, HD, fwd_keys(HD));
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, HD, fwd_keys(HD));
  if (err == cudaSuccess)
    err = allow_smem(flash_fwd_sm90_kernel<T, HD>, fwd_sm90_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + FWD_ROWS - 1) / FWD_ROWS, B * H);
  flash_fwd_sm90_kernel<T, HD><<<grid, SM90_THREADS, fwd_sm90_smem<HD>(),
                                 stream>>>(tq, tk, tv, static_cast<T*>(o),
                                           lse, H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dkv_sm90(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int H, int L, int S, float scale,
                    cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, HD, DKV_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tg, dout, B, L, H, HD, DKV_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, HD, dkv_keys(HD));
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, HD, dkv_keys(HD));
  if (err == cudaSuccess)
    err = allow_smem(flash_dkv_sm90_kernel<T, HD>, dkv_sm90_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + dkv_keys(HD) - 1) / dkv_keys(HD), B * H);
  flash_dkv_sm90_kernel<T, HD><<<grid, SM90_THREADS, dkv_sm90_smem<HD>(),
                                 stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int launch_dq_sm90(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int L, int S, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, HD, DQ_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tg, dout, B, L, H, HD, DQ_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, HD, dq_keys(HD));
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, HD, dq_keys(HD));
  if (err == cudaSuccess)
    err = allow_smem(flash_dq_sm90_kernel<T, HD>, dq_sm90_smem<HD>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((L + DQ_ROWS - 1) / DQ_ROWS, B * H);
  flash_dq_sm90_kernel<T, HD><<<grid, SM90_THREADS, dq_sm90_smem<HD>(),
                                stream>>>(
      tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), H, L, S, scale);
  return static_cast<int>(cudaGetLastError());
}

// 16-bit (T) forward, dq and dk/dv at head dim 384 or 512 (HD, the pairs)
// or 640 to 4096 (hd, the cluster kernels): clusters of cluster16_blocks
// blocks. Tensor maps of 64-column boxes over the whole head row; each block
// loads its own boxes
template <typename T, int HD>
int launch_fwd_pair(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int L, int S, float scale,
                    cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, HD, FWD_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, HD, PAIR_FWD_KEYS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, HD, PAIR_FWD_KEYS);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int NB = cluster16_blocks(HD);
  return launch_grid(flash_fwd_pair_kernel<T, HD>, NB,
                     (L + FWD_ROWS - 1) / FWD_ROWS, B * H, SM90_THREADS,
                     cluster16_q_smem<HD / NB, PAIR_FWD_KEYS, 1>(), stream,
                     tq, tk, tv, static_cast<T*>(o), lse, H, L, S, scale);
}

template <typename T>
int launch_fwd_cluster(const void* q, const void* k, const void* v, void* o,
                       float* lse, int B, int H, int L, int S, int hd,
                       float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, hd, FWD_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, hd, PAIR_FWD_KEYS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, hd, PAIR_FWD_KEYS);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_grid(
      flash_fwd_cluster_kernel<T, CLUSTER16_CMAX>, cluster16_blocks(hd),
      (L + FWD_ROWS - 1) / FWD_ROWS, B * H, SM90_THREADS,
      cluster16_q_smem<CLUSTER16_CMAX, PAIR_FWD_KEYS, 1, ExchangeRS>(),
      stream, tq, tk, tv, static_cast<T*>(o), lse, H, L, S, hd, scale);
}

template <typename T, int HD>
int launch_dq_pair(const void* q, const void* k, const void* v,
                   const void* dout, const float* lse, const float* delta,
                   void* dq, int B, int H, int L, int S, float scale,
                   cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, HD, DQ_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tg, dout, B, L, H, HD, DQ_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, HD, PAIR_DQ_KEYS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, HD, PAIR_DQ_KEYS);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int NB = cluster16_blocks(HD);
  return launch_grid(flash_dq_pair_kernel<T, HD>, NB,
                     (L + DQ_ROWS - 1) / DQ_ROWS, B * H, SM90_THREADS,
                     cluster16_q_smem<HD / NB, PAIR_DQ_KEYS, 2>(), stream,
                     tq, tk, tv, tg, lse, delta, static_cast<T*>(dq), H, L,
                     S, scale);
}

template <typename T>
int launch_dq_cluster(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      void* dq, int B, int H, int L, int S, int hd,
                      float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, hd, DQ_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tg, dout, B, L, H, hd, DQ_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, hd, PAIR_DQ_KEYS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, hd, PAIR_DQ_KEYS);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_grid(
      flash_dq_cluster_kernel<T, CLUSTER16_CMAX>, cluster16_blocks(hd),
      (L + DQ_ROWS - 1) / DQ_ROWS, B * H, SM90_THREADS,
      cluster16_q_smem<CLUSTER16_CMAX, PAIR_DQ_KEYS, 2>(), stream, tq, tk, tv,
      tg, lse, delta, static_cast<T*>(dq), H, L, S, hd, scale);
}

template <typename T, int HD>
int launch_dkv_pair(const void* q, const void* k, const void* v,
                    const void* dout, const float* lse, const float* delta,
                    void* dk, void* dv, int B, int H, int L, int S, float scale,
                    cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, HD,
                                                  PAIR_DKV_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tg, dout, B, L, H, HD, PAIR_DKV_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, HD, 64);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, HD, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int NB = cluster16_blocks(HD);
  return launch_grid(flash_dkv_pair_kernel<T, HD>, NB, (S + 63) / 64, B * H,
                     SM90_THREADS, cluster16_dkv_smem<HD / NB>(), stream, tq,
                     tk, tv, tg, lse, delta, static_cast<T*>(dk),
                     static_cast<T*>(dv), H, L, S, scale);
}

template <typename T>
int launch_dkv_cluster(const void* q, const void* k, const void* v,
                       const void* dout, const float* lse, const float* delta,
                       void* dk, void* dv, int B, int H, int L, int S, int hd,
                       float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tg;
  cudaError_t err = sm90::make_head_map<T>(&tq, q, B, L, H, hd,
                                                  PAIR_DKV_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tg, dout, B, L, H, hd, PAIR_DKV_ROWS);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tk, k, B, S, H, hd, 64);
  if (err == cudaSuccess)
    err = sm90::make_head_map<T>(&tv, v, B, S, H, hd, 64);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch_grid(
      flash_dkv_cluster_kernel<T, CLUSTER16_CMAX>, cluster16_blocks(hd),
      (S + 63) / 64, B * H, SM90_THREADS,
      cluster16_dkv_smem<CLUSTER16_CMAX>(), stream, tq, tk, tv, tg, lse,
      delta, static_cast<T*>(dk), static_cast<T*>(dv), H, L, S, hd, scale);
}

// the element type codes of the C entry points' `dtype`
enum : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

// the float32 kernels' head dims: HD = 128 NB, clusters of NB = 1 ..
// SPLIT3_MAX_NB blocks (past 8 Hopper's non-portable cluster sizes, 16 its
// largest); an instance of its own up to SPLIT3_FIXED_NB blocks, then
// <SPLIT3_ANY>
constexpr int SPLIT3_FIXED_NB = 4, SPLIT3_MAX_NB = 16;

// f(std::integral_constant<int, HD>{}) for the instance HD of the float32
// head dim `hd` = 128 K: K itself for K from K0 to SPLIT3_FIXED_NB (128 ..
// 512), SPLIT3_ANY past it up to SPLIT3_MAX_NB (640 .. 2048); or
// cudaErrorInvalidValue for any other hd
template <int K0 = 1, typename F>
int split3_head_dim(int hd, F&& f) {
  if constexpr (K0 > SPLIT3_FIXED_NB) {
    if (hd % D == 0 && hd > SPLIT3_FIXED_NB * D && hd <= SPLIT3_MAX_NB * D)
      return f(std::integral_constant<int, SPLIT3_ANY>{});
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (hd == K0 * D) return f(std::integral_constant<int, K0 * D>{});
    return split3_head_dim<K0 + 1>(hd, f);
  }
}

template <typename T>
struct Elem {
  using type = T;
};

// f(Elem<T>{}) for `dtype` bfloat16 or float16; else cudaErrorInvalidValue
template <typename F>
int elem16(int dtype, F&& f) {
  if (dtype == kBFloat16) return f(Elem<__nv_bfloat16>{});
  if (dtype == kFloat16) return f(Elem<__half>{});
  return static_cast<int>(cudaErrorInvalidValue);
}

// whether the float32 kernels on 192-column shares take head dim hd
constexpr bool shares3_takes(int hd) {
  return hd % 128 == 0 && hd >= SHARES3_MIN_HD && hd <= SHARES3_MAX_HD;
}

// whether the 16-bit cluster kernels take head dim hd
constexpr bool cluster16_takes(int hd) {
  return hd % 128 == 0 && hd >= CLUSTER16_MIN_HD && hd <= CLUSTER16_MAX_HD;
}

// how many clusters of the float32 kernel `kernel` (0 forward, 1 dq, 2
// dk/dv) at head dim hd (instance HD, hd / 128 blocks a cluster) the card
// holds at once
template <int HD>
int max_clusters_split3(int kernel, int hd, int* n) {
  switch (kernel) {
    case 0: return max_clusters(flash_fwd_split3_kernel<HD>, hd / D,
                                SM90_THREADS, fwd3_smem<HD>(), n);
    case 1: return max_clusters(flash_dq_split3_kernel<HD>, hd / D,
                                D3_THREADS, dq3_smem<HD>(), n);
    case 2: return max_clusters(flash_dkv_split3_kernel<HD>, hd / D,
                                D3_THREADS, dkv3_smem<HD>(), n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// and for the float32 kernel `kernel` on 192-column shares at head dim hd
// (shares3_blocks(hd) blocks a cluster)
int max_clusters_shares3(int kernel, int hd, int* n) {
  constexpr int C = SHARES3_CMAX;
  const int nb = shares3_blocks(hd);
  switch (kernel) {
    case 0: return max_clusters(flash_fwd_shares3_kernel<C>, nb, D3_THREADS,
                                fwd_shares3_smem<C>(), n);
    case 1: return max_clusters(flash_dq_shares3_kernel<C>, nb, D3_THREADS,
                                dq_shares3_smem<C>(), n);
    case 2: return max_clusters(flash_dkv_shares3_kernel<C>, nb,
                                SM90_THREADS, dkv_shares3_smem<C>(), n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// the same for the 16-bit pair kernel `kernel` of element type T at head
// dim HD (384 or 512, two blocks a cluster)
template <typename T, int HD>
int max_clusters_pair(int kernel, int* n) {
  constexpr int NB = cluster16_blocks(HD), C = HD / NB;
  switch (kernel) {
    case 0: return max_clusters(flash_fwd_pair_kernel<T, HD>, NB,
                                SM90_THREADS,
                                cluster16_q_smem<C, PAIR_FWD_KEYS, 1>(), n);
    case 1: return max_clusters(flash_dq_pair_kernel<T, HD>, NB,
                                SM90_THREADS,
                                cluster16_q_smem<C, PAIR_DQ_KEYS, 2>(), n);
    case 2: return max_clusters(flash_dkv_pair_kernel<T, HD>, NB,
                                SM90_THREADS, cluster16_dkv_smem<C>(), n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// and for the 16-bit cluster kernel `kernel` at head dim hd (640 to 4096,
// cluster16_blocks(hd) blocks a cluster)
template <typename T>
int max_clusters_cluster16(int kernel, int hd, int* n) {
  constexpr int C = CLUSTER16_CMAX;
  const int nb = cluster16_blocks(hd);
  switch (kernel) {
    case 0: return max_clusters(
        flash_fwd_cluster_kernel<T, C>, nb, SM90_THREADS,
        cluster16_q_smem<C, PAIR_FWD_KEYS, 1, ExchangeRS>(), n);
    case 1: return max_clusters(flash_dq_cluster_kernel<T, C>, nb,
                                SM90_THREADS,
                                cluster16_q_smem<C, PAIR_DQ_KEYS, 2>(), n);
    case 2: return max_clusters(flash_dkv_cluster_kernel<T, C>, nb,
                                SM90_THREADS, cluster16_dkv_smem<C>(), n);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" {

// q, o [B, L, H, D], k, v [B, S, H, D], contiguous and 16-byte aligned, all
// of the element type `dtype` (0 float, 1 bfloat16, 2 float16), D a
// multiple of 128: 128 .. 2304 in float32, 128 .. 4096 in bfloat16 and
// float16; lse [B*H, L] float. Each entry point returns a cudaError_t
// value; 0 means the launch was accepted (another D or dtype:
// cudaErrorInvalidValue).
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int L, int S, int D,
                        float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* lse_f = static_cast<float*>(lse);
  if (dtype == kFloat32 && shares3_takes(D))
    return launch_fwd_shares3(q, k, v, o, lse_f, B, H, L, S, D, scale, s);
  if (dtype == kFloat32)
    return split3_head_dim(D, [&](auto hd) {
      return launch_fwd_split3<decltype(hd)::value>(q, k, v, o, lse_f, B, H,
                                                    L, S, D, scale, s);
    });
  return elem16(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if (D == 128)
      return launch_fwd_sm90<T, 128>(q, k, v, o, lse_f, B, H, L, S, scale, s);
    if (D == 256)
      return launch_fwd_sm90<T, 256>(q, k, v, o, lse_f, B, H, L, S, scale, s);
    if (D == 384)
      return launch_fwd_pair<T, 384>(q, k, v, o, lse_f, B, H, L, S, scale, s);
    if (D == 512)
      return launch_fwd_pair<T, 512>(q, k, v, o, lse_f, B, H, L, S, scale, s);
    if (cluster16_takes(D))
      return launch_fwd_cluster<T>(q, k, v, o, lse_f, B, H, L, S, D, scale,
                                   s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// dout and dq as q; delta [B*H, L] float = rowsum(dout * o)
int flash_attention_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* delta,
                       void* dq, int B, int H, int L, int S, int D,
                       float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == kFloat32 && shares3_takes(D))
    return launch_dq_shares3(q, k, v, dout, l, dl, dq, B, H, L, S, D, scale,
                             s);
  if (dtype == kFloat32)
    return split3_head_dim(D, [&](auto hd) {
      return launch_dq_split3<decltype(hd)::value>(q, k, v, dout, l, dl, dq, B,
                                                   H, L, S, D, scale, s);
    });
  return elem16(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if (D == 128)
      return launch_dq_sm90<T, 128>(q, k, v, dout, l, dl, dq, B, H, L, S,
                                    scale, s);
    if (D == 256)
      return launch_dq_sm90<T, 256>(q, k, v, dout, l, dl, dq, B, H, L, S,
                                    scale, s);
    if (D == 384)
      return launch_dq_pair<T, 384>(q, k, v, dout, l, dl, dq, B, H, L, S,
                                    scale, s);
    if (D == 512)
      return launch_dq_pair<T, 512>(q, k, v, dout, l, dl, dq, B, H, L, S,
                                    scale, s);
    if (cluster16_takes(D))
      return launch_dq_cluster<T>(q, k, v, dout, l, dl, dq, B, H, L, S, D,
                                  scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// dk, dv as k
int flash_attention_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* delta,
                        void* dk, void* dv, int B, int H, int L, int S, int D,
                        float scale, int dtype, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto* l = static_cast<const float*>(lse);
  auto* dl = static_cast<const float*>(delta);
  if (dtype == kFloat32 && shares3_takes(D))
    return launch_dkv_shares3(q, k, v, dout, l, dl, dk, dv, B, H, L, S, D,
                              scale, s);
  if (dtype == kFloat32)
    return split3_head_dim(D, [&](auto hd) {
      return launch_dkv_split3<decltype(hd)::value>(q, k, v, dout, l, dl, dk,
                                                    dv, B, H, L, S, D, scale,
                                                    s);
    });
  return elem16(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if (D == 128)
      return launch_dkv_sm90<T, 128>(q, k, v, dout, l, dl, dk, dv, B, H, L, S,
                                     scale, s);
    if (D == 256)
      return launch_dkv_sm90<T, 256>(q, k, v, dout, l, dl, dk, dv, B, H, L, S,
                                     scale, s);
    if (D == 384)
      return launch_dkv_pair<T, 384>(q, k, v, dout, l, dl, dk, dv, B, H, L, S,
                                     scale, s);
    if (D == 512)
      return launch_dkv_pair<T, 512>(q, k, v, dout, l, dl, dk, dv, B, H, L, S,
                                     scale, s);
    if (cluster16_takes(D))
      return launch_dkv_cluster<T>(q, k, v, dout, l, dl, dk, dv, B, H, L, S,
                                   D, scale, s);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

// how many clusters of the kernel `kernel` (0 forward, 1 dq, 2 dk/dv) of
// element type `dtype` at head dim D the card can hold at once, into *n:
// float32 at 128 .. 2048 (clusters of D / 128 blocks, one at 128) and at
// 2176 and 2304 (twelve blocks of 192-column shares), bfloat16
// and float16 at 384 .. 4096 (clusters of ceil(D / 256) blocks, 2 to 16);
// returns a cudaError_t value (another kernel, type or D:
// cudaErrorInvalidValue)
int flash_attention_max_clusters(int kernel, int D, int dtype, int* n) {
  if (dtype == kFloat32 && shares3_takes(D))
    return max_clusters_shares3(kernel, D, n);
  if (dtype == kFloat32)
    return split3_head_dim(D, [&](auto hd) {
      return max_clusters_split3<decltype(hd)::value>(kernel, D, n);
    });
  return elem16(dtype, [&](auto t) {
    using T = typename decltype(t)::type;
    if (D == 384) return max_clusters_pair<T, 384>(kernel, n);
    if (D == 512) return max_clusters_pair<T, 512>(kernel, n);
    if (cluster16_takes(D)) return max_clusters_cluster16<T>(kernel, D, n);
    return static_cast<int>(cudaErrorInvalidValue);
  });
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
