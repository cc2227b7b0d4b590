// Fused R-GCN aggregate (forward) for NVIDIA Hopper, sm_90a, float32.
//
// Replaces the Pallas TPU kernel igmc_tpu/kernels/rgcn_aggregate.py:_kernel
// (launched by _aggregate_fwd). Over dst-block-aligned edges it computes
//
//   out[dst_e] += mask_e * sum_b att[etype_e, b] * (x[src_e] @ basis[b])
//
// for every node row, i.e. the masked segment-SUM of basis-mixed R-GCN
// messages ([num_nodes, Cout] float32; the mean divides by the degree
// outside).
//
// The run form. With W_r = sum_b att[r, b] * basis[b] folded once,
//
//   out[i] = sum_r (sum_{e: dst_e = i, etype_e = r} mask_e * x[src_e]) @ W_r,
//
// so an edge costs Cin adds of its gathered source row, and the products
// shrink to one [Cin] x [Cin, Cout] product per (dst, relation) run: the
// plan (block_align_edges) orders each dst row's edges by relation, so a
// run is a stretch of consecutive slots. At the ML-1M batch that is ~37 K
// runs for ~216 K edges, against 2*B*Cin*Cout operations per edge in the
// TPU's basis-mix form.
//
// What bounds it on this card: the function is bound by device memory
// (the mask over every slot, three index arrays over the real edges, x and
// the output: ~7 MB, 0.002 ms at 3.35 TB/s); its ~1e8 float32 operations
// take less. This kernel is bound by latency instead: each warp walks its
// slots through dependent steps (index loads, then the gather of x[src],
// one Cin-row per edge and ~28 MB at Cin 32, mostly from L2, then the
// run's product), and the grid holds about 12 warps per SM to hide them.
//
// Design:
//   * A thread-block cluster of kCluster = 4 CTAs of 256 threads per
//     `rows`-row output chunk: 200 CTAs of 8 warps at the ML-1M shape
//     (12,800 rows, 50 chunks), at most 2 per SM (128 registers a thread),
//     so every one of the 132 SMs gets work. The cluster's 32 warps take
//     the chunk's 128-slot tiles round robin, so the capacity padding that
//     block_align_edges puts at the tail of chunk 0 costs every warp alike;
//     a warp checks 8 of its tiles at once with one 16-byte mask load per
//     lane and tile (per slot where a block size that is not a multiple of
//     4 leaves the four unaligned), and skips the tiles with no live slot.
//   * A live tile is walked (walk_runs in rgcn_aggregate_common.cuh, the
//     walk the backward kernel shares) as four 32-slot groups, slots on lanes. Ballots
//     find the live slots (mask != 0, relation in this pass) and where a run
//     starts (its (dst, relation) differs from the live slot before it); the
//     rows mask * x[src] of the live slots are gathered, 16 loads in flight,
//     into the warp's staging in shared memory (a row fills Cin lanes
//     rounded up to a power of two, so one load instruction gathers 8 rows
//     at Cin 4); then lanes are the channels and each run's rows are summed
//     into a register.
//   * At a run's end, one product with W_r (lanes are the output channels,
//     the run sum broadcast by shuffles, W_r read from shared memory) goes
//     into the open row's carry, a register. The product is kept in the
//     walk: deferring the products to a batch (tried) was slower.
//   * Any width: a lane holds one channel, so Cin and Cout go in 32-wide
//     tiles and the kernel makes one pass over the chunk per (output tile,
//     input tile) pair, each pass walking one input tile of x[src] and
//     adding its products with that tile of W_r into the output tile (the
//     function is linear in x, so the input tiles' products sum). At Cin,
//     Cout <= 32 (the CLI's widths) that is a single pass;
//     Cin 200, Cout 40 takes 7 x 2.
//   * Each CTA owns a quarter of the chunk's output rows as a [rows/4, 32]
//     shared accumulator of the output tile; a warp adds a finished row's
//     carry to the owning
//     CTA's accumulator through distributed shared memory
//     (cluster.map_shared_rank, shared atomics). The CTAs write their own
//     rows of the tile once after its passes: no global atomics and no zero
//     fill of `out` (the wrapper allocates it with torch.empty).
//   * W_r's tile is folded in each pass's prologue from att and basis (any
//     number of bases, 8 at a time) into shared memory ([R, 32, 32] at
//     most, 20 KB at R 5, Cin 32, Cout 32; 63 KB per CTA in all). Where the
//     tiles of all R relations do not fit beside the staging and the
//     accumulator (yahoo_music's R = 71 needs 291 KB at Cin 32, over the
//     227 KB a block can have), the relations go in groups: one pass over
//     the chunk per group of relations, folding that group's W_r tiles and
//     taking only the live slots whose relation is in it (two passes of 36
//     relations at R = 71, Cin 32). The launcher sizes the groups from the
//     card's shared memory, so any R runs, with no error and no fallback.
//     Only a `rows` whose accumulator leaves no room for one relation's
//     tile (above 6,044 rows on an H100) is refused, before any launch.
//   * Summation order differs from the plain PyTorch version and shared
//     atomics make it vary between runs: compare with a tolerance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rgcn_aggregate_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;      // CTAs per output chunk
constexpr int kWarps = 8;        // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kStageWords = kWalkWords;   // per-warp staging of walk_runs

// kTiled: Cin or Cout above 32, more than one channel tile (without it
// the tile loops below compile to the single pass of the CLI's widths)
template <bool kTiled>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
rgcn_aggregate_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ att,
                          const float* __restrict__ basis,
                          const int* __restrict__ src,
                          const int* __restrict__ dstl,
                          const int* __restrict__ etype,
                          const float* __restrict__ mask,
                          const int* __restrict__ chunk_of_block,
                          float* __restrict__ out,
                          int cin, int cout, int nb, int nrel, int rows,
                          int nblk, int eblk, int rel_per_pass) {
  extern __shared__ float smem[];
  const int rpc = (rows + kCluster - 1) / kCluster;   // rows each CTA owns
  const int warp = threadIdx.x >> 5;
  float* stage = smem + warp * kStageWords;
  float* s_acc = smem + kWarps * kStageWords;          // [rpc, tout] of an output tile
  float* s_w = s_acc + rpc * min(cout, kLanes);        // [rel_per_pass, tin, tout]
  __shared__ long long s_range[2];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int chunk = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int wid = rank * kWarps + warp;                // warp index in the cluster
  const int stride = kCluster * kWarps;
  const int row_lo = rank * rpc, row_hi = min(rows, row_lo + rpc);

  chunk_range(chunk_of_block, nblk, chunk, eblk, s_range);

  // one pass per (output tile, input tile, relation group): the output
  // tile's sums gather in s_acc over its passes and are written once
  for (int ot = 0; ot < (kTiled ? ch_tiles(cout) : 1); ++ot) {
    const int o0 = ot * kLanes, tout = ch_width(cout, ot);
    const int o = lane < tout ? lane : 0;              // lanes past tout compute on 0
    __syncthreads();                            // the last tile's sums are written out
    for (int j = threadIdx.x; j < rpc * tout; j += kThreads) s_acc[j] = 0.f;
    for (int it = 0; it < (kTiled ? ch_tiles(cin) : 1); ++it) {
      const int i0 = it * kLanes, tin = ch_width(cin, it);
      for (int r0 = 0; r0 < nrel; r0 += rel_per_pass) {
        const int nr = min(rel_per_pass, nrel - r0);
        __syncthreads();                        // the last pass is done with s_w
        fold_relations(s_w, tout, att, basis, r0, nr, cin, cout, nb, i0, tin, o0, tout);
        // the output tile's first pass: every CTA's accumulator must be
        // zero before any warp of the cluster adds to it
        if (it == 0 && r0 == 0) cluster.sync(); else __syncthreads();

        float carry = 0.f;    // lane o: the open row's sum of run products
        int open_row = -1;
        // the open row's carry into the accumulator of the CTA that owns it
        auto flush_row = [&]() {
          if (open_row >= 0 && lane < tout) {
            float* acc = cluster.map_shared_rank(s_acc, open_row / rpc);
            atomicAdd(acc + (open_row % rpc) * tout + lane, carry);
          }
          carry = 0.f;
        };
        // each finished (dst, relation) run: its product with the W_r tile
        // into the row's carry (lane i of u holds the run's sum of channel
        // i0 + i)
        walk_runs(x, cin, i0, tin, src, dstl, etype, mask, s_range[0], s_range[1], wid,
                  stride, r0, nr, stage, [&](int row, int t, float u) {
          if (row != open_row) {
            flush_row();
            open_row = row;
          }
          const float* w = s_w + (t - r0) * tin * tout + o;
          float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
          int i = 0;
          for (; i + 4 <= tin; i += 4) {
            a0 = fmaf(__shfl_sync(kFull, u, i), w[i * tout], a0);
            a1 = fmaf(__shfl_sync(kFull, u, i + 1), w[(i + 1) * tout], a1);
            a2 = fmaf(__shfl_sync(kFull, u, i + 2), w[(i + 2) * tout], a2);
            a3 = fmaf(__shfl_sync(kFull, u, i + 3), w[(i + 3) * tout], a3);
          }
          for (; i < tin; ++i) a0 = fmaf(__shfl_sync(kFull, u, i), w[i * tout], a0);
          carry += (a0 + a1) + (a2 + a3);
        });
        flush_row();
      }
    }
    cluster.sync();   // every row carry of the cluster has landed

    float* out_rows = out + ((long long)chunk * rows + row_lo) * cout + o0;
    for (int j = threadIdx.x; j < (row_hi - row_lo) * tout; j += kThreads)
      out_rows[(long long)(j / tout) * cout + j % tout] = s_acc[j];
  }
}

}  // namespace

// Shared memory the kernel needs per CTA beside the static s_range with
// rel_per_pass relations per pass: the warps' staging, the accumulator of
// one output tile and the W_r tiles of the pass.
static size_t fwd_smem(int cin, int cout, int rows, int rel_per_pass) {
  const int tin = cin < kLanes ? cin : kLanes, tout = cout < kLanes ? cout : kLanes;
  return sizeof(float) * ((size_t)kWarps * kStageWords +
                          (size_t)((rows + kCluster - 1) / kCluster) * tout +
                          (size_t)rel_per_pass * tin * tout);
}

// Launches the kernel on `stream`: one cluster of kCluster CTAs per output
// chunk (num_nodes / rows of them); the channels in 32-wide tiles and the
// relations in as few groups as the card's shared memory allows, one pass
// over the chunk per (output tile, input tile, relation group). Returns a
// cudaError_t as int: 0 on success; or, before any launch, minus the bytes
// of shared memory a CTA needs when `rows` leaves no room beside the
// accumulator for one relation's W_r tile. Any cin, cout >= 1, nb >= 1,
// rows and eblk; the caller checks shapes, dtypes and contiguity.
extern "C" int rgcn_aggregate_fwd(const float* x, const float* att,
                                  const float* basis, const int* src,
                                  const int* dstl, const int* etype,
                                  const float* mask,
                                  const int* chunk_of_block, float* out,
                                  int num_nodes, int cin, int cout, int nb,
                                  int nrel, int rows, int nblk, int eblk,
                                  void* stream) {
  const int n_chunks = num_nodes / rows;
  if (n_chunks == 0) return 0;
  if (nrel < 1 || nb < 1 || cin < 1 || cout < 1 || eblk < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t room = (size_t)smem_max - 64;     // the static s_range
  const size_t fixed = fwd_smem(cin, cout, rows, 0);
  const size_t per_rel = fwd_smem(cin, cout, rows, 1) - fixed;
  if (fixed + per_rel > room) return -(int)(fixed + per_rel + 64);
  const int fit = (int)((room - fixed) / per_rel);
  const int passes = (nrel + fit - 1) / fit;
  const int rel_per_pass = (nrel + passes - 1) / passes;
  const size_t smem = fwd_smem(cin, cout, rows, rel_per_pass);
  const auto kernel = cin > kLanes || cout > kLanes ? rgcn_aggregate_fwd_kernel<true>
                                                    : rgcn_aggregate_fwd_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<n_chunks * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      x, att, basis, src, dstl, etype, mask, chunk_of_block, out, cin, cout, nb, nrel,
      rows, nblk, eblk, rel_per_pass);
  return (int)cudaGetLastError();
}

extern "C" const char* rgcn_aggregate_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
