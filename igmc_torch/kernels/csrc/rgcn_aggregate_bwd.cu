// Fused R-GCN aggregate (backward) for NVIDIA Hopper, sm_90a, float32.
//
// Replaces the Pallas TPU kernel igmc_tpu/kernels/rgcn_aggregate.py:
// _bwd_kernel (launched by _aggregate_bwd), the backward of
// rgcn_aggregate_pallas_train. For the output gradient g [N, Cout] of
//
//   out[dst_e] += mask_e * sum_b att[etype_e, b] * (x[src_e] @ basis[b])
//
// it computes dx (if wanted), datt and dbasis in one launch over the
// src-sorted twin plan (block_align_edges_transposed).
//
// The run form. With W_r = sum_b att[r, b] * basis[b], and for each
// (src, relation) run of the twin plan (it orders each source row's edges
// by relation) u = sum_e mask_e * g[dst_e]:
//
//   dx[src]  += u @ W_r^T                       (if dx is wanted)
//   dW_r     += x[src] outer u
//   datt[r, b] = <basis[b], dW_r>,   dbasis[b] = sum_r att[r, b] * dW_r
//
// so an edge costs Cout adds of its gathered gradient row, and the products
// shrink to one [Cout] x [Cout, Cin] product and one [Cin] x [Cout] outer
// product per run (~38 K runs for ~224 K edges at the ML-1M batch), against
// 2*B*Cin*Cout operations per edge plus per-edge datt atomics in the TPU's
// basis form.
//
// What bounds it on this card: the function is bound by device memory
// (the mask over every slot, three index arrays over the real edges, x, g,
// dx and the small outputs: ~9 MB, 0.003 ms at 3.35 TB/s); its ~1.7e8
// float32 operations take less. This kernel is bound by latency, as the
// forward is (the gather of g[dst], ~29 MB mostly from L2, behind the
// index loads), and by the shared-memory atomics that sum dW.
//
// Design (the forward kernel's walk, with src and dst swapped):
//   * A thread-block cluster of kCluster = 4 CTAs of 256 threads per
//     `rows`-row chunk of SOURCE rows: 200 CTAs at the ML-1M shape, at most
//     2 per SM. The cluster's 32 warps take the chunk's 128-slot tiles round
//     robin and skip the tiles with no live slot (one 16-byte mask load per
//     lane and tile where aligned, 8 tiles at once). A live tile is walked
//     as four 32-slot
//     groups (walk_runs in rgcn_aggregate_common.cuh, shared with the
//     forward kernel): ballots find the live slots and the run starts, the rows
//     mask * g[dst] are gathered into the warp's staging (16 loads in
//     flight), and each (src, relation) run's rows are summed into u, lanes
//     on the output channels.
//   * A finished run goes into the warp's buffer of kRunBuf = 12 runs (u in
//     shared memory, its source row and relation in a lane's registers).
//     When the buffer is full (and at the end of a pass) the warp gathers
//     the buffered runs' x rows at once and takes
//       - the dx products u @ W_r^T (lanes on the input channels, u
//         broadcast from the buffer), in order, into the open source row's
//         carry, added to the dx accumulator when the row changes;
//       - the outer products x[src] outer u summed per relation in
//         registers (lane o holds dW_r[i, o], 16 i at a time) and added to
//         the CTA's [R, Cin, Cout] shared dW partial once per relation and
//         buffer, not once per run: at R 5 that cuts the shared atomics
//         of dW at least 2.4-fold (12 runs, at most 5 relations).
//   * Any width: a lane holds one channel, so Cin and Cout go in 32-wide
//     tiles and the kernel makes one pass over the chunk per (input tile,
//     output tile) pair, walking one output tile of g[dst] and taking the
//     dx products into dx's input tile and the outer products into that
//     (input, output) tile of dW. At Cin, Cout <= 32 (the CLI's widths)
//     that is a single pass.
//   * dx: each CTA owns a quarter of the chunk's source rows as a
//     [rows/4, 32] shared accumulator of the input tile; carries go to the
//     owning CTA through
//     distributed shared memory; each CTA writes its rows of the tile once
//     after its passes (no zero fill; torch.empty). With dx not wanted (layer 1's one-hot input)
//     neither the accumulator, nor W_r, nor the product exists.
//   * dW: at the end of a pass the cluster's four partials are summed
//     through distributed shared memory, each CTA a quarter of the entries,
//     and added to a zeroed global [R, Cin, Cout] sum with one atomicAdd per
//     nonzero entry.
//   * The epilogue: the last CTA to finish (a ticket counter after a
//     __threadfence, the zeroed word after the global dW sum) folds dW into
//     datt and dbasis, which it writes whole (torch.empty in the wrapper).
//   * W_r's tile is folded in each pass's prologue (any number of bases, 8
//     at a time) into shared memory with a row stride of tile width + 1,
//     so that the dx product (lane i reads W_r[i, o]) is free of bank
//     conflicts; 109 KB per CTA in all at R 5, Cin 32, with dx. Where the
//     W_r and dW tiles of all R relations do not fit (R = 71 at Cin 32
//     needs ~590 KB), the relations go in groups, one pass over the chunk
//     per group (four passes of 18 relations at R = 71, Cin 32, dx
//     wanted); the launcher sizes the groups from the card's shared memory,
//     so any R runs. Only a `rows` whose dx accumulator leaves no room for
//     one relation's tiles (above 5,144 rows on an H100, dx wanted) is
//     refused, before any launch.
//   * Summation order differs from the plain PyTorch version and atomics
//     make it vary between runs: compare with a tolerance.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "rgcn_aggregate_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;      // CTAs per source-row chunk
constexpr int kWarps = 8;        // warps per CTA
constexpr int kThreads = kWarps * 32;
constexpr int kRunBuf = 12;      // finished runs a warp buffers before their products
// per-warp staging in shared memory: walk_runs' staging, then the buffered
// runs' sums and x rows
constexpr int kStageWords = kWalkWords + 2 * kRunBuf * 32;

// kTiled: Cin or Cout above 32, more than one channel tile (without it
// the tile loops below compile to the single pass of the CLI's widths)
template <bool kTiled>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 2)
rgcn_aggregate_bwd_kernel(const float* __restrict__ g,
                          const float* __restrict__ x,
                          const float* __restrict__ att,
                          const float* __restrict__ basis,
                          const int* __restrict__ gdst,
                          const int* __restrict__ srcl,
                          const int* __restrict__ etype,
                          const float* __restrict__ mask,
                          const int* __restrict__ chunk_of_block,
                          float* __restrict__ dx,
                          float* __restrict__ datt,
                          float* __restrict__ dbasis,
                          float* __restrict__ dw,
                          unsigned* __restrict__ done,
                          int cin, int cout, int nb, int nrel, int rows,
                          int nblk, int eblk, int rel_per_pass) {
  extern __shared__ float smem[];
  const bool want_dx = dx != nullptr;
  const int rpc = (rows + kCluster - 1) / kCluster;    // rows each CTA owns
  const int io_n = cin * cout;
  const int tile_n = min(cin, kLanes) * min(cout, kLanes);   // the largest W_r tile
  const int warp = threadIdx.x >> 5;
  float* stage = smem + warp * kStageWords;            // walk_runs' staging
  float* st_u = stage + kWalkWords;                    // [kRunBuf][32]
  float* st_x = st_u + kRunBuf * 32;                   // [kRunBuf][32]
  float* s_dx = smem + kWarps * kStageWords;           // [rpc, tin] of an input tile if want_dx
  float* s_dw = s_dx + (want_dx ? rpc * min(cin, kLanes) : 0);   // [rel_per_pass, tin, tout]
  float* s_w = s_dw + rel_per_pass * tile_n;           // [rel_per_pass, tin, tout + 1] if want_dx
  __shared__ long long s_range[2];
  __shared__ bool s_last;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int chunk = blockIdx.x / kCluster;
  const int lane = threadIdx.x & 31;
  const int wid = rank * kWarps + warp;                // warp index in the cluster
  const int stride = kCluster * kWarps;
  const long long row0 = (long long)chunk * rows;
  const int row_lo = rank * rpc, row_hi = min(rows, row_lo + rpc);

  chunk_range(chunk_of_block, nblk, chunk, eblk, s_range);

  // one pass per (input tile, output tile, relation group): dx's input tile
  // gathers in s_dx over its passes and is written once; each pass's dW
  // tile goes to the global sum
  for (int it = 0; it < (kTiled ? ch_tiles(cin) : 1); ++it) {
    const int i0 = it * kLanes, tin = ch_width(cin, it);
    const int ii = lane < tin ? lane : 0;              // lanes past tin compute on 0
    if (want_dx) {
      __syncthreads();                          // the last tile's dx is written out
      for (int j = threadIdx.x; j < rpc * tin; j += kThreads) s_dx[j] = 0.f;
    }
    for (int ot = 0; ot < (kTiled ? ch_tiles(cout) : 1); ++ot) {
      const int o0 = ot * kLanes, tout = ch_width(cout, ot);
      const int ldw = tout + 1;
      for (int r0 = 0; r0 < nrel; r0 += rel_per_pass) {
        const int nr = min(rel_per_pass, nrel - r0);
        __syncthreads();                        // the last pass is done with s_w
        for (int j = threadIdx.x; j < nr * tin * tout; j += kThreads) s_dw[j] = 0.f;
        if (want_dx)
          fold_relations(s_w, ldw, att, basis, r0, nr, cin, cout, nb, i0, tin, o0, tout);
        // the input tile's first pass: every CTA's dx accumulator must be
        // zero before any warp of the cluster adds to it
        if (ot == 0 && r0 == 0) cluster.sync(); else __syncthreads();

        int n_buf = 0;     // finished runs in the warp's buffer
        int buf_s = 0, buf_t = 0;     // lane k: source row and relation of buffered run k
        float dxc = 0.f;   // lane i: the open dx row's sum of u @ W_r^T
        int row_s = -1;    // the open dx row

        // the open dx row's carry into the accumulator of the CTA that owns it
        auto flush_row = [&]() {
          if (want_dx && row_s >= 0 && lane < tin) {
            float* acc = cluster.map_shared_rank(s_dx, row_s / rpc);
            atomicAdd(acc + (row_s % rpc) * tin + lane, dxc);
          }
          dxc = 0.f;
        };
        // the buffered runs: their dx products u_k @ W_r^T in order into the
        // row carries, and their outer products x[src_k] outer u_k summed per
        // relation in registers (lane o holds dW_r[i, o] for 16 i at a time)
        // and added to the CTA's dW tile once per relation
        auto flush_buffer = [&]() {
          {
            float v[kRunBuf];   // the runs' x row tiles, all loads in flight at once
#pragma unroll
            for (int k = 0; k < kRunBuf; ++k) {
              const int sk = __shfl_sync(kFull, buf_s, k);
              v[k] = k < n_buf && lane < tin ? __ldg(x + (row0 + sk) * cin + i0 + lane) : 0.f;
            }
#pragma unroll
            for (int k = 0; k < kRunBuf; ++k) st_x[k * 32 + lane] = v[k];
          }
          __syncwarp();
          if (want_dx) {
            for (int k = 0; k < n_buf; ++k) {
              const int sk = __shfl_sync(kFull, buf_s, k), tk = __shfl_sync(kFull, buf_t, k);
              if (sk != row_s) {
                flush_row();
                row_s = sk;
              }
              const float* w = s_w + ((tk - r0) * tin + ii) * ldw;
              const float* uk = st_u + k * 32;
              float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
              int o = 0;
              for (; o + 4 <= tout; o += 4) {
                a0 = fmaf(uk[o], w[o], a0);
                a1 = fmaf(uk[o + 1], w[o + 1], a1);
                a2 = fmaf(uk[o + 2], w[o + 2], a2);
                a3 = fmaf(uk[o + 3], w[o + 3], a3);
              }
              for (; o < tout; ++o) a0 = fmaf(uk[o], w[o], a0);
              dxc += (a0 + a1) + (a2 + a3);
            }
          }
          unsigned todo = (1u << n_buf) - 1u;
          while (todo) {
            const int t = __shfl_sync(kFull, buf_t, __ffs(todo) - 1);
            const unsigned same = __ballot_sync(kFull, buf_t == t) & todo;
            todo &= ~same;
            for (int ib = 0; ib < tin; ib += 16) {
              float acc[16];
#pragma unroll
              for (int i = 0; i < 16; ++i) acc[i] = 0.f;
              for (unsigned rest = same; rest; rest &= rest - 1u) {
                const int k = __ffs(rest) - 1;
                const float uo = st_u[k * 32 + lane];
                const float* xk = st_x + k * 32 + ib;
#pragma unroll
                for (int i = 0; i < 16; ++i) acc[i] = fmaf(xk[i], uo, acc[i]);
              }
              if (lane < tout) {
                float* p = s_dw + ((t - r0) * tin + ib) * tout + lane;
#pragma unroll
                for (int i = 0; i < 16; ++i)
                  if (ib + i < tin) atomicAdd(p + i * tout, acc[i]);
              }
            }
          }
          n_buf = 0;
          __syncwarp();
        };
        // each finished (src, relation) run into the buffer (lane o of u
        // holds the run's sum of mask * g[dst][o0 + o])
        walk_runs(g, cout, o0, tout, gdst, srcl, etype, mask, s_range[0], s_range[1], wid,
                  stride, r0, nr, stage, [&](int row, int t, float u) {
          if (n_buf == kRunBuf) flush_buffer();
          st_u[n_buf * 32 + lane] = u;
          if (lane == n_buf) {
            buf_s = row;
            buf_t = t;
          }
          ++n_buf;
        });
        flush_buffer();
        flush_row();

        // this pass's dW tiles of the cluster, summed through distributed
        // shared memory (each CTA a quarter of the entries), into the global sum
        cluster.sync();
        for (int j = rank * kThreads + threadIdx.x; j < nr * tin * tout;
             j += kCluster * kThreads) {
          float v = 0.f;
#pragma unroll
          for (int q = 0; q < kCluster; ++q) v += cluster.map_shared_rank(s_dw, q)[j];
          const int r = j / (tin * tout), io = j - r * tin * tout;
          const int i = io / tout, o = io - i * tout;
          if (v != 0.f)
            atomicAdd(dw + (long long)(r0 + r) * io_n + (long long)(i0 + i) * cout + o0 + o, v);
        }
        cluster.sync();   // the tiles were read: they may be zeroed or freed
      }
    }

    if (want_dx) {
      float* dx_rows = dx + (row0 + row_lo) * cin + i0;
      for (int j = threadIdx.x; j < (row_hi - row_lo) * tin; j += kThreads)
        dx_rows[(long long)(j / tin) * cin + j % tin] = s_dx[j];
    }
  }

  // the last CTA to finish folds dW into datt and dbasis
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int p = warp; p < nrel * nb; p += kWarps) {      // datt[r, b] = <basis[b], dW_r>
    const int r = p / nb, b = p - r * nb;
    float v = 0.f;
    for (int io = lane; io < io_n; io += 32)
      v = fmaf(__ldg(basis + (long long)b * io_n + io), __ldcg(dw + (long long)r * io_n + io), v);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
    if (lane == 0) datt[p] = v;
  }
  // dbasis[b] = sum_r att[r, b] dW_r, the bases kBaseGroup at a time
  for (int io = threadIdx.x; io < io_n; io += kThreads) {
    for (int b0 = 0; b0 < nb; b0 += kBaseGroup) {
      float acc[kBaseGroup];
#pragma unroll
      for (int b = 0; b < kBaseGroup; ++b) acc[b] = 0.f;
      for (int r = 0; r < nrel; ++r) {
        const float v = __ldcg(dw + (long long)r * io_n + io);
#pragma unroll
        for (int b = 0; b < kBaseGroup; ++b)
          if (b0 + b < nb) acc[b] = fmaf(__ldg(att + (long long)r * nb + b0 + b), v, acc[b]);
      }
#pragma unroll
      for (int b = 0; b < kBaseGroup; ++b)
        if (b0 + b < nb) dbasis[(long long)(b0 + b) * io_n + io] = acc[b];
    }
  }
}

}  // namespace

// Shared memory the kernel needs per CTA beside the static s_range and
// s_last with rel_per_pass relations per pass: the warps' staging and
// buffers, dx's accumulator of one input tile (when wanted), and the
// pass's dW tiles and, when dx is wanted, W_r tiles.
static size_t bwd_smem(int cin, int cout, int rows, int need_dx, int rel_per_pass) {
  const int tin = cin < kLanes ? cin : kLanes, tout = cout < kLanes ? cout : kLanes;
  return sizeof(float) *
         ((size_t)kWarps * kStageWords +
          (need_dx ? (size_t)((rows + kCluster - 1) / kCluster) * tin : 0) +
          (size_t)rel_per_pass * tin * (tout + (need_dx ? tout + 1 : 0)));
}

// Launches the kernel on `stream`: one cluster of kCluster CTAs per
// source-row chunk (num_nodes / rows of them); the channels in 32-wide
// tiles and the relations in as few groups as the card's shared memory
// allows, one pass over the chunk per (input tile, output tile, relation
// group). `work` is a zeroed float32 buffer of nrel * cin * cout + 1 words
// (the dW sum, then the CTA ticket); `dx` is written whole when need_dx is
// nonzero and ignored otherwise; datt and dbasis are written whole.
// Returns a cudaError_t as int: 0 on success; or, before any launch, minus
// the bytes of shared memory a CTA needs when `rows` leaves no room beside
// dx's accumulator for one relation's tiles. Any cin, cout >= 1, nb >= 1,
// rows and eblk; the caller checks shapes, dtypes and contiguity.
extern "C" int rgcn_aggregate_bwd(const float* g, const float* x,
                                  const float* att, const float* basis,
                                  const int* gdst, const int* srcl,
                                  const int* etype, const float* mask,
                                  const int* chunk_of_block, float* dx,
                                  float* datt, float* dbasis, float* work,
                                  int num_nodes, int cin, int cout, int nb,
                                  int nrel, int rows, int nblk, int eblk,
                                  int need_dx, void* stream) {
  const int n_chunks = num_nodes / rows;
  if (n_chunks == 0 || nrel < 1 || nb < 1 || cin < 1 || cout < 1 || eblk < 1)
    return (int)cudaErrorInvalidValue;
  int dev = 0, smem_max = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  const size_t room = (size_t)smem_max - 64;     // the static s_range and s_last
  const size_t fixed = bwd_smem(cin, cout, rows, need_dx, 0);
  const size_t per_rel = bwd_smem(cin, cout, rows, need_dx, 1) - fixed;
  if (fixed + per_rel > room) return -(int)(fixed + per_rel + 64);
  const int fit = (int)((room - fixed) / per_rel);
  const int passes = (nrel + fit - 1) / fit;
  const int rel_per_pass = (nrel + passes - 1) / passes;
  const size_t smem = bwd_smem(cin, cout, rows, need_dx, rel_per_pass);
  const auto kernel = cin > kLanes || cout > kLanes ? rgcn_aggregate_bwd_kernel<true>
                                                    : rgcn_aggregate_bwd_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  float* dw = work;
  unsigned* done = reinterpret_cast<unsigned*>(work + (size_t)nrel * cin * cout);
  kernel<<<n_chunks * kCluster, kThreads, smem, (cudaStream_t)stream>>>(
      g, x, att, basis, gdst, srcl, etype, mask, chunk_of_block, need_dx ? dx : nullptr,
      datt, dbasis, dw, done, cin, cout, nb, nrel, rows, nblk, eblk, rel_per_pass);
  return (int)cudaGetLastError();
}

extern "C" const char* rgcn_aggregate_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
