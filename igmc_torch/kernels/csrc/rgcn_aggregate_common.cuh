// Device code shared by the R-GCN aggregate kernels
// (rgcn_aggregate_fwd.cu, rgcn_aggregate_bwd.cu): the fold of a tile of
// W_r, a chunk's slot range, and the walk over a chunk's (row, relation)
// runs.
//
// Both kernels take any Cin, Cout and number of bases. A lane holds one
// channel, so the channels go in tiles of kLanes: each kernel makes one pass
// over its chunk per (input tile, output tile) pair it needs, with W_r
// folded tile by tile; at Cin, Cout <= 32 (the CLI's widths) one pass.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kLanes = 32;       // channels a warp holds: one tile
constexpr int kBaseGroup = 8;    // bases whose basis entries a thread holds at once
constexpr int kTile = 128;       // plan slots a warp takes at a time
constexpr int kAhead = 8;        // tiles whose masks a warp checks at once
constexpr int kLoads = 16;       // rows a warp gathers at once
// per-warp staging in shared memory for walk_runs: of one 32-slot group the
// live slots' gather indices and masks, and their gathered row tiles
constexpr int kWalkWords = 2 * 32 + 32 * kLanes;

// Channel tiles of a width: their count, and the width of tile t.
__device__ __forceinline__ int ch_tiles(int width) { return (width + kLanes - 1) / kLanes; }
__device__ __forceinline__ int ch_width(int width, int t) { return min(kLanes, width - t * kLanes); }

// The [i0, i0 + tin) x [o0, o0 + tout) tile of W_r = sum_b att[r0 + r, b] *
// basis[b] for r < nr into w[(r * tin + i) * ldw + o]; the bases in groups
// of kBaseGroup, any number of them. basis is [nb, cin, cout].
__device__ void fold_relations(float* w, int ldw, const float* __restrict__ att,
                               const float* __restrict__ basis, int r0, int nr,
                               int cin, int cout, int nb, int i0, int tin, int o0,
                               int tout) {
  const long long io_n = (long long)cin * cout;
  for (int io = threadIdx.x; io < tin * tout; io += blockDim.x) {
    const int i = io / tout, o = io - i * tout;
    const float* bp = basis + (long long)(i0 + i) * cout + o0 + o;
    for (int b0 = 0; b0 < nb; b0 += kBaseGroup) {
      float bas[kBaseGroup];
#pragma unroll
      for (int b = 0; b < kBaseGroup; ++b)
        bas[b] = b0 + b < nb ? __ldg(bp + (b0 + b) * io_n) : 0.f;
      for (int r = 0; r < nr; ++r) {
        const float* a = att + (long long)(r0 + r) * nb + b0;
        float* wr = w + (r * tin + i) * ldw + o;
        float v = b0 == 0 ? 0.f : *wr;
#pragma unroll
        for (int b = 0; b < kBaseGroup; ++b)
          if (b0 + b < nb) v = fmaf(__ldg(a + b), bas[b], v);
        *wr = v;
      }
    }
  }
}

// Whether any of the slots [e, e + 4) below e_end is live (nonzero mask):
// one 16-byte load where the four are in bounds and 16-byte aligned (every
// slot at a block size that is a multiple of 4), else one load per slot.
__device__ __forceinline__ bool any_live4(const float* __restrict__ mask, long long e,
                                          long long e_end) {
  if (e + 4 <= e_end && (reinterpret_cast<uintptr_t>(mask + e) & 15) == 0) {
    const float4 m4 = __ldg(reinterpret_cast<const float4*>(mask + e));
    return m4.x != 0.f || m4.y != 0.f || m4.z != 0.f || m4.w != 0.f;
  }
  bool any = false;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (e + j < e_end && __ldg(mask + e + j) != 0.f) any = true;
  return any;
}

// [first, end) edge slots of `chunk`: lower_bound(chunk_of_block, chunk)
// and lower_bound(chunk_of_block, chunk + 1), times eblk
__device__ void chunk_range(const int* __restrict__ chunk_of_block, int nblk,
                            int chunk, int eblk, long long* range) {
  if (threadIdx.x < 2) {
    const int key = chunk + threadIdx.x;
    int lo = 0, hi = nblk;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (chunk_of_block[mid] < key) lo = mid + 1; else hi = mid;
    }
    range[threadIdx.x] = (long long)lo * eblk;
  }
}

// One warp's walk over its share of a chunk's plan slots [e_begin, e_end):
// the kTile-slot tiles wid, wid + stride, wid + 2 * stride, ... A slot is
// live when its mask is nonzero and its relation lies in [r0, r0 + nr);
// tiles with no live slot are skipped, kAhead at a time, with one 16-byte
// mask load per lane and tile (any_live4). The plan orders each scatter
// row's slots by relation, so each (row, relation) pair is one run of
// consecutive live slots; for each run the walk sums one channel tile of
// the gathered rows, channels [c0, c0 + width) of rows of ld floats,
//
//   u = sum_e mask_e * table[gidx_e * ld + c0 + c]   (lane c < width <= 32:
//                                 channel c0 + c; the other lanes' u is
//                                 meaningless)
//
// and calls end_run(row, relation, u), warp-uniformly, when the run ends
// (the last one at the end of the walk); row is the chunk-local rowl_e.
//
// A tile is walked as four 32-slot groups, slots on lanes: ballots find the
// live slots and where a run starts (its (row, relation) differs from the
// live slot before it, the first against the open run); the row tiles
// mask * table[gidx] of the live slots are gathered, kLoads loads in
// flight, into the warp's staging `stage` (kWalkWords floats; a row tile
// fills `width` lanes rounded up to a power of two, so one load
// instruction gathers 8 rows at width 4); then lanes are channels and each
// run's rows are summed into a register.
template <class EndRun>
__device__ __forceinline__ void walk_runs(
    const float* __restrict__ table, int ld, int c0, int width,
    const int* __restrict__ gidx,
    const int* __restrict__ rowl, const int* __restrict__ etype,
    const float* __restrict__ mask, long long e_begin, long long e_end, int wid,
    int stride, int r0, int nr, float* stage, EndRun&& end_run) {
  const int lane = threadIdx.x & 31;
  int* st_idx = reinterpret_cast<int*>(stage);   // [32]
  float* st_m = stage + 32;                      // [32]
  float* st_row = stage + 64;                    // [32][kLanes]
  const int cw_log = width > 1 ? 32 - __clz(width - 1) : 0;
  const int cw = 1 << cw_log, spl = 32 >> cw_log;
  const int n_tiles = (int)((e_end - e_begin + kTile - 1) / kTile);
  float u = 0.f;                 // lane c: the open run's sum of channel c
  int cur_r = -1, cur_t = -1;    // the open run's row and relation

  for (int tb = wid; tb < n_tiles; tb += kAhead * stride) {
    unsigned live_tiles = 0;
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
      const long long e = e_begin + (long long)(tb + q * stride) * kTile + 4 * lane;
      live_tiles |= (unsigned)__any_sync(kFull, any_live4(mask, e, e_end)) << q;
    }
#pragma unroll 1
    for (int q = 0; q < kAhead; ++q) {
      if (!((live_tiles >> q) & 1u)) continue;
      // the tile's slots, one 32-slot group per register
      const long long base = e_begin + (long long)(tb + q * stride) * kTile;
      float tm[kTile / 32];
      int tg[kTile / 32], tr[kTile / 32], tt[kTile / 32];
#pragma unroll
      for (int k = 0; k < kTile / 32; ++k) {
        const long long e = base + 32 * k + lane;
        const bool valid = e < e_end;
        tm[k] = valid ? __ldg(mask + e) : 0.f;
        tg[k] = valid ? __ldg(gidx + e) : 0;
        tr[k] = valid ? __ldg(rowl + e) : 0;
        tt[k] = valid ? __ldg(etype + e) : 0;
      }
      static_assert(kTile == 128, "the selects below take four groups");
#pragma unroll 1
      for (int k = 0; k < kTile / 32; ++k) {
        const float m = k == 0 ? tm[0] : k == 1 ? tm[1] : k == 2 ? tm[2] : tm[3];
        const int gi = k == 0 ? tg[0] : k == 1 ? tg[1] : k == 2 ? tg[2] : tg[3];
        const int rw = k == 0 ? tr[0] : k == 1 ? tr[1] : k == 2 ? tr[2] : tr[3];
        const int t = k == 0 ? tt[0] : k == 1 ? tt[1] : k == 2 ? tt[2] : tt[3];
        const bool on = m != 0.f && (unsigned)(t - r0) < (unsigned)nr;
        const unsigned live = __ballot_sync(kFull, on);
        if (!live) continue;
        const unsigned below = live & ((1u << lane) - 1u);
        const int pj = below ? 31 - __clz(below) : lane;
        const int pr = __shfl_sync(kFull, rw, pj), pt = __shfl_sync(kFull, t, pj);
        const int prev_r = below ? pr : cur_r, prev_t = below ? pt : cur_t;
        const unsigned run_start = __ballot_sync(kFull, on && (rw != prev_r || t != prev_t));
        // gather mask * table[gidx] of the live slots in slot order: lane ->
        // (slot rank b0 + lane / cw, channel lane % cw)
        if (on) {
          st_idx[__popc(below)] = gi;
          st_m[__popc(below)] = m;
        }
        __syncwarp();
        const int n_live = __popc(live);
        const int c = lane & (cw - 1);
        for (int b0 = lane >> cw_log; b0 < n_live; b0 += kLoads * spl) {
          // kLoads loads in flight, all issued before the stores
          float v[kLoads];
#pragma unroll
          for (int k2 = 0; k2 < kLoads; ++k2) {
            const int b = b0 + k2 * spl;
            v[k2] = b < n_live && c < width
                        ? st_m[b] * __ldg(table + (long long)st_idx[b] * ld + c0 + c) : 0.f;
          }
#pragma unroll
          for (int k2 = 0; k2 < kLoads; ++k2)
            if (b0 + k2 * spl < 32) st_row[(b0 + k2 * spl) * 32 + c] = v[k2];
        }
        __syncwarp();
        // walk the runs: sum each run's rows, end the open run where the
        // next starts
        unsigned pending = live;
        int b = 0;
        while (pending) {
          const int j = __ffs(pending) - 1;
          if ((run_start >> j) & 1u) {           // warp-uniform
            if (cur_t >= 0) end_run(cur_r, cur_t, u);
            u = 0.f;
            cur_r = __shfl_sync(kFull, rw, j);
            cur_t = __shfl_sync(kFull, t, j);
          }
          const unsigned later = run_start & pending & (pending - 1u);
          const unsigned seg = later ? pending & ((later & (0u - later)) - 1u) : pending;
          const int n = __popc(seg);
          float a0 = 0.f, a1 = 0.f;
          int i = 0;
          for (; i + 2 <= n; i += 2) {
            a0 += st_row[(b + i) * 32 + lane];
            a1 += st_row[(b + i + 1) * 32 + lane];
          }
          if (i < n) a0 += st_row[(b + i) * 32 + lane];
          u += a0 + a1;
          b += n;
          pending &= ~seg;
        }
        __syncwarp();   // the staging is rewritten by the next group
      }
    }
  }
  if (cur_t >= 0) end_run(cur_r, cur_t, u);
}

}  // namespace
