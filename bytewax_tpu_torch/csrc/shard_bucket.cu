// Keyed shard bucketing for Hopper (sm_90a).
//
// Replaces the JAX package's bytewax_tpu/parallel/exchange.py
// `bucket_by_shard` (:27), the stable counting sort inside every step of
// the mesh-sharded tier (ops/sharded.py `make_sharded_step` :96 and
// `make_sharded_scan_step` :220): place each row of a source block into
// a fixed-capacity bucket of the shard that owns it, in the order the
// rows came.
//
// Input: n_blocks source blocks of n rows each.  A row carries n_lanes
// int32 lanes (1 to 4; lane k of row i of block b at
// lane_k[b * block_stride + i * row_stride]), a shard id (shard_ids at
// [b * block_stride + i], or, where shard_ids is NULL, lane 0 modulo
// n_shards) and a valid flag (valid at [b * block_stride + i], or every
// row where valid is NULL).  A row that is not valid, or whose shard
// lies outside [0, n_shards), goes to no bucket (the JAX version's
// overflow bin) and is not counted.
//
// Output, laid out by destination so that one destination's rows from
// every source are one contiguous slice (what the JAX all_to_all with
// split_axis = concat_axis = 0 hands the owner):
//   out[lane][dst][src][rank]  int32, rank < capacity: the row of block
//                              src that is the rank-th of that block's
//                              rows bound for dst;
//   counts[src][dst]           min(rows of src bound for dst, capacity);
//   dropped[src]               the rows of src that did not fit.
// Positions past a bucket's count hold 0 in every lane, as in JAX,
// unless `flags` asks for the owner's decoded inputs (below).
//
// flags bit 0 (DECODE): lane 0 is a wire key id (slot * n_shards +
//   shard), and out lane 0 holds the owner's local slot, key / n_shards;
//   an empty position holds pad0 there (the block's scratch slot), so
//   the segment fold (segment_fold.cu) and the segmented scan
//   (segment_scan.cu) read a destination's slice with no pass between:
//   scratch rows fold nothing, and sort to a scan's tail.
// flags bit 1 (POS): one more output lane holds each row's position,
//   pos_base + src * n + i; an empty position holds pos_pad.  The scan's
//   return trip writes each output to that position.
//
// What bounds it: bytes.  Each row is read once (4 B a lane, 1 B of
// valid, 4 B of shard id where given) and each output position written
// once (4 B a lane).  On the sharded step's path (two lanes, shard from
// lane 0, a valid flag, an exact power-of-two capacity): 9 B a row in
// and 8 B an output position out, about 17.8 MB for 2^20 rows at a
// capacity one row over the bucket maximum, 5.3 us at 3.35 TB/s; the
// scan's path adds the position lane, 12 B an output position.
//
// Design: three passes over chunks of kChunk rows, no atomics, so the
// output is deterministic and exact.
//   k_count   one block a (chunk, source block): each warp ranks its 32
//             rows with __match_any_sync, the lowest lane of each group
//             of equal shards writes the group's size to a shared
//             [warp][shard] table, and the block sums it into the
//             chunk's per-shard count;
//   k_offsets one block a source block: an exclusive scan of the chunk
//             counts over the chunks, per shard (a warp a shard,
//             shuffles), giving each chunk its base in every bucket,
//             and the bucket counts and drops;
//   k_pad     fills every position past a bucket's count;
//   k_place   one block a (chunk, source block), in the chunk's tiles of
//             kThreads rows in order: the same warp ranks, an exclusive
//             scan of the [warp][shard] table over the warps (a warp a
//             shard, shuffles), and a running base per shard carried
//             across tiles, so a row's rank is its block's earlier rows
//             bound for the same shard; rows under the capacity are
//             written.
// k_count and k_place read each row twice: 18 B a row, where one pass
// with a decoupled look-back (as segment_scan.cu) would read it once.
//
// The host wrapper (ops/bucket_kernel.py) checks every argument,
// allocates the outputs and the [n_blocks, chunks, n_shards] chunk-count
// workspace, passes PyTorch's current stream, and raises on a non-zero
// return, which is the first failing launch's cudaError_t.  Nothing is
// allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kTilesPerChunk = 4;
constexpr long long kChunk = static_cast<long long>(kThreads) * kTilesPerChunk;
constexpr int kMaxShards = 64;
constexpr int kMaxLanes = 4;
constexpr unsigned kFull = 0xffffffffu;
enum { DECODE = 1, POS = 2 };

struct Rows {
  const int32_t* lane[kMaxLanes];
  int n_lanes;
  long long block_stride;
  long long row_stride;
  const int32_t* shard_ids;
  const uint8_t* valid;
  long long n;
  int n_shards;
};

// The shard of row i of block b, or -1 for a row that goes to no bucket.
__device__ __forceinline__ int shard_of(const Rows& r, int b, long long i) {
  if (i >= r.n) return -1;
  const long long at = b * r.block_stride + i;
  if (r.valid != nullptr && r.valid[at] == 0) return -1;
  int s;
  if (r.shard_ids != nullptr) {
    s = r.shard_ids[at];
  } else {
    s = r.lane[0][b * r.block_stride + i * r.row_stride] % r.n_shards;
  }
  return (s >= 0 && s < r.n_shards) ? s : -1;
}

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Zero the [warp][shard] table (the caller synchronises after).
__device__ __forceinline__ void zero_table(int (*wc)[kMaxShards]) {
  for (int k = threadIdx.x; k < kWarps * kMaxShards; k += kThreads) {
    wc[k / kMaxShards][k % kMaxShards] = 0;
  }
}

// One warp's ranks for its row of a tile: the group of lanes with the
// same shard, and this lane's place in it.  The group's lowest lane
// writes the group's size to wc[warp][shard].
__device__ __forceinline__ unsigned rank_in_warp(int s, int (*wc)[kMaxShards]) {
  const unsigned group = __match_any_sync(kFull, s);
  if (s >= 0 && (group & lanes_below()) == 0) {
    wc[threadIdx.x >> 5][s] = __popc(group);
  }
  return group;
}

__global__ void __launch_bounds__(kThreads) k_count(Rows r, int chunks, int32_t* chunk_counts) {
  __shared__ int wc[kWarps][kMaxShards];
  __shared__ int sum[kMaxShards];
  const int b = blockIdx.y;
  const long long c = blockIdx.x;
  if (threadIdx.x < kMaxShards) sum[threadIdx.x] = 0;
  for (int t = 0; t < kTilesPerChunk; ++t) {
    zero_table(wc);
    __syncthreads();
    const long long i = c * kChunk + static_cast<long long>(t) * kThreads + threadIdx.x;
    rank_in_warp(shard_of(r, b, i), wc);
    __syncthreads();
    if (threadIdx.x < r.n_shards) {
      int acc = 0;
#pragma unroll 8
      for (int w = 0; w < kWarps; ++w) acc += wc[w][threadIdx.x];
      sum[threadIdx.x] += acc;
    }
    __syncthreads();
  }
  if (threadIdx.x < r.n_shards) {
    chunk_counts[(static_cast<long long>(b) * chunks + c) * r.n_shards + threadIdx.x] =
        sum[threadIdx.x];
  }
}

// An exclusive scan of the chunk counts over the chunks, in place, per
// shard; bucket counts and drops per source block.
__global__ void __launch_bounds__(kThreads)
    k_offsets(int chunks, int n_shards, long long capacity, int32_t* chunk_counts,
              int32_t* counts, int32_t* dropped) {
  __shared__ long long over[kMaxShards];
  const int b = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int32_t* cc = chunk_counts + static_cast<long long>(b) * chunks * n_shards;
  for (int s = warp; s < n_shards; s += kWarps) {
    long long run = 0;
    for (int c0 = 0; c0 < chunks; c0 += 32) {
      const int c = c0 + lane;
      const int v = c < chunks ? cc[static_cast<long long>(c) * n_shards + s] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      if (c < chunks) cc[static_cast<long long>(c) * n_shards + s] = static_cast<int>(run) + incl - v;
      run += __shfl_sync(kFull, incl, 31);
    }
    if (lane == 0) {
      counts[static_cast<long long>(b) * n_shards + s] =
          static_cast<int32_t>(run < capacity ? run : capacity);
      over[s] = run > capacity ? run - capacity : 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int s = 0; s < n_shards; ++s) total += over[s];
    dropped[b] = static_cast<int32_t>(total);
  }
}

// Fill every position past a bucket's count.
__global__ void k_pad(int n_out, int n_blocks, int n_shards, long long capacity,
                      const int32_t* counts, int pad0, int pos_lane, int pos_pad,
                      int32_t* out) {
  const long long per_lane = static_cast<long long>(n_shards) * n_blocks * capacity;
  for (long long p = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       p < per_lane; p += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long bucket = p / capacity;  // dst * n_blocks + src
    const long long rank = p - bucket * capacity;
    const int dst = static_cast<int>(bucket / n_blocks);
    const int src = static_cast<int>(bucket - static_cast<long long>(dst) * n_blocks);
    if (rank < counts[static_cast<long long>(src) * n_shards + dst]) continue;
    for (int k = 0; k < n_out; ++k) {
      out[k * per_lane + p] = k == 0 ? pad0 : (k == pos_lane ? pos_pad : 0);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    k_place(Rows r, int chunks, int n_blocks, long long capacity, int flags,
            long long pos_base, const int32_t* chunk_counts, int32_t* out) {
  __shared__ int wc[kWarps][kMaxShards];
  __shared__ int base[kMaxShards];
  const int b = blockIdx.y;
  const long long c = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int S = r.n_shards;
  if (threadIdx.x < S) {
    base[threadIdx.x] = chunk_counts[(static_cast<long long>(b) * chunks + c) * S + threadIdx.x];
  }
  const long long per_lane = static_cast<long long>(S) * n_blocks * capacity;
  for (int t = 0; t < kTilesPerChunk; ++t) {
    zero_table(wc);
    __syncthreads();
    const long long i = c * kChunk + static_cast<long long>(t) * kThreads + threadIdx.x;
    const int s = shard_of(r, b, i);
    const unsigned group = rank_in_warp(s, wc);
    __syncthreads();
    // Exclusive scan of wc[.][s] over the warps, from base[s]: warp w
    // takes shards w, w + 32; lane l holds warp l's count.
    for (int sh = warp; sh < S; sh += kWarps) {
      const int v = wc[lane][sh];
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int up = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += up;
      }
      const int b0 = base[sh];
      wc[lane][sh] = b0 + incl - v;
      __syncwarp();
      if (lane == 31) base[sh] = b0 + incl;
    }
    __syncthreads();
    if (s >= 0) {
      const long long rank = wc[warp][s] + __popc(group & lanes_below());
      if (rank < capacity) {
        const long long at = (static_cast<long long>(s) * n_blocks + b) * capacity + rank;
        const long long src_at = b * r.block_stride + i * r.row_stride;
        // Unrolled over the most lanes, so the lane pointers stay in
        // registers.
#pragma unroll
        for (int k = 0; k < kMaxLanes; ++k) {
          if (k < r.n_lanes) {
            int v = r.lane[k][src_at];
            if (k == 0 && (flags & DECODE)) v /= S;
            out[k * per_lane + at] = v;
          }
        }
        if (flags & POS) {
          out[r.n_lanes * per_lane + at] =
              static_cast<int32_t>(pos_base + static_cast<long long>(b) * r.n + i);
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Bucket n_blocks source blocks of n rows each into n_shards buckets of
// `capacity` rows per (source, destination), on the current device (see
// the header for the layouts).  chunk_counts is a workspace of
// n_blocks * ceil(n / 4096) * n_shards int32.  Returns the first failing
// launch's cudaError_t (0 on success).
extern "C" int bw_shard_bucket(const void* lane0, const void* lane1, const void* lane2,
                               const void* lane3, int n_lanes, long long block_stride,
                               long long row_stride, const void* shard_ids,
                               const void* valid, int n_blocks, long long n, int n_shards,
                               long long capacity, int flags, int pad0, long long pos_base,
                               int pos_pad, void* out, void* counts, void* dropped,
                               void* chunk_counts, void* stream) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_blocks < 1 || n_blocks > 65535 || n < 0 ||
      n > 0x7fffffffLL || n_shards < 1 || n_shards > kMaxShards || capacity < 0 ||
      (flags & ~(DECODE | POS)) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Rows r;
  const void* lanes[kMaxLanes] = {lane0, lane1, lane2, lane3};
  for (int k = 0; k < kMaxLanes; ++k) r.lane[k] = static_cast<const int32_t*>(lanes[k]);
  r.n_lanes = n_lanes;
  r.block_stride = block_stride;
  r.row_stride = row_stride;
  r.shard_ids = static_cast<const int32_t*>(shard_ids);
  r.valid = static_cast<const uint8_t*>(valid);
  r.n = n;
  r.n_shards = n_shards;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* o = static_cast<int32_t*>(out);
  int32_t* cnt = static_cast<int32_t*>(counts);
  int32_t* drp = static_cast<int32_t*>(dropped);
  int32_t* cc = static_cast<int32_t*>(chunk_counts);
  const int chunks = static_cast<int>((n + kChunk - 1) / kChunk);
  const dim3 grid(static_cast<unsigned int>(chunks), static_cast<unsigned int>(n_blocks));
  cudaError_t err;
  if (chunks > 0) {
    k_count<<<grid, kThreads, 0, st>>>(r, chunks, cc);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  k_offsets<<<n_blocks, kThreads, 0, st>>>(chunks, n_shards, capacity, cc, cnt, drp);
  if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  const int n_out = n_lanes + ((flags & POS) ? 1 : 0);
  const long long per_lane = static_cast<long long>(n_shards) * n_blocks * capacity;
  if (per_lane > 0) {
    long long pad_blocks = (per_lane + 255) / 256;
    if (pad_blocks > 4096) pad_blocks = 4096;
    const int pad_first = (flags & DECODE) ? pad0 : 0;
    const int pos_lane = (flags & POS) ? n_lanes : -1;
    k_pad<<<static_cast<unsigned int>(pad_blocks), 256, 0, st>>>(
        n_out, n_blocks, n_shards, capacity, cnt, pad_first, pos_lane, pos_pad, o);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  if (chunks > 0 && capacity > 0) {
    k_place<<<grid, kThreads, 0, st>>>(r, chunks, n_blocks, capacity, flags, pos_base, cc, o);
    if ((err = cudaGetLastError()) != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
