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
// split_axis = concat_axis = 0 hands the owner).  With `peers` = 1:
//   out[lane][dst][src][rank]  int32, rank < capacity: the row of block
//                              src that is the rank-th of that block's
//                              rows bound for dst;
// with peers = P > 1 (the cluster-wide exchange, L = n_shards / P
// shards a process, shard dst = peer * L + d):
//   out[peer][lane][d][src][rank], so that each peer's slice is one
//                              contiguous run, ready for all_to_all;
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
// and 8 B an output position out, about 26 MB for 2^20 rows at the
// phase-11 capacity (a bucket about half full), 7.8 us at 3.35 TB/s;
// the scan's path adds the position lane, 12 B an output position.
//
// Design: one launch, one pass over the rows, no atomics on placement,
// so the output is deterministic and stable.  The work is a list of
// items: one a chunk of kChunk = 4096 rows of one source block (the row
// items), then one a span of kPadSpan positions of one bucket (the
// padding items).  The grid is the card's resident blocks (at most one
// an item) of 512 threads, and each block takes items by ticket until
// none is left:
//   (a) a ticket comes from an atomic counter in the workspace header;
//       tickets below n_blocks * chunks are row work, chunk c of source
//       block b for ticket c * n_blocks + b, so a chunk's predecessors
//       in its block always hold smaller tickets: a running block holds
//       them or has finished them, and the look-back below cannot
//       deadlock however many chunks there are;
//   (b) a row item loads its rows once, each lane 8 rows of its warp's
//       256-row run (coalesced, one row a lane a load), into registers,
//       every load issued before the first is used, and ranks them:
//       __match_any_sync groups a warp's equal shards, and a
//       [warp][shard] table in shared memory carries each warp's
//       running count, so a row's rank in its chunk is (the chunk's
//       earlier warps' rows of its shard) + (its warp's earlier rows of
//       its shard); no block barrier inside the loop;
//   (c) publishes the chunk's per-shard counts at once: status A, or P
//       (an inclusive prefix) for chunk 0;
//   (d) looks back over the earlier chunks of its block, a warp a shard
//       (the block's 16 warps over at most 64 shards), its 32 lanes on
//       32 earlier chunks' words at once: sum the A counts down to the
//       first P, publish its own P, and, in the last chunk of a block,
//       write the block's counts and dropped; the warps without a shard
//       to look back for sort their rows (e) meanwhile;
//   (e) ranks its rows by shard in shared memory (a block-local counting
//       sort: shard offsets in the chunk + warp offset + rank), then
//       writes each bucket's run with consecutive threads on consecutive
//       output positions; positions at or past the capacity are not
//       written (those rows drop, in order).
// A padding item fills positions [count, capacity) of its span of one
// bucket: one thread waits for the last chunk's P of that (block,
// shard), the block's total, and then the block writes pad0 / pos_pad /
// 0.  It waits only on row items, whose tickets are all smaller, so
// every one of them is held by a running block or finished: a padding
// item cannot keep a row item from an SM.  And the blocks that finish
// their rows first take the padding items as soon as the last row item
// is claimed, so the padding, which must wait for the counts, runs on
// the whole card as the rows end.  A call is one launch
// (passes_per_call 1), with no memset.
//
// Memory ordering.  A status word is 64 bits: the call's tag in the
// upper 32 bits, bit 31 set for P, and the count in the lower 31 (a
// block's total can reach n, up to 2^31 - 1, more than 30 bits hold).
// Counts travel inside the word, so the word is its own payload;
// st.release / ld.acquire order it all the same.  The tag is the call's
// sequence number, kept in the workspace header: each block reads it
// after taking its ticket, and the block that finishes last resets the
// ticket counter and bumps it (skipping tags whose low 32 bits are 0,
// which a zeroed word would match).  A word of an earlier call is
// never read as current, with no memset between calls, back to back on
// one stream or replayed in a CUDA graph.  The workspace is zeroed once,
// when it is allocated.
//
// The host wrapper (ops/bucket_kernel.py) checks every argument,
// allocates the outputs, keeps the workspace (sized by
// bw_shard_bucket_workspace) with the device, passes PyTorch's current
// stream, and raises on a non-zero return, which is the launch's
// cudaError_t.  Nothing is allocated here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;                    // rows a lane of a chunk
constexpr int kWarpRows = 32 * kRows;       // a warp's run of rows
constexpr int kChunk = kThreads * kRows;    // 4096 rows
// Two blocks an SM (64 registers a thread): 264 blocks hold a 2^20-row
// call's 256 chunks in one wave.
constexpr int kMinBlocks = 2;
constexpr int kPadSpan = 4096;              // positions a padding item fills
constexpr int kMaxShards = 64;
constexpr int kMaxLanes = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kP = 1ull << 31;
constexpr unsigned long long kCount = kP - 1;
constexpr long long kHeaderBytes = 128;
constexpr int kMaxSmem = (kMaxLanes + 1) * kChunk * 4 + kChunk;
enum { DECODE = 1, POS = 2 };

struct Header {
  unsigned int next;         // tickets taken in this call
  unsigned int done;         // blocks finished in this call
  unsigned long long calls;  // calls finished; this call's tag is calls + 1
};

struct Args {
  const int32_t* lane[kMaxLanes];
  long long block_stride;
  long long row_stride;
  const int32_t* shard_ids;
  const uint8_t* valid;
  long long n;  // rows a block
  int n_shards;
  int n_blocks;
  int n_out;  // output lanes: n_lanes, plus one with POS
  int flags;
  int peers;
  long long capacity;
  long long lane_stride;  // out elements between output lanes
  int pad0;               // lane 0's padding (pad0 with DECODE, else 0)
  int pos_pad;
  long long pos_base;
  int32_t* out;
  int32_t* counts;
  int32_t* dropped;
  Header* hdr;
  unsigned long long* status;  // [n_blocks][chunks][n_shards]
  unsigned int chunks;         // chunks a block
  unsigned int row_blocks;     // row work items: n_blocks * chunks
  unsigned int pad_pieces;     // padding items a bucket
  unsigned int items;          // row and padding items
};

__device__ __forceinline__ unsigned lanes_below() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ unsigned long long word_of(unsigned tag, unsigned long long state,
                                                      long long count) {
  return (static_cast<unsigned long long>(tag) << 32) | state |
         static_cast<unsigned long long>(count);
}

// A status word of this call (an A or a P; a P only with `need_p`).
__device__ __forceinline__ unsigned long long wait_word(const unsigned long long* p, unsigned tag,
                                                        bool need_p) {
  for (int spins = 0;; ++spins) {
    const unsigned long long w = ld_acquire(p);
    if (static_cast<unsigned>(w >> 32) == tag && (!need_p || (w & kP))) return w;
    if (spins > 4) __nanosleep(64);
  }
}

// Where bucket (shard s, source block b) starts in out, lane 0.
__device__ __forceinline__ long long bucket_base(const Args& a, int s, int b) {
  const int local = a.n_shards / a.peers;
  const int peer = s / local;
  const int d = s - peer * local;
  return ((static_cast<long long>(peer) * a.n_out * local + d) * a.n_blocks + b) * a.capacity;
}

struct Shared {
  int wc[kWarps][kMaxShards];  // per warp: running count, then its offset
  int tot[kMaxShards];         // the chunk's rows per shard
  int coff[kMaxShards];        // the shard's first position in the chunk's sorted rows
  long long pre[kMaxShards];   // the chunk's exclusive prefix per shard
  long long base[kMaxShards];  // where the shard's run of this chunk starts in out
  long long over[kMaxShards];
  int placed;                  // rows of the chunk that go to a bucket
  unsigned ticket;
  unsigned tag;
  long long pad_count;
};

// A warp's rows into the chunk's sorted rows in shared memory: shard
// offset in the chunk + the warp's offset in the shard + the row's rank
// in its warp's run.
template <int NL>
__device__ __forceinline__ void place_rows(const Args& a, const Shared& sm, int* sorted,
                                           unsigned char* sorted_shard, const int (&sh)[kRows],
                                           const int (&rk)[kRows], const int (&v)[kRows][NL]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int s = sh[r];
    if (s < 0) continue;
    const int pos = sm.coff[s] + sm.wc[warp][s] + rk[r];
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      sorted[k * kChunk + pos] = (k == 0 && (a.flags & DECODE)) ? v[r][0] / a.n_shards : v[r][k];
    }
    if (a.flags & POS) sorted[NL * kChunk + pos] = warp * kWarpRows + r * 32 + lane;
    sorted_shard[pos] = static_cast<unsigned char>(s);
  }
}

template <int NL>
__device__ void row_chunk(const Args& a, Shared& sm, int* sorted, unsigned char* sorted_shard,
                          unsigned t, unsigned tag) {
  const int S = a.n_shards;
  const int b = static_cast<int>(t % static_cast<unsigned>(a.n_blocks));
  const unsigned c = t / static_cast<unsigned>(a.n_blocks);
  const long long i0 = static_cast<long long>(c) * kChunk;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  unsigned long long* status = a.status + (static_cast<long long>(b) * a.chunks) * S;

  for (int k = threadIdx.x; k < kWarps * kMaxShards; k += kThreads) {
    sm.wc[k / kMaxShards][k % kMaxShards] = 0;
  }
  __syncthreads();

  // (b) The rows, once, into registers: every load of the thread's
  // rows issued before the first is used, then their ranks in the
  // warp's run.
  int sh[kRows];
  int rk[kRows];
  int v[kRows][NL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = i0 + warp * kWarpRows + r * 32 + lane;
    sh[r] = -1;
#pragma unroll
    for (int k = 0; k < NL; ++k) v[r][k] = 0;
    if (i < a.n) {
      const long long at = static_cast<long long>(b) * a.block_stride + i;
      const long long src = static_cast<long long>(b) * a.block_stride + i * a.row_stride;
      sh[r] = a.valid == nullptr ? 1 : static_cast<int>(__ldg(a.valid + at));  // the valid flag
      if (a.shard_ids != nullptr) rk[r] = __ldg(a.shard_ids + at);  // the given shard
#pragma unroll
      for (int k = 0; k < NL; ++k) v[r][k] = __ldg(a.lane[k] + src);
    }
  }
  const unsigned below = lanes_below();
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const long long i = i0 + warp * kWarpRows + r * 32 + lane;
    int s = -1;
    if (i < a.n && sh[r] != 0) {
      s = a.shard_ids != nullptr ? rk[r] : v[r][0] % S;
      if (s < 0 || s >= S) s = -1;
    }
    const unsigned group = __match_any_sync(kFull, s);
    const int run = s >= 0 ? sm.wc[warp][s] : 0;
    __syncwarp();
    if (s >= 0 && (group & below) == 0) sm.wc[warp][s] = run + __popc(group);
    __syncwarp();
    sh[r] = s;
    rk[r] = run + __popc(group & below);
  }
  __syncthreads();

  // (c) The warps' offsets in each shard and the chunk's counts,
  // published at once.
  if (threadIdx.x < S) {
    const int s = threadIdx.x;
    int acc = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int x = sm.wc[w][s];
      sm.wc[w][s] = acc;
      acc += x;
    }
    sm.tot[s] = acc;
    st_release(status + static_cast<long long>(c) * S + s, word_of(tag, c == 0 ? kP : 0, acc));
  }
  __syncthreads();

  // The shards' offsets in the chunk's sorted rows (warp 0, shuffles).
  if (warp == 0) {
    const int x0 = lane < S ? sm.tot[lane] : 0;
    const int x1 = lane + 32 < S ? sm.tot[lane + 32] : 0;
    int s0 = x0;
    int s1 = x1;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u0 = __shfl_up_sync(kFull, s0, d);
      const int u1 = __shfl_up_sync(kFull, s1, d);
      if (lane >= d) s0 += u0, s1 += u1;
    }
    const int total0 = __shfl_sync(kFull, s0, 31);
    sm.coff[lane] = s0 - x0;
    sm.coff[lane + 32] = total0 + s1 - x1;
    if (lane == 31) sm.placed = total0 + s1;
  }
  __syncthreads();

  // (e), first half: the block-local counting sort into shared memory.
  // A warp with a look-back to walk sorts its rows after it, so that its
  // P, which later chunks wait on, is published first.
  if (warp >= S) place_rows<NL>(a, sm, sorted, sorted_shard, sh, rk, v);

  // (d) The look-back, a warp a shard (warp w takes shards w, w + 16,
  // ...): lane j reads the word of chunk top - j, 32 earlier chunks at
  // once, and the walk ends at the first P.  Then the chunk's P, and the
  // block's counts in its last chunk.
  for (int s = warp; s < S; s += kWarps) {
    long long excl = 0;
    if (c > 0) {
      for (long long top = static_cast<long long>(c) - 1;; top -= 32) {
        const long long k = top - lane;
        unsigned long long w = kP;  // before chunk 0: as if a P of 0
        unsigned stops;
        unsigned need;
        for (int spins = 0;; ++spins) {
          bool ready = true;
          if (k >= 0) {
            w = ld_acquire(status + k * S + s);
            ready = static_cast<unsigned>(w >> 32) == tag;
          }
          stops = __ballot_sync(kFull, ready && (w & kP));
          const unsigned waiting = __ballot_sync(kFull, !ready);
          // Lanes up to the first P (every lane if there is none).
          need = stops ? ((stops & (0u - stops)) << 1) - 1u : kFull;
          if (!(waiting & need)) break;
          if (spins > 4) __nanosleep(64);
        }
        long long x = ((need >> lane) & 1u) ? static_cast<long long>(w & kCount) : 0;
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(kFull, x, d);
        excl += x;
        if (stops) break;
      }
      if (lane == 0) {
        st_release(status + static_cast<long long>(c) * S + s, word_of(tag, kP, excl + sm.tot[s]));
      }
    }
    if (lane == 0) {
      sm.pre[s] = excl;
      sm.base[s] = bucket_base(a, s, b);
      if (c == a.chunks - 1) {
        const long long incl = excl + sm.tot[s];
        a.counts[static_cast<long long>(b) * S + s] =
            static_cast<int32_t>(incl < a.capacity ? incl : a.capacity);
        sm.over[s] = incl > a.capacity ? incl - a.capacity : 0;
      }
    }
  }
  if (warp < S) place_rows<NL>(a, sm, sorted, sorted_shard, sh, rk, v);
  __syncthreads();
  if (c == a.chunks - 1 && threadIdx.x == 0) {
    long long total = 0;
    for (int s = 0; s < S; ++s) total += sm.over[s];
    a.dropped[b] = static_cast<int32_t>(total);
  }

  // (e), second half: each bucket's run, consecutive threads on
  // consecutive positions.
  const long long row_pos = a.pos_base + static_cast<long long>(b) * a.n + i0;
  for (int j = threadIdx.x; j < sm.placed; j += kThreads) {
    const int s = sorted_shard[j];
    const long long rank = sm.pre[s] + (j - sm.coff[s]);
    if (rank >= a.capacity) continue;
    int32_t* o = a.out + sm.base[s] + rank;
#pragma unroll
    for (int k = 0; k < NL; ++k) o[k * a.lane_stride] = sorted[k * kChunk + j];
    if (a.flags & POS) {
      o[NL * a.lane_stride] = static_cast<int32_t>(row_pos + sorted[NL * kChunk + j]);
    }
  }
}

// One padding block: positions [count, capacity) of its span of one
// bucket.
__device__ void pad_span(const Args& a, Shared& sm, unsigned p, unsigned tag) {
  const int S = a.n_shards;
  const unsigned piece = p % a.pad_pieces;
  const unsigned bucket = p / a.pad_pieces;
  const int s = static_cast<int>(bucket % static_cast<unsigned>(S));
  const int b = static_cast<int>(bucket / static_cast<unsigned>(S));
  if (threadIdx.x == 0) {
    long long total = 0;
    if (a.chunks > 0) {
      const unsigned long long* last =
          a.status + (static_cast<long long>(b) * a.chunks + (a.chunks - 1)) * S + s;
      total = static_cast<long long>(wait_word(last, tag, true) & kCount);
    } else if (piece == 0) {
      // No rows: no row block writes the counts.
      a.counts[static_cast<long long>(b) * S + s] = 0;
      if (s == 0) a.dropped[b] = 0;
    }
    sm.pad_count = total < a.capacity ? total : a.capacity;
    sm.base[0] = bucket_base(a, s, b);
  }
  __syncthreads();
  long long lo = static_cast<long long>(piece) * kPadSpan;
  long long hi = lo + kPadSpan;
  if (lo < sm.pad_count) lo = sm.pad_count;
  if (hi > a.capacity) hi = a.capacity;
  int32_t* o = a.out + sm.base[0];
  const int pos_lane = (a.flags & POS) ? a.n_out - 1 : -1;
  for (long long r = lo + threadIdx.x; r < hi; r += kThreads) {
    for (int k = 0; k < a.n_out; ++k) {
      o[k * a.lane_stride + r] = k == 0 ? a.pad0 : (k == pos_lane ? a.pos_pad : 0);
    }
  }
}

template <int NL>
__global__ void __launch_bounds__(kThreads, kMinBlocks) bucket_onepass(Args a) {
  __shared__ Shared sm;
  extern __shared__ int sorted[];  // [n_out][kChunk] int32, then [kChunk] shard bytes
  if (threadIdx.x == 0) sm.tag = static_cast<unsigned>(__ldcg(&a.hdr->calls) + 1);
  // Tickets until none is left: row work first, then padding, so a block
  // that is done with its rows pads as soon as the rows are claimed.
  for (;;) {
    if (threadIdx.x == 0) sm.ticket = atomicAdd(&a.hdr->next, 1u);
    __syncthreads();
    const unsigned t = sm.ticket;
    const unsigned tag = sm.tag;
    if (t >= a.items) break;
    if (t < a.row_blocks) {
      row_chunk<NL>(a, sm, sorted, reinterpret_cast<unsigned char*>(sorted + a.n_out * kChunk), t, tag);
    } else {
      pad_span(a, sm, t - a.row_blocks, tag);
    }
    __syncthreads();
  }
  // The block that finishes last closes the call: every block has read
  // the tag and taken its last ticket by then.
  if (threadIdx.x == 0 && atomicAdd(&a.hdr->done, 1u) == gridDim.x - 1) {
    const unsigned long long calls = __ldcg(&a.hdr->calls) + 1;
    a.hdr->next = 0;
    a.hdr->done = 0;
    a.hdr->calls = calls + (static_cast<unsigned>(calls + 1) == 0u ? 1 : 0);
  }
}

// Launch instance NL on `grid` blocks (the card's resident blocks, at
// most one a work item), raising the shared-memory limit once.
template <int NL>
cudaError_t launch(const Args& a, size_t smem, long long items, int device, cudaStream_t st) {
  static int resident[64][2] = {};  // [device][with the position lane]
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  const int pos = smem > static_cast<size_t>(NL) * kChunk * 4 + kChunk;
  cudaError_t err = cudaSuccess;
  if (resident[device][pos] == 0) {
    err = cudaFuncSetAttribute(bucket_onepass<NL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kMaxSmem));
    int per_sm = 0;
    int sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, bucket_onepass<NL>, kThreads, smem);
    }
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    resident[device][pos] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const long long grid = items < resident[device][pos] ? items : resident[device][pos];
  bucket_onepass<NL><<<static_cast<unsigned>(grid), kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

long long chunks_of(long long n) { return (n + kChunk - 1) / kChunk; }

}  // namespace

extern "C" {

// Bytes of device workspace a call over n_blocks blocks of n rows and
// n_shards shards needs.  It must be zeroed once, when it is allocated,
// and may then serve any number of calls up to that size, issued in
// order on one stream.
long long bw_shard_bucket_workspace(int n_blocks, long long n, int n_shards) {
  if (n_blocks < 1 || n < 0 || n_shards < 1) return -1;
  return kHeaderBytes + static_cast<long long>(n_blocks) * chunks_of(n) * n_shards * 8;
}

// Bucket n_blocks source blocks of n rows each into n_shards buckets of
// `capacity` rows per (source, destination), `peers` destinations'
// slices apart (see the header for the layouts), on `stream` of CUDA
// device `device` (the calling thread's current device is left as it
// was).  Returns the launch's cudaError_t (0 on success).
int bw_shard_bucket(const void* lane0, const void* lane1, const void* lane2, const void* lane3,
                    int n_lanes, long long block_stride, long long row_stride,
                    const void* shard_ids, const void* valid, int n_blocks, long long n,
                    int n_shards, long long capacity, int flags, int pad0, long long pos_base,
                    int pos_pad, int peers, void* out, void* counts, void* dropped,
                    void* workspace, void* stream, int device) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n_blocks < 1 || n_blocks > 65535 || n < 0 ||
      n > 0x7fffffffLL || n_shards < 1 || n_shards > kMaxShards || capacity < 0 ||
      (flags & ~(DECODE | POS)) != 0 || peers < 1 || n_shards % peers != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  const void* lanes[kMaxLanes] = {lane0, lane1, lane2, lane3};
  for (int k = 0; k < kMaxLanes; ++k) a.lane[k] = static_cast<const int32_t*>(lanes[k]);
  a.block_stride = block_stride;
  a.row_stride = row_stride;
  a.shard_ids = static_cast<const int32_t*>(shard_ids);
  a.valid = static_cast<const uint8_t*>(valid);
  a.n = n;
  a.n_shards = n_shards;
  a.n_blocks = n_blocks;
  a.n_out = n_lanes + ((flags & POS) ? 1 : 0);
  a.flags = flags;
  a.peers = peers;
  a.capacity = capacity;
  a.lane_stride = static_cast<long long>(n_shards / peers) * n_blocks * capacity;
  a.pad0 = (flags & DECODE) ? pad0 : 0;
  a.pos_pad = pos_pad;
  a.pos_base = pos_base;
  a.out = static_cast<int32_t*>(out);
  a.counts = static_cast<int32_t*>(counts);
  a.dropped = static_cast<int32_t*>(dropped);
  a.hdr = static_cast<Header*>(workspace);
  a.status = reinterpret_cast<unsigned long long*>(static_cast<char*>(workspace) + kHeaderBytes);
  const long long chunks = chunks_of(n);
  const long long pieces = capacity > 0 ? (capacity + kPadSpan - 1) / kPadSpan : 1;
  const long long row_blocks = chunks * n_blocks;
  const long long items = row_blocks + pieces * n_blocks * n_shards;
  // The ticket counter runs past the items by one a block: keep it in 32 bits.
  if (items >= 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  a.chunks = static_cast<unsigned>(chunks);
  a.row_blocks = static_cast<unsigned>(row_blocks);
  a.pad_pieces = static_cast<unsigned>(pieces);
  a.items = static_cast<unsigned>(items);
  const size_t smem = static_cast<size_t>(a.n_out) * kChunk * 4 + kChunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (current != device && (err = cudaSetDevice(device)) != cudaSuccess) return static_cast<int>(err);
  switch (n_lanes) {
    case 1: err = launch<1>(a, smem, items, device, st); break;
    case 2: err = launch<2>(a, smem, items, device, st); break;
    case 3: err = launch<3>(a, smem, items, device, st); break;
    default: err = launch<4>(a, smem, items, device, st); break;
  }
  if (current != device) cudaSetDevice(current);
  return static_cast<int>(err);
}

}  // extern "C"
