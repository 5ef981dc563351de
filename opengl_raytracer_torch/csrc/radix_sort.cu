// G10: the integrator's ray sort, for Hopper: a stable LSD radix sort of
// int32 keys that hands back the sorted keys and an int32 permutation.
//
// Replaces the sorts of the JAX integrator's reorder
// (opengl_raytracer_tpu/ops/integrator.py:209-268: XLA sorts, not Pallas
// kernels), which the port ran as the library's torch.sort(keys,
// stable=True): an int64 arange as the payload, an int64 permutation out.
// The pair is that sort's bit for bit (the permutation as int32): a
// stable sort's permutation is fixed by the keys alone.  Keys are ordered
// as signed int32, which is the order of the key with its sign bit
// flipped read as uint32 (u = key ^ 0x80000000), so each pass takes its
// digit from u.
//
// The design is onesweep (Adinets and Merrill, "Onesweep: A Faster Least
// Significant Digit Radix Sort for GPUs", 2022), 1 + passes launches:
//
//   * radix_sort_histogram_kernel reads the keys once and counts the
//     first digit in shared memory.  Each thread counts runs of equal
//     digits in 16 consecutive keys and adds a run with one atomic: the
//     integrator's keys are computed in the order of the last sort, so
//     their digits often come in runs.  A block writes its counts out
//     whole (no atomics in device memory, so nothing needs zeroing
//     first).  It also zeroes the look-back words, group sums, digit
//     counts and tile tickets of the passes that follow, so a sort needs
//     no memset and no host sync, and lives in the renderer's CUDA graph
//     as its kernels.
//   * radix_sort_pass_kernel, once a digit.  A block takes its tile by an
//     atomic ticket, so every tile it may wait on is already running.  It
//     ranks its keys by digit with __match_any_sync, one warp's keys in
//     their order (stable), publishes its per-digit counts, looks back
//     over the tiles before it for their inclusive prefixes (decoupled
//     look-back: a tile's word carries its count or its prefix and a
//     flag, in one 32-bit store; 16 words read at once), and scatters
//     through shared memory, so each digit's run of the tile leaves in
//     coalesced stores.  The look-back has two levels (look_back): tiles
//     that start together publish their counts together, and a walk
//     tile by tile would cross hundreds of them; sums of 16 tiles let it
//     cross 16 a word.  While a block holds its keys it also counts the
//     next pass's digits into device memory, so only the first digit
//     needs the histogram launch.  Tile 0 scans the digits' counts into
//     their global starts and publishes them inside its prefix, so they
//     reach every tile through the look-back.  The first pass makes each
//     value from its key's position (no arange, no value read); the
//     buffers alternate so that the last pass writes the caller's
//     outputs.
//
// What bounds it on the card: latency, not bytes.  The least a sort can
// move is 12 bytes a key (read the key, write the sorted key and its
// index); an LSD sort of 8-bit digits moves 64 (4 for the histogram's
// read, then per pass a key and a value read and written; the first pass
// reads no value).  At the integrator's 2,073,600 keys that is 132.7 MB,
// 39.6 us at 3.35 TB/s, and most of it stays in the 50 MB L2.  A pass
// takes about three times its bytes' time (on an H100 ~30 us for 33 MB,
// as fast after L2 is flushed): the look-back chain across tiles, the
// ranks and staging in shared memory, tile 0's sum of the histogram
// blocks, and five launches.  The tile size is chosen
// from n by the wrapper (ops/radix_sort.py), so that every SM has tiles
// in flight both at a frame's keys and at a quarter of them.  Three
// passes of 11-bit digits (48 bytes a key) were timed against the four
// 8-bit ones and lost by 4-5x at both sizes: their 2,048-bin ranks and
// look-back cost more than the pass they save (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kBits = 8;  // a pass's digit
constexpr int kDigits = 1 << kBits;
constexpr int kPasses = 32 / kBits;
constexpr int kBlock = 256;  // a pass block's threads, one a digit
constexpr int kWarps = kBlock / 32;
constexpr int kHistBlock = 512;  // a histogram block's threads
constexpr int kRun = 16;  // consecutive keys a histogram thread counts
constexpr long long kHistKeys = 8192;  // keys a histogram block, and at
constexpr int kMaxHistBlocks = 128;    // most this many blocks
constexpr int kWindow = 16;  // tiles (or groups) a look-back step reads
constexpr int kGroup = 16;   // tiles a group of the look-back's second level
constexpr int kArrivalShift = 17;  // a group sum's arrivals, above its sum
constexpr long long kMaxKeys = (1 << 30) - (1 << 16);  // counts < 2^30
constexpr uint32_t kAggregate = 1u << 30;  // a tile's own count
constexpr uint32_t kPrefix = 2u << 30;     // its inclusive prefix
constexpr uint32_t kValue = kAggregate - 1;
constexpr uint32_t kSign = 0x80000000u;
static_assert(kDigits == kBlock, "a pass thread owns one digit");

// A pass block's shared memory, in 32-bit words: the staging tile, each
// digit's global start less its tile offset, the tile's counts of the
// next pass's digits, the warps' digit counts (16 bits each), the block
// scan's warp sums and the tile number.
template <int kItems>
struct PassSmem {
    static constexpr int kTile = kBlock * kItems;
    static constexpr int kBase = kTile;
    static constexpr int kNext = kBase + kDigits;
    static constexpr int kCounts = kNext + kDigits;
    static constexpr int kSums = kCounts + kWarps * kDigits / 2;
    static constexpr int kTileNo = kSums + kWarps;
    static constexpr int kBytes = (kTileNo + 1) * 4;
    static_assert(kTile < 65536, "a warp's digit counts are 16 bits");
    static_assert(kTile * kGroup < (1 << kArrivalShift), "a group's sum");
    static_assert(kBytes <= 48 * 1024, "no opt-in shared memory");
};

__device__ __forceinline__ int digit_of(uint32_t u, int shift) {
    return (int)((u >> shift) & (kDigits - 1));
}

// The look-back words are read and written at device scope, past L1.
__device__ __forceinline__ uint32_t load_relaxed(const uint32_t* p) {
    uint32_t v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
                 : "=r"(v) : "l"(p) : "memory");
    return v;
}

__device__ __forceinline__ void store_relaxed(uint32_t* p, uint32_t v) {
    asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
                 :: "l"(p), "r"(v) : "memory");
}

// The exclusive sum of x over the block's threads in thread order; sums
// (kWarps words of shared memory) is free again when it returns.
__device__ __forceinline__ uint32_t block_exclusive_sum(uint32_t x,
                                                        uint32_t* sums) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    uint32_t inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += y;
    }
    if (lane == 31) sums[warp] = inc;
    __syncthreads();
    if (warp == 0) {
        const uint32_t s = lane < kWarps ? sums[lane] : 0;
        uint32_t t = s;
#pragma unroll
        for (int o = 1; o < kWarps; o <<= 1) {
            const uint32_t y = __shfl_up_sync(0xffffffffu, t, o);
            if (lane >= o) t += y;
        }
        if (lane < kWarps) sums[lane] = t - s;
    }
    __syncthreads();
    const uint32_t r = sums[warp] + inc - x;
    __syncthreads();
    return r;
}

// Walks a digit's look-back words back from tile t0 (words kDigits
// apart), kWindow at a time, down to tile lo: the aggregates read are
// added to sum; returns whether it met an inclusive prefix (added too).
// A tile not yet published is read again, with the window from there.
__device__ __forceinline__ bool walk_tiles(const uint32_t* col, int t0, int lo,
                                           uint32_t& sum) {
    for (int t = t0; t >= lo;) {
        uint32_t s[kWindow];
#pragma unroll
        for (int w = 0; w < kWindow; ++w)
            s[w] = t - w >= lo
                ? load_relaxed(col + (long long)(t - w) * kDigits) : 0u;
        int used = 0;
        bool done = false;
#pragma unroll
        for (int w = 0; w < kWindow; ++w) {
            if (!done && used == w && t - w >= lo && s[w] != 0) {
                sum += s[w] & kValue;
                used = w + 1;
                done = (s[w] & kPrefix) != 0;
            }
        }
        if (done) return true;
        if (used == 0) __nanosleep(32);  // tile t is not published yet
        t -= used;
    }
    return false;
}

// The sum of a digit's counts over the tiles before ``tile`` (col: the
// digit's look-back word of tile 0, group: its group sum of group 0), up
// to the first inclusive prefix.  Tiles come in groups of kGroup: the
// walk reads the tiles of its own group, then, for each whole group
// before it, the last tile's word (a prefix ends the walk) or else the
// group's sum once all its tiles have added theirs, kWindow groups at
// once; group 0 it walks tile by tile, down to tile 0's prefix at the
// latest.  So a tile far from any prefix reads a word a group, not a
// word a tile: tiles that start together publish their aggregates
// together, and the prefixes then spread from tile 0 a window at a time.
__device__ __forceinline__ uint32_t look_back(const uint32_t* col,
                                              const uint32_t* group,
                                              int tile) {
    uint32_t sum = 0;
    const int g = tile / kGroup;
    if (walk_tiles(col, tile - 1, g * kGroup, sum)) return sum;
    for (int gg = g - 1; gg >= 1;) {
        uint32_t last[kWindow], gsum[kWindow];
#pragma unroll
        for (int w = 0; w < kWindow; ++w) {
            const bool in = gg - w >= 1;
            last[w] = in ? load_relaxed(
                col + ((long long)(gg - w) * kGroup + kGroup - 1) * kDigits) : 0u;
            gsum[w] = in ? load_relaxed(group + (long long)(gg - w) * kDigits)
                         : 0u;
        }
        int used = 0;
        bool done = false;
#pragma unroll
        for (int w = 0; w < kWindow; ++w) {
            if (!done && used == w && gg - w >= 1) {
                if (last[w] & kPrefix) {
                    sum += last[w] & kValue;
                    used = w + 1;
                    done = true;
                } else if ((gsum[w] >> kArrivalShift) == kGroup) {
                    sum += gsum[w] & ((1u << kArrivalShift) - 1);
                    used = w + 1;
                }
            }
        }
        if (done) return sum;
        if (used == 0) __nanosleep(32);  // group gg is not complete yet
        gg -= used;
    }
    walk_tiles(col, min(kGroup, tile) - 1, 0, sum);
    return sum;
}

// The first pass's digit counts: block b counts its runs of kRun keys
// into part[b][digit] (later passes' counts are made by the pass before
// them); all blocks together zero clear[0, n_clear).
__global__ void __launch_bounds__(kHistBlock)
radix_sort_histogram_kernel(const int* __restrict__ keys, int n,
                            uint32_t* __restrict__ part,
                            uint32_t* __restrict__ clear, int n_clear) {
    __shared__ uint32_t hist[kDigits];
    for (int i = threadIdx.x; i < kDigits; i += kHistBlock) hist[i] = 0;
    for (int i = blockIdx.x * kHistBlock + threadIdx.x; i < n_clear;
         i += gridDim.x * kHistBlock)
        clear[i] = 0;
    __syncthreads();
    const bool vec = ((uintptr_t)keys & 15) == 0;
    const int runs = (n + kRun - 1) / kRun;
    for (int r = blockIdx.x * kHistBlock + threadIdx.x; r < runs;
         r += gridDim.x * kHistBlock) {
        const int first = r * kRun;
        const int m = min(kRun, n - first);
        uint32_t u[kRun];
        if (vec && m == kRun) {
            const int4* p = reinterpret_cast<const int4*>(keys + first);
#pragma unroll
            for (int q = 0; q < kRun / 4; ++q) {
                const int4 v = p[q];
                u[4 * q] = (uint32_t)v.x ^ kSign;
                u[4 * q + 1] = (uint32_t)v.y ^ kSign;
                u[4 * q + 2] = (uint32_t)v.z ^ kSign;
                u[4 * q + 3] = (uint32_t)v.w ^ kSign;
            }
        } else {
#pragma unroll
            for (int e = 0; e < kRun; ++e)
                u[e] = e < m ? (uint32_t)keys[first + e] ^ kSign : 0u;
        }
        int cur = digit_of(u[0], 0);
        uint32_t cnt = 1;
#pragma unroll
        for (int e = 1; e < kRun; ++e) {
            if (e < m) {
                const int d = digit_of(u[e], 0);
                if (d == cur) {
                    ++cnt;
                } else {
                    atomicAdd(hist + cur, cnt);
                    cur = d;
                    cnt = 1;
                }
            }
        }
        atomicAdd(hist + cur, cnt);
    }
    __syncthreads();
    uint32_t* out = part + (long long)blockIdx.x * kDigits;
    for (int i = threadIdx.x; i < kDigits; i += kHistBlock) out[i] = hist[i];
}

// One pass over digit ``pass`` (bits pass * kBits up): keys_in/vals_in
// (vals_in unread in the first pass) to keys_out/vals_out, stably by the
// digit.  The digits' counts over all keys come from the histogram
// blocks (part, the first pass) or from the pass before (totals); the
// pass counts the next pass's digits into next (null in the last pass).
// status: this pass's look-back words, [tile][digit]; ticket: its tile
// counter; next: zero at launch, all three.  Thread tid owns digit tid
// wherever the block works by digit.
template <int kItems, bool kFirst>
__global__ void __launch_bounds__(kBlock)
radix_sort_pass_kernel(const int* __restrict__ keys_in,
                       const int* __restrict__ vals_in,
                       int* __restrict__ keys_out, int* __restrict__ vals_out,
                       const uint32_t* __restrict__ part, int hist_blocks,
                       const uint32_t* __restrict__ totals,
                       uint32_t* __restrict__ next, uint32_t* status,
                       uint32_t* groups, uint32_t* ticket, int pass, int n) {
    using S = PassSmem<kItems>;
    extern __shared__ uint32_t smem[];
    uint32_t* stage = smem;
    int* gbase = reinterpret_cast<int*>(smem + S::kBase);
    uint32_t* next_counts = smem + S::kNext;
    uint16_t* counts = reinterpret_cast<uint16_t*>(smem + S::kCounts);
    uint32_t* sums = smem + S::kSums;
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int shift = pass * kBits;

    if (tid == 0) smem[S::kTileNo] = atomicAdd(ticket, 1u);
    for (int i = tid; i < kWarps * kDigits; i += kBlock) counts[i] = 0;
    next_counts[tid] = 0;
    __syncthreads();
    const int tile = (int)smem[S::kTileNo];

    // tile 0: this thread's digit counted over all keys
    uint32_t total = 0;
    if (tile == 0) {
        if (kFirst) {
            for (int b0 = 0; b0 < hist_blocks; b0 += 16) {
#pragma unroll
                for (int b = b0; b < b0 + 16; ++b)
                    total += b < hist_blocks
                        ? part[(long long)b * kDigits + tid] : 0u;
            }
        } else {
            total = totals[tid];
        }
    }

    // Warp w takes 32 * kItems consecutive keys of the tile, item k of
    // lane l at k * 32 + l: coalesced, and in key order item by item.  A
    // key past n reads as all ones: the last digit, ranked after every
    // real key of that digit, and it lands at or past n.
    const int first = tile * S::kTile + warp * 32 * kItems + lane;
    uint32_t u[kItems];
    int v[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int i = first + k * 32;
        const bool ok = i < n;
        u[k] = ok ? (uint32_t)keys_in[i] ^ kSign : 0xFFFFFFFFu;
        v[k] = kFirst ? i : (ok ? vals_in[i] : 0);
    }

    // each key's rank among the warp's keys of its digit before it; and
    // the tile's count of each next digit (real keys only)
    uint16_t* wc = counts + warp * kDigits;
    const uint32_t lanes_below = (1u << lane) - 1;
    int pos[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int d = digit_of(u[k], shift);
        const uint32_t peers = __match_any_sync(0xffffffffu, d);
        const uint32_t below = peers & lanes_below;
        const int before = wc[d];
        pos[k] = before + __popc(below);
        __syncwarp();
        if (below == 0) wc[d] = (uint16_t)(before + __popc(peers));
        __syncwarp();
    }
    if (next != nullptr) {  // a warp of one digit (dead rays) adds once
#pragma unroll
        for (int k = 0; k < kItems; ++k) {
            const bool ok = first + k * 32 < n;
            const int d = digit_of(u[k], shift + kBits);
            const int d0 = __shfl_sync(0xffffffffu, d, 0);
            if (__all_sync(0xffffffffu, ok && d == d0)) {
                if (lane == 0) atomicAdd(next_counts + d0, 32u);
            } else if (ok) {
                atomicAdd(next_counts + d, 1u);
            }
        }
    }
    __syncthreads();

    // this thread's digit: the tile's count, and each warp's count
    // before it
    uint32_t cnt = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
        const uint32_t c = counts[w * kDigits + tid];
        counts[w * kDigits + tid] = (uint16_t)cnt;
        cnt += c;
    }
    uint32_t* mine = status + (long long)tile * kDigits + tid;
    if (tile > 0) {
        store_relaxed(mine, kAggregate | cnt);
        // the group's sum, with one arrival a tile in its high bits (a
        // group holds at most 16 * 4,096 keys, under 2^17)
        atomicAdd(groups + (long long)(tile / kGroup) * kDigits + tid,
                  cnt + (1u << kArrivalShift));
    }
    if (next != nullptr && next_counts[tid] != 0)
        atomicAdd(next + tid, next_counts[tid]);

    // the digit's offset in the tile, and its keys in the tiles before
    // this one, from the digit's global start: tile 0 scans the totals,
    // the others look back
    const uint32_t local = block_exclusive_sum(cnt, sums);
    const uint32_t excl = tile == 0 ? block_exclusive_sum(total, sums)
                                    : look_back(status + tid, groups + tid,
                                                tile);
    store_relaxed(mine, kPrefix | (excl + cnt));
    gbase[tid] = (int)excl - (int)local;
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
        counts[w * kDigits + tid] = (uint16_t)(counts[w * kDigits + tid] + local);
    __syncthreads();

    // keys, then values, through the staging tile in sorted order: thread
    // tid stores tile slots tid, tid + kBlock, ..., so a digit's run
    // leaves in consecutive addresses
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        pos[k] += wc[digit_of(u[k], shift)];
        stage[pos[k]] = u[k];
    }
    __syncthreads();
    int dst[kItems];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
        const int i = k * kBlock + tid;
        const uint32_t x = stage[i];
        dst[k] = gbase[digit_of(x, shift)] + i;
        if (dst[k] < n) keys_out[dst[k]] = (int)(x ^ kSign);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k) stage[pos[k]] = (uint32_t)v[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kItems; ++k)
        if (dst[k] < n) vals_out[dst[k]] = (int)stage[k * kBlock + tid];
}

// The workspace, in 32-bit words: the alternate keys and values (n
// each), the histogram blocks' counts of the first digit, then the region
// the histogram launch zeroes: each pass's look-back words and group
// sums, each later pass's digit counts and each pass's ticket.  ops/radix_sort.py:
// _layout_words computes the same size.
struct Layout {
    long long part, status, groups, totals, tickets, words;
    int hist_blocks, tiles, n_groups;
};

Layout layout(long long n, int items) {
    const long long tile = (long long)kBlock * items;
    Layout L;
    L.tiles = (int)std::max(1LL, (n + tile - 1) / tile);
    L.hist_blocks = (int)std::min(
        std::max(1LL, (n + kHistKeys - 1) / kHistKeys), (long long)kMaxHistBlocks);
    L.n_groups = (L.tiles + kGroup - 1) / kGroup;
    L.part = 2 * n;
    L.status = L.part + (long long)L.hist_blocks * kDigits;
    L.groups = L.status + (long long)kPasses * L.tiles * kDigits;
    L.totals = L.groups + (long long)kPasses * L.n_groups * kDigits;
    L.tickets = L.totals + kPasses * kDigits;
    L.words = L.tickets + kPasses;
    return L;
}

template <int kItems>
void sort_launch(const int* keys, int* keys_out, int* perm_out, uint32_t* ws,
                 const Layout& L, int n, cudaStream_t st) {
    constexpr int kBytes = PassSmem<kItems>::kBytes;
    int* tmp_keys = reinterpret_cast<int*>(ws);
    int* tmp_vals = tmp_keys + n;
    uint32_t* part = ws + L.part;
    uint32_t* status = ws + L.status;
    uint32_t* totals = ws + L.totals;  // [pass][digit], pass 0's unused
    uint32_t* tickets = ws + L.tickets;
    radix_sort_histogram_kernel<<<L.hist_blocks, kHistBlock, 0, st>>>(
        keys, n, part, status, (int)(L.words - L.status));
    const int* keys_in = keys;
    const int* vals_in = nullptr;
    for (int p = 0; p < kPasses; ++p) {
        // the buffers alternate so that the last pass writes the outputs
        const bool to_out = (kPasses - 1 - p) % 2 == 0;
        int* k_out = to_out ? keys_out : tmp_keys;
        int* v_out = to_out ? perm_out : tmp_vals;
        uint32_t* next =
            p + 1 < kPasses ? totals + (long long)(p + 1) * kDigits : nullptr;
        auto kernel = p == 0 ? radix_sort_pass_kernel<kItems, true>
                             : radix_sort_pass_kernel<kItems, false>;
        kernel<<<L.tiles, kBlock, kBytes, st>>>(
            keys_in, vals_in, k_out, v_out, part, L.hist_blocks,
            totals + (long long)p * kDigits, next,
            status + (long long)p * L.tiles * kDigits,
            ws + L.groups + (long long)p * L.n_groups * kDigits, tickets + p,
            p, n);
        keys_in = k_out;
        vals_in = v_out;
    }
}

}  // namespace

// keys: (n,) int32; keys_out, perm_out: (n,) int32; ws: ws_words 32-bit
// words (Layout).  items: 8 or 16 keys a pass thread.  1 + 4 launches on
// the stream; n < 2^30 - 2^16.
extern "C" int oglrt_radix_sort(const int* keys, int* keys_out, int* perm_out,
                                uint32_t* ws, long long ws_words, long long n,
                                int items, void* stream) {
    if (items != 8 && items != 16) return (int)cudaErrorInvalidValue;
    if (n <= 0) return 0;
    const Layout L = layout(n, items);
    if (n > kMaxKeys || ws_words < L.words) return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (items == 8)
        sort_launch<8>(keys, keys_out, perm_out, ws, L, (int)n, st);
    else
        sort_launch<16>(keys, keys_out, perm_out, ws, L, (int)n, st);
    return (int)cudaGetLastError();
}
