// K11 position_events: the position events of Q phrase or span worklists
// (rows), packed into 64-bit keys and radix-sorted per row.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py, the gather-and-sort
// halves of `_eval_phrase` (:486-502: every slot's position entries
// shifted to their phrase-aligned position, then `lax.sort` by (doc,
// apos)) and of `_gather_span_events` (:545-565: every clause term's
// entries, `lax.sort` by (doc, pos, clause)).
//
// Bound on an H100: bytes. Each valid worklist lane reads its doc and
// position (8 B) once and writes its key (8 B) once.
//
// Design: the key packs the whole sort order, so equal keys are equal
// events and the order is unique (the reference's phrase sort is not
// stable, and needs no stability): phrase mode doc << pos_bits | apos,
// span mode (doc << pos_bits | pos) << clause_bits | clause. The gather
// compacts: a tile's valid lanes (inside [start, end), and apos >= 0)
// take consecutive slots at the front of their row, claimed by one
// atomicAdd on the row's count, so the passes sort only the row's
// `count` valid keys, never the worklist's pow-2 padding or the lanes
// outside its spans. Any order of the compacted keys sorts to the same
// bits. The sort is an LSD radix sort on 64-bit keys without values, 8
// bits a pass (ceil(bits / 8) passes: 4 for 8.8M docs and positions
// below 64): histogram -> one parallel scan per (row, digit) over the
// row's blocks, with the digit totals -> scatter kept stable inside a
// block by __match_any_sync ranks, 8 rounds a warp between barriers, and
// a per-digit scan over its warps, each step of 2,048 keys ordered by
// digit in shared memory and written out in runs; blocks past the row's
// count are empty. Last, the row's tail [count, P)
// takes the reference's invalid-lane key, doc = num_docs above every
// valid key, so a row reads as the reference's sorted lanes.
// Rows never mix: a block never straddles two rows and row q's keys land
// in row q's own [q * P, (q + 1) * P) range.
//
// Stacked mode (K11s; under the vmap of `execute_shards` /
// `execute_shards_batch` :1155-1168): the positional planes are S shards'
// equal-shape planes, [S, PT, 256], and row r is the pair (query r / S,
// shard r % S), whose gather reads shard r % S's planes through the shard
// stride; keys stay shard-local. Only the gather changes: the sort never
// looks at the planes. S = 1 is the mode above.
#include "common.cuh"

#define PE_THREADS 256
#define PE_WARPS (PE_THREADS / 32)
// Keys a warp ranks a step (PE_ITEMS rounds of 32) and a block's step.
#define PE_ITEMS 8
#define PE_WARP_KEYS (32 * PE_ITEMS)
#define PE_TILE_KEYS (PE_WARPS * PE_WARP_KEYS)
#define PE_PHRASE 0

__global__ void events_gather_kernel(
    const int32_t* __restrict__ pos_doc,
    const int32_t* __restrict__ pos_val,
    const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends,
    const int32_t* __restrict__ lane_arg,
    int nt, int pos_bits, int clause_bits, int mode,
    int n_shards, int64_t shard_stride, int row0,
    uint64_t* __restrict__ keys,
    int32_t* __restrict__ count) {
    __shared__ int warp_base[ESK_TILE / 32];
    __shared__ int block_base;
    if (n_shards > 1) {
        const int64_t shard = (int64_t)((row0 + (int)blockIdx.y) % n_shards);
        pos_doc += shard * shard_stride;
        pos_val += shard * shard_stride;
    }
    const int64_t e = (int64_t)blockIdx.y * nt + blockIdx.x;
    const int64_t idx = (int64_t)tile_ids[e] * ESK_TILE + threadIdx.x;
    bool valid = idx >= (int64_t)starts[e] && idx < (int64_t)ends[e];
    uint64_t key = 0;
    if (valid) {
        const uint64_t doc = (uint64_t)pos_doc[idx];
        const int32_t pos = pos_val[idx];
        if (mode == PE_PHRASE) {
            const int32_t apos = pos - lane_arg[e];
            valid = apos >= 0;
            key = (doc << pos_bits) | (uint64_t)(valid ? apos : 0);
        } else {
            key = (((doc << pos_bits) | (uint64_t)pos) << clause_bits) |
                  (uint64_t)lane_arg[e];
        }
    }
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const unsigned ballot = __ballot_sync(0xffffffffu, valid);
    if (lane == 0) {
        warp_base[warp] = __popc(ballot);
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int run = 0;
        for (int w = 0; w < ESK_TILE / 32; ++w) {
            const int c = warp_base[w];
            warp_base[w] = run;
            run += c;
        }
        block_base = run ? atomicAdd(&count[blockIdx.y], run) : 0;
    }
    __syncthreads();
    if (valid) {
        const int64_t slot = block_base + warp_base[warp] +
                             __popc(ballot & ((1u << lane) - 1u));
        keys[(int64_t)blockIdx.y * nt * ESK_TILE + slot] = key;
    }
}

// A row's tail [count, P) takes the invalid-lane key.
__global__ void events_fill_kernel(
    uint64_t* __restrict__ keys, int64_t p, uint64_t sentinel,
    const int32_t* __restrict__ count) {
    const int64_t i = (int64_t)blockIdx.x * ESK_TILE + threadIdx.x;
    if (i < p && i >= (int64_t)count[blockIdx.y]) {
        keys[(int64_t)blockIdx.y * p + i] = sentinel;
    }
}

// counts[(row * 256 + digit) * nblocks + block].
__global__ void events_hist_kernel(
    const uint64_t* __restrict__ keys, int64_t p, int chunk, int shift,
    int nblocks, const int32_t* __restrict__ count,
    int32_t* __restrict__ counts) {
    __shared__ int hist[256];
    hist[threadIdx.x] = 0;
    __syncthreads();
    keys += (int64_t)blockIdx.y * p;
    const int64_t n = count[blockIdx.y];
    const int64_t lo = (int64_t)blockIdx.x * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    for (int64_t i = lo + threadIdx.x; i < hi; i += PE_THREADS) {
        atomicAdd(&hist[(int)((keys[i] >> shift) & 255)], 1);
    }
    __syncthreads();
    counts[((int64_t)blockIdx.y * 256 + threadIdx.x) * nblocks + blockIdx.x] =
        hist[threadIdx.x];
}

// Exclusive prefix sum in place over one (row, digit)'s nblocks counts
// (block = (digit, row)), and the digit's total into totals[row * 256 +
// digit].
__global__ void events_scan_kernel(int32_t* __restrict__ counts, int nblocks,
                                   int32_t* __restrict__ totals) {
    __shared__ int sums[PE_THREADS];
    const int64_t rd = (int64_t)blockIdx.y * 256 + blockIdx.x;
    int32_t* data = counts + rd * nblocks;
    const int per = (nblocks + PE_THREADS - 1) / PE_THREADS;
    const int lo = min((int)threadIdx.x * per, nblocks);
    const int hi = min(lo + per, nblocks);
    int s = 0;
    for (int i = lo; i < hi; ++i) {
        s += data[i];
    }
    sums[threadIdx.x] = s;
    __syncthreads();
    for (int off = 1; off < PE_THREADS; off <<= 1) {
        const int v = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
        __syncthreads();
        sums[threadIdx.x] += v;
        __syncthreads();
    }
    int run = threadIdx.x ? sums[threadIdx.x - 1] : 0;
    for (int i = lo; i < hi; ++i) {
        const int c = data[i];
        data[i] = run;
        run += c;
    }
    if (threadIdx.x == PE_THREADS - 1) {
        totals[rd] = sums[PE_THREADS - 1];
    }
}

// One pass's stable scatter. A block takes PE_TILE_KEYS keys a step: warp
// w the contiguous [w * PE_WARP_KEYS, (w + 1) * PE_WARP_KEYS) of them in
// PE_ITEMS rounds of 32, each key ranked among its round's same-digit
// lanes (__match_any_sync) after the warp's earlier rounds (a
// warp-private running count per digit); then one scan per digit over
// the warps, so a key lands after every earlier key of its digit in the
// chunk, in index order. The step is ordered by digit in shared memory
// before it is written. A digit's start in the row is the scan of the
// digit totals (digits below it) plus this block's offset among the
// row's blocks.
__global__ void events_scatter_kernel(
    const uint64_t* __restrict__ keys_in, uint64_t* __restrict__ keys_out,
    int64_t p, int chunk, int shift, int nblocks,
    const int32_t* __restrict__ count,
    const int32_t* __restrict__ offsets,
    const int32_t* __restrict__ totals) {
    __shared__ int base[256];
    __shared__ int wcount[PE_WARPS][256];
    __shared__ int total[256];
    __shared__ int tile_start[256];
    __shared__ int warp_sum[PE_WARPS];
    __shared__ uint64_t stage[PE_TILE_KEYS];
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const unsigned lanes_below = (1u << lane) - 1u;
    const int64_t row_base = (int64_t)blockIdx.y * p;
    keys_in += row_base;
    keys_out += row_base;
    offsets += (int64_t)blockIdx.y * 256 * nblocks;
    // Exclusive scan of the row's digit totals (Hillis-Steele over 256).
    total[tid] = totals[(int64_t)blockIdx.y * 256 + tid];
    __syncthreads();
    for (int off = 1; off < 256; off <<= 1) {
        const int v = tid >= off ? total[tid - off] : 0;
        __syncthreads();
        total[tid] += v;
        __syncthreads();
    }
    base[tid] = (tid ? total[tid - 1] : 0) + offsets[tid * nblocks + blockIdx.x];
    const int64_t n = count[blockIdx.y];
    const int64_t lo = (int64_t)blockIdx.x * chunk;
    const int64_t hi = lo + chunk < n ? lo + chunk : n;
    for (int64_t t = lo; t < hi; t += PE_TILE_KEYS) {
        for (int w = 0; w < PE_WARPS; ++w) {
            wcount[w][tid] = 0;
        }
        __syncthreads();
        uint64_t key[PE_ITEMS];
        int digit[PE_ITEMS];
        int rank[PE_ITEMS];
        // All of the warp's loads first, so that they are in flight together.
#pragma unroll
        for (int r = 0; r < PE_ITEMS; ++r) {
            const int64_t i = t + warp * PE_WARP_KEYS + r * 32 + lane;
            key[r] = i < hi ? keys_in[i] : 0;
            // out-of-range lanes share a digit no key has
            digit[r] = i < hi ? (int)((key[r] >> shift) & 255) : 256;
        }
#pragma unroll
        for (int r = 0; r < PE_ITEMS; ++r) {
            const unsigned peers = __match_any_sync(0xffffffffu, digit[r]);
            const int leader = __ffs(peers) - 1;
            int before = 0;
            if (digit[r] < 256 && lane == leader) {
                before = wcount[warp][digit[r]];
                wcount[warp][digit[r]] = before + __popc(peers);
            }
            rank[r] = __shfl_sync(0xffffffffu, before, leader) +
                      __popc(peers & lanes_below);
            __syncwarp();
        }
        __syncthreads();
        int run = 0;
        for (int w = 0; w < PE_WARPS; ++w) {
            const int c = wcount[w][tid];
            wcount[w][tid] = run;
            run += c;
        }
        // tile_start[d]: the step's keys of the digits below d (a scan of
        // the per-digit counts, by shuffles in a warp, then over warps).
        int v = run;
        for (int o = 1; o < 32; o <<= 1) {
            const int y = __shfl_up_sync(0xffffffffu, v, o);
            if (lane >= o) {
                v += y;
            }
        }
        if (lane == 31) {
            warp_sum[warp] = v;
        }
        __syncthreads();
        int below = 0;
        for (int w = 0; w < warp; ++w) {
            below += warp_sum[w];
        }
        tile_start[tid] = below + v - run;
        __syncthreads();
        // The step's keys in digit order in shared memory, then written
        // out in that order: consecutive threads write consecutive slots
        // of a digit's run instead of 32 scattered ones.
#pragma unroll
        for (int r = 0; r < PE_ITEMS; ++r) {
            if (digit[r] < 256) {
                stage[tile_start[digit[r]] + wcount[warp][digit[r]] + rank[r]] =
                    key[r];
            }
        }
        __syncthreads();
        const int n_step = (int)(hi - t < PE_TILE_KEYS ? hi - t : PE_TILE_KEYS);
        for (int j = tid; j < n_step; j += PE_THREADS) {
            const uint64_t k = stage[j];
            const int d = (int)((k >> shift) & 255);
            keys_out[base[d] + j - tile_start[d]] = k;
        }
        __syncthreads();
        base[tid] += run;
    }
}

// Rows [0, n_rows) of worklists [n_rows, nt]; P = nt * 256 keys a row.
// Stacked: n_shards > 1 planes of shard_stride elements each, and the
// launch's first row is row row0 of the whole batch (its shard row0 % S).
// The copy after an odd number of passes moves whole rows; the fill then
// writes each row's tail.
// keys: the output, n_rows * P; scratch: n_rows * P; counts: n_rows *
// 256 * (ceil(P / chunk) + 1) ints (the [digit][block] counts, then the
// digit totals); count: n_rows ints (valid events a row).
extern "C" int esk_position_events(
    const void* pos_doc,
    const void* pos_val,
    const void* tile_ids,
    const void* starts,
    const void* ends,
    const void* lane_arg,
    int n_rows,
    int nt,
    int num_docs,
    int pos_bits,
    int clause_bits,
    int key_bits,
    int mode,
    int chunk,
    int n_shards,
    long long shard_stride,
    int row0,
    void* keys,
    void* scratch,
    void* counts,
    void* count,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    if (n_rows == 0 || nt == 0) {
        return 0;
    }
    const int64_t p = (int64_t)nt * ESK_TILE;
    cudaMemsetAsync(count, 0, sizeof(int32_t) * n_rows, s);
    ESK_RETURN_IF_ERROR();
    events_gather_kernel<<<dim3(nt, n_rows), ESK_TILE, 0, s>>>(
        (const int32_t*)pos_doc, (const int32_t*)pos_val,
        (const int32_t*)tile_ids, (const int32_t*)starts,
        (const int32_t*)ends, (const int32_t*)lane_arg, nt, pos_bits,
        clause_bits, mode, n_shards, (int64_t)shard_stride, row0,
        (uint64_t*)keys, (int32_t*)count);
    ESK_RETURN_IF_ERROR();
    const int nblocks = (int)((p + chunk - 1) / chunk);
    int32_t* totals = (int32_t*)counts + (int64_t)n_rows * 256 * nblocks;
    uint64_t* src = (uint64_t*)keys;
    uint64_t* dst = (uint64_t*)scratch;
    for (int shift = 0; shift < key_bits; shift += 8) {
        events_hist_kernel<<<dim3(nblocks, n_rows), PE_THREADS, 0, s>>>(
            src, p, chunk, shift, nblocks, (const int32_t*)count,
            (int32_t*)counts);
        ESK_RETURN_IF_ERROR();
        events_scan_kernel<<<dim3(256, n_rows), PE_THREADS, 0, s>>>(
            (int32_t*)counts, nblocks, totals);
        ESK_RETURN_IF_ERROR();
        events_scatter_kernel<<<dim3(nblocks, n_rows), PE_THREADS, 0, s>>>(
            src, dst, p, chunk, shift, nblocks, (const int32_t*)count,
            (const int32_t*)counts, totals);
        ESK_RETURN_IF_ERROR();
        uint64_t* t = src;
        src = dst;
        dst = t;
    }
    if (src != (uint64_t*)keys) {
        cudaMemcpyAsync(keys, src, sizeof(uint64_t) * n_rows * p,
                        cudaMemcpyDeviceToDevice, s);
        ESK_RETURN_IF_ERROR();
    }
    const int low = pos_bits + (mode == PE_PHRASE ? 0 : clause_bits);
    events_fill_kernel<<<dim3(nt, n_rows), ESK_TILE, 0, s>>>(
        (uint64_t*)keys, p, (uint64_t)num_docs << low, (const int32_t*)count);
    ESK_RETURN_IF_ERROR();
    return 0;
}
