// K2 sparse_fold: candidate pairs, stable LSD radix sort by doc, run fold,
// for Q worklists (rows) at once.
//
// Replaces: elasticsearch_tpu/ops/bm25_device.py `_sparse_candidates`
// (:977), the candidate half of `_sparse_terms_inner` (:1019), i.e. the
// worklist gather, the stable `lax.sort` by doc (:993) and the t_pad
// shifted adds that left-fold each doc run — solo, and under the vmap of
// `execute_batch_sparse` (:1050). A solo query is the row count Q = 1.
//
// Bound on an H100: bytes. The pairs (4 B doc + 4 B contrib) are written
// once by the gather, read and written once per radix pass (3 passes for
// 8.8M docs), and read once by the fold; there is no arithmetic to speak
// of beyond one fp32 division per posting.
//
// Design: work and scratch stay proportional to the postings touched
// (P = NT * 256 pairs a row), never to the corpus: no [num_docs] plane is
// made. The sort is a hand-written LSD radix sort, 8 bits a pass over
// ceil(log2(num_docs + 2)) bits. Each pass is histogram -> exclusive
// scan over each row's [digit][block] counts (one block a row, the rows in
// parallel) -> stable scatter. The rows are sorted apart without a single
// extra key bit: a block never straddles two rows, and row q's scan starts
// at q * P, so every row's pairs land in that row's own
// [q * P, (q + 1) * P) range, digit-major inside it. The scatter keeps
// stability inside a block by walking its chunk 256 pairs at a time:
// __match_any_sync ranks a pair among the warp's lanes with the same
// digit, and a per-digit exclusive scan over the 8 warps orders the
// warps. Stability keeps each doc's pairs in worklist
// (query-term) order, so the fold reproduces the oracle's fp32
// accumulation order exactly. The fold never looks past its row.
//
// Stacked mode (K2s; `_shards_inner` :1137 under the vmap of
// `execute_shards_batch` :1161): the tile planes are S shards' planes
// stacked to equal shapes, [S, NT, 256], with live [S, num_docs], and row
// r is the pair (query r / S, shard r % S): the gather reads shard r % S's
// tiles and the fold its live plane. num_docs is the padded per-shard doc
// count, so the sentinel and the key width are the same in every shard.
// S = 1 is the mode above.
//
// Bounds mode (K2b bounds; the `bounds=` argument of `_sparse_candidates`
// (:1014-1015) under `execute_batch_packed` :1724): the planes are one
// packed multi-tenant plane and row q carries its tenant's doc range
// [lo[q], hi[q]); a run head is eligible only inside it. A row's worklist
// lies in its own tenant's tiles, so the mask changes nothing unless a
// plan pointed at another tenant's tiles: it enforces the isolation the
// plan gives by construction. The gather, sort and fold are unchanged; the
// fold reads two ints a row more.
#include "common.cuh"

#define RS_THREADS 256
#define RS_WARPS (RS_THREADS / 32)
#define RS_CHUNK 4096
#define SCAN_THREADS 1024

__global__ void sparse_gather_kernel(
    const int32_t* __restrict__ doc_tiles,
    const float* __restrict__ tn,
    const int32_t* __restrict__ tile_ids,
    const int32_t* __restrict__ starts,
    const int32_t* __restrict__ ends,
    const float* __restrict__ weights,
    int nt,
    int num_docs,
    int row0,
    int n_shards,
    int64_t tile_stride,
    int32_t* __restrict__ keys,
    float* __restrict__ vals) {
    if (n_shards > 1) {
        const int64_t shard = (row0 + (int)blockIdx.y) % n_shards;
        doc_tiles += shard * tile_stride;
        tn += shard * tile_stride;
    }
    const int64_t e = (int64_t)blockIdx.y * nt + blockIdx.x;
    const int64_t i = e * ESK_TILE + threadIdx.x;
    const int64_t pos = (int64_t)tile_ids[e] * ESK_TILE + threadIdx.x;
    const bool valid = pos >= (int64_t)starts[e] && pos < (int64_t)ends[e];
    if (valid) {
        const float w = weights[e];
        keys[i] = doc_tiles[pos];
        vals[i] = __fsub_rn(w, __fdiv_rn(w, __fadd_rn(1.0f, tn[pos])));
    } else {
        keys[i] = num_docs;
        vals[i] = 0.0f;
    }
}

// counts[(row * 256 + digit) * nblocks + block]: each row's counts are
// one contiguous run that the scan below turns into that row's offsets.
__global__ void radix_hist_kernel(
    const int32_t* __restrict__ keys, int p, int shift, int nblocks,
    int32_t* __restrict__ counts) {
    __shared__ int hist[256];
    hist[threadIdx.x] = 0;
    __syncthreads();
    keys += (int64_t)blockIdx.y * p;  // this block's row
    const int lo = blockIdx.x * RS_CHUNK;
    const int hi = min(lo + RS_CHUNK, p);
    for (int i = lo + threadIdx.x; i < hi; i += RS_THREADS) {
        atomicAdd(&hist[(keys[i] >> shift) & 255], 1);
    }
    __syncthreads();
    counts[((int64_t)blockIdx.y * 256 + threadIdx.x) * nblocks + blockIdx.x] =
        hist[threadIdx.x];
}

// Exclusive prefix sum in place over each row's n ints (block = row),
// starting from the row's base offset row * p.
__global__ void exclusive_scan_kernel(int32_t* __restrict__ data, int n,
                                      int p) {
    __shared__ int sums[SCAN_THREADS];
    data += (int64_t)blockIdx.x * n;
    const int per = (n + SCAN_THREADS - 1) / SCAN_THREADS;
    const int lo = min((int)threadIdx.x * per, n);
    const int hi = min(lo + per, n);
    int s = 0;
    for (int i = lo; i < hi; ++i) {
        s += data[i];
    }
    sums[threadIdx.x] = s;
    __syncthreads();
    for (int off = 1; off < SCAN_THREADS; off <<= 1) {
        const int v = threadIdx.x >= off ? sums[threadIdx.x - off] : 0;
        __syncthreads();
        sums[threadIdx.x] += v;
        __syncthreads();
    }
    int run = (int)blockIdx.x * p + (threadIdx.x ? sums[threadIdx.x - 1] : 0);
    for (int i = lo; i < hi; ++i) {
        const int c = data[i];
        data[i] = run;
        run += c;
    }
}

// ROWS: a batch (grid.y = row). One row compiles without the row offsets:
// measured on the H100, the row-offset form of this kernel took ~30 % more
// time for a single row than the form without them.
template <bool ROWS>
__global__ void radix_scatter_kernel(
    const int32_t* __restrict__ keys_in,
    const float* __restrict__ vals_in,
    int32_t* __restrict__ keys_out,
    float* __restrict__ vals_out,
    int p, int shift, int nblocks,
    const int32_t* __restrict__ offsets) {
    __shared__ int base[256];
    __shared__ int wcount[RS_WARPS][256];
    __shared__ int total[256];
    const int tid = threadIdx.x;
    const int warp = tid >> 5;
    const int lane = tid & 31;
    const unsigned lanes_below = (1u << lane) - 1u;
    if (ROWS) {
        keys_in += (int64_t)blockIdx.y * p;
        vals_in += (int64_t)blockIdx.y * p;
        offsets += (int64_t)blockIdx.y * 256 * nblocks;
    }
    base[tid] = offsets[tid * nblocks + blockIdx.x];
    const int lo = blockIdx.x * RS_CHUNK;
    const int hi = min(lo + RS_CHUNK, p);
    for (int t = lo; t < hi; t += RS_THREADS) {
        for (int w = 0; w < RS_WARPS; ++w) {
            wcount[w][tid] = 0;
        }
        __syncthreads();
        const int i = t + tid;
        const bool valid = i < hi;
        int32_t key = 0;
        float val = 0.0f;
        int digit = 256;  // out-of-range lanes share a digit no pair has
        if (valid) {
            key = keys_in[i];
            val = vals_in[i];
            digit = (key >> shift) & 255;
        }
        const unsigned peers = __match_any_sync(0xffffffffu, digit);
        const int rank = __popc(peers & lanes_below);
        if (valid && rank == 0) {
            wcount[warp][digit] = __popc(peers);
        }
        __syncthreads();
        int run = 0;
        for (int w = 0; w < RS_WARPS; ++w) {
            const int c = wcount[w][tid];
            wcount[w][tid] = run;
            run += c;
        }
        total[tid] = run;
        __syncthreads();
        if (valid) {
            const int dst = base[digit] + wcount[warp][digit] + rank;
            keys_out[dst] = key;
            vals_out[dst] = val;
        }
        __syncthreads();
        base[tid] += total[tid];
    }
}

__global__ void run_fold_kernel(
    const int32_t* __restrict__ docs,
    const float* __restrict__ vals,
    const uint8_t* __restrict__ live,
    int64_t n, int p, int t_pad, int num_docs, int row0, int n_shards,
    const int32_t* __restrict__ win_lo,
    const int32_t* __restrict__ win_hi,
    int32_t* __restrict__ docs_out,
    float* __restrict__ run_sum,
    uint8_t* __restrict__ eligible) {
    const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) {
        return;
    }
    const int in_row = (int)(i % p);
    if (n_shards > 1) {
        live += (((int64_t)row0 + i / p) % n_shards) * num_docs;
    }
    const int32_t d = docs[i];
    float s = vals[i];
    int j = 1;
    for (; j < t_pad && in_row + j < p; ++j) {
        if (docs[i + j] != d) {
            break;
        }
        s = __fadd_rn(s, vals[i + j]);
    }
    if (j < t_pad) {
        // The reference adds +0.0 for every remaining shift; adding it
        // once has the same effect (it only turns -0.0 into +0.0).
        s = __fadd_rn(s, 0.0f);
    }
    docs_out[i] = d;
    run_sum[i] = s;
    const bool head = (in_row == 0) || (docs[i - 1] != d);
    const bool in_range = d != num_docs;
    const int safe = min(d, num_docs - 1);
    bool in_window = true;
    if (win_lo != nullptr) {
        const int64_t row = i / p;
        in_window = d >= win_lo[row] && d < win_hi[row];
    }
    eligible[i] = (head && in_range && live[safe] && in_window) ? 1 : 0;
}

// Rows q in [0, n_rows), worklists [n_rows, nt]; P = nt * 256 pairs a row.
// keys_a/vals_a/keys_b/vals_b: n_rows * P scratch; counts: n_rows * 256 *
// ceil(P / RS_CHUNK) ints. Outputs docs_s i32, run_sum f32, eligible u8,
// each [n_rows, P]. The caller keeps n_rows * P below 2^31. Stacked
// shards: the planes are [n_shards, ...] (tile planes tile_stride
// elements apart, live num_docs apart) and the launch's row q is row
// row0 + q of the batch, which reads shard (row0 + q) % n_shards. lo/hi:
// i32[n_rows] doc bounds of the bounds mode (this launch's rows), or null.
extern "C" int esk_sparse_fold(
    const void* doc_tiles,
    const void* tn,
    const void* tile_ids,
    const void* starts,
    const void* ends,
    const void* weights,
    int n_rows,
    int nt,
    int num_docs,
    int t_pad,
    int key_bits,
    const void* live,
    void* keys_a,
    void* vals_a,
    void* keys_b,
    void* vals_b,
    void* counts,
    void* docs_s,
    void* run_sum,
    void* eligible,
    int row0,
    int n_shards,
    long long tile_stride,
    const void* lo,
    const void* hi,
    void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    const int p = nt * ESK_TILE;
    if (p == 0 || n_rows == 0 || n_shards <= 0) {
        return 0;
    }
    const int64_t n = (int64_t)n_rows * p;
    sparse_gather_kernel<<<dim3(nt, n_rows), ESK_TILE, 0, s>>>(
        (const int32_t*)doc_tiles, (const float*)tn, (const int32_t*)tile_ids,
        (const int32_t*)starts, (const int32_t*)ends, (const float*)weights,
        nt, num_docs, row0, n_shards, (int64_t)tile_stride,
        (int32_t*)keys_a, (float*)vals_a);
    ESK_RETURN_IF_ERROR();
    const int nblocks = esk_blocks(p, RS_CHUNK);
    int32_t* src_k = (int32_t*)keys_a;
    float* src_v = (float*)vals_a;
    int32_t* dst_k = (int32_t*)keys_b;
    float* dst_v = (float*)vals_b;
    for (int shift = 0; shift < key_bits; shift += 8) {
        radix_hist_kernel<<<dim3(nblocks, n_rows), RS_THREADS, 0, s>>>(
            src_k, p, shift, nblocks, (int32_t*)counts);
        ESK_RETURN_IF_ERROR();
        exclusive_scan_kernel<<<n_rows, SCAN_THREADS, 0, s>>>(
            (int32_t*)counts, 256 * nblocks, p);
        ESK_RETURN_IF_ERROR();
        if (n_rows == 1) {
            radix_scatter_kernel<false><<<nblocks, RS_THREADS, 0, s>>>(
                src_k, src_v, dst_k, dst_v, p, shift, nblocks,
                (const int32_t*)counts);
        } else {
            radix_scatter_kernel<true>
                <<<dim3(nblocks, n_rows), RS_THREADS, 0, s>>>(
                    src_k, src_v, dst_k, dst_v, p, shift, nblocks,
                    (const int32_t*)counts);
        }
        ESK_RETURN_IF_ERROR();
        int32_t* tk = src_k;
        src_k = dst_k;
        dst_k = tk;
        float* tv = src_v;
        src_v = dst_v;
        dst_v = tv;
    }
    run_fold_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(
        src_k, src_v, (const uint8_t*)live, n, p, t_pad, num_docs, row0,
        n_shards, (const int32_t*)lo, (const int32_t*)hi, (int32_t*)docs_s,
        (float*)run_sum, (uint8_t*)eligible);
    ESK_RETURN_IF_ERROR();
    return 0;
}
