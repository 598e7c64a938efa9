/* host_encode — the host C of the round-1 encoder's planning and tail.
 *
 * Built with the host C compiler (cc, then gcc) at first use by
 * _build.host_library() and loaded with ctypes:
 *
 *   int huff_lengths(const int64_t *freq, int n, int max_bits,
 *                    unsigned char *out_lens);
 *       length-limited Huffman code lengths: optimal depths by a
 *       two-queue merge, exact package-merge when a depth passes
 *       max_bits.  Returns 0, or -1 for n > MAX_SYMS or more used
 *       symbols than 2^max_bits (huffman.py raises ValueError).
 *
 *   int optimal_parse(const int32_t *mlen, const int32_t *mdist, int n,
 *                     const uint8_t *data, const float *lit_bits,
 *                     const float *lenc_bits, const float *dist_bits,
 *                     int32_t *sel_len, uint8_t *take);
 *       cost-model-optimal token parse (zopfli-style squeeze) by
 *       backward dynamic programming over float32 bit costs:
 *         cost[i] = min(lit_bits[b[i]] + cost[i+1],
 *                       min over lengths l: lenc_bits + dist_bits
 *                                           + cost[i+l])
 *       with the lengths every length-code class boundary <= mlen[i]
 *       plus mlen[i].  take[i] = 1 where a token starts on the optimal
 *       path, sel_len[i] its length (0 = literal).  Returns 0, or -1
 *       when the cost array cannot be allocated.
 *
 * The same algorithms, operation for operation, as the JAX package's
 * native/fasthuff.c and native/fastparse.c: the DP's float32 sums round
 * the same way (build without -ffast-math), so the tail encoder's bytes
 * are the same.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define MAX_SYMS 320

/* stable ascending sort of (weight, symbol) by weight: n is tiny, and an
 * insertion sort keeps the order of equal weights (symbol order). */
static void sort_by_weight(int64_t *w, int *sym, int n) {
    for (int i = 1; i < n; i++) {
        int64_t wi = w[i];
        int si = sym[i];
        int j = i - 1;
        while (j >= 0 && (w[j] > wi)) {
            w[j + 1] = w[j];
            sym[j + 1] = sym[j];
            j--;
        }
        w[j + 1] = wi;
        sym[j + 1] = si;
    }
}

/* package-merge: exact optimal length-limited lengths.  leaf_w ascending;
 * out_lens indexed by sorted order. */
static int package_merge(const int64_t *leaf_w, int n, int max_bits,
                         int *out_lens) {
    /* item weights + per-item symbol counts (n <= 320, list <= 2n) */
    static int64_t cur_w[2 * MAX_SYMS];
    static int16_t cur_c[2 * MAX_SYMS][MAX_SYMS];
    static int64_t nxt_w[2 * MAX_SYMS];
    static int16_t nxt_c[2 * MAX_SYMS][MAX_SYMS];

    int cur_n = n;
    for (int i = 0; i < n; i++) {
        cur_w[i] = leaf_w[i];
        memset(cur_c[i], 0, sizeof(int16_t) * n);
        cur_c[i][i] = 1;
    }
    for (int level = 1; level < max_bits; level++) {
        int pk = cur_n / 2;
        /* merge leaves (ascending) with packages (ascending), leaves
         * first on equal weights */
        int li = 0, pi = 0, m = 0;
        while (li < n || pi < pk) {
            int64_t pw = (pi < pk) ? cur_w[2 * pi] + cur_w[2 * pi + 1] : 0;
            int take_leaf;
            if (li >= n) take_leaf = 0;
            else if (pi >= pk) take_leaf = 1;
            else take_leaf = leaf_w[li] <= pw;
            if (take_leaf) {
                nxt_w[m] = leaf_w[li];
                memset(nxt_c[m], 0, sizeof(int16_t) * n);
                nxt_c[m][li] = 1;
                li++;
            } else {
                nxt_w[m] = pw;
                for (int s = 0; s < n; s++)
                    nxt_c[m][s] = (int16_t)(cur_c[2 * pi][s] +
                                            cur_c[2 * pi + 1][s]);
                pi++;
            }
            m++;
        }
        cur_n = m;
        memcpy(cur_w, nxt_w, sizeof(int64_t) * m);
        memcpy(cur_c, nxt_c, sizeof(int16_t) * m * MAX_SYMS);
    }
    memset(out_lens, 0, sizeof(int) * n);
    int need = 2 * n - 2;
    if (need > cur_n) return -1;
    for (int i = 0; i < need; i++)
        for (int s = 0; s < n; s++)
            out_lens[s] += cur_c[i][s];
    return 0;
}

int huff_lengths(const int64_t *freq, int n, int max_bits,
                 unsigned char *out_lens) {
    if (n > MAX_SYMS) return -1;
    int sym[MAX_SYMS];
    int64_t w[MAX_SYMS];
    int used = 0;
    for (int i = 0; i < n; i++) {
        out_lens[i] = 0;
        if (freq[i] > 0) {
            sym[used] = i;
            w[used] = freq[i];
            used++;
        }
    }
    if (used == 0) return 0;
    if (used == 1) { out_lens[sym[0]] = 1; return 0; }
    if (used == 2) { out_lens[sym[0]] = 1; out_lens[sym[1]] = 1; return 0; }

    sort_by_weight(w, sym, used);

    /* two-queue optimal merge */
    int64_t weight[2 * MAX_SYMS];
    int parent[2 * MAX_SYMS];
    int depth[2 * MAX_SYMS];
    for (int i = 0; i < used; i++) weight[i] = w[i];
    int li = 0, ii = used, nxt = used;
    for (int m = 0; m < used - 1; m++) {
        int picks[2];
        for (int t = 0; t < 2; t++) {
            if (li < used && (ii >= nxt || weight[li] <= weight[ii]))
                picks[t] = li++;
            else
                picks[t] = ii++;
        }
        weight[nxt] = weight[picks[0]] + weight[picks[1]];
        parent[picks[0]] = nxt;
        parent[picks[1]] = nxt;
        nxt++;
    }
    int root = nxt - 1;
    depth[root] = 0;
    for (int node = root - 1; node >= 0; node--)
        depth[node] = depth[parent[node]] + 1;

    int maxd = 0;
    for (int i = 0; i < used; i++)
        if (depth[i] > maxd) maxd = depth[i];

    if (maxd <= max_bits) {
        for (int i = 0; i < used; i++)
            out_lens[sym[i]] = (unsigned char)depth[i];
        return 0;
    }

    /* depth limit exceeded: exact package-merge (needs Fibonacci-like
     * skew) */
    int pm_lens[MAX_SYMS];
    if (package_merge(w, used, max_bits, pm_lens) != 0) return -1;
    for (int i = 0; i < used; i++)
        out_lens[sym[i]] = (unsigned char)pm_lens[i];
    return 0;
}

static const uint16_t LBASE[29] = {3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17,
    19, 23, 27, 31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227,
    258};

static int len_code_of(int l) {
    /* length (3..258) -> code index (0..28) */
    int n = l - 3;
    if (n < 8) return n;
    if (n == 255) return 28;
    int e = 0;
    int x = n;
    while (x > 3) { x >>= 1; e++; }
    e -= 1;
    if (e < 1) e = 1;
    return (e << 2) + (n >> e);
}

static int dist_code_of(int d) {
    int m = d - 1;
    if (m < 4) return m;
    int e = 0;
    int x = m;
    while (x > 1) { x >>= 1; e++; }
    return (e << 1) + ((m >> (e - 1)) & 1);
}

int optimal_parse(const int32_t *mlen, const int32_t *mdist, int n,
                  const uint8_t *data, const float *lit_bits,
                  const float *lenc_bits, const float *dist_bits,
                  int32_t *sel_len, uint8_t *take) {
    float *cost = (float *)malloc(sizeof(float) * (size_t)(n + 1));
    if (!cost) return -1;
    cost[n] = 0.0f;
    for (int i = n - 1; i >= 0; i--) {
        float best = lit_bits[data[i]] + cost[i + 1];
        int best_l = 0;
        int ml = mlen[i];
        if (ml >= 3) {
            if (ml > n - i) ml = n - i;
            float dc = dist_bits[dist_code_of(mdist[i])];
            /* candidate lengths: class boundaries <= ml, plus ml */
            for (int c = 0; c < 29; c++) {
                int l = LBASE[c];
                if (l > ml) break;
                float v = lenc_bits[c] + dc + cost[i + l];
                if (v < best) { best = v; best_l = l; }
            }
            {
                int l = ml;
                float v = lenc_bits[len_code_of(l)] + dc + cost[i + l];
                if (v < best) { best = v; best_l = l; }
            }
        }
        cost[i] = best;
        sel_len[i] = best_l;
    }
    free(cost);
    /* walk the optimal path: take[i] = 1 where a token starts */
    memset(take, 0, (size_t)n);
    for (int i = 0; i < n;) {
        take[i] = 1;
        i += sel_len[i] ? sel_len[i] : 1;
    }
    return 0;
}
