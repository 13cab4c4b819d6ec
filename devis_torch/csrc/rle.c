/* RLE codec of the port's tracker and TrackMAP (a copy of the JAX package's
 * native/rle.c, which stays as it is).
 *
 * Masks in the YouTube-VIS / COCO RLE convention: flattened in Fortran
 * (column-major) order, counts alternating runs of 0s and 1s, starting with
 * 0s; the string form is pycocotools' rleToString. The tracker encodes every
 * surviving frame mask at the video's size and the evaluation intersects
 * every detected track with every ground-truth track, so these loops
 * run on the host for each frame of a video.
 *
 * Built by devis_torch/evaluation/_native.py with `cc -O2 -fPIC -shared`
 * into devis_torch/_build/ at first use and bound with ctypes; the numpy
 * functions of devis_torch/evaluation/rle.py are its plain versions.
 */
#include <stdint.h>
#include <stddef.h>

/* Encode a 0/1 mask (n elements, F-order) into run counts.
 * Returns the number of counts written, or -1 if max_counts is too small. */
long rle_encode(const uint8_t *mask, long n, long *counts, long max_counts) {
    long n_counts = 0;
    uint8_t cur = 0;           /* runs start with zeros */
    long run = 0;
    long i = 0;
    while (i < n) {
        /* word-at-a-time fast path: extend the current run by 8 while the
         * next 8 bytes are uniformly equal to it (masks are blobs — long
         * runs dominate) */
        if (i + 8 <= n) {
            uint64_t w;
            __builtin_memcpy(&w, mask + i, 8);
            uint64_t want = cur ? 0x0101010101010101ULL : 0ULL;
            if (w == want) {
                run += 8;
                i += 8;
                continue;
            }
        }
        uint8_t v = mask[i] != 0;
        if (v == cur) {
            ++run;
        } else {
            if (n_counts >= max_counts) return -1;
            counts[n_counts++] = run;
            cur = v;
            run = 1;
        }
        ++i;
    }
    if (n_counts >= max_counts) return -1;
    counts[n_counts++] = run;
    return n_counts;
}

/* Decode run counts into a 0/1 mask of n elements (F-order). Returns 0, or
 * -1 if the counts overflow n. */
long rle_decode(const long *counts, long n_counts, uint8_t *out, long n) {
    long pos = 0;
    uint8_t val = 0;
    for (long c = 0; c < n_counts; ++c) {
        long run = counts[c];
        if (pos + run > n) return -1;
        for (long i = 0; i < run; ++i) out[pos + i] = val;
        pos += run;
        val = !val;
    }
    while (pos < n) out[pos++] = 0;
    return 0;
}

/* Total foreground area of a counts array. */
long rle_area(const long *counts, long n_counts) {
    long a = 0;
    for (long c = 1; c < n_counts; c += 2) a += counts[c];
    return a;
}

/* Foreground-interval intersection length of two counts arrays
 * (merge-scan over the implicit [start, end) 1-run intervals). */
long rle_intersection(const long *ca, long na, const long *cb, long nb) {
    long ia = 1, ib = 1;                  /* index of current 1-run */
    long sa = (na > 0) ? ca[0] : 0;       /* start of current a 1-run */
    long sb = (nb > 0) ? cb[0] : 0;
    long total = 0;
    while (ia < na && ib < nb) {
        long ea = sa + ca[ia];
        long eb = sb + cb[ib];
        long lo = sa > sb ? sa : sb;
        long hi = ea < eb ? ea : eb;
        if (hi > lo) total += hi - lo;
        if (ea < eb) {
            sa = ea + ((ia + 1 < na) ? ca[ia + 1] : 0);
            ia += 2;
        } else {
            sb = eb + ((ib + 1 < nb) ? cb[ib + 1] : 0);
            ib += 2;
        }
    }
    return total;
}

/* Pairwise IoU matrix: dt x gt, crowd gt uses dt-area denominator.
 * counts arrays are concatenated; offsets/lengths index into them. */
void rle_iou_matrix(const long *dt_counts, const long *dt_off,
                    const long *dt_len, long n_dt,
                    const long *gt_counts, const long *gt_off,
                    const long *gt_len, long n_gt,
                    const uint8_t *iscrowd, double *out) {
    for (long i = 0; i < n_dt; ++i) {
        const long *ci = dt_counts + dt_off[i];
        long ni = dt_len[i];
        long ai = rle_area(ci, ni);
        for (long j = 0; j < n_gt; ++j) {
            const long *cj = gt_counts + gt_off[j];
            long nj = gt_len[j];
            long inter = rle_intersection(ci, ni, cj, nj);
            long uni = iscrowd[j] ? ai : ai + rle_area(cj, nj) - inter;
            out[i * n_gt + j] = uni > 0 ? (double)inter / (double)uni : 0.0;
        }
    }
}

/* pycocotools rleToString: LEB128-ish base-48 char encoding with the
 * difference trick (counts[i] -= counts[i-2] for i > 2). Returns the number
 * of chars written, or -1 if the output buffer is too small. Each count
 * needs at most 13 chars (64-bit), so size out for 13*n_counts. */
long rle_counts_to_string(const long *counts, long n_counts, char *out,
                          long max_out) {
    long p = 0;
    for (long i = 0; i < n_counts; ++i) {
        long x = counts[i];
        if (i > 2) x -= counts[i - 2];
        int more = 1;
        while (more) {
            long ch = x & 0x1F;
            x >>= 5;
            more = (ch & 0x10) ? (x != -1) : (x != 0);
            if (more) ch |= 0x20;
            if (p >= max_out) return -1;
            out[p++] = (char)(ch + 48);
        }
    }
    return p;
}

/* pycocotools rleFrString inverse. Returns the number of counts written,
 * or -1 on overflow of max_counts. */
long rle_string_to_counts(const char *s, long n, long *counts,
                          long max_counts) {
    long p = 0, m = 0;
    while (p < n) {
        long x = 0;
        int k = 0, more = 1;
        long ch = 0;
        while (more) {
            if (p >= n) return -1;
            ch = (long)s[p] - 48;
            x |= (ch & 0x1F) << (5 * k);
            more = (int)(ch & 0x20);
            ++p;
            ++k;
        }
        if (!more && (ch & 0x10)) x |= -1L << (5 * k);
        if (m > 2) x += counts[m - 2];
        if (m >= max_counts) return -1;
        counts[m++] = x;
    }
    return m;
}
