/* Native host-side runtime for damar_tpu.
 *
 * The reference implements its entire host runtime in C (SURVEY.md §2:
 * DB codec in db/DB.c, .las IO in dalign/align.c, merge in LAmerge.c —
 * upstream-path citations, reference mount empty).  This build keeps
 * the compute path in JAX/Pallas but implements the same hot HOST
 * paths natively: 2-bit base packing (ingest of multi-GB FASTA) and
 * streaming k-way .las merge (tens of GB of overlap shards, the
 * reference's LAmerge).  Python bindings are ctypes (no pybind11 in
 * the image); damar_tpu.native builds this file on demand with cc -O3
 * and falls back to the numpy implementations when no compiler exists.
 *
 * Build: cc -O3 -shared -fPIC damar_native.c -o libdamar_native.so
 */
#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <pthread.h>
#include <unistd.h>

/* ---------------- 2-bit base codec ---------------- */

void pack2bit(const uint8_t *codes, int64_t n, uint8_t *out) {
    int64_t nb = n / 4;
    for (int64_t i = 0; i < nb; i++) {
        const uint8_t *c = codes + 4 * i;
        out[i] = (uint8_t)((c[0] << 6) | (c[1] << 4) | (c[2] << 2) | c[3]);
    }
    int64_t rem = n - 4 * nb;
    if (rem) {
        uint8_t b = 0;
        for (int64_t j = 0; j < rem; j++)
            b |= (uint8_t)(codes[4 * nb + j] << (6 - 2 * j));
        out[nb] = b;
    }
}

void unpack2bit(const uint8_t *packed, int64_t n, uint8_t *out) {
    int64_t nb = n / 4;
    for (int64_t i = 0; i < nb; i++) {
        uint8_t b = packed[i];
        uint8_t *o = out + 4 * i;
        o[0] = (uint8_t)(b >> 6);
        o[1] = (uint8_t)((b >> 4) & 3);
        o[2] = (uint8_t)((b >> 2) & 3);
        o[3] = (uint8_t)(b & 3);
    }
    for (int64_t j = 4 * nb; j < n; j++)
        out[j] = (uint8_t)((packed[j / 4] >> (6 - 2 * (j % 4))) & 3);
}

/* ---------------- streaming k-way .las merge ----------------
 *
 * Record layout (formats/las.py): header int64 novl + int32 tspace;
 * then per record 40 bytes (tlen,diffs,abpos,bbpos,aepos,bepos i32;
 * flags u32; aread,bread i32; 4 pad) + trace payload (tlen bytes when
 * tspace <= 125 else tlen*2).  Sort key: (aread, bread, flags&COMP,
 * abpos, aepos, bbpos).
 */

typedef struct {
    FILE *f;
    int64_t remaining;
    int32_t rec[10];      /* current record header */
    uint8_t *trace;       /* current trace payload */
    int32_t tbytes;
    int live;
} Stream;

static int stream_advance(Stream *s, int small) {
    if (s->remaining <= 0) { s->live = 0; return 0; }
    if (fread(s->rec, 4, 10, s->f) != 10) { s->live = 0; return -1; }
    int64_t tlen = s->rec[0];
    int64_t tb = small ? tlen : tlen * 2;
    /* reject corrupt record sizes before sizing an allocation */
    if (tb < 0 || tb > ((int64_t)1 << 31)) { s->live = 0; return -1; }
    s->tbytes = (int32_t)tb;
    uint8_t *nt_ = (uint8_t *)realloc(
        s->trace, (size_t)(s->tbytes ? s->tbytes : 1));
    if (!nt_) { s->live = 0; return -1; }
    s->trace = nt_;
    if (s->tbytes && fread(s->trace, 1, (size_t)s->tbytes, s->f)
            != (size_t)s->tbytes) { s->live = 0; return -1; }
    s->remaining--;
    return 1;
}

static int stream_less(const Stream *a, const Stream *b) {
    /* key fields in rec[]: aread=7, bread=8, comp=flags&1 (rec[6]),
       abpos=2, aepos=4, bbpos=3 */
    const int32_t ka[6] = {a->rec[7], a->rec[8],
                           (int32_t)(((uint32_t)a->rec[6]) & 1u),
                           a->rec[2], a->rec[4], a->rec[3]};
    const int32_t kb[6] = {b->rec[7], b->rec[8],
                           (int32_t)(((uint32_t)b->rec[6]) & 1u),
                           b->rec[2], b->rec[4], b->rec[3]};
    for (int i = 0; i < 6; i++) {
        if (ka[i] < kb[i]) return 1;
        if (ka[i] > kb[i]) return 0;
    }
    return 0;   /* strict: ties keep the earlier stream (stable) */
}

/* returns 0 on success, negative error code otherwise */
int las_merge(const char **inputs, int n_in, const char *output) {
    if (n_in <= 0) return -1;
    Stream *ss = (Stream *)calloc((size_t)n_in, sizeof(Stream));
    if (!ss) return -1;
    int32_t tspace = -1;
    int err = 0;
    int64_t total = 0;
    for (int i = 0; i < n_in && !err; i++) {
        ss[i].f = fopen(inputs[i], "rb");
        if (!ss[i].f) { err = -2; break; }
        int64_t novl;
        int32_t ts;
        if (fread(&novl, 8, 1, ss[i].f) != 1 ||
            fread(&ts, 4, 1, ss[i].f) != 1) { err = -3; break; }
        if (tspace < 0 && novl > 0) tspace = ts;
        else if (novl > 0 && ts != tspace) { err = -4; break; }
        if (tspace < 0) tspace = ts;
        ss[i].remaining = novl;
        ss[i].live = 1;
        total += novl;
    }
    int small = tspace <= 125;
    for (int i = 0; i < n_in && !err; i++) {
        int r = stream_advance(&ss[i], small);
        if (r < 0) err = -5;
    }
    FILE *out = NULL;
    if (!err) {
        out = fopen(output, "wb");
        if (!out) err = -6;
    }
    if (!err) {
        fwrite(&total, 8, 1, out);
        fwrite(&tspace, 4, 1, out);
        int64_t written = 0;
        for (;;) {
            int best = -1;
            for (int i = 0; i < n_in; i++) {
                if (!ss[i].live) continue;
                if (best < 0 || stream_less(&ss[i], &ss[best]))
                    best = i;
            }
            if (best < 0) break;
            fwrite(ss[best].rec, 4, 10, out);
            if (ss[best].tbytes)
                fwrite(ss[best].trace, 1, (size_t)ss[best].tbytes, out);
            written++;
            if (stream_advance(&ss[best], small) < 0) { err = -5; break; }
        }
        if (!err && written != total) err = -7;
        fclose(out);
    }
    for (int i = 0; i < n_in; i++) {
        if (ss[i].f) fclose(ss[i].f);
        free(ss[i].trace);
    }
    free(ss);
    return err;
}

/* ---------------- fast .las scan ----------------
 * Fill caller-provided arrays with record headers; returns count or
 * negative error.  Trace payloads are concatenated into trace_out
 * (caller sizes it via the file size).
 */
int64_t las_scan(const char *path, int32_t *headers /* n x 10 */,
                 uint8_t *trace_out, int64_t trace_cap,
                 int64_t *trace_offsets /* n+1 */) {
    FILE *f = fopen(path, "rb");
    if (!f) return -2;
    int64_t novl;
    int32_t tspace;
    if (fread(&novl, 8, 1, f) != 1 || fread(&tspace, 4, 1, f) != 1) {
        fclose(f);
        return -3;
    }
    int small = tspace <= 125;
    int64_t toff = 0;
    for (int64_t i = 0; i < novl; i++) {
        if (fread(headers + 10 * i, 4, 10, f) != 10) { fclose(f); return -5; }
        int32_t tlen = headers[10 * i];
        int64_t tb = small ? tlen : (int64_t)tlen * 2;
        if (toff + tb > trace_cap) { fclose(f); return -8; }
        if (tb && fread(trace_out + toff, 1, (size_t)tb, f) != (size_t)tb) {
            fclose(f);
            return -5;
        }
        trace_offsets[i] = toff;
        toff += tb;
    }
    trace_offsets[novl] = toff;
    fclose(f);
    return novl;
}

/* ---------------- banded edit alignment with traceback ----------------
 *
 * The consensus/polish path (pipeline/consensus.py banded_align_path)
 * and LAshow -a reconstruction align ~10^5 short cover windows per
 * contig; the numpy row loop costs ~25 ms per cover, this C version
 * ~1 ms.  Semantics MIRROR the Python implementation exactly (same
 * band frame, same traceback preference: match/sub, del, ins, edge
 * fallback) so native and fallback paths produce identical paths.
 *
 * Band frame: width = 2*band+1, off = (n-m)/2, j(i,k) = i + k - band + off.
 * ops: 0 = match/sub (consumes a,b), 1 = del (consumes a), 2 = ins
 * (consumes b).  Returns path length, or -1 on overflow/error.
 * jstart_out: j of the first consumed b (leading b skipped when
 * semiglobal).
 */
#define BA_INF 0x3FFFFFFF

int64_t band_align(const uint8_t *a, int32_t m, const uint8_t *b,
                   int32_t n, int32_t band, int32_t semiglobal,
                   uint8_t *ops_out, int64_t ops_cap,
                   int32_t *jstart_out) {
    const int32_t width = 2 * band + 1;
    /* FLOOR division to mirror Python's (n - m) // 2: C's / truncates
     * toward zero, shifting the band frame one diagonal when n - m is
     * negative and odd. */
    const int32_t nm = n - m;
    const int32_t off = nm >= 0 ? nm / 2 : -((-nm + 1) / 2);
    const int32_t ctr = band;
    int32_t *D = (int32_t *)malloc((size_t)(m + 1) * width * 4);
    if (!D) return -1;
    for (int32_t k = 0; k < width; k++) {
        int32_t j = 0 + k - ctr + off;
        D[k] = (j >= 0 && j <= n) ? (semiglobal ? 0 : j) : BA_INF;
    }
    for (int32_t i = 1; i <= m; i++) {
        const int32_t *prev = D + (size_t)(i - 1) * width;
        int32_t *row = D + (size_t)i * width;
        const uint8_t ai = a[i - 1];
        int32_t left = BA_INF;   /* D[i][k-1] as we sweep k upward */
        for (int32_t k = 0; k < width; k++) {
            int32_t j = i + k - ctr + off;
            int32_t best = BA_INF;
            if (j >= 0 && j <= n) {
                if (j >= 1) {
                    int32_t d = prev[k] + (b[j - 1] == ai ? 0 : 1);
                    if (d < best) best = d;
                }
                if (k + 1 < width && prev[k + 1] < BA_INF) {
                    int32_t d = prev[k + 1] + 1;
                    if (d < best) best = d;
                }
                if (j >= 1 && left < BA_INF) {
                    int32_t d = left + 1;
                    if (d < best) best = d;
                }
            } else {
                best = BA_INF;
            }
            row[k] = best;
            left = best;
        }
    }
    /* traceback start */
    int32_t i = m, k;
    if (semiglobal) {
        int32_t bestk = 0, bestv = BA_INF;
        for (int32_t kk = 0; kk < width; kk++) {
            int32_t j = m + kk - ctr + off;
            if (j >= 0 && j <= n && D[(size_t)m * width + kk] < bestv) {
                bestv = D[(size_t)m * width + kk];
                bestk = kk;
            }
        }
        k = bestk;
    } else {
        k = n - m + ctr - off;
        if (k < 0 || k >= width) { free(D); return -1; }
    }
    uint8_t *stack = (uint8_t *)malloc((size_t)m + n + 2);
    if (!stack) { free(D); return -1; }
    int64_t sp = 0;
    while (i > 0 || (!semiglobal && (i + k - ctr + off) > 0)) {
        int32_t j = i + k - ctr + off;
        int32_t cur = D[(size_t)i * width + k];
        if (i > 0 && j > 0 && j <= n &&
            D[(size_t)(i - 1) * width + k]
                + (b[j - 1] == a[i - 1] ? 0 : 1) == cur) {
            stack[sp++] = 0;
            i--;
        } else if (i > 0 && k + 1 < width &&
                   D[(size_t)(i - 1) * width + k + 1] + 1 == cur) {
            stack[sp++] = 1;
            i--;
            k++;
        } else if (j > 0 && k - 1 >= 0 &&
                   D[(size_t)i * width + k - 1] + 1 == cur) {
            stack[sp++] = 2;
            k--;
        } else if (semiglobal && i == 0) {
            break;
        } else {
            if (i > 0) {
                stack[sp++] = 1;
                i--;
            } else {
                stack[sp++] = 2;
                k--;
            }
        }
    }
    /* at exit i == 0 (and j == 0 for global): j = leading b skip */
    *jstart_out = i + k - ctr + off;
    free(D);
    if (sp > ops_cap) { free(stack); return -1; }
    for (int64_t t = 0; t < sp; t++)
        ops_out[t] = stack[sp - 1 - t];
    free(stack);
    return sp;
}

/* Batched covers-vs-one-template alignment (consensus window). */
int64_t band_align_batch(const uint8_t *a, int32_t m,
                         const uint8_t *b_concat, const int64_t *b_offs,
                         int32_t n_covers, int32_t band,
                         int32_t semiglobal,
                         uint8_t *ops_out, int64_t ops_cap,
                         int64_t *ops_offs /* n_covers + 1 */,
                         int32_t *jstarts /* n_covers */) {
    int64_t pos = 0;
    ops_offs[0] = 0;
    for (int32_t c = 0; c < n_covers; c++) {
        int32_t n = (int32_t)(b_offs[c + 1] - b_offs[c]);
        int64_t L = band_align(a, m, b_concat + b_offs[c], n, band,
                               semiglobal, ops_out + pos,
                               ops_cap - pos, jstarts + c);
        if (L < 0) return -1;
        pos += L;
        ops_offs[c + 1] = pos;
    }
    return pos;
}

/* ---------------- trace-point computation ----------------
 *
 * Host-side equivalent of the device trace kernels (ops/wave_bp.py
 * trace_wave_bp): per trace segment, a banded edit DP anchored at the
 * current (a, b) position (V-shaped band init = greedy chaining),
 * committed at the min-cost band column (the pinned endpoint for the
 * final segment).  Used as the wide-retry kernel on CPU backends where
 * the 128-lane JAX kernel costs ~40ms/record; this runs ~1ms.
 * Rolling rows only — no traceback is needed for (diffs, bspan) pairs.
 */

int32_t trace_points(const uint8_t *a, const uint8_t *b,
                     int64_t abpos, int64_t aepos,
                     int64_t bbpos, int64_t bepos,
                     int32_t tspace, int32_t band,
                     int32_t *out /* max_segs x 2 */, int32_t max_segs) {
    const int32_t width = 2 * band + 1;
    int32_t *D = (int32_t *)malloc((size_t)width * 4);
    int32_t *E = (int32_t *)malloc((size_t)width * 4);
    if (!D || !E) { free(D); free(E); return -1; }
    int64_t cur_a = abpos, cur_b = bbpos;
    int32_t nseg = 0;
    while (cur_a < aepos) {
        int64_t aend = (cur_a / tspace + 1) * tspace;
        if (aend > aepos) aend = aepos;
        int32_t m = (int32_t)(aend - cur_a);
        /* V-init: D[k] = |k - band| for valid vb, else INF */
        for (int32_t k = 0; k < width; k++) {
            int64_t vb = cur_b + k - band;     /* row 0 frame */
            D[k] = (vb >= bbpos && vb <= bepos)
                ? (k > band ? k - band : band - k) : BA_INF;
        }
        for (int32_t i = 1; i <= m; i++) {
            const uint8_t ai = a[cur_a + i - 1];
            /* hoist the vb-bound tests: valid k range is
             * [klo, khi); vb == bbpos only possible at k == klo0 */
            int64_t base = cur_b + i - band;        /* vb at k = 0 */
            int32_t klo = bbpos - base < 0 ? 0 : (int32_t)(bbpos - base);
            int32_t khi = bepos - base + 1 > width ? width
                          : (int32_t)(bepos - base + 1);
            int32_t left = BA_INF;
            for (int32_t k = 0; k < (klo < width ? klo : width); k++)
                E[k] = BA_INF;
            for (int32_t k = khi < 0 ? 0 : khi; k < width; k++)
                E[k] = BA_INF;
            for (int32_t k = klo; k < khi; k++) {
                int64_t vb = base + k;
                int32_t best;
                if (vb >= bbpos + 1) {
                    int32_t d0 = D[k] + (b[vb - 1] == ai ? 0 : 1);
                    int32_t d2 = left + 1;        /* BA_INF saturates */
                    best = d0 < d2 ? d0 : d2;
                    if (k + 1 < width) {
                        int32_t d1 = D[k + 1] + 1;
                        if (d1 < best) best = d1;
                    }
                    if (best > BA_INF) best = BA_INF;
                } else {
                    /* vb == bbpos: only the down move applies */
                    best = k + 1 < width && D[k + 1] < BA_INF
                           ? D[k + 1] + 1 : BA_INF;
                }
                E[k] = best;
                left = best;
            }
            int32_t *t = D; D = E; E = t;
        }
        int32_t bestk = -1, bestv = BA_INF;
        if (aend == aepos) {
            /* final segment: endpoint pinned at bepos */
            int64_t k = bepos - cur_b - m + band;
            if (k >= 0 && k < width && D[k] < BA_INF) {
                bestk = (int32_t)k;
                bestv = D[k];
            }
        } else {
            for (int32_t k = 0; k < width; k++) {
                int64_t vb = cur_b + m + k - band;
                if (vb > cur_b && vb <= bepos && D[k] < bestv) {
                    bestv = D[k];
                    bestk = k;
                }
            }
        }
        if (bestk < 0 || nseg >= max_segs) {
            free(D); free(E);
            return -2;               /* caller drops the record */
        }
        int64_t vb = cur_b + m + bestk - band;
        out[2 * nseg] = bestv;
        out[2 * nseg + 1] = (int32_t)(vb - cur_b);
        nseg++;
        cur_a = aend;
        cur_b = vb;
    }
    free(D); free(E);
    return nseg;
}

typedef struct {
    const uint8_t *a, *b;
    const int64_t *astart, *bstart, *abpos, *aepos, *bbpos, *bepos;
    int32_t tspace, band, max_segs;
    int32_t *out, *nseg_out, *dsum_out;
    int32_t lo, nt, n_rec;
} TpJob;

static void *tp_worker(void *vp) {
    /* strided record assignment: retry batches arrive length-sorted,
     * so contiguous ranges leave one thread with all the long
     * records; lo is the thread index */
    TpJob *j = (TpJob *)vp;
    for (int32_t r = j->lo; r < j->n_rec; r += j->nt) {
        int32_t *o = j->out + (size_t)r * j->max_segs * 2;
        int32_t ns = trace_points(j->a + j->astart[r],
                                  j->b + j->bstart[r], j->abpos[r],
                                  j->aepos[r], j->bbpos[r], j->bepos[r],
                                  j->tspace, j->band, o, j->max_segs);
        if (ns < 0) ns = 0;          /* inconsistent: empty trace */
        j->nseg_out[r] = ns;
        int32_t d = 0;
        for (int32_t s = 0; s < ns; s++) d += o[2 * s];
        j->dsum_out[r] = d;
    }
    return NULL;
}

int64_t trace_points_batch(const uint8_t *a, const uint8_t *b,
                           int32_t n_rec,
                           const int64_t *astart, const int64_t *bstart,
                           const int64_t *abpos, const int64_t *aepos,
                           const int64_t *bbpos, const int64_t *bepos,
                           int32_t tspace, int32_t band,
                           int32_t *out /* n_rec x max_segs x 2 */,
                           int32_t *nseg_out, int32_t *dsum_out,
                           int32_t max_segs, int32_t nthreads) {
    /* coordinates are READ-LOCAL (trace boundaries are multiples of
     * tspace in the A read's own frame); astart/bstart locate each
     * record's reads in the block arrays.  Records are independent:
     * nthreads pthreads split them. */
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (nthreads > n_rec) nthreads = n_rec > 0 ? n_rec : 1;
    TpJob tmpl = {a, b, astart, bstart, abpos, aepos, bbpos, bepos,
                  tspace, band, max_segs, out, nseg_out, dsum_out,
                  0, nthreads, n_rec};
    if (nthreads == 1) {
        tp_worker(&tmpl);
        return 0;
    }
    pthread_t tid[16];
    TpJob jobs[16];
    for (int i = 0; i < nthreads; i++) {
        jobs[i] = tmpl;
        jobs[i].lo = i;
        pthread_create(&tid[i], NULL, tp_worker, &jobs[i]);
    }
    for (int i = 0; i < nthreads; i++)
        pthread_join(tid[i], NULL);
    return 0;
}

/* ---------------- bit-parallel band kernels ----------------
 *
 * Exact scalar replicas of ops/wave_bp.py (extend_wave_bp /
 * trace_wave_bp): the Myers/Hyyro-style band-in-a-word DP the GPU
 * path runs one seed per thread (ops/wave_bp_gpu.py).  Every integer operation below
 * mirrors the JAX kernel so the CPU fallback produces BIT-IDENTICAL
 * extents/traces (asserted by tests/test_native_bp.py); pthreads
 * split the independent units across cores.
 */

#define BP_BW  32
#define BP_CTR 16
#define BP_NEG (-(1 << 20))
#define BP_INF (1 << 20)

static inline int bp_char(const uint8_t *bases, int64_t n, int64_t idx) {
    /* out-of-range reads are clamped garbage the masks neutralize
     * (same contract as wave_pallas._gather_packed word clipping) */
    if (idx < 0) idx = 0;
    if (idx >= n) idx = n - 1;
    return bases[idx] & 3;
}

static inline void bp_vinit(uint32_t *VP, uint32_t *VN, int32_t *Db) {
    uint32_t vn = (1u << (BP_CTR + 1)) - 1u;
    *VN = vn;
    *VP = ~vn;
    *Db = BP_CTR + 1;
}

static inline uint32_t bp_eq(uint32_t PH, uint32_t PL, uint32_t PV,
                             uint32_t x) {
    uint32_t mh = ((x >> 1) & 1u) - 1u;   /* 0 -> all ones, 1 -> 0 */
    uint32_t ml = (x & 1u) - 1u;
    return (PH ^ mh) & (PL ^ ml) & PV;
}

static inline uint32_t bp_row(uint32_t *VP, uint32_t *VN, int32_t *Db,
                              int32_t *Dc, uint32_t Eq) {
    /* one band-frame DP row; returns G0 (wave_bp._row_step) */
    uint32_t vp = *VP, vn = *VN;
    uint32_t X = Eq | (vn >> 1);
    uint32_t seed = (X << 1) & vp;
    uint32_t G0 = X | (vp & (seed | ((seed + vp) ^ vp)));
    uint32_t g = ~G0;
    uint32_t gp = g << 1;
    uint32_t d = g ^ gp, nd = ~d;
    uint32_t Z = ~(vp | vn);
    uint32_t VPn = ((vp & nd) | (Z & g & ~gp)) & 0xFFFFFFFEu;
    uint32_t VNn = (((vn & nd) | (Z & gp & G0)) & 0xFFFFFFFEu)
                   | (G0 & 1u);
    *Db += 1 + (int32_t)(vp & 1u) - (int32_t)(vn & 1u);
    *Dc += 1 - (int32_t)((G0 >> BP_CTR) & 1u);
    *VP = VPn;
    *VN = VNn;
    return G0;
}

static inline void bp_shift(uint32_t *PH, uint32_t *PL, uint32_t *PV,
                            uint32_t c, uint32_t valid) {
    *PH = (*PH >> 1) | (((c >> 1) & 1u) << (BP_BW - 1));
    *PL = (*PL >> 1) | ((c & 1u) << (BP_BW - 1));
    *PV = (*PV >> 1) | (valid << (BP_BW - 1));
}

static inline void bp_reconstruct(uint32_t VP, uint32_t VN, int32_t Db,
                                  int32_t *D) {
    int32_t v = Db;
    for (int j = 0; j < BP_BW; j++) {
        v += (int32_t)((VP >> j) & 1u) - (int32_t)((VN >> j) & 1u);
        D[j] = v;
    }
}

typedef struct {
    const uint8_t *A, *B;
    int64_t na, nb;
    const int32_t *i0, *i1, *i2, *i3;   /* per-kernel int args */
    const uint8_t *rev;
    int32_t S, R, max_rows, diff_cost, xdrop, tspace, max_segs;
    int32_t *o0, *o1, *o2, *o3;
    int32_t lo, hi;
    int which;                           /* 0 = extend, 1 = trace */
} BpJob;

static void bp_extend_group(const uint8_t *, int64_t, const uint8_t *,
                            int64_t, const int32_t *, const int32_t *,
                            const int32_t *, const int32_t *,
                            const uint8_t *, int, int, int, int, int,
                            int32_t *, int32_t *, int32_t *, int32_t *);
static void bp_trace_group(const uint8_t *, int64_t, const uint8_t *,
                           int64_t, const int32_t *, const int32_t *,
                           const int32_t *, const int32_t *,
                           const int32_t *, int, int, int, int32_t *,
                           int32_t *, int32_t *);
#define BP_GROUP 16

static void *bp_worker(void *vp) {
    BpJob *j = (BpJob *)vp;
    for (int32_t u = j->lo; u < j->hi; u += BP_GROUP) {
        int nl = j->hi - u < BP_GROUP ? j->hi - u : BP_GROUP;
        if (j->which == 0) {
            bp_extend_group(j->A, j->na, j->B, j->nb, j->i0 + u,
                            j->i1 + u, j->i2 + u, j->i3 + u,
                            j->rev ? j->rev + u : NULL, nl, j->R,
                            j->max_rows, j->diff_cost, j->xdrop,
                            j->o0 + u, j->o1 + u, j->o2 + u, j->o3 + u);
        } else {
            /* i0/i1 = astart/bstart (block origins), o3 = abpos/bbpos
             * packed: reuse slots — see bp_trace_batch */
            bp_trace_group(j->A, j->na, j->B, j->nb, j->i0 + u,
                           j->i1 + u, j->o3 + 2 * u, j->i2 + u,
                           j->i3 + u, nl, j->tspace, j->max_segs,
                           j->o0 + (size_t)u * j->max_segs * 2,
                           j->o1 + u, j->o2 + u);
        }
    }
    return NULL;
}

static void bp_run(BpJob *tmpl, int32_t S, int nthreads) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    if (nthreads > S) nthreads = S > 0 ? S : 1;
    pthread_t tid[16];
    BpJob jobs[16];
    int32_t per = (S + nthreads - 1) / nthreads;
    int nt = 0;
    for (int i = 0; i < nthreads; i++) {
        int32_t lo = i * per;
        if (lo >= S) break;
        jobs[nt] = *tmpl;
        jobs[nt].lo = lo;
        jobs[nt].hi = lo + per < S ? lo + per : S;
        nt++;
    }
    if (nt == 1) {
        bp_worker(&jobs[0]);
        return;
    }
    for (int i = 0; i < nt; i++)
        pthread_create(&tid[i], NULL, bp_worker, &jobs[i]);
    for (int i = 0; i < nt; i++)
        pthread_join(tid[i], NULL);
}

void bp_extend_batch(const uint8_t *A, int64_t na, const uint8_t *B,
                     int64_t nb, const int32_t *ao, const int32_t *bo,
                     const int32_t *alim, const int32_t *blim,
                     const uint8_t *rev, int32_t S, int32_t R,
                     int32_t max_rows, int32_t diff_cost, int32_t xdrop,
                     int32_t nthreads, int32_t *va, int32_t *vb,
                     int32_t *d, int32_t *sc) {
    BpJob j = {A, B, na, nb, ao, bo, alim, blim, rev, S, R, max_rows,
               diff_cost, xdrop, 0, 0, va, vb, d, sc, 0, 0, 0};
    bp_run(&j, S, nthreads);
}

void bp_trace_batch(const uint8_t *A, int64_t na, const uint8_t *B,
                    int64_t nb, const int32_t *astart,
                    const int32_t *bstart, const int32_t *abp_bbp,
                    const int32_t *alim, const int32_t *blim, int32_t S,
                    int32_t tspace, int32_t max_segs, int32_t nthreads,
                    int32_t *trace, int32_t *nseg, int32_t *dsum) {
    /* abp_bbp: interleaved [abpos, bbpos] pairs (int32[2*S]) */
    BpJob j = {A, B, na, nb, astart, bstart, alim, blim, NULL, S, 0, 0,
               0, 0, tspace, max_segs, trace, nseg, dsum,
               (int32_t *)abp_bbp, 0, 0, 1};
    bp_run(&j, S, nthreads);
}

/* ---------------- stable radix argsort ----------------
 *
 * LSD byte-wise radix argsort of u64 keys (stable), used by the host
 * sort backend (ops/sort.py DAMAR_SORT=host) in place of numpy's
 * mergesort argsort: the seeding stage's banding/index sorts are the
 * CPU fallback's hottest host op.  A prescan skips passes whose byte
 * never varies (typical keys use <48 bits -> 3-5 passes).
 */
typedef struct {
    uint64_t *ks, *kd;
    uint32_t *is, *id;
    int64_t lo, hi;
    int shift;
    uint64_t dmask;
    int64_t *cnt;        /* this thread's digit histogram / offsets */
} RxJob;

static void *rx_hist(void *vp) {
    RxJob *j = (RxJob *)vp;
    for (int64_t i = j->lo; i < j->hi; i++)
        j->cnt[(j->ks[i] >> j->shift) & j->dmask]++;
    return NULL;
}

static void *rx_scatter(void *vp) {
    RxJob *j = (RxJob *)vp;
    for (int64_t i = j->lo; i < j->hi; i++) {
        int64_t p = j->cnt[(j->ks[i] >> j->shift) & j->dmask]++;
        j->kd[p] = j->ks[i];
        j->id[p] = j->is[i];
    }
    return NULL;
}

int64_t radix_argsort_u64(const uint64_t *keys, int64_t n,
                          int64_t *order /* caller buffer [n] */) {
    if (n <= 0) return 0;
    if (n >= ((int64_t)1 << 31)) return -2;  /* u32 index domain */
    /* sort (key, idx) pairs so every pass streams sequentially;
     * 16-bit digits when n amortizes the 64k histogram; u32 indices
     * (the big banding sorts are memory-bound — 24B/element of pass
     * traffic instead of 32B).  Parallel per pass: per-thread chunk
     * histograms, a digit-major exclusive scan across
     * (digit, thread), per-thread scatters — stable because chunk
     * order is preserved within each digit. */
    uint64_t *k0 = (uint64_t *)malloc((size_t)n * 8);
    uint64_t *k1 = (uint64_t *)malloc((size_t)n * 8);
    uint32_t *i0 = (uint32_t *)malloc((size_t)n * 4);
    uint32_t *i1 = (uint32_t *)malloc((size_t)n * 4);
    if (!k0 || !k1 || !i0 || !i1) {
        free(k0); free(k1); free(i0); free(i1);
        return -1;
    }
    uint64_t all_or = 0, all_and = ~(uint64_t)0;
    for (int64_t i = 0; i < n; i++) {
        k0[i] = keys[i];
        i0[i] = (uint32_t)i;
        all_or |= keys[i];
        all_and &= keys[i];
    }
    uint64_t diff = all_or ^ all_and;
    const int dbits = n >= 65536 ? 16 : 8;
    const int nd = 1 << dbits;
    const uint64_t dmask = (uint64_t)(nd - 1);
    int nt = 1;
    if (n >= 262144) {
        long ncpu = sysconf(_SC_NPROCESSORS_ONLN);
        nt = ncpu < 1 ? 1 : (ncpu > 8 ? 8 : (int)ncpu);
    }
    int64_t *cnt = (int64_t *)malloc((size_t)nd * nt * 8);
    if (!cnt) {
        free(k0); free(k1); free(i0); free(i1);
        return -1;
    }
    uint64_t *ks = k0, *kd = k1;
    uint32_t *is = i0, *id = i1;
    pthread_t tid[8];
    RxJob jobs[8];
    int64_t per = (n + nt - 1) / nt;
    for (int shift = 0; shift < 64; shift += dbits) {
        if (!((diff >> shift) & dmask)) continue;
        memset(cnt, 0, (size_t)nd * nt * 8);
        for (int t = 0; t < nt; t++) {
            jobs[t] = (RxJob){ks, kd, is, id,
                              t * per, (t + 1) * per < n ? (t + 1) * per : n,
                              shift, dmask, cnt + (size_t)nd * t};
            if (jobs[t].lo > n) jobs[t].lo = n;
        }
        if (nt == 1) rx_hist(&jobs[0]);
        else {
            for (int t = 0; t < nt; t++)
                pthread_create(&tid[t], NULL, rx_hist, &jobs[t]);
            for (int t = 0; t < nt; t++) pthread_join(tid[t], NULL);
        }
        int64_t acc = 0;
        for (int v = 0; v < nd; v++)
            for (int t = 0; t < nt; t++) {
                int64_t c = cnt[(size_t)nd * t + v];
                cnt[(size_t)nd * t + v] = acc;
                acc += c;
            }
        if (nt == 1) rx_scatter(&jobs[0]);
        else {
            for (int t = 0; t < nt; t++)
                pthread_create(&tid[t], NULL, rx_scatter, &jobs[t]);
            for (int t = 0; t < nt; t++) pthread_join(tid[t], NULL);
        }
        uint64_t *kt = ks; ks = kd; kd = kt;
        uint32_t *it = is; is = id; id = it;
    }
    for (int64_t i = 0; i < n; i++)
        order[i] = (int64_t)is[i];
    free(k0); free(k1); free(i0); free(i1); free(cnt);
    return 0;
}

/* ---------------- canonical k-mer codes ----------------
 *
 * Exact replica of ops/kmers.py kmer_codes_canonical for the host
 * seeding path (ops/seeding_host.py): per window, canonical
 * min(code, rc) + strand bit; invalid windows (cross-read, tail,
 * masked, pad bases) get 4**k.
 */
void canon_kmers(const uint8_t *bases, int64_t n, const int32_t *read_id,
                 const uint8_t *mask /* may be NULL */, int32_t k,
                 uint32_t *codes_out, uint8_t *strand_out) {
    const uint32_t inval = ((uint32_t)1) << (2 * k);
    const uint32_t cmask = inval - 1;
    if (n < k) {               /* no whole window fits: all invalid */
        for (int64_t i = 0; i < n; i++) {
            codes_out[i] = inval;
            strand_out[i] = 0;
        }
        return;
    }
    /* rolling window, branch-light: prime k-1 bases, then one new
     * base per position; tail positions (i > n - k) are invalid by
     * contract (kmer_codes_canonical's idx <= n - k) */
    uint32_t code = 0, rc = 0;
    for (int32_t j = 0; j < k - 1; j++) {
        uint32_t b = bases[j] & 3u;
        code = (code << 2) | b;
        rc = (rc >> 2) | ((3u - b) << (2 * (k - 1)));
    }
    for (int64_t i = 0; i + k <= n; i++) {
        uint32_t b = bases[i + k - 1] & 3u;
        code = ((code << 2) | b) & cmask;
        rc = (rc >> 2) | ((3u - b) << (2 * (k - 1)));
        int valid = bases[i] < 4 && read_id[i] == read_id[i + k - 1]
            && !(mask && mask[i]);
        uint32_t canon = rc < code ? rc : code;
        codes_out[i] = valid ? canon : inval;
        strand_out[i] = (uint8_t)(valid && rc < code);
    }
    for (int64_t i = n - k + 1; i < n; i++) {
        codes_out[i] = inval;
        strand_out[i] = 0;
    }
}

/* ---------------- lockstep (SIMD) bp kernels ----------------
 *
 * VBL-lane transcriptions of the scalar bp_extend_unit/bp_trace_unit
 * above — the same layout the JAX kernels use ([S]-vector ops over
 * batched units), so -O3 -march=native auto-vectorizes the uint32
 * lane loops.  Semantics are IDENTICAL: per-lane masks reproduce the
 * JAX where()-gating, so outputs remain bit-identical to the JAX
 * kernels (tests/test_native_bp.py).  Lanes run until the whole
 * group finishes; inactive lanes keep evolving but all their output
 * updates are gated, exactly like the JAX batch.
 */
#define VBL 16

/* Chunk-local char prefill: each lane's rows consume CONTIGUOUS A and
 * B byte ranges (the band frame advances one diagonal per row), so the
 * per-row scalar gathers (int64 mul + clamp + load per lane — the row
 * loop's main cost next to the vectorized bit ops) become one bounded
 * copy per lane per BP_FILL-row sub-chunk, and the row loop reads the
 * lane-contiguous buffers with plain vector loads.  Out-of-range
 * indices reproduce bp_char's clamping exactly (the clamped bytes are
 * mask-neutralized garbage, but bit-identity is kept byte-for-byte). */
#define BP_FILL 256

static inline void bp_fill_a(const uint8_t *A, int64_t na, int64_t base,
                             int64_t sgn, int64_t v0, int n,
                             uint8_t *dst, int l) {
    /* dst[k*VBL + l] = A[clamp(base + sgn*(v0 + k))] & 3,  k < n */
    int64_t s0 = base + sgn * v0;
    int64_t lo, hi;                       /* in-range k interval */
    if (sgn > 0) {
        lo = s0 < 0 ? -s0 : 0;
        hi = na - s0;
    } else {
        lo = s0 - (na - 1) > 0 ? s0 - (na - 1) : 0;
        hi = s0 + 1;
    }
    if (lo > n) lo = n;
    if (hi > n) hi = n;
    if (hi < lo) hi = lo;
    uint8_t head = (uint8_t)(A[sgn > 0 ? 0 : na - 1] & 3);
    uint8_t tail = (uint8_t)(A[sgn > 0 ? na - 1 : 0] & 3);
    for (int64_t k = 0; k < lo; k++) dst[k * VBL + l] = head;
    if (sgn > 0) {
        const uint8_t *src = A + s0;
        for (int64_t k = lo; k < hi; k++)
            dst[k * VBL + l] = src[k] & 3;
    } else {
        for (int64_t k = lo; k < hi; k++)
            dst[k * VBL + l] = A[s0 - k] & 3;
    }
    for (int64_t k = hi; k < n; k++) dst[k * VBL + l] = tail;
}

static inline void bp_fill_b(const uint8_t *B, int64_t nb, int64_t base,
                             int64_t sgn, int64_t p0, int32_t bl, int n,
                             uint8_t *dst, int l) {
    /* dst[k*VBL + l] = (B[clamp(base + sgn*(p0+k))] & 3) << 1
     *                  | (0 <= p0+k < bl),  k < n */
    for (int64_t k = 0; k < n; k++) {
        int64_t p = p0 + k;
        int64_t bi = base + sgn * p;
        bi = bi < 0 ? 0 : (bi >= nb ? nb - 1 : bi);
        dst[k * VBL + l] = (uint8_t)(((B[bi] & 3) << 1)
                                     | (p >= 0 && p < bl));
    }
}

static void bp_extend_group(const uint8_t *A, int64_t na,
                            const uint8_t *B, int64_t nb,
                            const int32_t *ao, const int32_t *bo,
                            const int32_t *alim, const int32_t *blim,
                            const uint8_t *rev, int nl, int R,
                            int max_rows, int diff_cost, int xdrop,
                            int32_t *o_va, int32_t *o_vb, int32_t *o_d,
                            int32_t *o_s) {
    uint32_t VP[VBL], VN[VBL], PH[VBL], PL[VBL], PV[VBL], Eq[VBL];
    uint32_t ach[VBL], bch[VBL];
    int32_t Db[VBL], Dc[VBL], vbb[VBL], bs[VBL], bva[VBL], bvb[VBL];
    int32_t al[VBL], bl[VBL], aoo[VBL], boo[VBL];
    int64_t abase[VBL], bbase[VBL];
    int64_t sgn[VBL];
    uint8_t rv[VBL];
    int32_t act[VBL], died[VBL];
    for (int l = 0; l < VBL; l++) {
        int live = l < nl;
        al[l] = live ? alim[l] : 0;
        bl[l] = live ? blim[l] : 0;
        aoo[l] = live ? ao[l] : 0;
        boo[l] = live ? bo[l] : 0;
        rv[l] = live && rev ? rev[l] : 0;
        /* v-index -> base index is base + sgn * v for both dirs */
        sgn[l] = rv[l] ? -1 : 1;
        abase[l] = rv[l] ? (int64_t)aoo[l] - 1 : (int64_t)aoo[l];
        bbase[l] = rv[l] ? (int64_t)boo[l] - 1 : (int64_t)boo[l];
        bp_vinit(&VP[l], &VN[l], &Db[l]);
        Dc[l] = 0;
        vbb[l] = 1 - BP_CTR;
        bs[l] = bva[l] = bvb[l] = 0;
        act[l] = al[l] > 0;
    }
    int32_t rtot = 0;
    int any = 0;
    uint8_t abuf[BP_FILL * VBL];
    uint8_t bbuf[(BP_FILL + BP_BW) * VBL];
    for (int l = 0; l < VBL; l++) any |= act[l];
    while (any && rtot < max_rows) {
        for (int r0 = 0; r0 < R; r0 += BP_FILL) {
          int fl = R - r0 < BP_FILL ? R - r0 : BP_FILL;
          for (int l = 0; l < VBL; l++) {
              bp_fill_a(A, na, abase[l], sgn[l], (int64_t)rtot + r0,
                        fl, abuf, l);
              bp_fill_b(B, nb, bbase[l], sgn[l],
                        (int64_t)vbb[l] - 1 + r0, bl[l], fl + BP_BW,
                        bbuf, l);
          }
          if (r0 == 0) {
            for (int l = 0; l < VBL; l++) {
                PH[l] = PL[l] = PV[l] = 0;
                for (int j = 0; j < BP_BW; j++) {
                    uint32_t w = bbuf[j * VBL + l];
                    PH[l] |= ((w >> 2) & 1u) << j;
                    PL[l] |= ((w >> 1) & 1u) << j;
                    PV[l] |= (w & 1u) << j;
                }
                died[l] = 0;
            }
          }
          for (int rr = 0; rr < fl; rr++) {
            int r = r0 + rr;
            const uint8_t *arow = abuf + (size_t)rr * VBL;
            const uint8_t *brow = bbuf + ((size_t)rr + BP_BW) * VBL;
            for (int l = 0; l < VBL; l++) {
                ach[l] = arow[l];
                bch[l] = brow[l];
            }
            for (int l = 0; l < VBL; l++)
                Eq[l] = bp_eq(PH[l], PL[l], PV[l], ach[l]);
            for (int l = 0; l < VBL; l++) {
                uint32_t vp = VP[l], vn = VN[l];
                uint32_t X = Eq[l] | (vn >> 1);
                uint32_t seed = (X << 1) & vp;
                uint32_t G0 = X | (vp & (seed | ((seed + vp) ^ vp)));
                uint32_t g = ~G0;
                uint32_t gp = g << 1;
                uint32_t d = g ^ gp, ndm = ~d;
                uint32_t Z = ~(vp | vn);
                VP[l] = ((vp & ndm) | (Z & g & ~gp)) & 0xFFFFFFFEu;
                VN[l] = (((vn & ndm) | (Z & gp & G0)) & 0xFFFFFFFEu)
                        | (G0 & 1u);
                Db[l] += 1 + (int32_t)(vp & 1u) - (int32_t)(vn & 1u);
                Dc[l] += 1 - (int32_t)((G0 >> BP_CTR) & 1u);
            }
            int32_t t = rtot + r + 1;
            for (int l = 0; l < VBL; l++) {
                int32_t vc = vbb[l] + r + BP_CTR;
                int32_t sc = t + vc - diff_cost * Dc[l];
                int32_t ok = act[l] & (t <= al[l]) & (vc >= 0)
                             & (vc <= bl[l]);
                int32_t improve = ok & (sc > bs[l]);
                bs[l] = improve ? sc : bs[l];
                bva[l] = improve ? t : bva[l];
                bvb[l] = improve ? vc : bvb[l];
                died[l] |= ok & (sc < bs[l] - (xdrop + diff_cost));
            }
            for (int l = 0; l < VBL; l++) {
                uint32_t c = bch[l] >> 1, v = bch[l] & 1u;
                PH[l] = (PH[l] >> 1) | (((c >> 1) & 1u) << (BP_BW - 1));
                PL[l] = (PL[l] >> 1) | ((c & 1u) << (BP_BW - 1));
                PV[l] = (PV[l] >> 1) | (v << (BP_BW - 1));
            }
          }
        }
        int32_t t = rtot + R;
        for (int l = 0; l < VBL; l++) {
            int32_t D[BP_BW];
            bp_reconstruct(VP[l], VN[l], Db[l], D);
            int32_t vbt = vbb[l] + R - 1;
            int32_t smax = BP_NEG, jbest = 0;
            for (int j = 0; j < BP_BW; j++) {
                int32_t vbw = vbt + j;
                int32_t sw = (vbw >= 0 && vbw <= bl[l] && t <= al[l])
                             ? t + vbw - diff_cost * D[j] : BP_NEG;
                if (sw > smax) { smax = sw; jbest = j; }
            }
            if (act[l] && smax > bs[l]) {
                bs[l] = smax;
                bva[l] = t;
                bvb[l] = vbt + jbest;
            }
            act[l] = (uint8_t)(act[l] && smax >= bs[l] - xdrop
                               && t < al[l] && !died[l]);
            int32_t Dmin = BP_INF, jmin = 0;
            for (int j = 0; j < BP_BW; j++) {
                int32_t vbw = vbt + j;
                int32_t dm = (vbw >= 0 && vbw <= bl[l]) ? D[j] : BP_INF;
                if (dm < Dmin) { Dmin = dm; jmin = j; }
            }
            int32_t drift = act[l] ? jmin - BP_CTR : 0;
            int32_t Dn[BP_BW];
            for (int j = 0; j < BP_BW; j++) {
                int32_t ll = j + drift;
                int32_t idx = ll < 0 ? 0
                              : (ll > BP_BW - 1 ? BP_BW - 1 : ll);
                int32_t over = ll - idx;
                if (over < 0) over = -over;
                Dn[j] = D[idx] + over;
            }
            VP[l] = 1u;
            VN[l] = 0u;
            for (int j = 1; j < BP_BW; j++) {
                int32_t dl = Dn[j] - Dn[j - 1];
                if (dl > 0) VP[l] |= 1u << j;
                else if (dl < 0) VN[l] |= 1u << j;
            }
            Db[l] = Dn[0] - 1;
            Dc[l] = Dn[BP_CTR];
            vbb[l] = vbt + 1 + drift;
        }
        rtot = t;
        any = 0;
        for (int l = 0; l < VBL; l++) any |= act[l];
    }
    for (int l = 0; l < nl; l++) {
        if (bs[l] <= 0) {
            o_va[l] = o_vb[l] = o_d[l] = o_s[l] = 0;
        } else {
            o_va[l] = bva[l];
            o_vb[l] = bvb[l];
            o_d[l] = (bva[l] + bvb[l] - bs[l]) / diff_cost;
            o_s[l] = bs[l];
        }
    }
}

static void bp_trace_group(const uint8_t *A, int64_t na,
                           const uint8_t *B, int64_t nb,
                           const int32_t *astart, const int32_t *bstart,
                           const int32_t *abp_bbp, const int32_t *alim,
                           const int32_t *blim, int nl, int tspace,
                           int max_segs, int32_t *trace, int32_t *nseg,
                           int32_t *dsum) {
    uint32_t VP[VBL], VN[VBL], PH[VBL], PL[VBL], PV[VBL], Eq[VBL];
    uint32_t ach[VBL], bch[VBL];
    int32_t Db[VBL], vbb[VBL], done[VBL], prev_vb[VBL], ns[VBL],
        ds[VBL], segr[VBL], al[VBL], bl[VBL], abp[VBL];
    int64_t aor[VBL], bor[VBL];
    uint8_t go[VBL];
    for (int l = 0; l < VBL; l++) {
        int live = l < nl;
        al[l] = live ? alim[l] : 0;
        bl[l] = live ? blim[l] : 0;
        abp[l] = live ? abp_bbp[2 * l] : 0;
        aor[l] = live ? (int64_t)astart[l] + abp_bbp[2 * l] : 0;
        bor[l] = live ? (int64_t)bstart[l] + abp_bbp[2 * l + 1] : 0;
        bp_vinit(&VP[l], &VN[l], &Db[l]);
        vbb[l] = 1 - BP_CTR;
        done[l] = prev_vb[l] = ns[l] = ds[l] = 0;
    }
    int any = 0;
    uint8_t abuf[BP_FILL * VBL];
    uint8_t bbuf[(BP_FILL + BP_BW) * VBL];
    for (int l = 0; l < VBL; l++) any |= done[l] < al[l];
    while (any) {
        int32_t max_rows_g = 0;
        for (int l = 0; l < VBL; l++) {
            int live = done[l] < al[l];
            if (live) {
                int32_t a = abp[l] + done[l];
                int32_t nxt = (a / tspace + 1) * tspace - a;
                int32_t rem = al[l] - done[l];
                segr[l] = nxt < rem ? nxt : rem;
            } else {
                segr[l] = 0;
            }
            if (segr[l] > max_rows_g) max_rows_g = segr[l];
        }
        for (int r0 = 0; r0 < max_rows_g; r0 += BP_FILL) {
          int fl = max_rows_g - r0 < BP_FILL ? max_rows_g - r0
                                             : BP_FILL;
          for (int l = 0; l < VBL; l++) {
              bp_fill_a(A, na, aor[l], 1, (int64_t)done[l] + r0, fl,
                        abuf, l);
              bp_fill_b(B, nb, bor[l], 1, (int64_t)vbb[l] - 1 + r0,
                        bl[l], fl + BP_BW, bbuf, l);
          }
          if (r0 == 0) {
            for (int l = 0; l < VBL; l++) {
                PH[l] = PL[l] = PV[l] = 0;
                for (int j = 0; j < BP_BW; j++) {
                    uint32_t w = bbuf[j * VBL + l];
                    PH[l] |= ((w >> 2) & 1u) << j;
                    PL[l] |= ((w >> 1) & 1u) << j;
                    PV[l] |= (w & 1u) << j;
                }
            }
          }
          for (int rr = 0; rr < fl; rr++) {
            int r = r0 + rr;
            const uint8_t *arow = abuf + (size_t)rr * VBL;
            const uint8_t *brow = bbuf + ((size_t)rr + BP_BW) * VBL;
            for (int l = 0; l < VBL; l++) {
                go[l] = r < segr[l];
                ach[l] = arow[l];
                bch[l] = brow[l];
            }
            for (int l = 0; l < VBL; l++)
                Eq[l] = bp_eq(PH[l], PL[l], PV[l], ach[l]);
            for (int l = 0; l < VBL; l++) {
                uint32_t gm = go[l] ? 0xFFFFFFFFu : 0u;
                uint32_t vp = VP[l], vn = VN[l];
                uint32_t X = Eq[l] | (vn >> 1);
                uint32_t seed = (X << 1) & vp;
                uint32_t G0 = X | (vp & (seed | ((seed + vp) ^ vp)));
                uint32_t g = ~G0;
                uint32_t gp = g << 1;
                uint32_t d = g ^ gp, ndm = ~d;
                uint32_t Z = ~(vp | vn);
                uint32_t VPn = ((vp & ndm) | (Z & g & ~gp))
                               & 0xFFFFFFFEu;
                uint32_t VNn = (((vn & ndm) | (Z & gp & G0))
                                & 0xFFFFFFFEu) | (G0 & 1u);
                int32_t Dbn = Db[l] + 1 + (int32_t)(vp & 1u)
                              - (int32_t)(vn & 1u);
                VP[l] = (VPn & gm) | (vp & ~gm);
                VN[l] = (VNn & gm) | (vn & ~gm);
                Db[l] = go[l] ? Dbn : Db[l];
                uint32_t c = bch[l] >> 1, v = bch[l] & 1u;
                uint32_t PHn = (PH[l] >> 1)
                               | (((c >> 1) & 1u) << (BP_BW - 1));
                uint32_t PLn = (PL[l] >> 1) | ((c & 1u) << (BP_BW - 1));
                uint32_t PVn = (PV[l] >> 1) | (v << (BP_BW - 1));
                PH[l] = (PHn & gm) | (PH[l] & ~gm);
                PL[l] = (PLn & gm) | (PL[l] & ~gm);
                PV[l] = (PVn & gm) | (PV[l] & ~gm);
            }
          }
        }
        for (int l = 0; l < VBL; l++) {
            if (done[l] >= al[l]) continue;       /* frozen lane */
            int32_t va = done[l] + segr[l];
            int at_end = va == al[l];
            int32_t vbe = vbb[l] + segr[l] - 1;
            int32_t D[BP_BW];
            bp_reconstruct(VP[l], VN[l], Db[l], D);
            int32_t Dmin = BP_INF, jmin = 0;
            for (int j = 0; j < BP_BW; j++) {
                int32_t vbw = vbe + j;
                int32_t dm = (vbw >= 0 && vbw <= bl[l]
                              && vbw > prev_vb[l]) ? D[j] : BP_INF;
                if (dm < Dmin) { Dmin = dm; jmin = j; }
            }
            int32_t j_end = bl[l] - vbe;
            if (j_end < 0) j_end = 0;
            if (j_end > BP_BW - 1) j_end = BP_BW - 1;
            int32_t j_com = at_end ? j_end : jmin;
            int32_t vb_com = vbe + j_com;
            if (vb_com < prev_vb[l]) vb_com = prev_vb[l];
            if (vb_com > bl[l]) vb_com = bl[l];
            int32_t d_com = D[j_com];
            if (d_com >= BP_INF) d_com = al[l] + bl[l];
            int32_t slot = ns[l] < max_segs - 1 ? ns[l] : max_segs - 1;
            int32_t *tr = trace + ((size_t)l * max_segs + slot) * 2;
            tr[0] = d_com;
            tr[1] = vb_com - prev_vb[l];
            bp_vinit(&VP[l], &VN[l], &Db[l]);
            vbb[l] = vb_com - BP_CTR + 1;
            done[l] += segr[l];
            ns[l] += 1;
            prev_vb[l] = vb_com;
            ds[l] += d_com;
        }
        any = 0;
        for (int l = 0; l < VBL; l++) any |= done[l] < al[l];
    }
    for (int l = 0; l < nl; l++) {
        nseg[l] = ns[l];
        dsum[l] = ds[l];
    }
}

/* ---------------- diagonal band filter ----------------
 *
 * C core of the host seeding twin's banding stage
 * (ops/seeding_host.py _band_filter; semantics of ops/seeding.py
 * _diag_filter_impl): double-bucket hits into diagonal bands, stable
 * sort by (ar, br, strand, bucket, apos), sum novel k-mer coverage
 * per band, emit the first hit of every band reaching hit_min.
 * Inputs are the LIVE hits only (caller applies the upper-triangle
 * rule).  Returns the band count (total_seeds) or negative on error;
 * seeds beyond seed_cap are counted but not written.
 */
int64_t band_filter(const int32_t *apos, const int32_t *bpos,
                    const uint8_t *comp, const int32_t *ar,
                    const int32_t *br, int64_t n, int64_t bcap,
                    int32_t band_shift, int32_t kmer, int32_t hit_min,
                    int32_t read_bits, int32_t bucket_bits,
                    int32_t pos_bits, int64_t seed_cap, int32_t *s_ar,
                    int32_t *s_br, int32_t *s_ap, int32_t *s_bp,
                    int32_t *s_cov, int32_t *s_comp,
                    int64_t *nseeds_out) {
    if (2 * read_bits + 1 + bucket_bits > 64)
        return -9;                     /* caller falls back to numpy */
    int fused = 2 * read_bits + 1 + bucket_bits + pos_bits <= 64;
    int64_t m = 2 * n;
    uint64_t *key = (uint64_t *)malloc((size_t)m * 8);
    int64_t *ord = (int64_t *)malloc((size_t)m * 8);
    if ((!key || !ord) && m) {
        free(key); free(ord);
        return -1;
    }
    for (int64_t e = 0; e < m; e++) {
        int64_t s = e < n ? e : e - n;
        uint64_t bkt = (uint64_t)(((int64_t)apos[s] - bpos[s] + bcap)
                                  >> band_shift) + (e < n ? 0 : 1);
        uint64_t k2 = ((((((uint64_t)ar[s] << read_bits)
                          | (uint64_t)br[s]) << 1)
                        | (uint64_t)(comp[s] & 1)) << bucket_bits)
                      | bkt;
        key[e] = fused ? (k2 << pos_bits) | (uint64_t)apos[s] : k2;
    }
    int64_t rc;
    if (fused) {
        rc = radix_argsort_u64(key, m, ord);
    } else {
        /* two-pass stable sort (apos, then the band key over the
         * permuted entries) == one lexicographic sort; needed when
         * band key + apos exceed 64 bits (big blocks) */
        uint64_t *ap64 = (uint64_t *)malloc((size_t)m * 8);
        int64_t *o1 = (int64_t *)malloc((size_t)m * 8);
        if ((!ap64 || !o1) && m) {
            free(ap64); free(o1); free(key); free(ord);
            return -1;
        }
        for (int64_t e = 0; e < m; e++)
            ap64[e] = (uint64_t)apos[e < n ? e : e - n];
        rc = radix_argsort_u64(ap64, m, o1);
        if (rc == 0) {
            for (int64_t e = 0; e < m; e++)
                ap64[e] = key[o1[e]];         /* permuted band keys */
            rc = radix_argsort_u64(ap64, m, ord);
            for (int64_t e = 0; e < m; e++)
                ord[e] = o1[ord[e]];
        }
        free(ap64);
        free(o1);
    }
    if (rc != 0) {
        free(key); free(ord);
        return rc;
    }
    /* one linear pass: segment = run of equal band keys (key without
     * the apos field); novel coverage = min(apos - prev_apos, kmer) */
    int64_t nseeds = 0, total = 0;
    int64_t seg_first = -1;
    int32_t seg_sum = 0, prev_ap = 0;
    uint64_t prev_band = ~(uint64_t)0;
    for (int64_t i = 0; i <= m; i++) {
        uint64_t band = ~(uint64_t)0;
        int32_t ap = 0;
        if (i < m) {
            int64_t e = ord[i];
            band = fused ? key[e] >> pos_bits : key[e];
            ap = apos[e < n ? e : e - n];
        }
        if (i == m || band != prev_band) {
            if (seg_first >= 0 && seg_sum >= hit_min) {
                if (total < seed_cap) {
                    int64_t s = ord[seg_first] < n ? ord[seg_first]
                                : ord[seg_first] - n;
                    s_ar[nseeds] = ar[s];
                    s_br[nseeds] = br[s];
                    s_ap[nseeds] = apos[s];
                    s_bp[nseeds] = bpos[s];
                    s_cov[nseeds] = seg_sum;
                    s_comp[nseeds] = comp[s] & 1;
                    nseeds++;
                }
                total++;
            }
            if (i == m) break;
            seg_first = i;
            seg_sum = kmer;
        } else {
            int32_t cov = ap - prev_ap;
            if (cov > kmer) cov = kmer;
            if (cov < 0) cov = 0;
            seg_sum += cov;
        }
        prev_ap = ap;
        prev_band = band;
    }
    free(key);
    free(ord);
    *nseeds_out = nseeds;
    return total;
}

/* ---------------- 64-diagonal bp trace (retry tier) ----------------
 *
 * uint64 variant of the lockstep trace kernel: BW=64 diagonals per
 * band word, CTR=32.  Serves as the FIRST retry tier for records
 * whose alignment drifts past the 32-diagonal band within a segment
 * (~1% of records) — ~2x the cost of the 32-lane kernel vs ~100x for
 * the wide per-cell DP, which remains the final fallback.  Same
 * formulas as bp_trace_group with 64-bit words.
 */
#define BQ_BW  64
#define BQ_CTR 32
#define VQL 8

static void bq_trace_group(const uint8_t *A, int64_t na,
                           const uint8_t *B, int64_t nb,
                           const int32_t *astart, const int32_t *bstart,
                           const int32_t *abp_bbp, const int32_t *alim,
                           const int32_t *blim, int nl, int tspace,
                           int max_segs, int32_t *trace, int32_t *nseg,
                           int32_t *dsum) {
    uint64_t VP[VQL], VN[VQL], PH[VQL], PL[VQL], PV[VQL], Eq[VQL];
    uint64_t ach[VQL], bch[VQL];
    int64_t Db[VQL];
    int32_t vbb[VQL], done[VQL], prev_vb[VQL], ns[VQL], ds[VQL],
        segr[VQL], al[VQL], bl[VQL], abp[VQL];
    int64_t aor[VQL], bor[VQL];
    uint8_t go[VQL];
    for (int l = 0; l < VQL; l++) {
        int live = l < nl;
        al[l] = live ? alim[l] : 0;
        bl[l] = live ? blim[l] : 0;
        abp[l] = live ? abp_bbp[2 * l] : 0;
        aor[l] = live ? (int64_t)astart[l] + abp_bbp[2 * l] : 0;
        bor[l] = live ? (int64_t)bstart[l] + abp_bbp[2 * l + 1] : 0;
        VN[l] = (((uint64_t)1) << (BQ_CTR + 1)) - 1;
        VP[l] = ~VN[l];
        Db[l] = BQ_CTR + 1;
        vbb[l] = 1 - BQ_CTR;
        done[l] = prev_vb[l] = ns[l] = ds[l] = 0;
    }
    int any = 0;
    for (int l = 0; l < VQL; l++) any |= done[l] < al[l];
    while (any) {
        int32_t max_rows_g = 0;
        for (int l = 0; l < VQL; l++) {
            int live = done[l] < al[l];
            if (live) {
                int32_t a = abp[l] + done[l];
                int32_t nxt = (a / tspace + 1) * tspace - a;
                int32_t rem = al[l] - done[l];
                segr[l] = nxt < rem ? nxt : rem;
            } else {
                segr[l] = 0;
            }
            if (segr[l] > max_rows_g) max_rows_g = segr[l];
            PH[l] = PL[l] = PV[l] = 0;
            for (int j = 0; j < BQ_BW; j++) {
                int32_t p = vbb[l] - 1 + j;
                uint64_t c = (uint64_t)bp_char(B, nb, bor[l] + p);
                PH[l] |= ((c >> 1) & 1u) << j;
                PL[l] |= (c & 1u) << j;
                PV[l] |= (uint64_t)(p >= 0 && p < bl[l]) << j;
            }
        }
        for (int r = 0; r < max_rows_g; r++) {
            for (int l = 0; l < VQL; l++) {
                go[l] = r < segr[l];
                ach[l] = (uint64_t)bp_char(A, na,
                                           aor[l] + done[l] + r);
                int32_t nbp = vbb[l] + r + BQ_BW - 1;
                bch[l] = ((uint64_t)bp_char(B, nb, bor[l] + nbp) << 1)
                         | (uint64_t)(nbp >= 0 && nbp < bl[l]);
            }
            for (int l = 0; l < VQL; l++) {
                uint64_t mh = ((ach[l] >> 1) & 1u) - 1u;
                uint64_t ml = (ach[l] & 1u) - 1u;
                Eq[l] = (PH[l] ^ mh) & (PL[l] ^ ml) & PV[l];
            }
            for (int l = 0; l < VQL; l++) {
                uint64_t gm = go[l] ? ~(uint64_t)0 : 0;
                uint64_t vp = VP[l], vn = VN[l];
                uint64_t X = Eq[l] | (vn >> 1);
                uint64_t seed = (X << 1) & vp;
                uint64_t G0 = X | (vp & (seed | ((seed + vp) ^ vp)));
                uint64_t g = ~G0;
                uint64_t gp = g << 1;
                uint64_t d = g ^ gp, ndm = ~d;
                uint64_t Z = ~(vp | vn);
                uint64_t VPn = ((vp & ndm) | (Z & g & ~gp))
                               & ~(uint64_t)1;
                uint64_t VNn = (((vn & ndm) | (Z & gp & G0))
                                & ~(uint64_t)1) | (G0 & 1u);
                int64_t Dbn = Db[l] + 1 + (int64_t)(vp & 1u)
                              - (int64_t)(vn & 1u);
                VP[l] = (VPn & gm) | (vp & ~gm);
                VN[l] = (VNn & gm) | (vn & ~gm);
                Db[l] = go[l] ? Dbn : Db[l];
                uint64_t c = bch[l] >> 1, v = bch[l] & 1u;
                uint64_t PHn = (PH[l] >> 1)
                               | (((c >> 1) & 1u) << (BQ_BW - 1));
                uint64_t PLn = (PL[l] >> 1)
                               | ((c & 1u) << (BQ_BW - 1));
                uint64_t PVn = (PV[l] >> 1) | (v << (BQ_BW - 1));
                PH[l] = (PHn & gm) | (PH[l] & ~gm);
                PL[l] = (PLn & gm) | (PL[l] & ~gm);
                PV[l] = (PVn & gm) | (PV[l] & ~gm);
            }
        }
        for (int l = 0; l < VQL; l++) {
            if (done[l] >= al[l]) continue;
            int32_t va = done[l] + segr[l];
            int at_end = va == al[l];
            int32_t vbe = vbb[l] + segr[l] - 1;
            int64_t D[BQ_BW];
            {
                int64_t v = Db[l];
                for (int j = 0; j < BQ_BW; j++) {
                    v += (int64_t)((VP[l] >> j) & 1u)
                         - (int64_t)((VN[l] >> j) & 1u);
                    D[j] = v;
                }
            }
            int64_t Dmin = BP_INF;
            int32_t jmin = 0;
            for (int j = 0; j < BQ_BW; j++) {
                int32_t vbw = vbe + j;
                int64_t dm = (vbw >= 0 && vbw <= bl[l]
                              && vbw > prev_vb[l]) ? D[j] : BP_INF;
                if (dm < Dmin) { Dmin = dm; jmin = j; }
            }
            int32_t j_end = bl[l] - vbe;
            if (j_end < 0) j_end = 0;
            if (j_end > BQ_BW - 1) j_end = BQ_BW - 1;
            int32_t j_com = at_end ? j_end : jmin;
            int32_t vb_com = vbe + j_com;
            if (vb_com < prev_vb[l]) vb_com = prev_vb[l];
            if (vb_com > bl[l]) vb_com = bl[l];
            int64_t d_com = D[j_com];
            if (d_com >= BP_INF) d_com = al[l] + bl[l];
            int32_t slot = ns[l] < max_segs - 1 ? ns[l] : max_segs - 1;
            int32_t *tr = trace + ((size_t)l * max_segs + slot) * 2;
            tr[0] = (int32_t)d_com;
            tr[1] = vb_com - prev_vb[l];
            VN[l] = (((uint64_t)1) << (BQ_CTR + 1)) - 1;
            VP[l] = ~VN[l];
            Db[l] = BQ_CTR + 1;
            vbb[l] = vb_com - BQ_CTR + 1;
            done[l] += segr[l];
            ns[l] += 1;
            prev_vb[l] = vb_com;
            ds[l] += (int32_t)d_com;
        }
        any = 0;
        for (int l = 0; l < VQL; l++) any |= done[l] < al[l];
    }
    for (int l = 0; l < nl; l++) {
        nseg[l] = ns[l];
        dsum[l] = ds[l];
    }
}

typedef struct {
    const uint8_t *A, *B;
    int64_t na, nb;
    const int32_t *as, *bs, *ab, *al, *bl;
    int32_t S, tspace, max_segs, glo, ghi;
    int32_t *tr, *ns, *ds;
} BqJob;

static void *bq_worker(void *vp) {
    BqJob *q = (BqJob *)vp;
    for (int32_t gg = q->glo; gg < q->ghi; gg++) {
        int32_t u = gg * VQL;
        int nl = q->S - u < VQL ? q->S - u : VQL;
        bq_trace_group(q->A, q->na, q->B, q->nb, q->as + u, q->bs + u,
                       q->ab + 2 * u, q->al + u, q->bl + u, nl,
                       q->tspace, q->max_segs,
                       q->tr + (size_t)u * q->max_segs * 2,
                       q->ns + u, q->ds + u);
    }
    return NULL;
}

void bp_trace64_batch(const uint8_t *A, int64_t na, const uint8_t *B,
                      int64_t nb, const int32_t *astart,
                      const int32_t *bstart, const int32_t *abp_bbp,
                      const int32_t *alim, const int32_t *blim,
                      int32_t S, int32_t tspace, int32_t max_segs,
                      int32_t nthreads, int32_t *trace, int32_t *nseg,
                      int32_t *dsum) {
    if (nthreads < 1) nthreads = 1;
    if (nthreads > 16) nthreads = 16;
    int32_t groups = (S + VQL - 1) / VQL;
    if (groups < 1) return;
    if (nthreads > groups) nthreads = groups;
    int32_t per_g = (groups + nthreads - 1) / nthreads;
    BqJob qs[16];
    pthread_t tid[16];
    int nt = 0;
    for (int i = 0; i < nthreads; i++) {
        int32_t glo = i * per_g;
        if (glo >= groups) break;
        qs[nt] = (BqJob){A, B, na, nb, astart, bstart, abp_bbp, alim,
                         blim, S, tspace, max_segs, glo,
                         glo + per_g < groups ? glo + per_g : groups,
                         trace, nseg, dsum};
        nt++;
    }
    if (nt == 1) {
        bq_worker(&qs[0]);
        return;
    }
    for (int i = 0; i < nt; i++)
        pthread_create(&tid[i], NULL, bq_worker, &qs[i]);
    for (int i = 0; i < nt; i++)
        pthread_join(tid[i], NULL);
}

/* ---------------- per-read reverse complement ----------------
 *
 * COMP-pass block preparation (core/blocks.py revcomp_block): each
 * read's span reversed and complemented in place.  Sequential writes,
 * reversed reads per read — the numpy gather form costs ~0.25 s per
 * 10 Mbp block, this ~15 ms.
 */
void revcomp_reads(const uint8_t *bases, const int32_t *starts,
                   int32_t nreads, uint8_t *out) {
    for (int32_t r = 0; r < nreads; r++) {
        const uint8_t *src = bases + starts[r + 1];
        uint8_t *dst = out + starts[r];
        int32_t len = starts[r + 1] - starts[r];
        for (int32_t i = 0; i < len; i++)
            dst[i] = (uint8_t)(3 - src[-1 - i]);
    }
}

/* Plain (forward-only) k-mer codes — exact replica of
 * ops/kmers.py kmer_codes for the host tandem-seeding path. */
void plain_kmers(const uint8_t *bases, int64_t n, const int32_t *read_id,
                 const uint8_t *mask /* may be NULL */, int32_t k,
                 uint32_t *codes_out) {
    const uint32_t inval = ((uint32_t)1) << (2 * k);
    const uint32_t cmask = inval - 1;
    if (n < k) {
        for (int64_t i = 0; i < n; i++) codes_out[i] = inval;
        return;
    }
    uint32_t code = 0;
    for (int32_t j = 0; j < k - 1; j++)
        code = (code << 2) | (bases[j] & 3u);
    for (int64_t i = 0; i + k <= n; i++) {
        code = ((code << 2) | (bases[i + k - 1] & 3u)) & cmask;
        int valid = bases[i] < 4 && read_id[i] == read_id[i + k - 1]
            && !(mask && mask[i]);
        codes_out[i] = valid ? code : inval;
    }
    for (int64_t i = n - k + 1; i < n; i++)
        codes_out[i] = inval;
}

/* ---------------- DUST low-complexity scan ----------------
 *
 * Exact replica of utils/dust.py dust_read over a batch of reads:
 * triplet-repetitiveness windows via an O(n) sliding histogram (the
 * numpy form builds an [m,64] prefix matrix per read).  Interval
 * emission and merging mirror the Python loop byte-for-byte.
 */
int64_t dust_batch(const uint8_t *bases, const int64_t *starts,
                   int32_t nreads, int32_t window, double thresh,
                   int32_t *out, int64_t out_cap,
                   int64_t *out_offs /* nreads + 1 */) {
    int64_t pos = 0;
    out_offs[0] = 0;
    const int32_t w = window - 2;          /* triplets per window */
    const double denom = (double)(w - 1 > 1 ? w - 1 : 1);
    for (int32_t r = 0; r < nreads; r++) {
        const uint8_t *s = bases + starts[r];
        const int64_t n = starts[r + 1] - starts[r];
        const int64_t m = n - 2;
        if (m < window) {
            out_offs[r + 1] = pos;
            continue;
        }
        int32_t cnt[64] = {0};
        int64_t isum = 0;                  /* sum c*(c-1) */
        int64_t lo = -1, hi = -1;
        for (int64_t i = 0; i < m; i++) {
            int t_in = ((s[i] & 3) << 4) | ((s[i + 1] & 3) << 2)
                       | (s[i + 2] & 3);
            isum += 2 * cnt[t_in];
            cnt[t_in]++;
            if (i >= w) {
                int64_t j = i - w;
                int t_out = ((s[j] & 3) << 4) | ((s[j + 1] & 3) << 2)
                            | (s[j + 2] & 3);
                cnt[t_out]--;
                isum -= 2 * cnt[t_out];
            }
            if (i >= w - 1) {
                int64_t st = i - (w - 1);   /* window start */
                double score = ((double)isum) / 2.0 / denom;
                if (score > thresh) {
                    if (lo < 0) {
                        lo = st;
                        hi = st + window;
                    } else if (st <= hi) {
                        hi = st + window;
                    } else {
                        if (pos + 2 > out_cap) return -1;
                        out[pos++] = (int32_t)lo;
                        out[pos++] = (int32_t)hi;
                        lo = st;
                        hi = st + window;
                    }
                }
            }
        }
        if (lo >= 0) {
            if (pos + 2 > out_cap) return -1;
            out[pos++] = (int32_t)lo;
            out[pos++] = (int32_t)(hi < n ? hi : n);
        }
        out_offs[r + 1] = pos;
    }
    return pos;
}

/* ---------------- seeding host helpers ----------------
 *
 * run_firsts: segment structure of a sorted code stream — starts[i] =
 * index of the first element of i's equal-code run, cnt[i] = run
 * length.  Exact replica of ops/seeding_host.py _run_firsts (one pass
 * instead of accumulate + flatnonzero + double repeat).
 */
void run_firsts(const uint32_t *codes, int64_t n, int64_t *starts,
                int64_t *cnt) {
    int64_t s = 0;
    for (int64_t i = 1; i <= n; i++) {
        if (i == n || codes[i] != codes[s]) {
            int64_t len = i - s;
            for (int64_t j = s; j < i; j++) {
                starts[j] = s;
                cnt[j] = len;
            }
            s = i;
        }
    }
}

/* fill_hits_strand: fused hit materialization + strand split + rc
 * mapping for the canonical seeding path — exact replica of
 * ops/seeding_host.py _fill_hits followed by the strand-split block
 * in find_seeds_canonical_host (B-tuple-major enumeration truncated
 * at cap, comp = strand_a ^ strand_b, comp bpos mapped to the
 * per-read rc frame).  Threads split the OUTPUT range so order is
 * byte-identical to the numpy twin. */
typedef struct {
    const int32_t *a_pos2, *b_pos2;
    const int64_t *lo, *cum;
    const int32_t *b_rid;
    const int64_t *b_starts;
    int32_t k;
    int64_t ntuples;
    int64_t o0, o1;
    int32_t *apos, *bpos;
    uint8_t *comp;
} FhJob;

static void *fh_worker(void *vp) {
    FhJob *j = (FhJob *)vp;
    int64_t lo_t = 0, hi_t = j->ntuples;
    while (lo_t < hi_t) {          /* first t with cum[t+1] > o0 */
        int64_t mid = lo_t + (hi_t - lo_t) / 2;
        if (j->cum[mid + 1] > j->o0) hi_t = mid;
        else lo_t = mid + 1;
    }
    int64_t out = j->o0;
    for (int64_t t = lo_t; t < j->ntuples && out < j->o1; t++) {
        int64_t base = j->cum[t];
        int64_t end = j->cum[t + 1];
        if (end == base) continue;
        const int32_t bp2 = j->b_pos2[t];
        const int64_t bposf = (int64_t)(bp2 >> 1);
        const int32_t r = j->b_rid[bposf];
        const int64_t rc_base = j->b_starts[r] + j->b_starts[r + 1]
            - bposf - j->k;
        const int64_t a0 = j->lo[t];
        int64_t stop = end < j->o1 ? end : j->o1;
        for (; out < stop; out++) {
            int32_t ap2 = j->a_pos2[a0 + (out - base)];
            uint8_t cm = (uint8_t)((ap2 ^ bp2) & 1);
            j->apos[out] = ap2 >> 1;
            j->comp[out] = cm;
            j->bpos[out] = cm ? (int32_t)rc_base : (int32_t)bposf;
        }
    }
    return NULL;
}

int64_t fill_hits_strand(const int32_t *a_pos2, const int32_t *b_pos2,
                         const int64_t *lo, const int64_t *c,
                         int64_t ntuples, int64_t cap,
                         const int32_t *b_rid, const int64_t *b_starts,
                         int32_t k, int32_t nthreads,
                         int32_t *apos, int32_t *bpos, uint8_t *comp,
                         int64_t *total_out) {
    int64_t *cum = (int64_t *)malloc(((size_t)ntuples + 1) * 8);
    if (!cum) return -1;
    cum[0] = 0;
    for (int64_t i = 0; i < ntuples; i++) cum[i + 1] = cum[i] + c[i];
    int64_t total = cum[ntuples];
    *total_out = total;
    int64_t nhits = total < cap ? total : cap;
    if (nhits <= 0) {
        free(cum);
        return nhits < 0 ? -1 : 0;
    }
    int nt = nthreads < 1 ? 1 : (nthreads > 8 ? 8 : nthreads);
    if (nhits < 262144) nt = 1;
    pthread_t tid[8];
    FhJob jobs[8];
    int64_t per = (nhits + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t o0 = t * per, o1 = o0 + per;
        if (o0 > nhits) o0 = nhits;
        if (o1 > nhits) o1 = nhits;
        jobs[t] = (FhJob){a_pos2, b_pos2, lo, cum, b_rid, b_starts, k,
                          ntuples, o0, o1, apos, bpos, comp};
    }
    if (nt == 1) fh_worker(&jobs[0]);
    else {
        for (int t = 0; t < nt; t++)
            pthread_create(&tid[t], NULL, fh_worker, &jobs[t]);
        for (int t = 0; t < nt; t++) pthread_join(tid[t], NULL);
    }
    free(cum);
    return nhits;
}

/* self_hit_counts: fused self-pair tuple counts for the canonical
 * seeding path — one pass producing what seeding_host's self_pair
 * branch derives from run_firsts in five array passes:
 *   lo[i] = segment start index of i's equal-code run
 *   c[i]  = i's rank within its run when the code is live
 *           (code != inval and run length <= tmax), else 0
 */
void self_hit_counts(const uint32_t *codes, int64_t n, uint32_t inval,
                     int64_t tmax, int64_t *lo, int64_t *c) {
    int64_t s = 0;
    for (int64_t i = 1; i <= n; i++) {
        if (i == n || codes[i] != codes[s]) {
            int64_t len = i - s;
            if (codes[s] != inval && len <= tmax) {
                for (int64_t j = s; j < i; j++) {
                    lo[j] = s;
                    c[j] = j - s;
                }
            } else {
                for (int64_t j = s; j < i; j++) {
                    lo[j] = s;
                    c[j] = 0;
                }
            }
            s = i;
        }
    }
}

/* ---------------- v3 packed-payload seeding twins ----------------
 *
 * fill_hits_packed: packed twin of fill_hits_strand — the same
 * B-tuple-major run expansion truncated at cap, but payloads are the
 * v3 packed (rid, read-local pos, strand) words carried verbatim
 * (strand split and rc mapping move to the band filter / seed
 * emission).  Threads split the OUTPUT range so order is
 * byte-identical to the numpy twin (_fill_hits_packed_np).
 */
typedef struct {
    const uint32_t *a_mp, *b_mp;
    const int64_t *lo, *cum;
    int64_t ntuples;
    int64_t o0, o1;
    uint32_t *ap, *bp;
} FpJob;

static void *fp_worker(void *vp) {
    FpJob *j = (FpJob *)vp;
    int64_t lo_t = 0, hi_t = j->ntuples;
    while (lo_t < hi_t) {          /* first t with cum[t+1] > o0 */
        int64_t mid = lo_t + (hi_t - lo_t) / 2;
        if (j->cum[mid + 1] > j->o0) hi_t = mid;
        else lo_t = mid + 1;
    }
    int64_t out = j->o0;
    for (int64_t t = lo_t; t < j->ntuples && out < j->o1; t++) {
        int64_t base = j->cum[t];
        int64_t end = j->cum[t + 1];
        if (end == base) continue;
        const uint32_t bmp = j->b_mp[t];
        const int64_t a0 = j->lo[t];
        int64_t stop = end < j->o1 ? end : j->o1;
        for (; out < stop; out++) {
            j->ap[out] = j->a_mp[a0 + (out - base)];
            j->bp[out] = bmp;
        }
    }
    return NULL;
}

int64_t fill_hits_packed(const uint32_t *a_mp, const uint32_t *b_mp,
                         const int64_t *lo, const int64_t *c,
                         int64_t ntuples, int64_t cap, int32_t nthreads,
                         uint32_t *ap, uint32_t *bp,
                         int64_t *total_out) {
    int64_t *cum = (int64_t *)malloc(((size_t)ntuples + 1) * 8);
    if (!cum) return -1;
    cum[0] = 0;
    for (int64_t i = 0; i < ntuples; i++) cum[i + 1] = cum[i] + c[i];
    int64_t total = cum[ntuples];
    *total_out = total;
    int64_t nhits = total < cap ? total : cap;
    if (nhits <= 0) {
        free(cum);
        return nhits < 0 ? -1 : 0;
    }
    int nt = nthreads < 1 ? 1 : (nthreads > 8 ? 8 : nthreads);
    if (nhits < 262144) nt = 1;
    pthread_t tid[8];
    FpJob jobs[8];
    int64_t per = (nhits + nt - 1) / nt;
    for (int t = 0; t < nt; t++) {
        int64_t o0 = t * per, o1 = o0 + per;
        if (o0 > nhits) o0 = nhits;
        if (o1 > nhits) o1 = nhits;
        jobs[t] = (FpJob){a_mp, b_mp, lo, cum, ntuples, o0, o1, ap, bp};
    }
    if (nt == 1) fp_worker(&jobs[0]);
    else {
        for (int t = 0; t < nt; t++)
            pthread_create(&tid[t], NULL, fp_worker, &jobs[t]);
        for (int t = 0; t < nt; t++) pthread_join(tid[t], NULL);
    }
    free(cum);
    return nhits;
}

/* band_filter_packed: v3 single-bucket banding over packed hits — C
 * core of the host twin (ops/seeding_host.py _band_filter_packed_np;
 * semantics of ops/seeding.py diagonal_filter_packed).  Stable sort
 * by (ar, br, strand, bucket, arpos); per-band novel k-mer coverage;
 * band score = cov(band) + cov(band+1) via band-key adjacency
 * (key + 1 never carries past the bucket field: headroom bit); the
 * first hit of every band reaching hit_min is its anchor seed,
 * emitted in READ-LOCAL coordinates (caller converts).  Returns the
 * band count (total_seeds) or negative on error. */
int64_t band_filter_packed(const uint32_t *ap_mp, const uint32_t *bp_mp,
                           int64_t n, int32_t a_rpos_bits,
                           int32_t b_rpos_bits, int32_t read_bits,
                           int32_t band_shift, int32_t kmer,
                           int32_t hit_min, int32_t upper_only,
                           int32_t include_self, int64_t seed_cap,
                           int32_t *s_ar, int32_t *s_br,
                           int32_t *s_arp, int32_t *s_brp,
                           int32_t *s_cov, int32_t *s_comp,
                           int64_t *nseeds_out) {
    int32_t rpb = a_rpos_bits > b_rpos_bits ? a_rpos_bits : b_rpos_bits;
    int32_t bucket_bits = rpb + 2 - band_shift;
    if (2 * read_bits + 1 + bucket_bits > 64)
        return -9;                     /* caller falls back to numpy */
    int fused = 2 * read_bits + 1 + bucket_bits + a_rpos_bits <= 64;
    const uint32_t amask = ((uint32_t)1 << a_rpos_bits) - 1;
    const uint32_t bmask = ((uint32_t)1 << b_rpos_bits) - 1;
    uint64_t *key = (uint64_t *)malloc((size_t)n * 8);
    int64_t *hid = (int64_t *)malloc((size_t)n * 8);
    if ((!key || !hid) && n) {
        free(key); free(hid);
        return -1;
    }
    int64_t m = 0;
    for (int64_t i = 0; i < n; i++) {
        uint32_t a = ap_mp[i], b = bp_mp[i];
        int64_t ar = a >> (1 + a_rpos_bits);
        int64_t br = b >> (1 + b_rpos_bits);
        if (upper_only && !(include_self ? ar <= br : ar < br))
            continue;
        int64_t arp = (a >> 1) & amask;
        int64_t brp = (b >> 1) & bmask;
        uint64_t st = (a ^ b) & 1u;
        int64_t diag = st ? arp + brp
                          : arp - brp + ((int64_t)1 << rpb);
        uint64_t bkt = (uint64_t)(diag >> band_shift);
        uint64_t k2 = ((((((uint64_t)ar << read_bits)
                          | (uint64_t)br) << 1) | st)
                       << bucket_bits) | bkt;
        key[m] = fused ? (k2 << a_rpos_bits) | (uint64_t)arp : k2;
        hid[m] = i;
        m++;
    }
    int64_t *ord = (int64_t *)malloc((size_t)m * 8);
    if (!ord && m) {
        free(key); free(hid);
        return -1;
    }
    int64_t rc = 0;
    if (m) {
        if (fused) {
            rc = radix_argsort_u64(key, m, ord);
        } else {
            /* two-pass stable sort (arp, then band key) == one
             * lexicographic sort, when band key + arp exceed 64 bits */
            uint64_t *tmp = (uint64_t *)malloc((size_t)m * 8);
            int64_t *o1 = (int64_t *)malloc((size_t)m * 8);
            if (!tmp || !o1) {
                free(tmp); free(o1); free(key); free(hid); free(ord);
                return -1;
            }
            for (int64_t e = 0; e < m; e++)
                tmp[e] = (ap_mp[hid[e]] >> 1) & amask;
            rc = radix_argsort_u64(tmp, m, o1);
            if (rc == 0) {
                for (int64_t e = 0; e < m; e++)
                    tmp[e] = key[o1[e]];
                rc = radix_argsort_u64(tmp, m, ord);
                for (int64_t e = 0; e < m; e++)
                    ord[e] = o1[ord[e]];
            }
            free(tmp);
            free(o1);
        }
    }
    if (rc != 0) {
        free(key); free(hid); free(ord);
        return rc;
    }
    /* pass 1: segment structure (band = run of equal band keys) */
    int64_t *seg_first = (int64_t *)malloc((size_t)(m + 1) * 8);
    uint64_t *seg_key = (uint64_t *)malloc((size_t)(m + 1) * 8);
    int64_t *seg_sum = (int64_t *)malloc((size_t)(m + 1) * 8);
    if ((!seg_first || !seg_key || !seg_sum) && m) {
        free(key); free(hid); free(ord);
        free(seg_first); free(seg_key); free(seg_sum);
        return -1;
    }
    int64_t nseg = 0;
    int64_t prev_arp = 0;
    uint64_t prev_band = ~(uint64_t)0;
    for (int64_t i = 0; i < m; i++) {
        int64_t e = ord[i];
        uint64_t band = fused ? key[e] >> a_rpos_bits : key[e];
        int64_t arp = (ap_mp[hid[e]] >> 1) & amask;
        if (i == 0 || band != prev_band) {
            seg_first[nseg] = i;
            seg_key[nseg] = band;
            seg_sum[nseg] = kmer;
            nseg++;
        } else {
            int64_t cov = arp - prev_arp;
            if (cov > kmer) cov = kmer;
            if (cov < 0) cov = 0;
            seg_sum[nseg - 1] += cov;
        }
        prev_arp = arp;
        prev_band = band;
    }
    /* pass 2: adjacent-band (previous, this) score + anchor emission */
    int64_t nseeds = 0, total = 0;
    for (int64_t s = 0; s < nseg; s++) {
        int64_t score = seg_sum[s];
        if (s > 0 && seg_key[s - 1] + 1 == seg_key[s])
            score += seg_sum[s - 1];
        if (score < hit_min) continue;
        if (total < seed_cap) {
            int64_t h = hid[ord[seg_first[s]]];
            uint32_t a = ap_mp[h], b = bp_mp[h];
            s_ar[nseeds] = (int32_t)(a >> (1 + a_rpos_bits));
            s_br[nseeds] = (int32_t)(b >> (1 + b_rpos_bits));
            s_arp[nseeds] = (int32_t)((a >> 1) & amask);
            s_brp[nseeds] = (int32_t)((b >> 1) & bmask);
            s_cov[nseeds] = (int32_t)score;
            s_comp[nseeds] = (int32_t)((a ^ b) & 1u);
            nseeds++;
        }
        total++;
    }
    free(key); free(hid); free(ord);
    free(seg_first); free(seg_key); free(seg_sum);
    *nseeds_out = nseeds;
    return total;
}

/* ---------------- ragged byte-run copy ----------------
 *
 * Gather ragged runs src[starts[i] .. starts[i]+lens[i]) into a
 * contiguous destination (dst offsets = running sum of lens).  Serves
 * the columnar .las sort permute and the trace-emission row gather,
 * whose numpy formulation builds int64 index arrays 8-16x the payload
 * (measured 2-3 s per 50 Mbp pass on the host trace path vs ~30 ms
 * here).  starts/lens are in BYTES of src.
 */
void ragged_copy_u8(const uint8_t *src, const int64_t *starts,
                    const int64_t *lens, int64_t n, uint8_t *dst) {
    int64_t off = 0;
    for (int64_t i = 0; i < n; i++) {
        int64_t l = lens[i];
        if (l > 0) {
            memcpy(dst + off, src + starts[i], (size_t)l);
            off += l;
        }
    }
}
