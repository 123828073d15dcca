/* Native host-side runtime components.
 *
 * Equivalents of the reference's C/C++ host code paths:
 *  - PNG scanline unfiltering (reference: LodePNG via mLib, used by every
 *    image example) -- the decode hot loop;
 *  - mesh 1-ring neighbor-list construction (reference:
 *    examples/arap_mesh_deformation/src/CombinedSolver.h:105-143 and
 *    examples/shared/OptGraph.h createGraphFromNeighborLists);
 *  - a CSR toolkit (transpose pattern+values, symbolic+numeric A^T A,
 *    SpMV) mirroring the reference's CPU sparse linalg
 *    (API/src/linalg_cpu.t) for host-side Jacobian inspection.
 *
 * Exposed as plain C functions over raw buffers; Python binds via ctypes
 * (opt_tpu/native/build.py) with pure-Python fallbacks.
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define EXPORT __attribute__((visibility("default")))

/* ---------------- PNG unfilter (decode hot loop) ---------------- */

static inline int paeth(int a, int b, int c) {
    int p = a + b - c;
    int pa = abs(p - a), pb = abs(p - b), pc = abs(p - c);
    if (pa <= pb && pa <= pc) return a;
    if (pb <= pc) return b;
    return c;
}

/* raw: h*(1+stride) filtered bytes; out: h*stride; returns 0 on success */
EXPORT int png_unfilter(const uint8_t *raw, uint8_t *out, int64_t height,
                        int64_t stride, int64_t bpp) {
    const uint8_t *prev = NULL;
    int64_t pos = 0;
    for (int64_t y = 0; y < height; y++) {
        uint8_t ftype = raw[pos++];
        uint8_t *cur = out + y * stride;
        const uint8_t *line = raw + pos;
        pos += stride;
        switch (ftype) {
        case 0:
            memcpy(cur, line, stride);
            break;
        case 1: /* Sub */
            for (int64_t i = 0; i < stride; i++) {
                uint8_t left = i >= bpp ? cur[i - bpp] : 0;
                cur[i] = (uint8_t)(line[i] + left);
            }
            break;
        case 2: /* Up */
            for (int64_t i = 0; i < stride; i++) {
                uint8_t up = prev ? prev[i] : 0;
                cur[i] = (uint8_t)(line[i] + up);
            }
            break;
        case 3: /* Average */
            for (int64_t i = 0; i < stride; i++) {
                int left = i >= bpp ? cur[i - bpp] : 0;
                int up = prev ? prev[i] : 0;
                cur[i] = (uint8_t)(line[i] + ((left + up) >> 1));
            }
            break;
        case 4: /* Paeth */
            for (int64_t i = 0; i < stride; i++) {
                int a = i >= bpp ? cur[i - bpp] : 0;
                int b = prev ? prev[i] : 0;
                int c = (prev && i >= bpp) ? prev[i - bpp] : 0;
                cur[i] = (uint8_t)(line[i] + paeth(a, b, c));
            }
            break;
        default:
            return -1;
        }
        prev = cur;
    }
    return 0;
}

/* ---------------- mesh neighbor lists ---------------- */

/* faces: (nf,3) int32; emits CSR (offsets: nv+1, idx: capacity 6*nf)
 * with each vertex's unique sorted neighbors.  Returns total entries or
 * -1 on overflow. */
EXPORT int64_t neighbor_lists(const int32_t *faces, int64_t nf, int64_t nv,
                              int32_t *offsets, int32_t *idx,
                              int64_t capacity) {
    /* count degrees (with duplicates) */
    int64_t *deg = (int64_t *)calloc(nv, sizeof(int64_t));
    if (!deg) return -1;
    for (int64_t f = 0; f < nf; f++) {
        deg[faces[3 * f + 0]] += 2;
        deg[faces[3 * f + 1]] += 2;
        deg[faces[3 * f + 2]] += 2;
    }
    int64_t *starts = (int64_t *)malloc((nv + 1) * sizeof(int64_t));
    if (!starts) { free(deg); return -1; }
    starts[0] = 0;
    for (int64_t v = 0; v < nv; v++) starts[v + 1] = starts[v] + deg[v];
    int64_t total = starts[nv];
    int32_t *tmp = (int32_t *)malloc(total * sizeof(int32_t));
    if (!tmp) { free(deg); free(starts); return -1; }
    int64_t *fill = (int64_t *)calloc(nv, sizeof(int64_t));
    for (int64_t f = 0; f < nf; f++) {
        int32_t a = faces[3 * f], b = faces[3 * f + 1], c = faces[3 * f + 2];
        tmp[starts[a] + fill[a]++] = b;
        tmp[starts[a] + fill[a]++] = c;
        tmp[starts[b] + fill[b]++] = a;
        tmp[starts[b] + fill[b]++] = c;
        tmp[starts[c] + fill[c]++] = a;
        tmp[starts[c] + fill[c]++] = b;
    }
    /* sort + dedupe per vertex */
    int64_t out = 0;
    offsets[0] = 0;
    for (int64_t v = 0; v < nv; v++) {
        int64_t n = fill[v];
        int32_t *row = tmp + starts[v];
        /* insertion sort (rings are small) */
        for (int64_t i = 1; i < n; i++) {
            int32_t key = row[i];
            int64_t j = i - 1;
            while (j >= 0 && row[j] > key) { row[j + 1] = row[j]; j--; }
            row[j + 1] = key;
        }
        for (int64_t i = 0; i < n; i++) {
            if (i > 0 && row[i] == row[i - 1]) continue;
            if (out >= capacity) { out = -1; goto done; }
            idx[out++] = row[i];
        }
        offsets[v + 1] = (int32_t)out;
    }
done:
    free(deg); free(starts); free(tmp); free(fill);
    return out;
}

/* ---------------- CSR toolkit (linalg_cpu.t parity) ---------------- */

/* CSR transpose: A (nr x nc) -> AT; parity with computeNnzPatternAT /
 * computeAT (reference: API/src/linalg_cpu.t:203-289,523-568). */
EXPORT void csr_transpose(const int32_t *rowptr, const int32_t *colind,
                          const float *vals, int64_t nr, int64_t nc,
                          int32_t *t_rowptr, int32_t *t_colind,
                          float *t_vals) {
    int64_t nnz = rowptr[nr];
    for (int64_t i = 0; i <= nc; i++) t_rowptr[i] = 0;
    for (int64_t k = 0; k < nnz; k++) t_rowptr[colind[k] + 1]++;
    for (int64_t i = 0; i < nc; i++) t_rowptr[i + 1] += t_rowptr[i];
    int32_t *fill = (int32_t *)calloc(nc, sizeof(int32_t));
    for (int64_t r = 0; r < nr; r++) {
        for (int32_t k = rowptr[r]; k < rowptr[r + 1]; k++) {
            int32_t c = colind[k];
            int64_t dst = t_rowptr[c] + fill[c]++;
            t_colind[dst] = (int32_t)r;
            if (t_vals && vals) t_vals[dst] = vals[k];
        }
    }
    free(fill);
}

/* SpMV y = A x; parity with applyAtoVector (linalg_cpu.t:571-682). */
EXPORT void csr_spmv(const int32_t *rowptr, const int32_t *colind,
                     const float *vals, const float *x, float *y,
                     int64_t nr) {
    for (int64_t r = 0; r < nr; r++) {
        float acc = 0.0f;
        for (int32_t k = rowptr[r]; k < rowptr[r + 1]; k++)
            acc += vals[k] * x[colind[k]];
        y[r] = acc;
    }
}

/* Symbolic+numeric A^T A for CSR A (nr x nc); out CSR is nc x nc.
 * Two-phase like computeNnzPatternATA / computeATA
 * (linalg_cpu.t:292-520).  Pass out_colind=NULL to count nnz only
 * (returns nnz); second call fills values. */
EXPORT int64_t csr_ata(const int32_t *rowptr, const int32_t *colind,
                       const float *vals, int64_t nr, int64_t nc,
                       const int32_t *t_rowptr, const int32_t *t_colind,
                       const float *t_vals,
                       int32_t *out_rowptr, int32_t *out_colind,
                       float *out_vals) {
    /* (A^T A)[i,j] = sum_r AT[i,r] * A[r,j]; iterate rows of AT */
    float *acc = (float *)calloc(nc, sizeof(float));
    int32_t *touched = (int32_t *)malloc(nc * sizeof(int32_t));
    int64_t *marker = (int64_t *)malloc(nc * sizeof(int64_t));
    for (int64_t j = 0; j < nc; j++) marker[j] = -1;
    int64_t nnz = 0;
    if (out_rowptr) out_rowptr[0] = 0;
    for (int64_t i = 0; i < nc; i++) {
        int64_t ntouched = 0;
        for (int32_t k = t_rowptr[i]; k < t_rowptr[i + 1]; k++) {
            int32_t r = t_colind[k];
            float av = t_vals ? t_vals[k] : 1.0f;
            for (int32_t k2 = rowptr[r]; k2 < rowptr[r + 1]; k2++) {
                int32_t j = colind[k2];
                if (marker[j] != i) {
                    marker[j] = i;
                    touched[ntouched++] = j;
                    acc[j] = 0.0f;
                }
                acc[j] += av * (vals ? vals[k2] : 1.0f);
            }
        }
        /* sort touched columns */
        for (int64_t a = 1; a < ntouched; a++) {
            int32_t key = touched[a];
            int64_t b = a - 1;
            while (b >= 0 && touched[b] > key) {
                touched[b + 1] = touched[b];
                b--;
            }
            touched[b + 1] = key;
        }
        for (int64_t t = 0; t < ntouched; t++) {
            if (out_colind) {
                out_colind[nnz] = touched[t];
                if (out_vals) out_vals[nnz] = acc[touched[t]];
            }
            nnz++;
        }
        if (out_rowptr) out_rowptr[i + 1] = (int32_t)nnz;
    }
    free(acc);
    free(touched);
    free(marker);
    return nnz;
}
