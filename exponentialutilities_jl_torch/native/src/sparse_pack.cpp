// Native host-side sparse preprocessing for the port's operator containers
// (a copy of the packers of exponentialutilities_jl_tpu/native/src/
// sparse_pack.cpp that the port uses, with the RCM start-vertex search
// repaired): converting host CSR/BSR matrices into the padded layouts of
// ops/sparse.py, diagonal (banded) extraction, and bandwidth-reducing RCM
// reordering. These are O(nnz) pointer-chasing loops, the wrong shape for
// numpy and far too slow as Python loops at 10M rows.
//
// ABI: plain C, int64_t sizes/indptr, int32_t column indices, explicit
// f32/f64 instantiations. All buffers are caller-allocated (numpy).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- ELL pack

// Max nonzeros per row (the required ELL width).
int64_t csr_max_degree(const int64_t* indptr, int64_t n) {
    int64_t w = 0;
    for (int64_t i = 0; i < n; ++i)
        w = std::max(w, indptr[i + 1] - indptr[i]);
    return w;
}

}  // extern "C"

template <typename T>
static void csr_to_ell_impl(int64_t n, int64_t w, const int64_t* indptr,
                            const int32_t* indices, const T* data,
                            T* out_vals, int32_t* out_cols) {
    // Padded slots stay (value 0, col 0): gather-safe.
    std::memset(out_vals, 0, sizeof(T) * n * w);
    std::memset(out_cols, 0, sizeof(int32_t) * n * w);
    for (int64_t i = 0; i < n; ++i) {
        const int64_t lo = indptr[i], hi = indptr[i + 1];
        T* vrow = out_vals + i * w;
        int32_t* crow = out_cols + i * w;
        for (int64_t k = lo; k < hi; ++k) {
            vrow[k - lo] = data[k];
            crow[k - lo] = indices[k];
        }
    }
}

extern "C" {

void csr_to_ell_f64(int64_t n, int64_t w, const int64_t* indptr,
                    const int32_t* indices, const double* data,
                    double* out_vals, int32_t* out_cols) {
    csr_to_ell_impl<double>(n, w, indptr, indices, data, out_vals, out_cols);
}

void csr_to_ell_f32(int64_t n, int64_t w, const int64_t* indptr,
                    const int32_t* indices, const float* data,
                    float* out_vals, int32_t* out_cols) {
    csr_to_ell_impl<float>(n, w, indptr, indices, data, out_vals, out_cols);
}

// ------------------------------------------------------------ BlockELL pack

// Pack BSR (block-CSR: nbr block rows, (br*bc)-sized dense blocks) into
// fixed-width blocked ELL. Padded block slots are zero blocks at bcol 0.
}  // extern "C"

template <typename T>
static void bsr_to_blockell_impl(int64_t nbr, int64_t w, int64_t bsz,
                                 const int64_t* indptr,
                                 const int32_t* indices, const T* data,
                                 T* out_blocks, int32_t* out_bcols) {
    std::memset(out_blocks, 0, sizeof(T) * nbr * w * bsz);
    std::memset(out_bcols, 0, sizeof(int32_t) * nbr * w);
    for (int64_t i = 0; i < nbr; ++i) {
        const int64_t lo = indptr[i], hi = indptr[i + 1];
        for (int64_t k = lo; k < hi; ++k) {
            std::memcpy(out_blocks + (i * w + (k - lo)) * bsz,
                        data + k * bsz, sizeof(T) * bsz);
            out_bcols[i * w + (k - lo)] = indices[k];
        }
    }
}

extern "C" {

void bsr_to_blockell_f64(int64_t nbr, int64_t w, int64_t bsz,
                         const int64_t* indptr, const int32_t* indices,
                         const double* data, double* out_blocks,
                         int32_t* out_bcols) {
    bsr_to_blockell_impl<double>(nbr, w, bsz, indptr, indices, data,
                                 out_blocks, out_bcols);
}

void bsr_to_blockell_f32(int64_t nbr, int64_t w, int64_t bsz,
                         const int64_t* indptr, const int32_t* indices,
                         const float* data, float* out_blocks,
                         int32_t* out_bcols) {
    bsr_to_blockell_impl<float>(nbr, w, bsz, indptr, indices, data,
                                out_blocks, out_bcols);
}

// ----------------------------------------------------- banded extraction

// Extract diagonal storage: diags[k][i] = A[i, i + offsets[k]].
// Entries at columns not covered by `offsets` are counted in *out_dropped
// so the caller can reject a lossy conversion.
}  // extern "C"

template <typename T>
static void csr_to_banded_impl(int64_t n, int64_t noff,
                               const int64_t* offsets, const int64_t* indptr,
                               const int32_t* indices, const T* data,
                               T* out_diags, int64_t* out_dropped) {
    std::memset(out_diags, 0, sizeof(T) * noff * n);
    // offset -> slot lookup over the (small) band range
    int64_t omin = 0, omax = 0;
    for (int64_t k = 0; k < noff; ++k) {
        omin = std::min(omin, offsets[k]);
        omax = std::max(omax, offsets[k]);
    }
    std::vector<int64_t> slot(omax - omin + 1, -1);
    for (int64_t k = 0; k < noff; ++k) slot[offsets[k] - omin] = k;
    int64_t dropped = 0;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t o = (int64_t)indices[k] - i;
            if (o < omin || o > omax || slot[o - omin] < 0) {
                ++dropped;
                continue;
            }
            out_diags[slot[o - omin] * n + i] = data[k];
        }
    }
    *out_dropped = dropped;
}

extern "C" {

void csr_to_banded_f64(int64_t n, int64_t noff, const int64_t* offsets,
                       const int64_t* indptr, const int32_t* indices,
                       const double* data, double* out_diags,
                       int64_t* out_dropped) {
    csr_to_banded_impl<double>(n, noff, offsets, indptr, indices, data,
                               out_diags, out_dropped);
}

void csr_to_banded_f32(int64_t n, int64_t noff, const int64_t* offsets,
                       const int64_t* indptr, const int32_t* indices,
                       const float* data, float* out_diags,
                       int64_t* out_dropped) {
    csr_to_banded_impl<float>(n, noff, offsets, indptr, indices, data,
                              out_diags, out_dropped);
}

// Distinct offsets present in a CSR matrix (for automatic banded
// conversion). Returns the count; writes up to max_out offsets sorted
// ascending. A return of -1 means more than max_out distinct offsets.
int64_t csr_band_offsets(int64_t n, const int64_t* indptr,
                         const int32_t* indices, int64_t* out_offsets,
                         int64_t max_out) {
    std::vector<int64_t> offs;
    for (int64_t i = 0; i < n; ++i) {
        for (int64_t k = indptr[i]; k < indptr[i + 1]; ++k) {
            const int64_t o = (int64_t)indices[k] - i;
            auto it = std::lower_bound(offs.begin(), offs.end(), o);
            if (it == offs.end() || *it != o) {
                if ((int64_t)offs.size() >= max_out) return -1;
                offs.insert(it, o);
            }
        }
    }
    for (size_t k = 0; k < offs.size(); ++k) out_offsets[k] = offs[k];
    return (int64_t)offs.size();
}

// ------------------------------------------------------------ RCM ordering

// Reverse Cuthill–McKee bandwidth-reducing permutation of a symmetric
// pattern. perm[new_index] = old_index.
void rcm_ordering(int64_t n, const int64_t* indptr, const int32_t* indices,
                  int32_t* perm) {
    std::vector<int64_t> degree(n);
    for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
    std::vector<char> visited(n, 0);
    std::vector<int32_t> order;
    order.reserve(n);
    std::vector<int32_t> nbrs;

    // Breadth-first search from the minimum-degree unvisited vertex at or
    // after comp (the first such vertex on ties).
    auto search_from = [&](int64_t comp) {
        int64_t start = comp;
        for (int64_t i = comp + 1; i < n; ++i)
            if (!visited[i] && degree[i] < degree[start]) start = i;
        visited[start] = 1;
        order.push_back((int32_t)start);
        for (size_t head = order.size() - 1; head < order.size(); ++head) {
            const int64_t u = order[head];
            nbrs.clear();
            for (int64_t k = indptr[u]; k < indptr[u + 1]; ++k) {
                const int32_t v = indices[k];
                if (!visited[v]) {
                    visited[v] = 1;
                    nbrs.push_back(v);
                }
            }
            std::sort(nbrs.begin(), nbrs.end(),
                      [&](int32_t a, int32_t b) {
                          return degree[a] < degree[b];
                      });
            for (int32_t v : nbrs) order.push_back(v);
        }
    };
    // First pass: one search per unvisited comp, comp always advancing.
    // When the start lies in another component than comp, comp stays
    // unvisited and may never be reached (an isolated row after connected
    // ones, for instance).
    for (int64_t comp = 0; comp < n; ++comp)
        if (!visited[comp]) search_from(comp);
    // Second pass, for the vertices the first one lost: comp advances only
    // past visited vertices, so every vertex is ordered. An ordering that
    // the first pass completes is left exactly as it was.
    for (int64_t comp = 0; comp < n;) {
        if (visited[comp])
            ++comp;
        else
            search_from(comp);
    }
    // Reverse for RCM.
    for (int64_t i = 0; i < n; ++i) perm[i] = order[n - 1 - i];
}

}  // extern "C"
