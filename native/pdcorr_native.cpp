// Native runtime components for the JAX PD-corrosion framework.
//
// The device compute path is JAX/XLA; these C++ pieces cover the host-side
// runtime where the reference is also native C++ (SURVEY §2: C++ everywhere):
//
//  1. fmt_doubles / fmt_vec3 — fast "%.9g"-per-line ASCII serialization for
//     the VTK writers (vtk_writer.cpp equivalent hot path: ~10 arrays x N
//     nodes per snapshot; Python string formatting is ~30x slower).
//  2. cell_list_neighbors — the AMR padded-neighbor builder
//     (grid.cpp:660-808 equivalent): spatial-hash cell list, same-level
//     bonds, neighbor-dx beta partial volumes, OpenMP-parallel.
//  3. voronoi_assign — nearest-seed grain assignment (grains.cpp:56-70
//     equivalent) for large grids.
//
// Built as a shared library (see Makefile); loaded via ctypes with a pure
// NumPy fallback, so the framework works without a toolchain.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// ---------------------------------------------------------------------------
// 1. ASCII serialization
// ---------------------------------------------------------------------------

// Format n doubles, one per line with 10-space indent, "%.9g". Returns the
// number of bytes written (excluding the terminating NUL). `out` must hold
// at least n * 32 bytes.
int64_t fmt_doubles(const double* vals, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(p, "          ", 10);
        p += 10;
        p += std::snprintf(p, 22, "%.9g", vals[i]);
        *p++ = '\n';
    }
    *p = '\0';
    return p - out;
}

// Format n rows of 3 doubles per line. `out` must hold n * 96 bytes.
int64_t fmt_vec3(const double* vals, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(p, "          ", 10);
        p += 10;
        p += std::snprintf(p, 22, "%.9g", vals[3 * i + 0]);
        *p++ = ' ';
        p += std::snprintf(p, 22, "%.9g", vals[3 * i + 1]);
        *p++ = ' ';
        p += std::snprintf(p, 22, "%.9g", vals[3 * i + 2]);
        *p++ = '\n';
    }
    *p = '\0';
    return p - out;
}

// Format n int64 values one per line. `out` must hold n * 32 bytes.
int64_t fmt_ints(const int64_t* vals, int64_t n, char* out) {
    char* p = out;
    for (int64_t i = 0; i < n; ++i) {
        std::memcpy(p, "          ", 10);
        p += 10;
        p += std::snprintf(p, 22, "%lld", (long long)vals[i]);
        *p++ = '\n';
    }
    *p = '\0';
    return p - out;
}

// ---------------------------------------------------------------------------
// 2. AMR cell-list padded neighbor builder (2D)
// ---------------------------------------------------------------------------

// First pass: count neighbors per node (to size K). Returns max count.
// Second call fills the padded arrays. mode=0 -> count only (counts[N]);
// mode=1 -> fill (requires K).
int64_t cell_list_neighbors_2d(
    const double* pos,          // [N, 2]
    const uint8_t* node_type,   // [N]
    const double* dx_local,     // [N]
    const double* delta_local,  // [N]
    const int32_t* grid_level,  // [N]
    int64_t N,
    int32_t mode, int32_t K,
    // outputs (mode 0: counts; mode 1: padded arrays)
    int32_t* counts,            // [N]
    int32_t* nbr_idx,           // [N, K]
    double* nbr_dist,           // [N, K]
    double* nbr_evec,           // [N, K, 2]
    double* nbr_vol)            // [N, K]
{
    const uint8_t OUTSIDE = 5;

    // cell size: min(delta)/2 over active nodes (grid.cpp:669)
    double dmin = 1e300, dmax_dx = 0.0;
    double xmin = 1e300, xmax = -1e300, ymin = 1e300, ymax = -1e300;
    for (int64_t i = 0; i < N; ++i) {
        if (node_type[i] == OUTSIDE) continue;
        if (delta_local[i] < dmin) dmin = delta_local[i];
        if (dx_local[i] > dmax_dx) dmax_dx = dx_local[i];
        if (pos[2 * i] < xmin) xmin = pos[2 * i];
        if (pos[2 * i] > xmax) xmax = pos[2 * i];
        if (pos[2 * i + 1] < ymin) ymin = pos[2 * i + 1];
        if (pos[2 * i + 1] > ymax) ymax = pos[2 * i + 1];
    }
    double h = dmin / 2.0;
    if (h < 1e-30) h = 1.0;

    int ncx = (int)std::ceil((xmax - xmin) / h) + 1;
    int ncy = (int)std::ceil((ymax - ymin) / h) + 1;

    // bucket fill (serial; counts then offsets)
    std::vector<int32_t> cell_count((size_t)ncx * ncy, 0);
    std::vector<int32_t> cell_of(N, -1);
    for (int64_t i = 0; i < N; ++i) {
        if (node_type[i] == OUTSIDE) continue;
        int cx = (int)std::floor((pos[2 * i] - xmin) / h);
        int cy = (int)std::floor((pos[2 * i + 1] - ymin) / h);
        cx = cx < 0 ? 0 : (cx >= ncx ? ncx - 1 : cx);
        cy = cy < 0 ? 0 : (cy >= ncy ? ncy - 1 : cy);
        int c = cy * ncx + cx;
        cell_of[i] = c;
        cell_count[c]++;
    }
    std::vector<int32_t> cell_off((size_t)ncx * ncy + 1, 0);
    for (size_t c = 0; c < (size_t)ncx * ncy; ++c)
        cell_off[c + 1] = cell_off[c] + cell_count[c];
    std::vector<int32_t> cell_items(cell_off.back());
    {
        std::vector<int32_t> cur(cell_off.begin(), cell_off.end() - 1);
        for (int64_t i = 0; i < N; ++i) {
            if (cell_of[i] < 0) continue;
            cell_items[cur[cell_of[i]]++] = (int32_t)i;
        }
    }

    int64_t max_count = 0;

#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64) reduction(max : max_count)
#endif
    for (int64_t i = 0; i < N; ++i) {
        if (node_type[i] == OUTSIDE) {
            if (mode == 0) counts[i] = 0;
            continue;
        }
        double px = pos[2 * i], py = pos[2 * i + 1];
        double di = delta_local[i];
        int32_t lvl = grid_level[i];
        int sr = (int)std::ceil((di + 0.5 * dmax_dx) / h) + 1;
        int cix = (int)std::floor((px - xmin) / h);
        int ciy = (int)std::floor((py - ymin) / h);

        int found = 0;
        for (int dy = -sr; dy <= sr; ++dy) {
            int cy = ciy + dy;
            if (cy < 0 || cy >= ncy) continue;
            for (int dxc = -sr; dxc <= sr; ++dxc) {
                int cx = cix + dxc;
                if (cx < 0 || cx >= ncx) continue;
                int c = cy * ncx + cx;
                for (int32_t it = cell_off[c]; it < cell_off[c + 1]; ++it) {
                    int32_t j = cell_items[it];
                    if (j == (int32_t)i) continue;
                    if (grid_level[j] != lvl) continue;  // same-level bonds only
                    double ddx = pos[2 * j] - px;
                    double ddy = pos[2 * j + 1] - py;
                    double r = std::sqrt(ddx * ddx + ddy * ddy);
                    if (r < 1e-14) continue;  // coincident real/fictitious
                    double dxj = dx_local[j];
                    if (r > di + 0.5 * dxj) continue;
                    double beta = (r <= di - 0.5 * dxj)
                                      ? 1.0
                                      : (di + 0.5 * dxj - r) / dxj;
                    if (mode == 1 && found < K) {
                        int64_t slot = (int64_t)i * K + found;
                        nbr_idx[slot] = j;
                        nbr_dist[slot] = r;
                        nbr_evec[2 * slot] = ddx / r;
                        nbr_evec[2 * slot + 1] = ddy / r;
                        nbr_vol[slot] = beta * dxj * dxj;
                    }
                    ++found;
                }
            }
        }
        if (mode == 0) counts[i] = found;
        if (found > max_count) max_count = found;
    }
    return max_count;
}

// ---------------------------------------------------------------------------
// 3. Voronoi nearest-seed assignment
// ---------------------------------------------------------------------------

void voronoi_assign(const double* pos, int64_t n_pts, int dim,
                    const double* seeds, int64_t n_seeds,
                    int32_t* out) {
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 256)
#endif
    for (int64_t i = 0; i < n_pts; ++i) {
        double best = 1e300;
        int32_t bg = 0;
        for (int64_t g = 0; g < n_seeds; ++g) {
            double d2 = 0.0;
            for (int d = 0; d < dim; ++d) {
                double dd = pos[i * dim + d] - seeds[g * dim + d];
                d2 += dd * dd;
            }
            if (d2 < best) {
                best = d2;
                bg = (int32_t)g;
            }
        }
        out[i] = bg;
    }
}

}  // extern "C"
