// Exact rectangular linear assignment (Jonker-Volgenant shortest augmenting
// paths, the e-maxx potentials formulation) over N independent problems.
//
// The JAX package solves the same problem with dskd_tpu/core/matching.py
// lap_jv, a sequential lax.while_loop on the device; the reference solves it
// with scipy on the host. The port's matcher="jv" copies the (N, R, C) cost
// to the host and calls this function (dskd_tpu_torch/core/matching.py).
// Exposed via a plain C ABI for ctypes.
//
// Built by dskd_tpu_torch/native/build.py:
// c++ -O3 -shared -fPIC -o build/lap_jv-<key>.so lap_jv.cpp
#include <cstdint>
#include <limits>
#include <vector>

extern "C" {

// cost: (n, rows, cols) row-major float64, rows <= cols. row2col: (n, rows),
// the column assigned to each row; every row gets a distinct column and the
// total cost is minimal. Returns 0, or 1 when rows > cols (nothing written).
int lap_jv(const double* cost, int64_t n, int64_t rows, int64_t cols,
           int64_t* row2col) {
    if (rows > cols) return 1;
    const double inf = std::numeric_limits<double>::infinity();
    // 1-indexed as in the formulation: row 0 and column 0 are sentinels
    std::vector<double> u(rows + 1), v(cols + 1), minv(cols + 1);
    std::vector<int64_t> p(cols + 1), way(cols + 1);
    std::vector<char> used(cols + 1);
    for (int64_t k = 0; k < n; ++k) {
        const double* a = cost + k * rows * cols;
        std::fill(u.begin(), u.end(), 0.0);
        std::fill(v.begin(), v.end(), 0.0);
        std::fill(p.begin(), p.end(), 0);
        for (int64_t i = 1; i <= rows; ++i) {
            p[0] = i;
            int64_t j0 = 0;
            std::fill(minv.begin(), minv.end(), inf);
            std::fill(used.begin(), used.end(), 0);
            do {
                used[j0] = 1;
                const int64_t i0 = p[j0];
                const double* row = a + (i0 - 1) * cols;
                double delta = inf;
                int64_t j1 = 0;
                for (int64_t j = 1; j <= cols; ++j) {
                    if (used[j]) continue;
                    const double cur = row[j - 1] - u[i0] - v[j];
                    if (cur < minv[j]) {
                        minv[j] = cur;
                        way[j] = j0;
                    }
                    if (minv[j] < delta) {
                        delta = minv[j];
                        j1 = j;
                    }
                }
                for (int64_t j = 0; j <= cols; ++j) {
                    if (used[j]) {
                        u[p[j]] += delta;
                        v[j] -= delta;
                    } else {
                        minv[j] -= delta;
                    }
                }
                j0 = j1;
            } while (p[j0] != 0);
            do {  // augment along the path of predecessors
                const int64_t j1 = way[j0];
                p[j0] = p[j1];
                j0 = j1;
            } while (j0 != 0);
        }
        int64_t* out = row2col + k * rows;
        for (int64_t j = 1; j <= cols; ++j)
            if (p[j] != 0) out[p[j] - 1] = j - 1;
    }
    return 0;
}

}  // extern "C"
