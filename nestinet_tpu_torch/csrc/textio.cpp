// Fast text-table writer for serving outputs.
//
// The serving protocol's result files (.normals / .experts /
// .experts_probs — parity with the reference's np.savetxt outputs,
// test_n_est_w_experts.py:188-196) are plain text, and np.savetxt
// formats them in a per-row Python loop measured at ~35 ms per 1024
// patches on the 1-core serving host — pure GIL-held work that the
// async writer thread steals from the serving loop.  This module does
// the same formatting with snprintf at C speed (~10x); byte-identical
// output is asserted against np.savetxt in tests/test_torch_host.py (both
// glibc printf and CPython's '%'-formatting round correctly, so the
// strings agree digit-for-digit).
//
// Exposed via ctypes (nestinet_tpu_torch/core/textio.py); built on demand
// with g++ like csrc/patch_sampler.cpp.

#include <cstdio>
#include <cstdint>
#include <cstring>

extern "C" {

// Write `rows` x `cols` doubles as "%.18e" space-joined rows (exactly
// np.savetxt's default fmt).  Returns 0 on success, -1 on I/O error.
int write_table_f64(const char *path, const double *data,
                    int64_t rows, int64_t cols) {
    FILE *f = std::fopen(path, "w");
    if (!f) return -1;
    static char vbuf[1 << 20];
    std::setvbuf(f, vbuf, _IOFBF, sizeof(vbuf));
    // "%.18e" is at most 26 chars ("-1.234567890123456789e-308");
    // denormals can print a 4-digit exponent? No — e-format exponents
    // for double are at most 3 digits.  27 with separator is safe.
    char row[27 * 512];
    if (cols > 512) { std::fclose(f); return -1; }
    for (int64_t i = 0; i < rows; ++i) {
        char *p = row;
        for (int64_t j = 0; j < cols; ++j) {
            if (j) *p++ = ' ';
            p += std::snprintf(p, 32, "%.18e", data[i * cols + j]);
        }
        *p++ = '\n';
        if (std::fwrite(row, 1, p - row, f) != (size_t)(p - row)) {
            std::fclose(f);
            return -1;
        }
    }
    if (std::fclose(f) != 0) return -1;
    return 0;
}

// Write `rows` int64s one per line ("%i", np.savetxt fmt="%i").
int write_table_i64(const char *path, const int64_t *data, int64_t rows) {
    FILE *f = std::fopen(path, "w");
    if (!f) return -1;
    static char vbuf[1 << 20];
    std::setvbuf(f, vbuf, _IOFBF, sizeof(vbuf));
    char row[32];
    for (int64_t i = 0; i < rows; ++i) {
        int n = std::snprintf(row, sizeof(row), "%lld\n",
                              (long long)data[i]);
        if (std::fwrite(row, 1, n, f) != (size_t)n) {
            std::fclose(f);
            return -1;
        }
    }
    if (std::fclose(f) != 0) return -1;
    return 0;
}

}  // extern "C"
