// The port's host point-cloud runtime: ASCII PLY rows written and parsed
// in C++ for multi-million-point dense clouds.
//
// The port's own copy of native/pointcloud.cpp:243-335 (the JAX package's
// host library, which the port does not load). Built at first use by
// runtime/native.py with `g++ -O3 -std=c++17 -fPIC -shared` into
// recon3d_tpu_torch/_build, and loaded from there through ctypes. The
// point-cloud searches of that file are CUDA kernels in the port
// (csrc/pointcloud.cu).

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>

extern "C" {

// Append n ASCII "x y z r g b" rows to an already-open file position.
// Returns 0 on success, -1 on I/O error.
int ply_write_ascii_rows(const char* path, const float* points,
                         const unsigned char* colors, long long n) {
    FILE* f = std::fopen(path, "ab");
    if (!f) return -1;
    std::vector<char> buf(1 << 20);
    std::setvbuf(f, buf.data(), _IOFBF, buf.size());
    for (long long i = 0; i < n; ++i) {
        const float* p = points + 3 * i;
        const unsigned char* c = colors + 3 * i;
        if (std::fprintf(f, "%.6f %.6f %.6f %d %d %d\n",
                         static_cast<double>(p[0]), static_cast<double>(p[1]),
                         static_cast<double>(p[2]), c[0], c[1], c[2]) < 0) {
            std::fclose(f);
            return -1;
        }
    }
    return std::fclose(f) == 0 ? 0 : -1;
}

// Parse n ASCII vertex rows starting at byte `offset` of the file. Each row
// has `n_props` whitespace-separated numeric properties; all are parsed as
// double into out (n * n_props). Returns rows parsed, or -1 on error.
// Reads the region into memory once and strtod's through it (an order of
// magnitude faster than fscanf).
long long ply_parse_ascii_rows(const char* path, long long offset,
                               long long n, int n_props, double* out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return -1;
    if (std::fseek(f, 0, SEEK_END) != 0) { std::fclose(f); return -1; }
    const long long fsize = std::ftell(f);
    if (fsize < offset) { std::fclose(f); return -1; }
    if (std::fseek(f, static_cast<long>(offset), SEEK_SET) != 0) {
        std::fclose(f);
        return -1;
    }
    std::vector<char> data(static_cast<size_t>(fsize - offset) + 1);
    size_t got = std::fread(data.data(), 1, data.size() - 1, f);
    std::fclose(f);
    data[got] = 0;

    const char* p = data.data();
    const char* lim = data.data() + got;
    const long long total = n * n_props;
    for (long long i = 0; i < total; ++i) {
        // skip whitespace
        while (p < lim && (*p == ' ' || *p == '\n' || *p == '\r' || *p == '\t'))
            ++p;
        if (p >= lim) return i / n_props;
        // fast fixed-decimal parse (sign, int part, fraction, exponent,
        // nan/inf tokens)
        bool neg = false;
        if (*p == '-') { neg = true; ++p; }
        else if (*p == '+') ++p;
        if (p + 2 < lim && (*p == 'n' || *p == 'N')) {
            out[i] = std::nan("");
            p += 3;  // "nan"
            continue;
        }
        if (p + 2 < lim && (*p == 'i' || *p == 'I')) {
            out[i] = neg ? -HUGE_VAL : HUGE_VAL;
            p += 3;  // "inf"
            if (p + 4 < lim && (*p == 'i' || *p == 'I')) p += 5;  // "inity"
            continue;
        }
        const char* digits_start = p;
        double v = 0.0;
        while (p < lim && *p >= '0' && *p <= '9')
            v = v * 10.0 + (*p++ - '0');
        if (p < lim && *p == '.') {
            ++p;
            double frac = 0.0, scale = 1.0;
            while (p < lim && *p >= '0' && *p <= '9') {
                frac = frac * 10.0 + (*p++ - '0');
                scale *= 10.0;
            }
            v += frac / scale;
        }
        if (p == digits_start && (p >= lim || *p != '.'))
            return i / n_props;  // no progress: malformed token
        if (p < lim && (*p == 'e' || *p == 'E')) {
            ++p;
            bool eneg = false;
            if (p < lim && (*p == '-' || *p == '+')) eneg = (*p++ == '-');
            int ex = 0;
            while (p < lim && *p >= '0' && *p <= '9') ex = ex * 10 + (*p++ - '0');
            v *= std::pow(10.0, eneg ? -ex : ex);
        }
        out[i] = neg ? -v : v;
    }
    return n;
}

}  // extern "C"
