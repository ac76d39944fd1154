// Comma-separated float matrix reader for the expmap CSV files of the
// motion datasets (dstdgcn_tpu_torch/data/native.py binds it with ctypes).
// Built at first use with g++ -O2 -shared -fPIC.
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

extern "C" {

// Parse a comma/newline separated float matrix.
// Returns number of values written, or -1 on error.  First call with
// out=nullptr to obtain counts.
long parse_csv(const char* path, float* out, long capacity,
               long* n_rows, long* n_cols) {
    FILE* f = fopen(path, "rb");
    if (!f) return -1;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    std::vector<char> buf(size + 1);
    if (fread(buf.data(), 1, size, f) != (size_t)size) { fclose(f); return -1; }
    fclose(f);
    buf[size] = '\0';

    long rows = 0, cols = 0, count = 0, row_cols = 0;
    char* p = buf.data();
    char* end = buf.data() + size;
    while (p < end) {
        char* next;
        float v = strtof(p, &next);
        if (next == p) { ++p; continue; }
        if (out) {
            if (count >= capacity) return -1;
            out[count] = v;
        }
        ++count; ++row_cols;
        p = next;
        while (p < end && (*p == ',' || *p == ' ' || *p == '\r')) ++p;
        if (p < end && *p == '\n') {
            if (row_cols > cols) cols = row_cols;
            row_cols = 0; ++rows; ++p;
        }
    }
    if (row_cols > 0) { ++rows; if (row_cols > cols) cols = row_cols; }
    *n_rows = rows; *n_cols = cols;
    return count;
}

}  // extern "C"
