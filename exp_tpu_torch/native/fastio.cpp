// Native IO kernels for exp_tpu_torch (a copy of exp_tpu/native/fastio.cpp;
// the counterpart of the reference's C++ particle readers,
// exputil/ParticleReader.cc / Component body readers).
//
// Exposed through ctypes (see exp_tpu_torch/native/__init__.py).  The hot
// function parses whitespace-separated numeric tables (the ascii body-file
// format) at strtod speed, which matters when bootstrapping 10M-particle
// runs from text ICs.
//
// Build:  g++ -O3 -shared -fPIC fastio.cpp -o libfastio.so

#include <cstdlib>

extern "C" {

// Parse up to max_rows rows of ncols doubles from the buffer `data`
// (NUL-terminated) starting at byte offset `start`.  One row per line:
// comment lines (first token non-numeric) are skipped; a line with FEWER
// than ncols numbers stops the parse (rows never merge across newlines —
// a missing value must not silently shift every later row).  Extra
// trailing columns per line are ignored.  Returns the number of complete
// rows written to `out` (row-major max_rows x ncols).
long parse_table(const char* data, long start, double* out,
                 long max_rows, int ncols)
{
    const char* p = data + start;
    long rows = 0;
    while (rows < max_rows) {
        // reach the next line's first token (newlines allowed here only)
        while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n')
            ++p;
        if (*p == '\0')
            return rows;
        int c = 0;
        bool bad = false;
        for (; c < ncols; ++c) {
            while (*p == ' ' || *p == '\t' || *p == '\r')
                ++p;                          // intra-line whitespace only
            if (*p == '\0' || *p == '\n') {   // short row
                bad = true;
                break;
            }
            char* end = nullptr;
            double v = strtod(p, &end);
            if (end == p) {                   // non-numeric token
                bad = true;
                break;
            }
            out[rows * ncols + c] = v;
            p = end;
        }
        if (!bad) {
            ++rows;
            // consume the remainder of the line (extra attributes)
            while (*p && *p != '\n') ++p;
        } else if (c == 0) {
            // comment/garbage line: skip it and continue
            while (*p && *p != '\n') ++p;
        } else {
            return rows;                      // partial numeric row: stop
        }
    }
    return rows;
}

// Count numeric columns in the first DATA row after `start`, skipping
// comment lines the same way parse_table does.
int count_columns(const char* data, long start)
{
    const char* p = data + start;
    for (;;) {
        while (*p == ' ' || *p == '\t' || *p == '\r' || *p == '\n') ++p;
        if (*p == '\0') return 0;
        char* end = nullptr;
        strtod(p, &end);
        if (end != p) break;                  // numeric: this is the row
        while (*p && *p != '\n') ++p;         // comment line: skip
    }
    int n = 0;
    while (*p && *p != '\n') {
        char* end = nullptr;
        strtod(p, &end);
        if (end == p) break;
        ++n;
        p = end;
        while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
    }
    return n;
}

}  // extern "C"
