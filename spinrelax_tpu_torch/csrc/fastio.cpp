// fastio: high-throughput numeric text table parsing for trajectory-scale
// inputs (PLUMED colvars, xvg tables).
//
// The reference parses colvar files token-by-token in Python
// (plumedcolvario.py:24-81) — ~50 MB/s at best.  This parser mmaps the
// file and runs a single strtod sweep, reaching several hundred MB/s on
// one core, and is exposed through a plain C ABI consumed via ctypes
// (no pybind11 dependency).
//
// Build: see build.sh (g++ -O3 -shared -fPIC fastio.cpp -o libfastio.so)

#include <cerrno>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Count data rows/cols of a whitespace-separated numeric table.
// Lines whose first non-blank character is in `skip_chars` are ignored.
// Returns 0 on success, negative errno-style codes on failure.
// n_cols is taken from the first data line; ragged rows cause -2.
int fastio_table_dims(const char* path, const char* skip_chars,
                      long* n_rows, long* n_cols);

// Parse into a caller-allocated row-major double buffer of
// n_rows*n_cols.  Returns number of values written, or negative code.
long fastio_parse_table(const char* path, const char* skip_chars,
                        double* out, long n_rows, long n_cols);

// Count '#! FIELDS' headers in a PLUMED colvar (replica chunks).
int fastio_count_fields_headers(const char* path, long* n_headers);

// Bulk "%16g"-formatted table writer (PLUMED-style colvar rows; the
// write-side counterpart of the parser: np.savetxt's per-row Python
// formatting dominates the orientation stage at 10^6 frames).
// append != 0 appends.  Returns 0 on success, -1 on I/O failure.
int fastio_write_table(const char* path, int append, const double* data,
                       long n_rows, long n_cols);
}

namespace {

struct MappedFile {
    const char* data = nullptr;
    size_t size = 0;
    int fd = -1;

    bool open_file(const char* path) {
        fd = ::open(path, O_RDONLY);
        if (fd < 0) return false;
        struct stat st;
        // On failure, reset fd before returning: the destructor also
        // closes, and a double ::close could destroy another thread's
        // recycled descriptor (the threaded XTC workers open files
        // concurrently).
        if (fstat(fd, &st) != 0) { ::close(fd); fd = -1; return false; }
        size = static_cast<size_t>(st.st_size);
        if (size == 0) { data = nullptr; return true; }
        void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
        if (p == MAP_FAILED) { ::close(fd); fd = -1; return false; }
        data = static_cast<const char*>(p);
        // Sequential advisory: big linear sweep.
        madvise(const_cast<char*>(data), size, MADV_SEQUENTIAL);
        return true;
    }

    ~MappedFile() {
        if (data) munmap(const_cast<char*>(data), size);
        if (fd >= 0) ::close(fd);
    }
};

inline bool is_blank(char c) { return c == ' ' || c == '\t' || c == '\r'; }

inline const char* skip_line(const char* p, const char* end) {
    while (p < end && *p != '\n') ++p;
    return p < end ? p + 1 : end;
}

}  // namespace

// strtod on a non-NUL-terminated mapping may walk past the final page
// when the file size is an exact page multiple: raw strtod is safe only
// when a terminator byte (whitespace/newline — anything non-numeric)
// provably exists before `end`.  A fixed "last 32 bytes" window is NOT
// enough: a >=32-char final token (e.g. '%.25e' output) with no trailing
// newline still scans one past the mapping.  Copy-terminate whenever the
// token itself reaches `end`.
static inline bool strtod_char(char c) {
    // Superset of bytes strtod can consume (digits, sign, dot, exponent,
    // hex/inf/nan letters) — anything else terminates its scan in-bounds.
    return (c >= '0' && c <= '9') || c == '+' || c == '-' || c == '.' ||
           (c >= 'a' && c <= 'z') || (c >= 'A' && c <= 'Z');
}

static double safe_strtod(const char* p, const char* end, char** next) {
    const char* q = p;
    while (q < end && strtod_char(*q)) ++q;
    if (q < end) return strtod(p, next);  // in-bounds terminator exists
    char tmp[64];
    size_t n = (size_t)(end - p);
    if (n >= sizeof tmp) n = sizeof tmp - 1;  // token longer than any real number
    memcpy(tmp, p, n);
    tmp[n] = 0;
    char* nx = nullptr;
    double v = strtod(tmp, &nx);
    *next = (char*)p + (nx - tmp);
    return v;
}

int fastio_table_dims(const char* path, const char* skip_chars,
                      long* n_rows, long* n_cols) {
    MappedFile mf;
    if (!mf.open_file(path)) return -1;
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    long rows = 0, cols = 0;
    while (p < end) {
        while (p < end && is_blank(*p)) ++p;
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (strchr(skip_chars, *p)) { p = skip_line(p, end); continue; }
        // Data line: count columns on the first one.
        if (cols == 0) {
            const char* q = p;
            long c = 0;
            while (q < end && *q != '\n') {
                while (q < end && is_blank(*q)) ++q;
                if (q >= end || *q == '\n') break;
                ++c;
                while (q < end && !is_blank(*q) && *q != '\n') ++q;
            }
            cols = c;
        }
        ++rows;
        p = skip_line(p, end);
    }
    *n_rows = rows;
    *n_cols = cols;
    return 0;
}

long fastio_parse_table(const char* path, const char* skip_chars,
                        double* out, long n_rows, long n_cols) {
    MappedFile mf;
    if (!mf.open_file(path)) return -1;
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    long written = 0;
    long row = 0;
    while (p < end && row < n_rows) {
        while (p < end && is_blank(*p)) ++p;
        if (p >= end) break;
        if (*p == '\n') { ++p; continue; }
        if (strchr(skip_chars, *p)) { p = skip_line(p, end); continue; }
        long col = 0;
        while (p < end && *p != '\n' && col < n_cols) {
            char* next = nullptr;
            double v = safe_strtod(p, end, &next);
            if (next == p) { return -2; }  // malformed token
            out[row * n_cols + col] = v;
            ++col;
            ++written;
            p = next;
            while (p < end && is_blank(*p)) ++p;
        }
        if (col != n_cols) return -3;  // ragged row (too few columns)
        if (p < end && *p != '\n' && *p != '\r') return -3;  // extra columns
        ++row;
        p = skip_line(p, end);
    }
    return written;
}

int fastio_write_table(const char* path, int append, const double* data,
                       long n_rows, long n_cols) {
    FILE* fp = fopen(path, append ? "ab" : "wb");
    if (!fp) return -1;
    const size_t CHUNK = 1 << 20;
    char* out = (char*)malloc(CHUNK + 4096);
    if (!out) { fclose(fp); return -1; }
    char buf[64];
    size_t off = 0;
    bool ok = true;
    for (long r = 0; r < n_rows && ok; r++) {
        for (long c = 0; c < n_cols && ok; c++) {
            int n = snprintf(buf, sizeof buf, c ? " %16g" : "%16g",
                             data[r * n_cols + c]);
            memcpy(out + off, buf, (size_t)n);
            off += (size_t)n;
            // Flush per VALUE: an end-of-row-only check would overflow
            // the fixed slack for wide tables (>= ~240 columns).
            if (off >= CHUNK) {
                ok = fwrite(out, 1, off, fp) == off;
                off = 0;
            }
        }
        out[off++] = '\n';
        if (off >= CHUNK) {
            ok = fwrite(out, 1, off, fp) == off;
            off = 0;
        }
    }
    if (ok && off) ok = fwrite(out, 1, off, fp) == off;
    free(out);
    int rc = fclose(fp);
    return (ok && rc == 0) ? 0 : -1;
}

int fastio_count_fields_headers(const char* path, long* n_headers) {
    MappedFile mf;
    if (!mf.open_file(path)) return -1;
    const char* p = mf.data;
    const char* end = mf.data + mf.size;
    long count = 0;
    while (p < end) {
        while (p < end && is_blank(*p)) ++p;
        if (p < end && *p == '#') {
            const char* q = p;
            const char* line_end = q;
            while (line_end < end && *line_end != '\n') ++line_end;
            // Match the Python readers exactly (parts[1] == 'FIELDS'):
            // FIELDS must be the SECOND whitespace token, not a
            // substring anywhere in the comment ('# note: FIELDS
            // unchanged' is not a header).
            while (q < line_end && !is_blank(*q)) ++q;  // skip '#!'/'#'
            while (q < line_end && is_blank(*q)) ++q;
            if (line_end - q >= 6 && memcmp(q, "FIELDS", 6) == 0 &&
                (q + 6 == line_end || is_blank(q[6])))
                ++count;
            p = line_end < end ? line_end + 1 : end;
            continue;
        }
        p = skip_line(p, end);
    }
    *n_headers = count;
    return 0;
}

// ===========================================================================
// numpy-exact float rendering: the fast path of io/xvg.print_sxylist.
//
// The reference prints each C(t) row as `str(np.array([ct, dCt]))` and the
// artefact parity tests pin those BYTES — so a fast writer must reproduce
// numpy 2.x's FloatingFormat (arrayprint.fillFormat) exactly: shortest
// round-trip digits capped at printoptions precision=8, the per-row
// positional/scientific switch (max>=1e8, min<1e-4 or max/min>1000), the
// per-row int/frac space padding (positional) and zero-padded mantissa +
// common exponent width (scientific), and numpy's nan/inf padding rules.
// Shortest digits come from std::to_chars (shortest correctly-rounded,
// the same contract as numpy's dragon4 unique=True); cap rounding uses
// glibc's correctly-rounded "%.8e"/"%.8f".  Pinned against the live
// Python rendering by a differential fuzz test (test_native.py).
// ===========================================================================

#include <charconv>
#include <cmath>

namespace npf {

struct Repr {
    char dig[48];  // significant digits, no '.', no sign
    int nd = 0;    // number of digits
    int e10 = 0;   // value = dig[0].dig[1..] x 10^e10
    bool neg = false;
    int cls = 0;   // 0 finite, 1 inf, 2 nan
};

// Parse "[-]d[.ddd]e[+-]dd" (to_chars / printf %e output) into Repr.
static void parse_sci(const char* b, const char* e, Repr& r) {
    r.neg = (b < e && *b == '-');
    if (r.neg) ++b;
    int nd = 0;
    for (; b < e && *b != 'e'; ++b)
        if (*b != '.') r.dig[nd++] = *b;
    r.nd = nd;
    int ex = 0, es = 1;
    if (b < e && *b == 'e') {
        ++b;
        if (*b == '-') { es = -1; ++b; }
        else if (*b == '+') ++b;
        for (; b < e; ++b) ex = ex * 10 + (*b - '0');
    }
    r.e10 = es * ex;
    r.cls = 0;
}

static void shortest(double v, bool f32, Repr& r) {
    if (std::isnan(v)) { r.cls = 2; r.neg = false; return; }
    if (std::isinf(v)) { r.cls = 1; r.neg = v < 0; return; }
    char buf[64];
    std::to_chars_result res = f32
        ? std::to_chars(buf, buf + sizeof buf, (float)v,
                        std::chars_format::scientific)
        : std::to_chars(buf, buf + sizeof buf, v,
                        std::chars_format::scientific);
    parse_sci(buf, res.ptr, r);
}

// Correctly-rounded `prec`-fractional-digit scientific rounding, then
// trailing zeros trimmed: dragon4 unique=True with a precision cutoff.
static void round_sci_capped(double v, int prec, Repr& r) {
    char buf[64];
    int n = snprintf(buf, sizeof buf, "%.*e", prec, v);
    parse_sci(buf, buf + n, r);
    while (r.nd > 1 && r.dig[r.nd - 1] == '0') --r.nd;
}

// Same cutoff but on FRACTIONAL digits in positional notation (%.*f).
static void round_pos_capped(double v, int prec, Repr& r) {
    char buf[700];
    int n = snprintf(buf, sizeof buf, "%.*f", prec, v);
    const char* b = buf;
    const char* e = buf + n;
    r.neg = (*b == '-');
    if (r.neg) ++b;
    const char* dot = b;
    while (dot < e && *dot != '.') ++dot;
    long intlen = dot - b;
    // position of the first significant (nonzero) digit
    const char* p = b;
    while (p < e && (*p == '0' || *p == '.')) ++p;
    if (p == e) {  // all zeros -> canonical 0
        r.dig[0] = '0'; r.nd = 1; r.e10 = 0; r.cls = 0;
        return;
    }
    if (p < dot) r.e10 = (int)(intlen - 1 - (p - b));
    else r.e10 = -(int)(p - dot);  // p-dot >= 1 -> e10 <= -1
    int nd = 0;
    for (; p < e; ++p)
        if (*p != '.' && nd < (int)sizeof r.dig) r.dig[nd++] = *p;
    while (nd > 1 && r.dig[nd - 1] == '0') --nd;
    r.nd = nd;
    r.cls = 0;
}

struct Elem {       // canonical per-element pieces for one row
    Repr r;
    int int_len;    // positional: len(sign+int digits); sci: 1+sign
    int frac_len;   // digits after the point (trim='.')
};

static const int CAP = 8;  // printoptions precision default

// out must have room; returns chars written.
static int put_spaces(char* o, int n) {
    for (int i = 0; i < n; ++i) o[i] = ' ';
    return n;
}

// Render one row (n values, optionally f32) exactly as
// str(np.asarray(row)).strip('[]').  Returns bytes written.
static long long render_row(const double* v, int n, bool f32, char* out) {
    Elem el[8];
    bool any_nonfinite = false, neg_inf = false;
    double max_val = 0.0, min_val = 0.0;
    bool have_nz = false, have_finite = false;
    for (int i = 0; i < n; ++i) {
        double x = f32 ? (double)(float)v[i] : v[i];
        if (std::isnan(x)) { any_nonfinite = true; continue; }
        if (std::isinf(x)) { any_nonfinite = true; neg_inf |= x < 0; continue; }
        have_finite = true;
        double a = std::fabs(x);
        if (a != 0.0) {
            if (!have_nz) { max_val = min_val = a; have_nz = true; }
            else {
                if (a > max_val) max_val = a;
                if (a < min_val) min_val = a;
            }
        }
    }
    bool exp_format = false;
    if (have_nz) {
        // numpy computes the ratio in the ARRAY dtype (f32 arrays use a
        // float32 division before comparing to 1000).
        double ratio = f32 ? (double)((float)max_val / (float)min_val)
                           : max_val / min_val;
        exp_format = (max_val >= 1.e8) || (min_val < 0.0001)
                     || (ratio > 1000.0);
    }

    int pad_left = 0, pad_right = 0, precision = 0, exp_size = 2;
    if (!have_finite) {
        // numpy: len(finite_vals)==0 -> pad_left = pad_right = 0
    } else if (exp_format) {
        for (int i = 0; i < n; ++i) {
            double x = f32 ? (double)(float)v[i] : v[i];
            Elem& E = el[i];
            shortest(x, f32, E.r);
            if (E.r.cls != 0) continue;
            if (E.r.nd - 1 > CAP) round_sci_capped(x, CAP, E.r);
            E.int_len = 1 + (E.r.neg ? 1 : 0);
            E.frac_len = E.r.nd - 1;
            int ed = std::abs(E.r.e10) >= 100 ? 3 : 2;  // >=2 exp digits
            if (std::abs(E.r.e10) >= 1000) ed = 4;
            if (ed > exp_size) exp_size = ed;
            if (E.int_len > pad_left) pad_left = E.int_len;
            if (E.frac_len > precision) precision = E.frac_len;
        }
        pad_right = exp_size + 2 + precision;
    } else {
        for (int i = 0; i < n; ++i) {
            double x = f32 ? (double)(float)v[i] : v[i];
            Elem& E = el[i];
            shortest(x, f32, E.r);
            if (E.r.cls != 0) continue;
            if (E.r.nd - 1 < E.r.e10) {
                // numpy's positional render passes min_digits=0, under
                // which dragon4 never early-stops ABOVE the ones digit:
                // -37701928.0f prints its exact integer digits, not the
                // zero-filled shortest "-3.770193e7" -> "-37701930.".
                // Such values are integral (binary spacing >= 1), so
                // "%.0f" reproduces the exact digit string.
                round_pos_capped(x, 0, E.r);
            }
            int frac = E.r.nd - 1 - E.r.e10;
            if (frac < 0) frac = 0;
            if (frac > CAP) {
                round_pos_capped(x, CAP, E.r);
                frac = E.r.nd - 1 - E.r.e10;
                if (frac < 0) frac = 0;
            }
            E.int_len = (E.r.e10 >= 0 ? E.r.e10 + 1 : 1) + (E.r.neg ? 1 : 0);
            E.frac_len = frac;
            if (E.int_len > pad_left) pad_left = E.int_len;
            if (E.frac_len > pad_right) pad_right = E.frac_len;
        }
    }
    if (any_nonfinite) {
        // numpy (arrayprint.fillFormat): pad_left widens so 'nan' /
        // '[-]inf' fit within pad_left + pad_right + 1 total width.
        int offset = pad_right + 1;  // +1 for the decimal point
        int a = 3 - offset;                       // len(nanstr)
        int b = 3 + (neg_inf ? 1 : 0) - offset;   // len(infstr) + neginf
        if (a > pad_left) pad_left = a;
        if (b > pad_left) pad_left = b;
    }

    char* o = out;
    for (int i = 0; i < n; ++i) {
        if (i) *o++ = ' ';
        double x = f32 ? (double)(float)v[i] : v[i];
        if (std::isnan(x) || std::isinf(x)) {
            char tmp[8];
            int tn = 0;
            if (std::isnan(x)) { memcpy(tmp, "nan", 3); tn = 3; }
            else if (x < 0) { memcpy(tmp, "-inf", 4); tn = 4; }
            else { memcpy(tmp, "inf", 3); tn = 3; }
            int width = pad_left + pad_right + 1;
            o += put_spaces(o, width > tn ? width - tn : 0);
            memcpy(o, tmp, tn); o += tn;
            continue;
        }
        const Elem& E = el[i];
        const Repr& r = E.r;
        if (exp_format) {
            // numpy renders with min_digits=precision and unique=True:
            // the mantissa is the TRUE value correctly rounded at
            // `precision` fractional digits (NOT the shortest repr
            // zero-padded) — 6.20694505e-8f at precision 7 prints
            // "6.2069446e-08", its real 8th digit.
            Repr rr;
            {
                char buf[64];
                int n = snprintf(buf, sizeof buf, "%.*e", precision, x);
                parse_sci(buf, buf + n, rr);
            }
            o += put_spaces(o, pad_left - E.int_len);
            if (rr.neg) *o++ = '-';
            *o++ = rr.dig[0];
            *o++ = '.';
            for (int k = 1; k < rr.nd; ++k) *o++ = rr.dig[k];
            for (int k = rr.nd - 1; k < precision; ++k) *o++ = '0';
            *o++ = 'e';
            *o++ = rr.e10 < 0 ? '-' : '+';
            int ae = std::abs(rr.e10);
            char ebuf[8];
            int en = 0;
            do { ebuf[en++] = '0' + ae % 10; ae /= 10; } while (ae);
            while (en < exp_size) ebuf[en++] = '0';
            while (en) *o++ = ebuf[--en];
        } else {
            o += put_spaces(o, pad_left - E.int_len);
            if (r.neg) *o++ = '-';
            if (r.e10 < 0) *o++ = '0';
            else {
                for (int k = 0; k <= r.e10; ++k)
                    *o++ = k < r.nd ? r.dig[k] : '0';
            }
            *o++ = '.';
            int written = 0;
            for (int k = -1; k > r.e10; --k) {  // leading frac zeros
                *o++ = '0'; ++written;
            }
            // for e10 < 0 ALL significant digits are fractional
            for (int k = (r.e10 >= 0 ? r.e10 + 1 : 0); k < r.nd; ++k) {
                *o++ = r.dig[k]; ++written;
            }
            // (written may exceed E.frac_len only never; pad to row width)
            o += put_spaces(o, pad_right - written);
        }
    }
    return o - out;
}

// Python-float repr (np.float64 scalar str): shortest digits, scientific
// iff e10 < -4 or e10 >= 16, integral values keep a trailing ".0".
static long long py_repr(double v, char* out) {
    char* o = out;
    if (std::isnan(v)) { memcpy(o, "nan", 3); return 3; }
    if (std::isinf(v)) {
        if (v < 0) { memcpy(o, "-inf", 4); return 4; }
        memcpy(o, "inf", 3); return 3;
    }
    Repr r;
    shortest(v, false, r);
    if (r.neg) *o++ = '-';
    if (r.e10 < -4 || r.e10 >= 16) {
        *o++ = r.dig[0];
        if (r.nd > 1) {
            *o++ = '.';
            for (int k = 1; k < r.nd; ++k) *o++ = r.dig[k];
        }
        *o++ = 'e';
        *o++ = r.e10 < 0 ? '-' : '+';
        int ae = std::abs(r.e10);
        char ebuf[8];
        int en = 0;
        do { ebuf[en++] = '0' + ae % 10; ae /= 10; } while (ae);
        while (en < 2) ebuf[en++] = '0';
        while (en) *o++ = ebuf[--en];
    } else if (r.e10 < 0) {
        *o++ = '0'; *o++ = '.';
        for (int k = -1; k > r.e10; --k) *o++ = '0';
        for (int k = 0; k < r.nd; ++k) *o++ = r.dig[k];
    } else {
        for (int k = 0; k <= r.e10; ++k) *o++ = k < r.nd ? r.dig[k] : '0';
        *o++ = '.';
        if (r.nd > r.e10 + 1)
            for (int k = r.e10 + 1; k < r.nd; ++k) *o++ = r.dig[k];
        else *o++ = '0';
    }
    return o - out;
}

}  // namespace npf

extern "C" {

// Format n_rows lines "py_repr(x[i]) <numpy row of y[i*n_cols..]>\n".
// y is float64 (y_is_f32=0) or float32 (y_is_f32=1).  Returns bytes
// written, or -1 if cap would overflow (caller re-allocates).
long long fastio_format_sxy(const double* x, const void* y, int y_is_f32,
                            long long n_rows, int n_cols,
                            char* out, long long cap) {
    if (n_cols < 1 || n_cols > 8) return -2;
    const float* yf = (const float*)y;
    const double* yd = (const double*)y;
    char* o = out;
    double row[8];
    for (long long i = 0; i < n_rows; ++i) {
        if (cap - (o - out) < 64 + 40 * n_cols) return -1;
        o += npf::py_repr(x[i], o);
        *o++ = ' ';
        for (int c = 0; c < n_cols; ++c)
            row[c] = y_is_f32 ? (double)yf[i * n_cols + c]
                              : yd[i * n_cols + c];
        o += npf::render_row(row, n_cols, y_is_f32 != 0, o);
        *o++ = '\n';
    }
    return o - out;
}

}  // extern "C"
