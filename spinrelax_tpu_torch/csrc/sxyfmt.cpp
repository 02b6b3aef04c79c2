// sxyfmt: the rows of io/xvg.print_sxylist (the C(t) files _Ctext.dat and
// _Ctint.dat), a whole (nSets, n, k) block in one call, its sets spread
// over worker threads.
//
// Each row is `py_repr(x[i]) + " " + str(np.asarray(row)).strip('[]')`:
// numpy 2.x's FloatingFormat (arrayprint.fillFormat) under the default
// printoptions -- shortest round-trip digits capped at precision=8, the
// per-row positional/scientific switch (max>=1e8, min<1e-4 or
// max/min>1000), the per-row int/frac space padding (positional) and the
// zero-padded mantissa and common exponent width (scientific), numpy's
// nan/inf padding -- beside Python's float repr of the lag.  The same
// renderer as csrc/fastio.cpp's fastio_format_sxy (kept as the JAX
// package's source), with every digit string from std::to_chars:
// shortest (dragon4 unique=True's contract) or at a precision, where it
// gives printf's correctly-rounded "%.*e" / "%.*f" digits of the C locale
// without printf's locale and format parsing.  Byte for byte the same
// output at any worker count; held to fastio_format_sxy and to numpy by
// tests/test_torch_fastio.py.
//
// Build: g++ -O3 -pthread -shared -fPIC sxyfmt.cpp -o libsxyfmt.so

#include <atomic>
#include <charconv>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace npf {

struct Repr {
    char dig[48];  // significant digits, no '.', no sign
    int nd = 0;    // number of digits
    int e10 = 0;   // value = dig[0].dig[1..] x 10^e10
    bool neg = false;
    int cls = 0;   // 0 finite, 1 inf, 2 nan
};

// Parse "[-]d[.ddd]e[+-]dd" (to_chars scientific output) into Repr.
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

// v correctly rounded to `prec` fractional digits in scientific notation.
static void round_sci(double v, int prec, Repr& r) {
    char buf[64];
    std::to_chars_result res = std::to_chars(
        buf, buf + sizeof buf, v, std::chars_format::scientific, prec);
    parse_sci(buf, res.ptr, r);
}

// Correctly-rounded `prec`-fractional-digit scientific rounding, then
// trailing zeros trimmed: dragon4 unique=True with a precision cutoff.
static void round_sci_capped(double v, int prec, Repr& r) {
    round_sci(v, prec, r);
    while (r.nd > 1 && r.dig[r.nd - 1] == '0') --r.nd;
}

// Same cutoff but on FRACTIONAL digits in positional notation.
static void round_pos_capped(double v, int prec, Repr& r) {
    char buf[700];
    std::to_chars_result res = std::to_chars(
        buf, buf + sizeof buf, v, std::chars_format::fixed, prec);
    const char* b = buf;
    const char* e = res.ptr;
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

static int put_spaces(char* o, int n) {
    for (int i = 0; i < n; ++i) o[i] = ' ';
    return n;
}

// Render one row (n <= 8 values, optionally f32) exactly as
// str(np.asarray(row)).strip('[]').  Returns bytes written.
static long long render_row(const double* v, int n, bool f32, char* out) {
    Elem el[8];
    bool any_nonfinite = false, neg_inf = false;
    double max_val = 0.0, min_val = 0.0;
    bool have_nz = false, have_finite = false;
    for (int i = 0; i < n; ++i) {
        double x = v[i];
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
            double x = v[i];
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
            double x = v[i];
            Elem& E = el[i];
            shortest(x, f32, E.r);
            if (E.r.cls != 0) continue;
            if (E.r.nd - 1 < E.r.e10) {
                // numpy's positional render passes min_digits=0, under
                // which dragon4 never early-stops ABOVE the ones digit:
                // -37701928.0f prints its exact integer digits, not the
                // zero-filled shortest "-3.770193e7" -> "-37701930.".
                // Such values are integral (binary spacing >= 1), so
                // zero fractional digits give the exact digit string.
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
        double x = v[i];
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
            // zero-padded) -- 6.20694505e-8f at precision 7 prints
            // "6.2069446e-08", its real 8th digit.
            Repr rr;
            round_sci(x, precision, rr);
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
            o += put_spaces(o, pad_right - written);  // pad to row width
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

// The rows of one set into [out, out + cap): bytes written, or -1 if a
// row might not fit.
static long long render_set(const double* x, const float* yf, const double* yd,
                            long long n_rows, int n_cols, char* out,
                            long long cap) {
    char* o = out;
    double row[8];
    for (long long i = 0; i < n_rows; ++i) {
        if (cap - (o - out) < 64 + 40 * n_cols) return -1;
        o += py_repr(x[i], o);
        *o++ = ' ';
        for (int c = 0; c < n_cols; ++c)
            row[c] = yf ? (double)yf[i * n_cols + c] : yd[i * n_cols + c];
        o += render_row(row, n_cols, yf != nullptr, o);
        *o++ = '\n';
    }
    return o - out;
}

}  // namespace npf

extern "C" {

// Render the sets of a (n_sets, n_rows, n_cols) block y, float32
// (y_is_f32=1) or float64, each row beside the float64 lag x[i], on
// n_threads workers.  Set s is rendered into out + s * set_cap; once every
// worker is done the sets are moved down to lie back to back, set s at
// the sum of the lengths before it, its length in set_len[s].  Returns
// the block's total bytes, -1 if a set might overrun set_cap, -2 if
// n_cols is not 1..8.
long long sxyfmt_render_sets(const double* x, const void* y, int y_is_f32,
                             long long n_sets, long long n_rows, int n_cols,
                             int n_threads, char* out, long long set_cap,
                             long long* set_len) {
    if (n_cols < 1 || n_cols > 8) return -2;
    const float* yf = y_is_f32 ? (const float*)y : nullptr;
    const double* yd = y_is_f32 ? nullptr : (const double*)y;
    const long long stride = n_rows * n_cols;
    std::atomic<long long> next{0};
    std::atomic<bool> overrun{false};
    auto work = [&]() {
        for (long long s; (s = next.fetch_add(1)) < n_sets;) {
            long long n = npf::render_set(
                x, yf ? yf + s * stride : nullptr, yd ? yd + s * stride : nullptr,
                n_rows, n_cols, out + s * set_cap, set_cap);
            set_len[s] = n;
            if (n < 0) overrun = true;
        }
    };
    int T = n_threads < 1 ? 1 : n_threads;
    if (T > n_sets) T = (int)(n_sets > 0 ? n_sets : 1);
    std::vector<std::thread> workers;
    try {
        workers.reserve(T - 1);
        for (int t = 1; t < T; ++t) workers.emplace_back(work);
    } catch (...) {
        // No more threads (a pids limit, no memory): the calling thread's
        // work() below takes every set that no worker took.
    }
    work();
    for (auto& w : workers) w.join();
    if (overrun) return -1;
    long long total = 0;
    for (long long s = 0; s < n_sets; ++s) {
        if (total != s * set_cap) memmove(out + total, out + s * set_cap, set_len[s]);
        total += set_len[s];
    }
    return total;
}

}  // extern "C"
