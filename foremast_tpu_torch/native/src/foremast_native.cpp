// Native data-plane hot path: metric-response parsing + grid resampling.
//
// The reference's data plane is Go services moving JSON over HTTP
// (foremast-service/pkg/prometheus/prometheushelper.go builds query_range
// URLs; the absent Python brain parsed the responses per job). At the TPU
// build's fleet scale (100k concurrent metric-pair windows, BASELINE.md)
// the host-side cost of turning HTTP bytes into dense device-ready arrays
// dominates the non-device time: Python json.loads allocates a DOM of
// ~10k lists per 7-day historical response. This extension replaces that
// with a single-pass extracting scanner and a C resampler; Python keeps a
// pure fallback (foremast_tpu/dataplane/fetch.py) for platforms without a
// toolchain.
//
// Exposed C ABI (ctypes, no pybind11 in this image):
//   fm_parse_series(buf, len, flavor, &ts, &vals, &n) -> 0 | negative error
//     flavor 0: Prometheus query_range   {"data":{"result":[{"values":
//               [[ts,"v"],...]},...]}}  — extracts every "values" array.
//     flavor 1: Wavefront chart API      {"timeseries":[{"data":
//               [[ts,v],...]},...]}     — extracts every "data" array whose
//               value is an array of [ts, v] pairs.
//     Pairs across all series are merged: sorted by timestamp, duplicates
//     averaged — byte-for-byte the semantics of fetch._avg_series.
//   fm_resample(ts, vals, n, start, end, step, out_vals, out_mask)
//     Snap samples onto the [start, end) grid: nearest slot, later samples
//     win, non-finite dropped — semantics of ops.windowing.resample_to_grid.
//   fm_parse_grid(buf, len, flavor, step, max_steps, out_vals, out_mask,
//                 &start) -> T | 0 (no samples) | -1 (malformed)
//     The fused hot path: response bytes -> dense grid in ONE call (and one
//     GIL release), combining fm_parse_series' scan/merge with the grid
//     derivation the engine does per window (engine/analyzer.py
//     _fetch_window: end = align(max_ts)+step, start clamped to max_steps)
//     and fm_resample — no intermediate (ts, vals) arrays ever cross the
//     ctypes boundary.
//   fm_free(p) frees arrays returned by fm_parse_series.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

struct Pair {
    double ts;
    double val;
};

class Scanner {
  public:
    Scanner(const char* buf, long len, int flavor, std::vector<Pair>* out)
        : p_(buf), end_(buf + len), flavor_(flavor), out_(out) {}

    // Parse one JSON value; returns false on malformed input. Nesting is
    // depth-limited: the scanner recurses per level, so a hostile body of
    // 200k '['s would otherwise smash the stack and take the engine process
    // with it — past the limit we bail and the caller falls back to the
    // Python parser, which raises a catchable error instead.
    bool value() {
        if (depth_ >= kMaxDepth) return false;
        ws();
        if (p_ >= end_) return false;
        ++depth_;
        bool ok;
        switch (*p_) {
            case '{': ok = object(); break;
            case '[': ok = array(false); break;
            case '"': ok = string(nullptr); break;
            case 't': ok = lit("true"); break;
            case 'f': ok = lit("false"); break;
            case 'n': ok = lit("null"); break;
            default:  ok = number(nullptr); break;
        }
        --depth_;
        return ok;
    }

  private:
    void ws() {
        while (p_ < end_ && (*p_ == ' ' || *p_ == '\t' || *p_ == '\n' || *p_ == '\r'))
            ++p_;
    }

    bool lit(const char* s) {
        size_t n = std::strlen(s);
        if (end_ - p_ < (long)n || std::memcmp(p_, s, n) != 0) return false;
        p_ += n;
        return true;
    }

    // Skip a string; if key is non-null, record whether it equals the
    // extraction key for the active flavor.
    bool string(bool* is_target_key) {
        if (*p_ != '"') return false;
        const char* start = ++p_;
        bool simple = true;
        while (p_ < end_) {
            if (*p_ == '\\') {
                simple = false;
                ++p_;
                if (p_ >= end_) return false;
                if (*p_ == 'u') {
                    if (end_ - p_ < 5) return false;
                    p_ += 4;
                }
                ++p_;
            } else if (*p_ == '"') {
                if (is_target_key) {
                    const char* key = flavor_ == 0 ? "values" : "data";
                    size_t klen = std::strlen(key);
                    *is_target_key = simple && (size_t)(p_ - start) == klen &&
                                     std::memcmp(start, key, klen) == 0;
                }
                last_str_ = start;
                last_str_len_ = p_ - start;
                ++p_;
                return true;
            } else {
                ++p_;
            }
        }
        return false;
    }

    bool number(double* out) {
        char* endp = nullptr;
        double v = std::strtod(p_, &endp);
        if (endp == p_) return false;
        if (out) *out = v;
        p_ = endp;
        return true;
    }

    bool object() {
        ++p_;  // '{'
        ws();
        if (p_ < end_ && *p_ == '}') { ++p_; return true; }
        while (p_ < end_) {
            ws();
            bool target = false;
            if (!string(&target)) return false;
            ws();
            if (p_ >= end_ || *p_ != ':') return false;
            ++p_;
            ws();
            if (target && p_ < end_ && *p_ == '[') {
                if (!array(true)) return false;
            } else {
                if (!value()) return false;
            }
            ws();
            if (p_ < end_ && *p_ == ',') { ++p_; continue; }
            if (p_ < end_ && *p_ == '}') { ++p_; return true; }
            return false;
        }
        return false;
    }

    // extracting=true: this array is the value of a target key; its
    // [ts, v] element pairs are appended to out_.
    bool array(bool extracting) {
        ++p_;  // '['
        ws();
        if (p_ < end_ && *p_ == ']') { ++p_; return true; }
        while (p_ < end_) {
            ws();
            if (extracting && *p_ == '[') {
                if (!sample()) return false;
            } else {
                if (!value()) return false;
            }
            ws();
            if (p_ < end_ && *p_ == ',') { ++p_; continue; }
            if (p_ < end_ && *p_ == ']') { ++p_; return true; }
            return false;
        }
        return false;
    }

    // One [ts, v] sample: ts is a number; v is a number or a string-encoded
    // number ("1.5", "NaN", "+Inf" — Prometheus wire format). Extra elements
    // are skipped.
    bool sample() {
        ++p_;  // '['
        ws();
        double ts;
        if (!number(&ts)) return false;
        ws();
        if (p_ >= end_ || *p_ != ',') return false;
        ++p_;
        ws();
        double val;
        if (p_ < end_ && *p_ == '"') {
            if (!string(nullptr)) return false;
            // strtod over the in-place string bytes; the closing quote
            // terminates the scan so no copy is needed
            char tmp[64];
            long n = std::min<long>(last_str_len_, 63);
            std::memcpy(tmp, last_str_, n);
            tmp[n] = 0;
            char* endp = nullptr;
            val = std::strtod(tmp, &endp);
            if (endp == tmp) return false;
        } else {
            if (!value_number(&val)) return false;
        }
        out_->push_back({ts, val});
        ws();
        while (p_ < end_ && *p_ == ',') {  // skip any extra elements
            ++p_;
            if (!value()) return false;
            ws();
        }
        if (p_ >= end_ || *p_ != ']') return false;
        ++p_;
        return true;
    }

    bool value_number(double* out) {
        // JSON numbers only here (null -> NaN for robustness)
        ws();
        if (p_ < end_ && *p_ == 'n') {
            if (!lit("null")) return false;
            *out = std::nan("");
            return true;
        }
        return number(out);
    }

    static constexpr int kMaxDepth = 64;

    const char* p_;
    const char* end_;
    int flavor_;
    std::vector<Pair>* out_;
    const char* last_str_ = nullptr;
    long last_str_len_ = 0;
    int depth_ = 0;
};

// Sort by timestamp and average duplicates in place (same-key accumulation
// as fetch._avg_series); returns the compacted length.
long merge_pairs(std::vector<Pair>& pairs) {
    // NaN timestamps CAN reach here: sample() reads ts with strtod, which
    // accepts "nan" — and a `<` comparator over NaN violates strict weak
    // ordering, which is undefined behavior in stable_sort (a real crash
    // vector on hostile bodies). Partition NaNs to the tail and sort only
    // the finite-ordered prefix; the duplicate loop below keeps each NaN
    // as its own group (NaN != NaN), mirroring the Python parser where
    // distinct float('nan') dict keys never merge.
    auto mid = std::stable_partition(
        pairs.begin(), pairs.end(),
        [](const Pair& a) { return !std::isnan(a.ts); });
    std::stable_sort(pairs.begin(), mid,
                     [](const Pair& a, const Pair& b) { return a.ts < b.ts; });
    long n = (long)pairs.size();
    long m = 0;
    long i = 0;
    while (i < n) {
        // j starts PAST i: for a NaN group the `==` below is false even
        // at j == i, and a non-advancing j stalled i while m kept
        // growing — an unbounded write past the vector (heap smash on a
        // hostile body; found by tests/test_native_fuzz.py).
        long j = i + 1;
        double acc = pairs[i].val;
        while (j < n && pairs[j].ts == pairs[i].ts) acc += pairs[j++].val;
        pairs[m].ts = pairs[i].ts;
        pairs[m].val = acc / (double)(j - i);
        ++m;
        i = j;
    }
    return m;
}

}  // namespace

extern "C" {

int fm_parse_series(const char* buf, long len, int flavor,
                    double** out_ts, double** out_vals, long* out_n) {
    if (!buf || len <= 0) return -1;
    std::vector<Pair> pairs;
    pairs.reserve(1024);
    Scanner sc(buf, len, flavor, &pairs);
    if (!sc.value()) return -2;

    long m = merge_pairs(pairs);
    double* ts = (double*)std::malloc(sizeof(double) * (m ? m : 1));
    double* vals = (double*)std::malloc(sizeof(double) * (m ? m : 1));
    if (!ts || !vals) {
        std::free(ts);
        std::free(vals);
        return -3;
    }
    for (long i = 0; i < m; ++i) {
        ts[i] = pairs[i].ts;
        vals[i] = pairs[i].val;
    }
    *out_ts = ts;
    *out_vals = vals;
    *out_n = m;
    return 0;
}

// a / b rounded toward -inf (b > 0), as Python's //
static long floor_div(long a, long b) {
    const long q = a / b;
    return (a % b != 0 && a < 0) ? q - 1 : q;
}

long fm_parse_grid(const char* buf, long len, int flavor,
                   long step, long max_steps,
                   float* out_vals, unsigned char* out_mask,
                   long* out_start) {
    if (!buf || len <= 0 || step <= 0 || max_steps <= 0) return -1;
    std::vector<Pair> pairs;
    pairs.reserve(1024);
    Scanner sc(buf, len, flavor, &pairs);
    if (!sc.value()) return -1;
    long m = merge_pairs(pairs);

    // grid span from the finite timestamps, aligned as align_step aligns:
    // int(t) (truncation toward zero) then a floor division by step, so a
    // negative timestamp lands on the slot the Python path gives it
    double tmin = 0.0, tmax = 0.0;
    bool any = false;
    for (long i = 0; i < m; ++i) {
        double t = pairs[i].ts;
        if (!std::isfinite(t)) continue;
        if (!any) { tmin = tmax = t; any = true; }
        else {
            if (t < tmin) tmin = t;
            if (t > tmax) tmax = t;
        }
    }
    *out_start = 0;
    if (!any) return 0;
    // a double -> long cast outside long's range is undefined behavior,
    // and a hostile body can carry ts = 1e300; clamp the span endpoints
    // well inside long range (real unix times are ~1.7e9 — anything near
    // the cap is garbage whose samples the fill loop drops anyway)
    const double kTsCap = 4.0e18;
    tmax = std::clamp(tmax, -kTsCap, kTsCap);
    tmin = std::clamp(tmin, -kTsCap, kTsCap);
    long end = floor_div((long)tmax, step) * step + step;
    long start = floor_div((long)tmin, step) * step;
    if (start < end - max_steps * step) start = end - max_steps * step;
    long T = (end - start) / step;
    if (T < 1) T = 1;
    if (T > max_steps) T = max_steps;

    for (long i = 0; i < T; ++i) {
        out_vals[i] = 0.0f;
        out_mask[i] = 0;
    }
    for (long i = 0; i < m; ++i) {
        double t = pairs[i].ts, v = pairs[i].val;
        if (!std::isfinite(t) || !std::isfinite(v)) continue;
        if (t < (double)start || t >= (double)end) continue;
        long idx = (long)std::nearbyint((t - (double)start) / (double)step);
        if (idx < 0) idx = 0;
        if (idx > T - 1) idx = T - 1;
        out_vals[idx] = (float)v;
        out_mask[idx] = 1;
    }
    *out_start = start;
    return T;
}

void fm_resample(const double* ts, const double* vals, long n,
                 long start, long end, long step,
                 float* out_vals, unsigned char* out_mask) {
    long T = (end - start) / step;
    if (T < 1) T = 1;
    for (long i = 0; i < T; ++i) {
        out_vals[i] = 0.0f;
        out_mask[i] = 0;
    }
    for (long i = 0; i < n; ++i) {
        double t = ts[i], v = vals[i];
        if (!std::isfinite(t) || !std::isfinite(v)) continue;
        if (t < (double)start || t >= (double)end) continue;
        // nearbyint under the default FE_TONEAREST mode rounds half-to-even,
        // matching np.round in the Python resampler exactly
        long idx = (long)std::nearbyint((t - (double)start) / (double)step);
        if (idx < 0) idx = 0;
        if (idx > T - 1) idx = T - 1;
        out_vals[idx] = (float)v;
        out_mask[idx] = 1;
    }
}

long fm_render_matrix(long ts0, long step, const double* vals, long n,
                      char* out, long out_cap) {
    // Serialize n grid samples into the query_range matrix "values"
    // payload: [ts,"v"],[ts,"v"],... at fixed 4-decimal precision — the
    // render twin of the parse scanner above, for in-process backends
    // (simfleet) whose Python f-string join dominated the serve path at
    // 100k-fleet warm fetches. glibc printf rounds %.4f correctly like
    // Python's fixed-precision format, so rendered bodies stay
    // byte-identical to the Python fallback (parity-pinned in
    // tests/test_simfleet.py). Returns bytes written, or -1 when the
    // caller's buffer would overflow (caller falls back to Python).
    long w = 0;
    for (long i = 0; i < n; ++i) {
        if (i) {
            if (out_cap - w < 1) return -1;
            out[w++] = ',';
        }
        int k = std::snprintf(out + w, (size_t)(out_cap - w),
                              "[%ld,\"%.4f\"]", ts0 + i * step, vals[i]);
        if (k < 0 || (long)k >= out_cap - w) return -1;
        w += k;
    }
    return w;
}

void fm_free(void* p) { std::free(p); }

}  // extern "C"
