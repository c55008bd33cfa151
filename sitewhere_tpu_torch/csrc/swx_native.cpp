// The telemetry store's host loops: the columnar ring append and the
// window / timestamp / latest gathers that every persisted event and
// every store read passes through (persistence/telemetry.py). The
// store lives in host memory, so this is C++ for the CPU, not a CUDA
// kernel: numpy's vectorised append needs a stable sort + unique +
// cumcount to keep per-device order; this single pass is a cursor-
// chasing loop and handles in-batch duplicates by construction.
//
// The same four entry points and semantics as the JAX package's
// native/swx_native.cpp; the numpy functions in persistence/telemetry.py
// (`append_plain`, `window_plain`, `window_ts_plain`, `latest_plain`)
// are their plain versions, and the tests hold the two bit-equal.
//
// Contract notes:
// - All arrays are caller-allocated, C-contiguous; this code never
//   allocates or retains pointers.
// - Caller guarantees every dev[i] < capacity (the Python wrapper grows
//   the table first).
// - ctypes releases the GIL for the duration of each call, so appends
//   from worker threads run in parallel.
//
// Build (ops/build.py, at first use): g++ -O3 -shared -fPIC

#include <cstdint>
#include <cstring>

extern "C" {

// Append n events into the [capacity, history] ring (values f32, ts f64),
// preserving arrival order per device. Returns n.
int64_t swx_telemetry_append(
    float* values, double* ts_tab, int64_t* cursor, int64_t* count,
    int64_t capacity, int64_t history,
    const uint32_t* dev, const float* vals, const double* ts, int64_t n) {
    (void)capacity;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t d = dev[i];
        const int64_t pos = cursor[d];
        values[d * history + pos] = vals[i];
        ts_tab[d * history + pos] = ts[i];
        const int64_t next = pos + 1;
        cursor[d] = next == history ? 0 : next;
        if (count[d] < history) ++count[d];
    }
    return n;
}

// Gather the last `w` values per device, chronological, left-padded.
// out: [n, w] f32; valid_out: [n, w] bool (uint8).
void swx_window_gather(
    const float* values, const int64_t* cursor, const int64_t* count,
    int64_t history, const uint32_t* dev, int64_t n, int64_t w,
    float* out, uint8_t* valid_out) {
    for (int64_t j = 0; j < n; ++j) {
        const int64_t d = dev[j];
        const int64_t cur = cursor[d];
        const int64_t cnt = count[d] < w ? count[d] : w;
        const int64_t pad = w - cnt;
        float* orow = out + j * w;
        uint8_t* vrow = valid_out + j * w;
        const float* vtab = values + d * history;
        // start of the chronological window in ring coordinates
        int64_t pos = cur - w;
        pos %= history;
        if (pos < 0) pos += history;
        // padded slots carry whatever ring data sits there, exactly like
        // the numpy gather — the valid mask is the contract
        for (int64_t k = 0; k < w; ++k) {
            orow[k] = vtab[pos];
            vrow[k] = k >= pad;
            ++pos;
            if (pos == history) pos = 0;
        }
    }
}

// Gather the last `w` timestamps per device (chronological).
void swx_window_ts_gather(
    const double* ts_tab, const int64_t* cursor,
    int64_t history, const uint32_t* dev, int64_t n, int64_t w,
    double* out) {
    for (int64_t j = 0; j < n; ++j) {
        const int64_t d = dev[j];
        int64_t pos = (cursor[d] - w) % history;
        if (pos < 0) pos += history;
        double* orow = out + j * w;
        const double* ttab = ts_tab + d * history;
        for (int64_t k = 0; k < w; ++k) {
            orow[k] = ttab[pos];
            ++pos;
            if (pos == history) pos = 0;
        }
    }
}

// Latest (value, ts) per device; ts==0 where never written.
void swx_latest(
    const float* values, const double* ts_tab, const int64_t* cursor,
    int64_t history, const uint32_t* dev, int64_t n,
    float* val_out, double* ts_out) {
    for (int64_t j = 0; j < n; ++j) {
        const int64_t d = dev[j];
        int64_t pos = cursor[d] - 1;
        if (pos < 0) pos += history;
        val_out[j] = values[d * history + pos];
        ts_out[j] = ts_tab[d * history + pos];
    }
}

}  // extern "C"
