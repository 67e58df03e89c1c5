// r4w_capi.cpp — C API implementation for the r4w_tpu host-side core.
//
// See r4w_capi.h for the surface contract. Algorithms mirror the
// Python package bit-for-bit where integers are involved (Gray maps,
// LoRa whitening LFSR, Hamming(4,4+cr) parities, interleaver) and
// phase-law-for-phase-law on the chirp/constellation math
// (waveforms/lora/chirp.py, waveforms/linear_mod.py), so
// tests/test_capi.py can cross-validate C output against JAX output.
// Role parity: crates/r4w-ffi/src/lib.rs (re-designed, not translated).
//
// Build: g++ -O2 -shared -fPIC -o libr4w.so r4w_capi.cpp

#include "r4w_capi.h"

#include <atomic>
#include <cmath>
#include <complex>
#include <cstring>
#include <new>
#include <vector>

namespace {

using cplx = std::complex<double>;

constexpr double kPi = 3.14159265358979323846;

bool is_pow2(size_t n) { return n != 0 && (n & (n - 1)) == 0; }

size_t next_pow2(size_t n) {
    size_t p = 1;
    while (p < n) p <<= 1;
    return p;
}

// ------------------------------------------------------------------
// Radix-2 iterative FFT core (in place, size must be a power of two).
// ------------------------------------------------------------------

void fft_radix2(cplx *a, size_t n, bool inverse) {
    // bit-reversal permutation
    for (size_t i = 1, j = 0; i < n; ++i) {
        size_t bit = n >> 1;
        for (; j & bit; bit >>= 1) j ^= bit;
        j ^= bit;
        if (i < j) std::swap(a[i], a[j]);
    }
    for (size_t len = 2; len <= n; len <<= 1) {
        double ang = 2.0 * kPi / (double)len * (inverse ? 1.0 : -1.0);
        cplx wlen(std::cos(ang), std::sin(ang));
        for (size_t i = 0; i < n; i += len) {
            cplx w(1.0, 0.0);
            for (size_t k = 0; k < len / 2; ++k) {
                cplx u = a[i + k];
                cplx v = a[i + k + len / 2] * w;
                a[i + k] = u + v;
                a[i + k + len / 2] = u - v;
                w *= wlen;
            }
        }
    }
    if (inverse) {
        for (size_t i = 0; i < n; ++i) a[i] /= (double)n;
    }
}

// Bluestein's algorithm: arbitrary-size DFT via one pow2 convolution.
void fft_bluestein(cplx *x, size_t n, bool inverse) {
    const double sign = inverse ? 1.0 : -1.0;
    const size_t m = next_pow2(2 * n - 1);
    std::vector<cplx> w(n);          // chirp factors e^{sign*i*pi*k^2/n}
    for (size_t k = 0; k < n; ++k) {
        // k^2 mod 2n keeps the angle small for large k
        unsigned long long k2 = ((unsigned long long)k * k) % (2ULL * n);
        double ang = sign * kPi * (double)k2 / (double)n;
        w[k] = cplx(std::cos(ang), std::sin(ang));
    }
    std::vector<cplx> a(m, cplx(0, 0)), b(m, cplx(0, 0));
    for (size_t k = 0; k < n; ++k) a[k] = x[k] * w[k];
    b[0] = std::conj(w[0]);
    for (size_t k = 1; k < n; ++k)
        b[k] = b[m - k] = std::conj(w[k]);
    fft_radix2(a.data(), m, false);
    fft_radix2(b.data(), m, false);
    for (size_t k = 0; k < m; ++k) a[k] *= b[k];
    fft_radix2(a.data(), m, true);
    for (size_t k = 0; k < n; ++k) x[k] = a[k] * w[k];
    if (inverse) {
        for (size_t k = 0; k < n; ++k) x[k] /= (double)n;
    }
}

void fft_any(cplx *a, size_t n, bool inverse) {
    if (is_pow2(n)) fft_radix2(a, n, inverse);
    else fft_bluestein(a, n, inverse);
}

// ------------------------------------------------------------------
// Shared LoRa math (chirp.py / coding.py conventions)
// ------------------------------------------------------------------

struct ChirpTable {
    int sf = 7;
    uint32_t bw = 125000;
    size_t osf = 1;
    std::vector<cplx> up, down;  // length chips*osf

    size_t chips() const { return (size_t)1 << sf; }
    size_t sps() const { return chips() * osf; }

    void build() {
        const size_t n = sps();
        up.resize(n);
        down.resize(n);
        const double ts = 1.0 / ((double)bw * (double)osf);
        const double t_symbol = (double)chips() / (double)bw;
        const double df = (double)bw / t_symbol;
        for (size_t i = 0; i < n; ++i) {
            double t = (double)i * ts;
            double up_ph = 2.0 * kPi * (-(double)bw / 2.0 * t
                                        + df / 2.0 * t * t);
            up[i] = cplx(std::cos(up_ph), std::sin(up_ph));
            double dn_ph = -up_ph;
            down[i] = cplx(std::cos(dn_ph), std::sin(dn_ph));
        }
    }

    // symbol chirp = cyclic rotation of the base upchirp
    void symbol(uint32_t sym, cplx *out) const {
        const size_t n = sps();
        const size_t shift = ((size_t)sym * osf) % n;
        for (size_t i = 0; i < n; ++i) out[i] = up[(i + shift) % n];
    }
};

int popcount8(unsigned v) { return __builtin_popcount(v & 0xFFu); }

// LoRa whitening PRBS: 8-bit LFSR, feedback = parity(state & 0x3A),
// output bit = old MSB (coding.py _whitening_sequence).
std::vector<uint8_t> whitening_sequence(size_t n_bytes) {
    std::vector<uint8_t> out(n_bytes);
    unsigned state = 0xFF;
    for (size_t b = 0; b < n_bytes; ++b) {
        unsigned byte = 0;
        for (int i = 0; i < 8; ++i) {
            unsigned fb = (unsigned)(popcount8(state & 0x3A) & 1);
            unsigned msb = (state >> 7) & 1u;
            state = ((state << 1) | fb) & 0xFFu;
            byte |= msb << (7 - i);
        }
        out[b] = (uint8_t)byte;
    }
    return out;
}

// Hamming(4, 4+cr) parity rows (coding.py _PARITY_ROWS).
const int kParityRows[5][4][4] = {
    {},  // cr=0 unused
    {{1, 1, 1, 1}},
    {{1, 0, 1, 1}, {0, 1, 1, 1}},
    {{1, 0, 1, 1}, {1, 1, 1, 0}, {0, 1, 1, 1}},
    {{1, 0, 1, 1}, {1, 1, 1, 0}, {1, 1, 0, 1}, {0, 1, 1, 1}},
};

uint32_t hamming_encode_nibble(uint32_t data, int cr) {
    data &= 0xF;
    int bits[4];
    for (int i = 0; i < 4; ++i) bits[i] = (int)((data >> (3 - i)) & 1);
    uint32_t cw = data;
    for (int r = 0; r < cr; ++r) {
        int p = 0;
        for (int i = 0; i < 4; ++i) p += kParityRows[cr][r][i] * bits[i];
        cw |= (uint32_t)(p & 1) << (4 + r);
    }
    return cw;
}

// Minimum-distance decode; corrects one bit at CR4/7 and CR4/8
// (coding.py _hamming_tables decode rule).
uint32_t hamming_decode_cw(uint32_t w, int cr) {
    const uint32_t mask = (1u << (4 + cr)) - 1u;
    w &= mask;
    const int t = (cr >= 3) ? 1 : 0;
    int best = 0, best_d = 32;
    for (uint32_t data = 0; data < 16; ++data) {
        uint32_t cw = hamming_encode_nibble(data, cr);
        int d = __builtin_popcount(w ^ cw);
        if (d < best_d) { best_d = d; best = (int)data; }
    }
    return best_d <= t ? (uint32_t)best : (w & 0xF);
}

uint32_t gray_encode_u(uint32_t x) { return x ^ (x >> 1); }

uint32_t gray_decode_u(uint32_t g) {
    g ^= g >> 8; g ^= g >> 4; g ^= g >> 2; g ^= g >> 1;
    return g;
}

// Diagonal interleaver over one block (coding.py interleave):
// symbols[(i+j) % n_bits] bit i = codeword[i] bit j.
void interleave_block(const uint32_t *cw, int sf, int cr, uint32_t *sym) {
    const int n_bits = 4 + cr;
    for (int s = 0; s < n_bits; ++s) sym[s] = 0;
    for (int i = 0; i < sf; ++i)
        for (int j = 0; j < n_bits; ++j)
            sym[(i + j) % n_bits] |= ((cw[i] >> j) & 1u) << i;
}

void deinterleave_block(const uint32_t *sym, int sf, int cr,
                        uint32_t *cw) {
    const int n_bits = 4 + cr;
    for (int i = 0; i < sf; ++i) {
        cw[i] = 0;
        for (int j = 0; j < n_bits; ++j)
            cw[i] |= ((sym[(i + j) % n_bits] >> i) & 1u) << j;
    }
}

// ------------------------------------------------------------------
// PSK tables (linear_mod.py: Gray map + constellation)
// ------------------------------------------------------------------

const int kGray4[4] = {0, 1, 3, 2};

void psk_constellation(int m, cplx *out) {
    const double offset = (m == 4) ? kPi / 4.0 : 0.0;
    for (int i = 0; i < m; ++i) {
        double ang = offset + 2.0 * kPi * (double)i / (double)m;
        out[i] = cplx(std::cos(ang), std::sin(ang));
    }
}

// value_to_index: inv[gray_map[i]] = i
void psk_value_to_index(int m, int *v2i) {
    for (int i = 0; i < m; ++i) {
        int g = (m == 4) ? kGray4[i] : i;  // identity for BPSK
        v2i[g] = i;
    }
}

}  // namespace

// ==================================================================
// Version / init
// ==================================================================

extern "C" const char *r4w_version(void) { return "0.3.0"; }
extern "C" int r4w_abi_version(void) { return 1; }
extern "C" r4w_error_t r4w_init(void) { return R4W_OK; }

// ==================================================================
// Complex helpers
// ==================================================================

extern "C" r4w_complex_t r4w_complex_new(double re, double im) {
    return {re, im};
}

extern "C" r4w_complex_t r4w_complex_from_polar(double magnitude,
                                                double phase) {
    return {magnitude * std::cos(phase), magnitude * std::sin(phase)};
}

extern "C" double r4w_complex_magnitude(r4w_complex_t c) {
    return std::hypot(c.re, c.im);
}

extern "C" double r4w_complex_phase(r4w_complex_t c) {
    return std::atan2(c.im, c.re);
}

extern "C" double r4w_complex_power(r4w_complex_t c) {
    return c.re * c.re + c.im * c.im;
}

extern "C" r4w_complex_t r4w_complex_conj(r4w_complex_t c) {
    return {c.re, -c.im};
}

extern "C" r4w_complex_t r4w_complex_mul(r4w_complex_t a,
                                         r4w_complex_t b) {
    return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}

extern "C" r4w_complex_t r4w_complex_add(r4w_complex_t a,
                                         r4w_complex_t b) {
    return {a.re + b.re, a.im + b.im};
}

// ==================================================================
// FFT
// ==================================================================

struct r4w_fft {
    size_t size;
};

extern "C" r4w_fft_t *r4w_fft_new(size_t size) {
    if (size == 0) return nullptr;
    return new (std::nothrow) r4w_fft{size};
}

extern "C" void r4w_fft_free(r4w_fft_t *fft) { delete fft; }

extern "C" size_t r4w_fft_size(const r4w_fft_t *fft) {
    return fft ? fft->size : 0;
}

extern "C" r4w_error_t r4w_fft_forward(r4w_fft_t *fft,
                                       r4w_complex_t *buffer,
                                       size_t len) {
    if (!fft || !buffer) return R4W_NULL_POINTER;
    if (len != fft->size) return R4W_INVALID_SIZE;
    fft_any(reinterpret_cast<cplx *>(buffer), len, false);
    return R4W_OK;
}

extern "C" r4w_error_t r4w_fft_inverse(r4w_fft_t *fft,
                                       r4w_complex_t *buffer,
                                       size_t len) {
    if (!fft || !buffer) return R4W_NULL_POINTER;
    if (len != fft->size) return R4W_INVALID_SIZE;
    fft_any(reinterpret_cast<cplx *>(buffer), len, true);
    return R4W_OK;
}

extern "C" r4w_error_t r4w_fft_find_peak(const r4w_complex_t *spectrum,
                                         size_t len, size_t *bin,
                                         double *magnitude,
                                         double *phase) {
    if (!spectrum) return R4W_NULL_POINTER;
    if (len == 0) return R4W_INVALID_SIZE;
    size_t best = 0;
    double best_p = -1.0;
    for (size_t i = 0; i < len; ++i) {
        double p = spectrum[i].re * spectrum[i].re
                 + spectrum[i].im * spectrum[i].im;
        if (p > best_p) { best_p = p; best = i; }
    }
    if (bin) *bin = best;
    if (magnitude) *magnitude = std::sqrt(best_p);
    if (phase) *phase = std::atan2(spectrum[best].im, spectrum[best].re);
    return R4W_OK;
}

extern "C" r4w_error_t r4w_fft_power_spectrum_db(
        const r4w_complex_t *input, double *output_db, size_t len) {
    if (!input || !output_db) return R4W_NULL_POINTER;
    if (len == 0) return R4W_INVALID_SIZE;
    for (size_t i = 0; i < len; ++i) {
        double p = input[i].re * input[i].re + input[i].im * input[i].im;
        output_db[i] = (p > 1e-20) ? 10.0 * std::log10(p) : -200.0;
    }
    return R4W_OK;
}

// ==================================================================
// Chirp generator
// ==================================================================

struct r4w_chirp {
    ChirpTable t;
};

extern "C" r4w_chirp_t *r4w_chirp_new(uint8_t spreading_factor,
                                      uint32_t bandwidth_hz,
                                      size_t oversample) {
    if (spreading_factor < 5 || spreading_factor > 12) return nullptr;
    if (bandwidth_hz == 0 || oversample == 0) return nullptr;
    auto *c = new (std::nothrow) r4w_chirp;
    if (!c) return nullptr;
    c->t.sf = spreading_factor;
    c->t.bw = bandwidth_hz;
    c->t.osf = oversample;
    c->t.build();
    return c;
}

extern "C" void r4w_chirp_free(r4w_chirp_t *chirp) { delete chirp; }

extern "C" size_t r4w_chirp_samples_per_symbol(const r4w_chirp_t *c) {
    return c ? c->t.sps() : 0;
}

extern "C" double r4w_chirp_bandwidth(const r4w_chirp_t *c) {
    return c ? (double)c->t.bw : 0.0;
}

static r4w_error_t copy_chirp(const std::vector<cplx> &src,
                              r4w_complex_t *buffer, size_t len) {
    if (!buffer) return R4W_NULL_POINTER;
    if (len < src.size()) return R4W_INVALID_SIZE;
    for (size_t i = 0; i < src.size(); ++i)
        buffer[i] = {src[i].real(), src[i].imag()};
    return R4W_OK;
}

extern "C" r4w_error_t r4w_chirp_generate_upchirp(const r4w_chirp_t *c,
                                                  r4w_complex_t *buffer,
                                                  size_t len) {
    if (!c) return R4W_NULL_POINTER;
    return copy_chirp(c->t.up, buffer, len);
}

extern "C" r4w_error_t r4w_chirp_generate_downchirp(
        const r4w_chirp_t *c, r4w_complex_t *buffer, size_t len) {
    if (!c) return R4W_NULL_POINTER;
    return copy_chirp(c->t.down, buffer, len);
}

extern "C" r4w_error_t r4w_chirp_modulate_symbol(const r4w_chirp_t *c,
                                                 uint16_t symbol,
                                                 r4w_complex_t *buffer,
                                                 size_t len) {
    if (!c || !buffer) return R4W_NULL_POINTER;
    const size_t n = c->t.sps();
    if (len < n) return R4W_INVALID_SIZE;
    std::vector<cplx> tmp(n);
    c->t.symbol(symbol, tmp.data());
    for (size_t i = 0; i < n; ++i)
        buffer[i] = {tmp[i].real(), tmp[i].imag()};
    return R4W_OK;
}

// ==================================================================
// SPSC ring buffer
// ==================================================================

struct r4w_ringbuffer {
    std::vector<r4w_complex_t> buf;
    size_t mask;
    std::atomic<size_t> head{0};  // write index
    std::atomic<size_t> tail{0};  // read index
};

extern "C" r4w_ringbuffer_t *r4w_ringbuffer_new(size_t capacity) {
    if (capacity < 2) return nullptr;
    auto *rb = new (std::nothrow) r4w_ringbuffer;
    if (!rb) return nullptr;
    size_t cap = next_pow2(capacity);
    rb->buf.resize(cap);
    rb->mask = cap - 1;
    return rb;
}

extern "C" void r4w_ringbuffer_free(r4w_ringbuffer_t *rb) { delete rb; }

extern "C" size_t r4w_ringbuffer_capacity(const r4w_ringbuffer_t *rb) {
    return rb ? rb->buf.size() : 0;
}

extern "C" size_t r4w_ringbuffer_len(const r4w_ringbuffer_t *rb) {
    if (!rb) return 0;
    return rb->head.load(std::memory_order_acquire)
         - rb->tail.load(std::memory_order_acquire);
}

extern "C" int r4w_ringbuffer_is_empty(const r4w_ringbuffer_t *rb) {
    return r4w_ringbuffer_len(rb) == 0;
}

extern "C" int r4w_ringbuffer_is_full(const r4w_ringbuffer_t *rb) {
    return rb ? r4w_ringbuffer_len(rb) == rb->buf.size() : 0;
}

extern "C" r4w_error_t r4w_ringbuffer_push(r4w_ringbuffer_t *rb,
                                           r4w_complex_t s) {
    if (!rb) return R4W_NULL_POINTER;
    size_t h = rb->head.load(std::memory_order_relaxed);
    size_t t = rb->tail.load(std::memory_order_acquire);
    if (h - t == rb->buf.size()) return R4W_BUFFER_FULL;
    rb->buf[h & rb->mask] = s;
    rb->head.store(h + 1, std::memory_order_release);
    return R4W_OK;
}

extern "C" r4w_error_t r4w_ringbuffer_pop(r4w_ringbuffer_t *rb,
                                          r4w_complex_t *out) {
    if (!rb || !out) return R4W_NULL_POINTER;
    size_t t = rb->tail.load(std::memory_order_relaxed);
    size_t h = rb->head.load(std::memory_order_acquire);
    if (h == t) return R4W_BUFFER_EMPTY;
    *out = rb->buf[t & rb->mask];
    rb->tail.store(t + 1, std::memory_order_release);
    return R4W_OK;
}

extern "C" size_t r4w_ringbuffer_push_slice(r4w_ringbuffer_t *rb,
                                            const r4w_complex_t *data,
                                            size_t len) {
    if (!rb || !data) return 0;
    size_t h = rb->head.load(std::memory_order_relaxed);
    size_t t = rb->tail.load(std::memory_order_acquire);
    size_t room = rb->buf.size() - (h - t);
    size_t n = len < room ? len : room;
    for (size_t i = 0; i < n; ++i) rb->buf[(h + i) & rb->mask] = data[i];
    rb->head.store(h + n, std::memory_order_release);
    return n;
}

extern "C" size_t r4w_ringbuffer_pop_slice(r4w_ringbuffer_t *rb,
                                           r4w_complex_t *out,
                                           size_t len) {
    if (!rb || !out) return 0;
    size_t t = rb->tail.load(std::memory_order_relaxed);
    size_t h = rb->head.load(std::memory_order_acquire);
    size_t avail = h - t;
    size_t n = len < avail ? len : avail;
    for (size_t i = 0; i < n; ++i) out[i] = rb->buf[(t + i) & rb->mask];
    rb->tail.store(t + n, std::memory_order_release);
    return n;
}

// ==================================================================
// Signal utilities
// ==================================================================

extern "C" r4w_error_t r4w_generate_tone(double frequency,
                                         double sample_rate,
                                         r4w_complex_t *buffer,
                                         size_t len) {
    if (!buffer) return R4W_NULL_POINTER;
    if (len == 0 || sample_rate <= 0.0) return R4W_INVALID_PARAMETER;
    const double inc = 2.0 * kPi * frequency / sample_rate;
    for (size_t i = 0; i < len; ++i) {
        double ph = inc * (double)i;
        buffer[i] = {std::cos(ph), std::sin(ph)};
    }
    return R4W_OK;
}

extern "C" r4w_error_t r4w_add_awgn(r4w_complex_t *buffer, size_t len,
                                    double snr_db) {
    if (!buffer) return R4W_NULL_POINTER;
    if (len == 0) return R4W_INVALID_SIZE;
    double sig_p = 0.0;
    for (size_t i = 0; i < len; ++i)
        sig_p += buffer[i].re * buffer[i].re + buffer[i].im * buffer[i].im;
    sig_p /= (double)len;
    const double noise_p = sig_p / std::pow(10.0, snr_db / 10.0);
    const double std_per_dim = std::sqrt(noise_p / 2.0);
    // deterministic LCG + Box-Muller (seeded; reproducible across runs)
    uint64_t s = 0x9E3779B97F4A7C15ull;
    auto u01 = [&s]() {
        s = s * 6364136223846793005ull + 1442695040888963407ull;
        return (double)(s >> 11) * (1.0 / 9007199254740992.0);
    };
    for (size_t i = 0; i < len; ++i) {
        double u1 = u01(), u2 = u01();
        if (u1 < 1e-12) u1 = 1e-12;
        double r = std::sqrt(-2.0 * std::log(u1)) * std_per_dim;
        double th = 2.0 * kPi * u2;
        buffer[i].re += r * std::cos(th);
        buffer[i].im += r * std::sin(th);
    }
    return R4W_OK;
}

extern "C" r4w_error_t r4w_frequency_shift(r4w_complex_t *buffer,
                                           size_t len,
                                           double frequency_offset,
                                           double sample_rate) {
    if (!buffer) return R4W_NULL_POINTER;
    if (len == 0 || sample_rate <= 0.0) return R4W_INVALID_PARAMETER;
    const double inc = 2.0 * kPi * frequency_offset / sample_rate;
    for (size_t i = 0; i < len; ++i) {
        double ph = inc * (double)i;
        r4w_complex_t rot = {std::cos(ph), std::sin(ph)};
        buffer[i] = r4w_complex_mul(buffer[i], rot);
    }
    return R4W_OK;
}

// ==================================================================
// Waveforms
// ==================================================================

struct r4w_waveform {
    r4w_waveform_type_t type;
    // PSK
    int m = 2;                 // constellation order
    size_t sps = 1;            // samples per symbol
    // LoRa
    ChirpTable chirp;
    int cr = 1;                // coding rate 4/(4+cr)
    int preamble_len = 8;      // upchirps before sync
};

static const size_t kLoraSyncChirps = 2;     // sync word 0x12 pair
static const size_t kLoraDownChirps = 2;     // + a quarter chirp

static size_t lora_preamble_samples(const r4w_waveform *wf) {
    const size_t n = wf->chirp.sps();
    return (size_t)wf->preamble_len * n + kLoraSyncChirps * n
         + kLoraDownChirps * n + n / 4;
}

static size_t lora_payload_symbols(const r4w_waveform *wf,
                                   size_t data_len) {
    const int sf = wf->chirp.sf;
    const size_t n_cw = 2 * data_len;               // nibbles
    const size_t n_blocks = (n_cw + sf - 1) / sf;   // ceil
    return n_blocks * (size_t)(4 + wf->cr);
}

extern "C" r4w_waveform_t *r4w_waveform_bpsk_new(double sample_rate,
                                                 double symbol_rate) {
    if (sample_rate <= 0.0 || symbol_rate <= 0.0) return nullptr;
    auto *wf = new (std::nothrow) r4w_waveform;
    if (!wf) return nullptr;
    wf->type = R4W_WAVEFORM_BPSK;
    wf->m = 2;
    size_t sps = (size_t)(sample_rate / symbol_rate);
    wf->sps = sps < 1 ? 1 : sps;
    return wf;
}

extern "C" r4w_waveform_t *r4w_waveform_qpsk_new(double sample_rate,
                                                 double symbol_rate) {
    if (sample_rate <= 0.0 || symbol_rate <= 0.0) return nullptr;
    auto *wf = new (std::nothrow) r4w_waveform;
    if (!wf) return nullptr;
    wf->type = R4W_WAVEFORM_QPSK;
    wf->m = 4;
    size_t sps = (size_t)(sample_rate / symbol_rate);
    wf->sps = sps < 1 ? 1 : sps;
    return wf;
}

extern "C" r4w_waveform_t *r4w_waveform_lora_new(uint8_t spreading_factor,
                                                 uint32_t bandwidth_hz,
                                                 double sample_rate) {
    if (spreading_factor < 5 || spreading_factor > 12) return nullptr;
    if (bandwidth_hz != 125000 && bandwidth_hz != 250000
        && bandwidth_hz != 500000) return nullptr;
    if (sample_rate <= 0.0) return nullptr;
    double osf_f = sample_rate / (double)bandwidth_hz;
    size_t osf = (size_t)(osf_f + 0.5);
    if (osf < 1 || std::fabs(osf_f - (double)osf) > 1e-9) return nullptr;
    auto *wf = new (std::nothrow) r4w_waveform;
    if (!wf) return nullptr;
    wf->type = R4W_WAVEFORM_LORA;
    wf->chirp.sf = spreading_factor;
    wf->chirp.bw = bandwidth_hz;
    wf->chirp.osf = osf;
    wf->chirp.build();
    return wf;
}

extern "C" void r4w_waveform_free(r4w_waveform_t *wf) { delete wf; }

extern "C" r4w_waveform_type_t r4w_waveform_get_type(
        const r4w_waveform_t *wf) {
    return wf ? wf->type : R4W_WAVEFORM_BPSK;
}

extern "C" size_t r4w_waveform_samples_per_symbol(
        const r4w_waveform_t *wf) {
    if (!wf) return 0;
    return wf->type == R4W_WAVEFORM_LORA ? wf->chirp.sps() : wf->sps;
}

extern "C" const char *r4w_waveform_name(const r4w_waveform_t *wf) {
    if (!wf) return nullptr;
    switch (wf->type) {
        case R4W_WAVEFORM_BPSK: return "BPSK";
        case R4W_WAVEFORM_QPSK: return "QPSK";
        case R4W_WAVEFORM_LORA: return "LoRa";
    }
    return nullptr;
}

extern "C" size_t r4w_waveform_modulate_size(const r4w_waveform_t *wf,
                                             size_t data_len) {
    if (!wf) return 0;
    if (wf->type == R4W_WAVEFORM_LORA) {
        return lora_preamble_samples(wf)
             + lora_payload_symbols(wf, data_len) * wf->chirp.sps();
    }
    const int bps = (wf->m == 4) ? 2 : 1;
    const size_t n_sym = (data_len * 8 + bps - 1) / bps;
    return n_sym * wf->sps;
}

// PSK modulate: bytes -> bits (MSB first) -> Gray value->index ->
// constellation point repeated sps times (linear_mod.py).
static size_t psk_modulate(const r4w_waveform *wf, const uint8_t *data,
                           size_t data_len, r4w_complex_t *out) {
    const int m = wf->m;
    const int bps = (m == 4) ? 2 : 1;
    cplx con[8];
    int v2i[8];
    psk_constellation(m, con);
    psk_value_to_index(m, v2i);
    const size_t n_bits = data_len * 8;
    const size_t n_sym = (n_bits + bps - 1) / bps;
    size_t w = 0;
    for (size_t s = 0; s < n_sym; ++s) {
        int value = 0;
        for (int b = 0; b < bps; ++b) {
            size_t bit_idx = s * bps + b;
            int bit = 0;
            if (bit_idx < n_bits)
                bit = (data[bit_idx / 8] >> (7 - bit_idx % 8)) & 1;
            value = (value << 1) | bit;
        }
        cplx p = con[v2i[value]];
        for (size_t i = 0; i < wf->sps; ++i)
            out[w++] = {p.real(), p.imag()};
    }
    return w;
}

static size_t psk_demodulate(const r4w_waveform *wf,
                             const r4w_complex_t *samples, size_t len,
                             uint8_t *out, size_t out_len) {
    const int m = wf->m;
    const int bps = (m == 4) ? 2 : 1;
    cplx con[8];
    int v2i[8], i2v[8];
    psk_constellation(m, con);
    psk_value_to_index(m, v2i);
    for (int v = 0; v < m; ++v) i2v[v2i[v]] = v;
    const size_t n_sym = len / wf->sps;
    const size_t n_bits = n_sym * (size_t)bps;
    const size_t n_bytes = (n_bits + 7) / 8;
    if (n_bytes > out_len) return (size_t)-1;
    std::memset(out, 0, n_bytes);
    for (size_t s = 0; s < n_sym; ++s) {
        cplx avg(0, 0);
        for (size_t i = 0; i < wf->sps; ++i) {
            const r4w_complex_t &c = samples[s * wf->sps + i];
            avg += cplx(c.re, c.im);
        }
        avg /= (double)wf->sps;
        int best = 0;
        double best_d = 1e300;
        for (int k = 0; k < m; ++k) {
            double d = std::norm(avg - con[k]);
            if (d < best_d) { best_d = d; best = k; }
        }
        int value = i2v[best];
        for (int b = 0; b < bps; ++b) {
            size_t bit_idx = s * bps + b;
            int bit = (value >> (bps - 1 - b)) & 1;
            if (bit) out[bit_idx / 8] |= 1u << (7 - bit_idx % 8);
        }
    }
    return n_bytes;
}

// LoRa modulate: whiten -> nibbles -> Hamming -> block-pad ->
// interleave -> Gray -> chirps, with preamble (lora/modem.py).
static size_t lora_modulate(const r4w_waveform *wf, const uint8_t *data,
                            size_t data_len, r4w_complex_t *out) {
    const int sf = wf->chirp.sf;
    const int cr = wf->cr;
    const int n_bits = 4 + cr;
    const size_t n = wf->chirp.sps();
    // 1. whiten + split into nibbles (high first)
    std::vector<uint8_t> wseq = whitening_sequence(data_len);
    std::vector<uint32_t> cw;
    cw.reserve(2 * data_len);
    for (size_t i = 0; i < data_len; ++i) {
        uint8_t v = data[i] ^ wseq[i];
        cw.push_back(hamming_encode_nibble((v >> 4) & 0xF, cr));
        cw.push_back(hamming_encode_nibble(v & 0xF, cr));
    }
    // 2. pad to whole interleaver blocks of sf codewords
    const size_t n_blocks = (cw.size() + sf - 1) / sf;
    cw.resize(n_blocks * (size_t)sf, 0);
    // 3. interleave + Gray per block
    std::vector<uint32_t> symbols;
    symbols.reserve(n_blocks * (size_t)n_bits);
    std::vector<uint32_t> sym(n_bits);
    for (size_t b = 0; b < n_blocks; ++b) {
        interleave_block(&cw[b * sf], sf, cr, sym.data());
        for (int s = 0; s < n_bits; ++s)
            symbols.push_back(gray_encode_u(sym[s]));
    }
    // 4. preamble: preamble_len upchirps, sync (K-8, K-16), 2.25 down
    size_t w = 0;
    auto emit = [&](const cplx *src) {
        for (size_t i = 0; i < n; ++i)
            out[w++] = {src[i].real(), src[i].imag()};
    };
    for (int p = 0; p < wf->preamble_len; ++p) emit(wf->chirp.up.data());
    const uint32_t k = (uint32_t)wf->chirp.chips();
    std::vector<cplx> tmp(n);
    wf->chirp.symbol(k >= 8 ? k - 8 : 0, tmp.data());
    emit(tmp.data());
    wf->chirp.symbol(k >= 16 ? k - 16 : 0, tmp.data());
    emit(tmp.data());
    emit(wf->chirp.down.data());
    emit(wf->chirp.down.data());
    for (size_t i = 0; i < n / 4; ++i) {
        out[w++] = {wf->chirp.down[i].real(), wf->chirp.down[i].imag()};
    }
    // 5. payload chirps
    for (uint32_t s : symbols) {
        wf->chirp.symbol(s, tmp.data());
        emit(tmp.data());
    }
    return w;
}

// LoRa demodulate on payload-aligned samples: dechirp -> FFT(chips) ->
// argmax -> Gray^-1 -> deinterleave -> Hamming^-1 -> dewhiten.
static size_t lora_demodulate(const r4w_waveform *wf,
                              const r4w_complex_t *samples, size_t len,
                              uint8_t *out, size_t out_len) {
    const int sf = wf->chirp.sf;
    const int cr = wf->cr;
    const int n_bits = 4 + cr;
    const size_t n = wf->chirp.sps();
    const size_t chips = wf->chirp.chips();
    const size_t n_sym = len / n;
    // symbols via dechirp-FFT-argmax
    std::vector<uint32_t> symbols(n_sym);
    std::vector<cplx> buf(chips);
    for (size_t s = 0; s < n_sym; ++s) {
        for (size_t c = 0; c < chips; ++c) {
            size_t i = c * wf->chirp.osf;  // decimate to chip rate
            cplx x(samples[s * n + i].re, samples[s * n + i].im);
            buf[c] = x * wf->chirp.down[i];
        }
        fft_radix2(buf.data(), chips, false);
        size_t best = 0;
        double best_p = -1.0;
        for (size_t c = 0; c < chips; ++c) {
            double p = std::norm(buf[c]);
            if (p > best_p) { best_p = p; best = c; }
        }
        symbols[s] = (uint32_t)best;
    }
    // decode chain
    const size_t n_blocks = n_sym / (size_t)n_bits;
    std::vector<uint32_t> nibbles;
    nibbles.reserve(n_blocks * (size_t)sf);
    std::vector<uint32_t> sym(n_bits), cw(sf);
    for (size_t b = 0; b < n_blocks; ++b) {
        for (int s = 0; s < n_bits; ++s)
            sym[s] = gray_decode_u(symbols[b * n_bits + s]);
        deinterleave_block(sym.data(), sf, cr, cw.data());
        for (int i = 0; i < sf; ++i)
            nibbles.push_back(hamming_decode_cw(cw[i], cr));
    }
    const size_t n_bytes = nibbles.size() / 2;
    if (n_bytes > out_len) return (size_t)-1;
    std::vector<uint8_t> wseq = whitening_sequence(n_bytes);
    for (size_t i = 0; i < n_bytes; ++i) {
        uint8_t v = (uint8_t)(((nibbles[2 * i] & 0xF) << 4)
                              | (nibbles[2 * i + 1] & 0xF));
        out[i] = v ^ wseq[i];
    }
    return n_bytes;
}

extern "C" r4w_error_t r4w_waveform_modulate(const r4w_waveform_t *wf,
                                             const uint8_t *data,
                                             size_t data_len,
                                             r4w_complex_t *output,
                                             size_t output_len,
                                             size_t *samples_written) {
    if (!wf || !data || !output) return R4W_NULL_POINTER;
    const size_t need = r4w_waveform_modulate_size(wf, data_len);
    if (output_len < need) return R4W_INVALID_SIZE;
    size_t w;
    if (wf->type == R4W_WAVEFORM_LORA)
        w = lora_modulate(wf, data, data_len, output);
    else
        w = psk_modulate(wf, data, data_len, output);
    if (samples_written) *samples_written = w;
    return R4W_OK;
}

extern "C" r4w_error_t r4w_waveform_demodulate(const r4w_waveform_t *wf,
                                               const r4w_complex_t *samples,
                                               size_t samples_len,
                                               uint8_t *output,
                                               size_t output_len,
                                               size_t *bytes_written) {
    if (!wf || !samples || !output) return R4W_NULL_POINTER;
    if (samples_len == 0) {
        if (bytes_written) *bytes_written = 0;
        return R4W_OK;
    }
    size_t n;
    if (wf->type == R4W_WAVEFORM_LORA)
        n = lora_demodulate(wf, samples, samples_len, output, output_len);
    else
        n = psk_demodulate(wf, samples, samples_len, output, output_len);
    if (n == (size_t)-1) return R4W_INVALID_SIZE;
    if (bytes_written) *bytes_written = n;
    return R4W_OK;
}
