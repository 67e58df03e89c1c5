// Example C-ABI waveform plugin (plugins/example-waveform role):
// a Manchester-coded OOK waveform, entirely native.
//
// Build: g++ -O2 -shared -fPIC -o libr4w_example_plugin.so \
//            example_plugin.cpp

#include <cstring>

#include "r4w_plugin.h"

namespace {

constexpr int kSps = 8;  // samples per half-bit

const R4wPluginInfo kInfo = {
    "example-native", "1.0.0",
    "Manchester OOK demonstration plugin (C ABI)", "r4w_tpu",
    1,
};

const R4wWaveformDescriptor kWaveforms[] = {
    {"manchester-ook", "Manchester OOK",
     "On-off keying with Manchester coding (native plugin)",
     1000.0, 10e6, R4W_CAP_CAN_MODULATE | R4W_CAP_CAN_DEMODULATE},
};

}  // namespace

extern "C" {

uint32_t r4w_plugin_api_version(void) { return R4W_PLUGIN_API_VERSION; }

const R4wPluginInfo* r4w_plugin_info(void) { return &kInfo; }

const R4wWaveformDescriptor* r4w_list_waveforms(void) {
    return kWaveforms;
}

int64_t r4w_modulate(const char* id, double /*sample_rate*/,
                     const uint8_t* data, int64_t n_bytes,
                     float* iq_out, int64_t max_samples) {
    if (std::strcmp(id, "manchester-ook") != 0) return -1;
    // each bit -> two half-bits (1->10, 0->01), each half kSps samples
    int64_t n_samples = n_bytes * 8 * 2 * kSps;
    if (n_samples > max_samples) return -1;
    float* p = iq_out;
    for (int64_t i = 0; i < n_bytes; ++i) {
        for (int b = 7; b >= 0; --b) {
            int bit = (data[i] >> b) & 1;
            float halves[2] = {bit ? 1.0f : 0.0f, bit ? 0.0f : 1.0f};
            for (float amp : halves) {
                for (int s = 0; s < kSps; ++s) {
                    *p++ = amp;   // I
                    *p++ = 0.0f;  // Q
                }
            }
        }
    }
    return n_samples;
}

int64_t r4w_demodulate(const char* id, double /*sample_rate*/,
                       const float* iq, int64_t n_samples,
                       uint8_t* out, int64_t max_bytes) {
    if (std::strcmp(id, "manchester-ook") != 0) return -1;
    int64_t n_bits = n_samples / (2 * kSps);
    int64_t n_bytes = n_bits / 8;
    if (n_bytes > max_bytes) return -1;
    for (int64_t byte = 0; byte < n_bytes; ++byte) {
        uint8_t v = 0;
        for (int b = 0; b < 8; ++b) {
            int64_t bit_idx = byte * 8 + b;
            const float* first = iq + bit_idx * 2 * kSps * 2;
            const float* second = first + kSps * 2;
            float e1 = 0.0f, e2 = 0.0f;
            for (int s = 0; s < kSps; ++s) {
                e1 += first[2 * s] * first[2 * s]
                    + first[2 * s + 1] * first[2 * s + 1];
                e2 += second[2 * s] * second[2 * s]
                    + second[2 * s + 1] * second[2 * s + 1];
            }
            v = (uint8_t)((v << 1) | (e1 > e2 ? 1 : 0));
        }
        out[byte] = v;
    }
    return n_bytes;
}

}  // extern "C"
