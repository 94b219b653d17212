// Threshold gradient codec: host C++ of the distributed trainer.
//
// A copy of deeplearning4j_tpu/native/threshold_codec.cpp (framework-neutral
// host code, kept byte-compatible with it): the reference's threshold-encoding
// wire format (libnd4j encodeThreshold/decodeThreshold). Values with
// |v| >= threshold are encoded as sign-tagged int32 indices, and the unsent
// remainder accumulates in a residual buffer. The trainer exchanges these
// encodings between processes (train/distributed.py).
//
// Encoding: out[0..count) = (index + 1), negated for a negative value.
// Residual update is fused into the encode pass.

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// Encode with residual accumulation. Returns number of encoded indices
// (capped at max_elements). grad is left untouched; residual is updated:
//   acc = grad + residual
//   if |acc| >= t: emit sign(acc)*t, residual = acc - sign(acc)*t
//   else:          residual = acc
int64_t threshold_encode(const float* grad, float* residual, int64_t n,
                         float threshold, int32_t* out, int64_t max_elements) {
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    float acc = grad[i] + residual[i];
    if (acc >= threshold && count < max_elements) {
      out[count++] = static_cast<int32_t>(i + 1);
      residual[i] = acc - threshold;
    } else if (acc <= -threshold && count < max_elements) {
      out[count++] = -static_cast<int32_t>(i + 1);
      residual[i] = acc + threshold;
    } else {
      residual[i] = acc;
    }
  }
  return count;
}

// Would-be-emitted element count for (grad + residual) against threshold,
// WITHOUT touching the residual — the sparse-vs-bitmap format predictor
// (the choice must precede encoding: encoding is stateful).
int64_t threshold_count(const float* grad, const float* residual, int64_t n,
                        float threshold) {
  int64_t count = 0;
  for (int64_t i = 0; i < n; ++i) {
    float acc = grad[i] + residual[i];
    if (acc >= threshold || acc <= -threshold) ++count;
  }
  return count;
}

// Decode: target[|idx|-1] += sign(idx) * threshold
void threshold_decode(const int32_t* encoded, int64_t count, float threshold,
                      float* target, int64_t n) {
  for (int64_t i = 0; i < count; ++i) {
    int32_t idx = encoded[i];
    if (idx > 0 && idx <= n) {
      target[idx - 1] += threshold;
    } else if (idx < 0 && -idx <= n) {
      target[-idx - 1] -= threshold;
    }
  }
}

// Bitmap encoding (reference encodeBitmap): 2 bits per element
// (0 = skip, 1 = +threshold, 2 = -threshold). Returns bytes written.
int64_t bitmap_encode(const float* grad, float* residual, int64_t n,
                      float threshold, uint8_t* out) {
  int64_t nbytes = (n + 3) / 4;
  std::memset(out, 0, nbytes);
  for (int64_t i = 0; i < n; ++i) {
    float acc = grad[i] + residual[i];
    uint8_t code = 0;
    if (acc >= threshold) {
      code = 1;
      residual[i] = acc - threshold;
    } else if (acc <= -threshold) {
      code = 2;
      residual[i] = acc + threshold;
    } else {
      residual[i] = acc;
    }
    out[i >> 2] |= code << ((i & 3) * 2);
  }
  return nbytes;
}

void bitmap_decode(const uint8_t* encoded, int64_t n, float threshold,
                   float* target) {
  for (int64_t i = 0; i < n; ++i) {
    uint8_t code = (encoded[i >> 2] >> ((i & 3) * 2)) & 3;
    if (code == 1) target[i] += threshold;
    else if (code == 2) target[i] -= threshold;
  }
}

}  // extern "C"
