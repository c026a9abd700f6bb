// Covariance helpers for object_msgs: the Object message stores a
// validity-reduced covariance as a packed upper triangle
// (`complete_covariance`) plus a 24-bit `state_validity` mask ordered by
// ObjectStateIndex. These helpers convert packed <-> full matrices, slice /
// scatter sub-matrices, and re-shape a covariance between two validity
// masks.
//
// Capability parity with the reference's Eigen-based helper
// (`reference ros_messages/object_msgs/include/object_msgs/
// covariance_helper.h`), implemented dependency-free over row-major float
// buffers so it also serves non-ROS hosts; the C-ABI twin used from python
// via ctypes lives in `native/covariance_helper.cc`.

#pragma once

#include <array>
#include <cstdint>
#include <vector>

namespace object_msgs {

constexpr int kNumStates = 24;  // ObjectStateIndex range

// State indices, mirroring ObjectStateIndex.msg.
enum RandomVariable : int {
  POSE_X = 0, POSE_Y, POSE_Z, POSE_ROLL, POSE_PITCH, POSE_YAW,
  VELOCITY_X, VELOCITY_Y, VELOCITY_Z,
  VELOCITY_ROLL, VELOCITY_PITCH, VELOCITY_YAW,
  ACCELERATION_X, ACCELERATION_Y, ACCELERATION_Z,
  ACCELERATION_ROLL, ACCELERATION_PITCH, ACCELERATION_YAW,
  DIMENSION_LENGTH_TO_FRONT, DIMENSION_LENGTH_TO_REAR,
  DIMENSION_WIDTH_TO_LEFT, DIMENSION_WIDTH_TO_RIGHT,
  DIMENSION_HEIGHT_TO_UPPER, DIMENSION_HEIGHT_TO_BOTTOM,
};

// Minimal dense symmetric matrix (row-major), sized at runtime.
struct CovMatrix {
  int n = 0;
  std::vector<float> data;  // n * n row-major

  explicit CovMatrix(int size = 0) : n(size), data(static_cast<size_t>(size) * size, 0.f) {}
  float& at(int i, int j) { return data[static_cast<size_t>(i) * n + j]; }
  float at(int i, int j) const { return data[static_cast<size_t>(i) * n + j]; }
};

inline int64_t packed_size(int n) { return static_cast<int64_t>(n) * (n + 1) / 2; }

// packed upper triangle (row-major over the triangle) -> full symmetric.
inline CovMatrix covariance_from_packed(const std::vector<float>& packed, int n) {
  CovMatrix cov(n);
  size_t k = 0;
  for (int i = 0; i < n; ++i)
    for (int j = i; j < n; ++j, ++k) {
      cov.at(i, j) = packed[k];
      cov.at(j, i) = packed[k];
    }
  return cov;
}

// full symmetric -> packed upper triangle.
inline std::vector<float> covariance_to_packed(const CovMatrix& cov) {
  std::vector<float> packed;
  packed.reserve(packed_size(cov.n));
  for (int i = 0; i < cov.n; ++i)
    for (int j = i; j < cov.n; ++j) packed.push_back(cov.at(i, j));
  return packed;
}

// validity mask -> ordered list of valid state indices.
inline std::vector<int> indices_from_mask(const std::array<uint8_t, kNumStates>& mask) {
  std::vector<int> idx;
  for (int i = 0; i < kNumStates; ++i)
    if (mask[i]) idx.push_back(i);
  return idx;
}

inline std::array<uint8_t, kNumStates> mask_from_indices(const std::vector<int>& idx) {
  std::array<uint8_t, kNumStates> mask{};
  for (int i : idx)
    if (i >= 0 && i < kNumStates) mask[i] = 1;
  return mask;
}

// rows/cols `indices` of `cov` gathered into a dense sub-matrix.
inline CovMatrix sub_matrix(const CovMatrix& cov, const std::vector<int>& indices) {
  CovMatrix sub(static_cast<int>(indices.size()));
  for (size_t a = 0; a < indices.size(); ++a)
    for (size_t b = 0; b < indices.size(); ++b)
      sub.at(static_cast<int>(a), static_cast<int>(b)) = cov.at(indices[a], indices[b]);
  return sub;
}

inline void set_sub_matrix(CovMatrix& cov, const std::vector<int>& indices,
                           const CovMatrix& sub) {
  for (size_t a = 0; a < indices.size(); ++a)
    for (size_t b = 0; b < indices.size(); ++b)
      cov.at(indices[a], indices[b]) = sub.at(static_cast<int>(a), static_cast<int>(b));
}

// Re-shape a covariance expressed over `in_states` into one over
// `out_states`: shared states copy across, states new to the output get
// zero rows/cols (callers typically seed their variance afterwards).
inline CovMatrix reshape_by_random_variables(const CovMatrix& in_cov,
                                             const std::vector<int>& in_states,
                                             const std::vector<int>& out_states) {
  CovMatrix out(static_cast<int>(out_states.size()));
  // position of each state id within the input covariance
  std::array<int, kNumStates> pos;
  pos.fill(-1);
  for (size_t a = 0; a < in_states.size(); ++a) pos[in_states[a]] = static_cast<int>(a);
  for (size_t a = 0; a < out_states.size(); ++a) {
    const int ia = pos[out_states[a]];
    if (ia < 0) continue;
    for (size_t b = 0; b < out_states.size(); ++b) {
      const int ib = pos[out_states[b]];
      if (ib >= 0)
        out.at(static_cast<int>(a), static_cast<int>(b)) = in_cov.at(ia, ib);
    }
  }
  return out;
}

}  // namespace object_msgs
