// Quaternion rotation as ops/quat.py computes it, shared by frame_setup.cu
// (the WASD move) and camera_rays.cu (the ray directions). Layout (x, y, z,
// w); v is rotated by (conj(q) * (v, 0) * q).xyz with the Hamilton product.
//
// One rounding an operation in the order of the torch expressions (the
// kernels are built with -fmad=false, so nothing is contracted):
//   s = w1 * w2 - ((x1 * x2 + y1 * y2) + z1 * z2)
//   v = (cross(v1, v2) + w1 * v2) + w2 * v1
// and the zero w of (v, 0) enters every product, as the zeros_like does.

#pragma once

namespace mm {

struct Quat {
  float x, y, z, w;
};

__device__ __forceinline__ Quat load_quat(const float* q) { return Quat{q[0], q[1], q[2], q[3]}; }

// ops/quat.py hamilton.
__device__ __forceinline__ Quat hamilton(Quat a, Quat b) {
  const float s = a.w * b.w - ((a.x * b.x + a.y * b.y) + a.z * b.z);
  const float cx = a.y * b.z - a.z * b.y;
  const float cy = a.z * b.x - a.x * b.z;
  const float cz = a.x * b.y - a.y * b.x;
  return Quat{(cx + a.w * b.x) + b.w * a.x, (cy + a.w * b.y) + b.w * a.y,
              (cz + a.w * b.z) + b.w * a.z, s};
}

// ops/quat.py rotate: hamilton(hamilton(conjugate(q), (v, 0)), q).xyz.
__device__ __forceinline__ void rotate(float& x, float& y, float& z, Quat q) {
  const Quat conj{-q.x, -q.y, -q.z, q.w};
  const Quat r = hamilton(hamilton(conj, Quat{x, y, z, 0.0f}), q);
  x = r.x;
  y = r.y;
  z = r.z;
}

}  // namespace mm
