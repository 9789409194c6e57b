// XLA-CPU's fp32 exp, bit for bit (with -fmad=false -ftz=true).
//
// The JAX reference is jitted on the CPU, where `jnp.exp` lowers to this
// polynomial, not to libm: range clamp, n = floor(x log2 e + 1/2), a
// two-constant ln 2 reduction, a degree-5 Horner step, and 2^n built in
// the exponent bits.  The plain PyTorch copy is `kernels/ref.py::xla_exp`;
// both keep the same operation order, with every constant an fp32 value.
#pragma once

__device__ __forceinline__ float xla_exp(float x) {
  x = fminf(fmaxf(x, -87.80000305175781f), 88.80000305175781f);
  float n = floorf(x * 1.4426950216293335f + 0.5f);
  n = fminf(fmaxf(n, -127.0f), 127.0f);
  const float r = (x - 0.693359375f * n) - (-0.00021219444170128554f) * n;
  float p = 1.9875691214110702e-4f;
  p = p * r + 1.398199936375022e-3f;
  p = p * r + 8.333452045917511e-3f;
  p = p * r + 4.166579619050026e-2f;
  p = p * r + 0.1666666567325592f;
  p = p * r + 0.5f;
  const float y = 1.0f + (r + p * (r * r));
  return y * __int_as_float((__float2int_rz(n) + 127) << 23);
}
