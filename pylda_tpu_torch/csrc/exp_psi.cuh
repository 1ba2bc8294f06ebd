// The fast exp-digamma of the gamma fixed points (shared by
// ragged_gamma.cu and dense_gamma.cu).
//
// psi(v) = ln(v + 2) + psi_tail(v): the 2-shift recurrence
// psi(x) = psi(x+2) - 1/x - 1/(x+1) with the asymptotic series, in the
// same expression order as
// pylda_tpu_torch/ops/dirichlet.py::exp_dirichlet_expectation_fast, so
//
//   exp(psi(x) - psi(s)) = (x + 2) * exp(psi_tail(x) - (ln(s + 2) + psi_tail(s))).

#pragma once

namespace {

__device__ __forceinline__ float psi_tail(float v) {
  const float y = v + 2.0f;
  const float inv = 1.0f / y;
  const float inv2 = inv * inv;
  const float t = -0.5f * inv -
      inv2 * (1.0f / 12.0f - inv2 * (1.0f / 120.0f - inv2 * (1.0f / 252.0f)));
  return t - 1.0f / v - 1.0f / (v + 1.0f);
}

// ln(s + 2) + psi_tail(s) for a row sum s: subtract it from psi_tail(x).
__device__ __forceinline__ float psi_row_term(float s) {
  return logf(s + 2.0f) + psi_tail(s);
}

}  // namespace
