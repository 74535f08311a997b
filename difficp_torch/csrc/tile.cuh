// Shared constant of the pair-sum kernels: log2(e), for the exponentials of a
// prescaled argument (exp(a) = 2^(a log2(e)), one ex2 each).
#pragma once

namespace {

constexpr float kLog2e = 1.4426950408889634f;

}  // namespace
