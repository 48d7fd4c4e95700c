// The (n_state, n_shock) shapes a DSGE kernel library instantiates. The
// kernels' domain is 1 <= n_state, n_shock <= SMC_MAX_DIM (n_obs 3), the
// domain of the TPU kernels they replace; the build passes SMC_MAX_DIM
// (_build.DSGE_MAX_DIM), and the list of n_shock below must cover it. A
// library holds one n_state, SMC_NS, set by the build: with every n_shock
// (the card's libraries, one nvcc each), or with the one n_shock SMC_NK
// where the build sets it too (the host library of the tests, one g++ per
// shape).
#pragma once

#if !defined(SMC_MAX_DIM) || SMC_MAX_DIM != 8
#error "SMC_SIZES lists n_shock 1..8: build with -DSMC_MAX_DIM=8"
#endif

#if !defined(SMC_NS) || SMC_NS < 1 || SMC_NS > SMC_MAX_DIM
#error "build with -DSMC_NS=<n_state>, 1..SMC_MAX_DIM"
#endif

#ifdef SMC_NK
#if SMC_NK < 1 || SMC_NK > SMC_MAX_DIM
#error "SMC_NK (n_shock) must be 1..SMC_MAX_DIM"
#endif
#define SMC_SIZES(X) X(SMC_NS, SMC_NK)
#else
#define SMC_SIZES(X)                                                    \
  X(SMC_NS, 1) X(SMC_NS, 2) X(SMC_NS, 3) X(SMC_NS, 4) X(SMC_NS, 5)      \
  X(SMC_NS, 6) X(SMC_NS, 7) X(SMC_NS, 8)
#endif
