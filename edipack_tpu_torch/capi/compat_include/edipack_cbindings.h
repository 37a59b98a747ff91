/* Drop-in alias: reference drivers do `#include <edipack_cbindings.h>`
 * (the reference's single C/C++ header name). The same symbol surface is
 * provided by edipack_compat.h; add
 *   -I <repo>/edipack_tpu_torch/capi
 *   -I <repo>/edipack_tpu_torch/capi/compat_include
 * and link -ledipack_tpu_torch_c. */
#ifndef EDIPACK_CBINDINGS_ALIAS_H
#define EDIPACK_CBINDINGS_ALIAS_H
#include "edipack_compat.h"
#endif
