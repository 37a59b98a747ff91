"""Device seconds a solve of the cuBLAS gemm/gemv kernels (the Lanczos
reorthogonalization and Ritz products) in the traced span."""


def read(ctx):
    return ctx.device_group_per_solve("cuBLAS gemm/gemv")
