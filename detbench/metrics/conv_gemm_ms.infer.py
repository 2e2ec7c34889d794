"""Device ms an inference batch in convolution and GEMM kernels."""
from core import readers


def read(tr):
    return readers.conv_gemm_ms(tr)
