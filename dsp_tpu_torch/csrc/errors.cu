// Names the CUDA error a kernel entry point returned, for the Python
// wrappers' exceptions (dsp_tpu_torch/kernels.py).

#include <cuda_runtime.h>

extern "C" const char* dsp_cuda_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}
