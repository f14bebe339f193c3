"""Native (C++) host-pipeline components: the port's copy of vs_seg_tpu/native/.

`decoder` binds the zlib-based NIFTI payload decoder (csrc/nifti_decode.cc),
built at first use by the host's g++ into build/vs_seg_tpu_torch/
(ops/_build.py). Where the build fails, the callers take the plain gzip and
numpy twins after one WARNING that carries the compiler's output.
"""

from vs_seg_tpu_torch.native.decoder import (convert_to_float32,
                                             convert_to_float32_plain,
                                             native_available, read_file_bytes,
                                             read_file_bytes_plain)

__all__ = ["convert_to_float32", "convert_to_float32_plain",
           "native_available", "read_file_bytes", "read_file_bytes_plain"]
