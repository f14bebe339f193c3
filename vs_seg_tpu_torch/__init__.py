"""vs_seg_tpu_torch: the PyTorch + CUDA port of vs_seg_tpu, for one H100.

The JAX package `vs_seg_tpu` stays the reference; this package mirrors its
layout (`nn/`, `models/`, `ops/`, `infer/`, `train/`, `data/`, `eval/`,
`core/`, `compat/`, `native/`, `preprocessing/`) so each counterpart sits
under the same path; `cli/inference.py` and `cli/train.py` are the
counterparts of VS_inference.py and VS_train.py, `cli/vs_pipeline.sh` of
vs_pipeline.sh. It imports torch, numpy and scipy only, never jax, flax,
msgpack or vs_seg_tpu.

Conventions shared with the JAX package:
  - activations are (N, D, H, W, C), depth adjacent to batch;
  - conv kernels keep the JAX parameter shape (kh, kw, kd, Cin, Cout) in the
    reference (H, W, D) order; kernel sizes and strides are given in that
    order too;
  - every function that allocates takes an explicit `device`; nothing falls
    back to the CPU when CUDA is missing.

Hand-written Hopper kernels live in `ops/csrc/*.cu` and are built by nvcc at
first use (`ops/_build.py`); each has a plain PyTorch twin in the same
module, which the wrapper runs only for tensors on the CPU.
"""
