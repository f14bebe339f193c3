"""Data layer of the port (numpy, host side): NIFTI IO, the MONAI-0.4
transforms, the cached dataset and loader, and the synthetic dataset
generator; copies of vs_seg_tpu/data/ that import neither JAX nor the JAX
package."""
