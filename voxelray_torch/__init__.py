"""voxelray_torch: the PyTorch + CUDA port of voxelray_tpu.

Same layout and public names as the JAX package (io/, ops/, models/,
render/, utils/).  Plain tensor code is PyTorch; the four hand-written
Hopper kernels (K1 voxel_accum, K2 mega_trace, K3 grid_walk, K4
brick_fine) live in csrc/ and are bound in ops/kernels/.  Importing this
package imports no subpackage, so nothing here builds a kernel: the CUDA
library is compiled on first launch.
"""
