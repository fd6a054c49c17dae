"""simpleslam_tpu_torch — the LiDAR SLAM framework in PyTorch and CUDA.

A port of ``simpleslam_tpu`` (the JAX package beside it, which stays the
reference) to PyTorch on an NVIDIA Hopper GPU. It mirrors the reference's
layout and names so each counterpart is easy to find:

  utils/     config, logging, concurrency, timing, file IO
  ops/       device math on tensors; ``loam_kernels`` holds the hand-written
             CUDA kernels (sources in ``csrc/``, built with nvcc at first use)
  models/    frontend, registration, map manager, lidar odometry
  pipeline/  offline replay harness and the sensor simulator
  native/    ctypes loader for the shared C++ host helpers

It never imports jax or ``simpleslam_tpu``. Every tensor lives on an explicit
device (config key ``torch.device``); nothing switches device on its own.
"""

__version__ = "0.1.0"

import torch as _torch

# The registration math is geometric f32 (plane normals from 5-point
# scatters, SE(3) Jacobian products, 6x6 normal equations); the reference
# runs every matmul at full f32 ("highest" precision), so TF32 stays off.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")
