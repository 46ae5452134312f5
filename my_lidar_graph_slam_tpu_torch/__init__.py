"""PyTorch/CUDA port of the 2D LiDAR graph-SLAM engine.

Counterpart of ``my_lidar_graph_slam_tpu`` (the JAX reference), with the
same module layout: ``utils/``, ``sensor/``, ``io/``, ``ops/``,
``models/``. The two Pallas TPU kernels are hand-written CUDA kernels for
Hopper (``csrc/``), wrapped in ``ops/cuda/``.

Device tensors are float32 and host graph state float64, as in the JAX
package. TF32 is switched off for matmuls and convolutions: scores are sums
of up to 1024 occupancies, and TF32 keeps only about 3 decimal digits,
enough to reorder near-tied candidates.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
