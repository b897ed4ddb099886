"""tpgsd_torch - the PyTorch/CUDA port of tpgsd's SPH producer.

* ``tpgsd_torch.sph`` - WCSPH step on torch tensors; on an NVIDIA Hopper
  card its pair passes run as hand-written CUDA kernels
  (``tpgsd_torch/csrc``, built with ``nvcc`` at first use).
* ``tpgsd_torch.io_runtime`` - asynchronous frame dump of torch tensors
  into ``tpgsd_torch.parallel.ShardedFrameWriter``.
* ``tpgsd_torch.format`` / ``fl`` / ``hoomd`` / ``io`` / ``parallel`` /
  ``utils`` - the port's own copy of the GSD write/read-back stack
  (numpy + a C++ positioned-I/O engine built with ``g++`` at first use);
  files are byte-identical to the JAX package's.
* ``tpgsd_torch.entry`` - the flagship dam-break step, in summation or
  continuity density mode.

The package imports torch, never JAX and nothing of the JAX package
``tpgsd``, which is the reference the port is tested against.
"""
