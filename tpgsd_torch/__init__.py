"""tpgsd_torch - the PyTorch/CUDA port of tpgsd's SPH producer.

* ``tpgsd_torch.sph`` - WCSPH step on torch tensors; on an NVIDIA Hopper
  card its pair passes run as hand-written CUDA kernels
  (``tpgsd_torch/csrc``, built with ``nvcc`` at first use).
* ``tpgsd_torch.io_runtime`` - asynchronous frame dump of torch tensors
  into the shared numpy GSD stack (``tpgsd.parallel.ShardedFrameWriter``).
* ``tpgsd_torch.entry`` - the flagship dam-break step.

The package imports torch and never JAX.  The JAX package ``tpgsd`` is
the reference the port is tested against.
"""
