"""photon_tpu_torch: the PyTorch/CUDA port of ``photon_tpu``.

Module paths mirror ``photon_tpu/`` one to one; each module names its
counterpart. The port imports ``torch``, ``numpy`` and the standard library,
never ``jax`` and nothing of ``photon_tpu``. Its sparse passes run as CUDA
kernels written for Hopper (``csrc/``), built at first use into ``_build/``.
"""
