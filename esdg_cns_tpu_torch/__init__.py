"""esdg_cns_tpu_torch — the PyTorch + CUDA port of esdg_cns_tpu.

The same entropy-stable DG semi-discretization as the JAX package
(``esdg_cns_tpu``, which stays the reference), written with PyTorch on
tensors and with hand-written CUDA kernels for NVIDIA Hopper (sm_90a) in
place of the Pallas TPU kernels.

The first slice is the main path: 3D periodic compressible Euler on a
Gauss-collocated hex mesh (``presets.euler_hex_3d``), the fused RHS
(``solvers.euler_fused.make_euler_rhs_fused`` over the CUDA kernels in
``csrc/``) and LSRK45 (``timestepping.lsrk45``), with the plain PyTorch
twin ``solvers.euler.make_euler_rhs``.

Host-side setup reuses the NumPy-only ``esdg_cns_tpu.basis`` and
``esdg_cns_tpu.mesh``; nothing here imports ``jax``.  Every function
takes an explicit ``device``.  The CUDA kernels build at first use into
``build/esdg_cns_tpu_torch/`` (``kernels.py``).
"""

__version__ = "0.1.0"

GAMMA = 1.4
