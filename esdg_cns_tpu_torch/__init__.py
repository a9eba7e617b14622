"""esdg_cns_tpu_torch — the PyTorch + CUDA port of esdg_cns_tpu.

The same entropy-stable DG semi-discretization as the JAX package
(``esdg_cns_tpu``, which stays the reference), written with PyTorch on
tensors and with hand-written CUDA kernels for NVIDIA Hopper (sm_90a) in
place of the Pallas TPU kernels.  The ported paths:

  * 3D periodic compressible Euler on a Gauss-collocated hex mesh, affine
    or curved (``presets.euler_hex_3d(curved=...)`` ->
    ``solvers.make_euler_rhs_fused`` over the CUDA kernels K1/K2 ->
    ``timestepping.lsrk45``), with the plain PyTorch twin
    ``solvers.make_euler_rhs``, whose ``flux_diff_impl`` 'pallas' and
    'lines_pallas' run the flux-differencing kernels K5 and row 10;
  * the compressible Navier-Stokes lid-driven cavity on triangles (2D)
    and on Gauss-collocated hexes (3D) (``presets.lid_driven_cavity``,
    ``lid_driven_cavity_3d`` -> ``solvers.make_cns_rhs_affine`` over the
    CUDA kernels K3 or K1, then K4 or K8 + K7 -> ``timestepping.lsrk45``),
    with the plain twin ``solvers.make_cns_rhs`` and entropy-stable wall
    BCs (``solvers.boundary``).

Host-side setup (``basis``, ``mesh``, ``core.ref_elem``) is the port's own
NumPy copy of the JAX package's; nothing here imports ``jax`` or any
module of ``esdg_cns_tpu``.  Every function takes an explicit ``device``.
The CUDA kernels build at first use into ``build/esdg_cns_tpu_torch/``
(``kernels.py``).
"""

__version__ = "0.1.0"

GAMMA = 1.4
