"""Throughput probes of the card's f32 arithmetic and the isolated K1
flux-differencing section: the CUDA counterparts of the TPU study kernels
in ``examples/`` (``vpu_peak.py``, ``vpu_divide.py``,
``vpu_transcendental.py``, ``r5_packed_fd_study.py``).

  * ``peak``: the f32 FMA rate (``python -m esdg_cns_tpu_torch.probes.peak``);
  * ``divide``: the cost of an IEEE division in FMA issue slots;
  * ``transcendental``: the costs of mul, add, div, log, exp, rsqrt and
    sqrt in FMA issue slots;
  * ``fd_section``: K1's flux-differencing section alone, K1's joint line
    body against the split path's three per-direction launches;
  * ``timing``: the slope timing the probes share.

Each kernel's wrapper has its plain PyTorch version beside it, takes it
for CPU tensors and for CUDA tensors launches its kernel or raises; each
counts its launches (``fma_peak.launches``).  Nothing here runs at import.
"""
