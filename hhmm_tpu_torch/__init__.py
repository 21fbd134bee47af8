"""hhmm_tpu_torch — the PyTorch / CUDA port of ``hhmm_tpu``.

The package grows slice by slice beside ``hhmm_tpu/``, which stays the
reference the port is held against. It imports ``torch`` and numpy and
never ``jax`` or ``hhmm_tpu``. Module and subpackage names follow the
JAX package so each counterpart is easy to find:

- ``core``     log-space math, constraint bijectors and distributions
- ``robust``   per-lane chain-health guards
- ``kernels``  plain scans, the decode (filter, beta, smoothing,
  Viterbi), FFBS, value-and-grad and trajectory entries, and the
  hand-written CUDA kernels (``kernels/csrc``) with their plain PyTorch
  versions
- ``models``   the parameter contract (with the fused ``make_vg`` and
  the generated quantities), the Tayal (2009) HHMM and the Gaussian HMM
- ``infer``    batch-native blocked Gibbs, ChEES-HMC with its warmup
  adaptation, MCMC diagnostics and label-switching utilities
- ``sim``      simulators on ``torch.Generator`` streams
- ``batch``    ragged padding, the digest-keyed result cache, per-series
  chain inits and ``fit_batched`` (chunks of series by Gibbs or ChEES)
- ``native``   the C++ zig-zag feature extractor, built with g++ at
  first use (ctypes)
- ``apps``     the Tayal (2009) application: features, trading,
  analytics and the walk-forward back-test (``apps/tayal/wf.py``)
- ``convert``  carries the JAX package's draws and parameters across

Entry points take ``device=None``, meaning CUDA, and raise on a host
without a card (see ``_device.resolve_device``).
"""

from hhmm_tpu_torch._device import resolve_device

__all__ = ["resolve_device"]
