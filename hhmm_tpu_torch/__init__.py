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
- ``hhmm``     the HHMM structure DSL: node taxonomy, the recursive
  simulator, the example trees, the tree → flat HMM compiler and the
  route tables of the tree Gibbs sampler
- ``models``   the parameter contract (with the fused ``make_vg`` and
  the generated quantities), the Tayal (2009) HHMM, the Gaussian and
  multinomial HMMs, the input-output HMMs and the tree HHMM
- ``infer``    batch-native blocked Gibbs, ChEES-HMC with its warmup
  adaptation, MCMC diagnostics and label-switching utilities
- ``sim``      simulators on ``torch.Generator`` streams
- ``batch``    ragged padding, the digest-keyed result cache, per-series
  chain inits and ``fit_batched`` (chunks of series by Gibbs or ChEES)
- ``native``   the C++ zig-zag feature extractor, built with g++ at
  first use (ctypes)
- ``apps``     the Tayal (2009) application: features, trading,
  analytics and the walk-forward back-test (``apps/tayal/wf.py``); the
  Hassan (2005) walk-forward forecaster (``apps/hassan/wf.py``); the
  Jangmin (2004) market-regime fit (``apps/jangmin.py``); the data
  readers (``apps/data_io.py``, ``apps/rdata.py``)
- ``obs``      spans, sampler health, run manifests, kernel-build and
  memory telemetry, device timing on CUDA events, counted kernel costs,
  the serving request plane
- ``serve``    online filtering, the snapshot registry and pager, the
  micro-batching tick scheduler with its carry lanes and event feed
- ``pipeline`` the async serving pipeline's in-flight table and
  series→device placement
- ``adapt``    per-draw reweighting, Liu–West rejuvenation and the
  escalation ladder over the served draw banks
- ``maint``    drift and staleness triggers, warm refits, the shadow
  gate, promotion and the tick-driven maintenance loop
- ``convert``  carries the JAX package's draws and parameters across

The example drivers live beside the package, in ``examples_torch/``.

- ``analysis`` the port's static analyzer (stdlib only: ``python -m
  hhmm_tpu_torch.analysis``)
- ``viz``      the plot library (needs matplotlib; never imported here)

The example drivers live beside the package, in ``examples_torch/``.

Entry points take ``device=None``, meaning CUDA, and raise on a host
without a card (see ``_device.resolve_device``). Importing the package
itself imports nothing: ``resolve_device`` (and with it torch) loads at
first use, so the analyzer's CLI starts without torch.
"""

__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from hhmm_tpu_torch._device import resolve_device

        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
