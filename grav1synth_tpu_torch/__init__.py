"""grav1synth_tpu_torch: the AV1 film-grain engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

This package sits beside the JAX package ``grav1synth_tpu``, which stays
the reference it is held against, and imports nothing of it. The device
half:

- ``ops.grain``          -- parameter batches (one buffer each),
                            block-offset randoms, pattern upload, the
                            ``apply_grain`` dispatch and its plain
                            PyTorch reference
- ``ops.program``        -- each apply batch's parameter program: a
                            captured CUDA graph on the card, eager on the
                            CPU (the counterpart of ``jax.jit``)
- ``ops.grain_kernels``  -- the grain and pattern kernel wrappers, each
                            beside its plain PyTorch version
- ``ops.diff_kernels``   -- the flat-block activity and lag-window
                            statistics kernel wrappers, each beside its
                            plain PyTorch version
- ``ops.diff_estimate``  -- flat blocks, per-frame diff statistics, the
                            host model fit and ``DiffEstimator``
- ``ops.estimate``       -- the single-input noise statistics and
                            ``NoiseEstimator``
- ``parallel.mesh``      -- frame sharding over a ``DeviceMesh``
- ``csrc/``              -- the CUDA sources, built by ``_build`` with
                            nvcc on first use and loaded with ctypes

The host half is this package's own copy of the JAX package's host
modules, which contain no JAX (same sub-package names, imports switched):
``bitio``, ``obu``, ``container`` (IVF, Annex B and y4m readers and
writers, the libav*/dav1d shim, built into ``container/native/``, and its
native pattern generator), ``tables``, ``ops.grain_ref``,
``ops.tables_data``, ``ops.photon_noise``, ``utils`` and
``parallel.host_shard``. On top of both:

- ``pipelines``          -- the host pipelines (``inspect``,
                            ``apply_table``, ``generate``, ``remove``) and
                            the device ones (``render``, ``diff``,
                            ``estimate``)
- ``cli``                -- every subcommand

Nothing in this package imports ``jax``.
"""
