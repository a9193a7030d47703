"""grav1synth_tpu_torch: the AV1 film-grain engine in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

This package sits beside the JAX package ``grav1synth_tpu``, which stays
the reference it is held against. It ports the device half of grain
application and of ``diff``:

- ``ops.grain``          -- parameter batches, block-offset randoms,
                            pattern upload, the ``apply_grain`` dispatch
                            and its plain PyTorch reference
- ``ops.grain_kernels``  -- the luma and chroma-pair kernel wrappers,
                            each beside its plain PyTorch version
- ``ops.diff_kernels``   -- the flat-block activity and lag-window
                            statistics kernel wrappers, each beside its
                            plain PyTorch version
- ``ops.diff_estimate``  -- flat blocks, per-frame diff statistics, the
                            host model fit and ``DiffEstimator``
- ``csrc/``              -- the CUDA sources, built by ``_build`` with
                            nvcc on first use and loaded with ctypes
- ``pipelines``          -- ``render`` (decode, grain on the GPU, y4m)
                            and ``diff`` (decode both, statistics on the
                            GPU, grain table)
- ``cli``                -- the ``render`` and ``diff`` subcommands;
                            host-only subcommands delegate to
                            ``grav1synth_tpu.cli``

The host layers of the JAX package contain no JAX and are imported, not
copied: ``bitio``, ``obu``, ``container`` (IVF/y4m readers and writers,
the libav*/dav1d shim and its native pattern generator),
``ops.grain_ref``, ``ops.tables_data``, ``utils.prefetch``,
``utils.progress``, ``utils.filters``, ``tables`` and the host classes
of ``pipelines``. The diff model fit is numpy too, but its module imports
JAX, so ``ops.diff_estimate`` holds a copy. Nothing in this package
imports ``jax``.
"""
